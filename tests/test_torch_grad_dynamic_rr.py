"""Port gradients against ``jax.grad`` through adaptive Russian roulette
(``brute_force_iterative_dynamic_rr``).

The statistics only act once a pixel's depth bucket holds RR_MIN_SAMPLES
(16) observations, so this renders ``g_bfiterrr`` with the integrator
overridden and Russian roulette from depth 0 at 20 spp (as
``test_torch_multibounce.py`` does): from sample 17 on, the per-pixel running
means decide RR and reweight survivors, and the gradient flows through them
across samples, as in the JAX package (which does not stop it).  The port
updates the statistics out of place, so autograd may still read the old
values, and the checkpointed recompute of a bounce sees the statistics it
saw the first time.  Tolerances as in ``test_torch_grad.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import simplepath_tpu as J
from test_torch_grad import LEAVES, assert_leaf_close, both_grads

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
DYNAMIC = "brute_force_iterative_dynamic_rr"


@pytest.fixture(scope="module")
def grads():
    js = J.load_scene(os.path.join(HERE, "scenes", "g_bfiterrr.sp"),
                      cli_integrator=DYNAMIC)
    js = dataclasses.replace(js, static=dataclasses.replace(
        js.static, russian_roulette_depth=0))
    rs = np.random.RandomState(0)
    xs, ys = rs.randint(0, 48, 16), rs.randint(24, 48, 16)
    return both_grads(js, xs, ys, spp=20, seed=2, target=0.1)


def test_loss_matches_jax(grads):
    jl, _, tl, _ = grads
    assert tl == pytest.approx(jl, rel=1e-5)


@pytest.mark.parametrize("leaf", [l for l in LEAVES if l != "light_radiance"])
def test_gradient_leaf_matches_jax(grads, leaf):
    _, jg, _, tg = grads
    assert_leaf_close(jg, tg, leaf)
    assert np.isfinite(tg[leaf]).all()


def test_albedo_gradient_nonzero(grads):
    assert np.abs(grads[3]["mat_albedo"]).sum() > 0
