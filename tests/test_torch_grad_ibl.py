"""Gradients through an image-based environment light against ``jax.grad``:
``tests/scenes/g_ibl.sp`` (direct lighting) and ``g_ibl_rrnee.sp`` (the
flagship), a few pixels each, the JAX scene carried over (the CDF tables
stay detached in both packages; the radiance gradient flows through the
texel lookup into ``env_image``).  Tolerances as in ``test_torch_grad.py``.
"""

import os

import numpy as np
import pytest
import torch

import simplepath_tpu as J
from test_torch_grad import assert_leaf_close, both_grads

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)


@pytest.fixture(scope="module", params=["g_ibl", "g_ibl_rrnee"])
def grads(request):
    js = J.load_scene(os.path.join(HERE, "scenes", request.param + ".sp"))
    rs = np.random.RandomState(4)
    w, h = js.static.width, js.static.height
    return both_grads(js, rs.randint(0, w, 24), rs.randint(0, h, 24), spp=2,
                      seed=6, target=0.1)


def test_loss_matches_jax(grads):
    jl, _, tl, _ = grads
    assert tl == pytest.approx(jl, rel=1e-5)


@pytest.mark.parametrize("leaf", ["env_image", "env_radiance", "mat_albedo"])
def test_gradient_leaf_matches_jax(grads, leaf):
    _, jg, _, tg = grads
    assert_leaf_close(jg, tg, leaf)
    if leaf == "env_image":
        assert np.abs(tg[leaf]).max() > 0
