"""Port gradients against ``jax.grad`` for direct lighting (tolerances and
measured errors in ``test_torch_grad.py``), the grazing pixel (12, 11) on
its own, and the rho table that ``set_params`` rebuilds.

The grazing pixel: one lane grazes the shiny sphere, where XLA and PyTorch
round its discriminant 1 % apart; through 1/sqrt(disc) the camera leaves
move by half that (measured 5.1e-3 to 5.2e-3 of each leaf's max), so they
are held at 1e-2 x the leaf's max; every other leaf at the usual 2e-3.

The JAX package rebuilds the microfacet directional-albedo table inside
every render, so a render at a new roughness uses that roughness's table.
The port keeps the table in ``MaterialArrays`` and ``set_params`` rebuilds
it: a render after ``set_params`` with another ``mat_roughness`` equals the
JAX render at that roughness, and differs from a render that kept the old
table.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplepath_tpu_torch as T
from simplepath_tpu import build_scene, parse_sp
from simplepath_tpu.diff import grad as JG
from simplepath_tpu.render.film import render_rays as j_render_rays
from simplepath_tpu_torch.convert import params_from_numpy
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.diff import grad as TG
from simplepath_tpu_torch.render.film import with_rho_table
from test_gradients import SCENE
from test_torch_grad import (CAMERA, LEAVES, analytic_grads, assert_leaf_close,
                             convert)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grads():
    return analytic_grads("direct_lighting")


def test_loss_matches_jax(grads):
    jl, _, tl, _ = grads
    assert tl == pytest.approx(jl, rel=1e-5)


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradient_leaf_matches_jax(grads, leaf):
    _, jg, _, tg = grads
    assert_leaf_close(jg, tg, leaf)


@pytest.fixture(scope="module")
def grazing_grads():
    return analytic_grads("direct_lighting", grazing=True)


@pytest.mark.parametrize("leaf", LEAVES)
def test_grazing_pixel_leaf_matches_jax(grazing_grads, leaf):
    jl, jg, tl, tg = grazing_grads
    assert tl == pytest.approx(jl, rel=1e-3)
    assert_leaf_close(jg, tg, leaf, rel=1e-2 if leaf in CAMERA else 2e-3)


def test_set_params_rebuilds_the_rho_table():
    js = build_scene(parse_sp(SCENE))
    jp = JG.get_params(js)
    jp["mat_roughness"] = jp["mat_roughness"] * 0.25     # 0.4 -> 0.1 (shiny)
    n = 64
    xs, ys = np.arange(n) * 5 % 16, np.arange(n) * 3 % 16
    ref = np.asarray(j_render_rays(JG.set_params(js, jp), jnp.asarray(xs, jnp.int32),
                                   jnp.asarray(ys, jnp.int32), 2,
                                   jax.random.PRNGKey(1), "iterative_rrnee"))

    ts = convert(js)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    txs, tys = torch.from_numpy(xs), torch.from_numpy(ys)
    fresh = TG.set_params(ts, tp)
    out = T.render_rays(fresh, txs, tys, 2, prng_key(1), "iterative_rrnee",
                        device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)

    # a scene left with the old materials' table renders the same:
    # render_rays builds the table from the scene's materials on every
    # call, as JAX does
    stale = dataclasses.replace(fresh, materials=dataclasses.replace(
        fresh.materials, rho_table=with_rho_table(ts).materials.rho_table))
    assert not torch.equal(with_rho_table(fresh).materials.rho_table,
                           stale.materials.rho_table)
    out_stale = T.render_rays(stale, txs, tys, 2, prng_key(1), "iterative_rrnee",
                              device="cpu").numpy()
    np.testing.assert_array_equal(out_stale, out)
