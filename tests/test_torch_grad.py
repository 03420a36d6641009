"""Port gradients against ``jax.grad``: the flagship (iterative_rrnee).

The analytic scene of ``tests/test_gradients.py`` (16x16, depth 3, 4 spp,
key 3, target 0.25): the JAX scene and its parameters are carried over with
``convert.scene_from_numpy`` / ``params_from_numpy``, the loss and every
gradient leaf are computed by both packages, the JAX side as its own tests
run it (a jitted ``jax.value_and_grad`` of ``render_loss``), the port's
through its checkpointed bounces on the CPU.

Pixels: the 16x16 grid without pixel (12, 11).  On the direct-lighting and
brute-force RR renders one lane of that pixel, sample 3, grazes the shiny
sphere (b^2 - 4ac = 1.5e-3 against b^2 = 101), where XLA and PyTorch round
the same float32 inputs to discriminants 1 % apart (1.5493e-3 vs
1.5335e-3); through 1/sqrt(disc) that moves the pixel's camera derivatives
by 0.5 %, enough to swamp a small camera leaf of the whole grid.  That pixel
is compared on its own (``test_torch_grad_direct.py``).

Tolerance: the loss at rtol 1e-5; every leaf at atol = 2e-3 x the leaf's
own max |g| + 1e-6.

Measured on the CPU (max |port - jax| / max |g| of the leaf; every loss
within 2.5e-7): iterative_rrnee <= 3.1e-6 on the material, light and
environment leaves, camera <= 4.0e-4; direct_lighting <= 5.4e-5
(cam_to), 4.0e-5 (mat_roughness); brute_force_iterative_rr <= 2.6e-4
(cam_eye), the other leaves <= 4.9e-6; the grazing pixel alone, camera
4.6e-3 to 5.2e-3, the other leaves <= 3.6e-4; the mesh <= 8.5e-8, camera
<= 6.2e-5; the IBL scenes env_image <= 9.0e-7, mat_albedo <= 1.6e-7,
camera <= 6.0e-5 (env_radiance gets no gradient in either package: an
IBL's radiance is baked into its image at load); adaptive RR mat_albedo
2.9e-7, env_radiance 1.8e-7 (its camera leaves are ~1e-10 in both).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplepath_tpu import build_scene, parse_sp
from simplepath_tpu.diff import grad as JG
from simplepath_tpu_torch.convert import (params_from_numpy, params_to_numpy,
                                          scene_from_numpy)
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.diff import grad as TG
from test_gradients import SCENE

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)

LEAVES = ("mat_albedo", "mat_roughness", "mat_ior", "mat_cc_ior",
          "mat_cc_color", "cam_eye", "cam_to", "cam_up", "cam_fov",
          "light_radiance", "env_radiance", "env_image")
CAMERA = ("cam_eye", "cam_to", "cam_up", "cam_fov")


def jax_scene_arrays(js) -> dict:
    out = {}
    for g in dataclasses.fields(js):
        group = getattr(js, g.name)
        if g.name == "static" or group is None:
            continue
        for f in dataclasses.fields(group):
            out[f"{g.name}.{f.name}"] = np.asarray(getattr(group, f.name))
    return out


def convert(js):
    return scene_from_numpy(dataclasses.asdict(js.static), jax_scene_arrays(js),
                            device="cpu")


def both_grads(js, xs, ys, spp, seed, integrator=None, target=0.25):
    """(jax loss, jax grads, port loss, port grads) as numpy, for the same
    scene, parameters, pixels and key."""
    xs, ys = np.asarray(xs, np.int32), np.asarray(ys, np.int32)
    tgt = np.full((len(xs), 3), target, np.float32) if np.isscalar(target) \
        else np.asarray(target, np.float32)
    jp = JG.get_params(js)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JG.render_loss(js, p, jnp.asarray(tgt), jnp.asarray(xs),
                                 jnp.asarray(ys), spp, jax.random.PRNGKey(seed),
                                 integrator)))(jp)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    tl, tg = TG.render_loss_and_grad(
        convert(js), tp, torch.from_numpy(tgt), torch.from_numpy(xs),
        torch.from_numpy(ys), spp, prng_key(seed), integrator, device="cpu")
    return (float(jl), {k: np.asarray(v) for k, v in jg.items()}, float(tl),
            params_to_numpy(tg))


def assert_leaf_close(jg: dict, tg: dict, leaf: str, rel: float = 2e-3) -> None:
    a, b = jg[leaf], tg[leaf]
    assert a.shape == b.shape and np.isfinite(b).all()
    err = float(np.abs(a - b).max())
    scale = float(np.abs(a).max())
    assert err <= rel * scale + 1e-6, f"{leaf}: max |port - jax| = " \
        f"{err:.3e}, max |g| = {scale:.3e}"


GRID = np.arange(16 * 16)
GRAZING = (12, 11)           # (x, y): see the module docstring


def analytic_grads(integrator, grazing=False):
    """Both packages' loss and gradients on the analytic scene: the 16x16
    grid without the grazing pixel, or (``grazing``) that pixel alone."""
    js = build_scene(parse_sp(SCENE))
    xs, ys = GRID % 16, GRID // 16
    at = (xs == GRAZING[0]) & (ys == GRAZING[1])
    keep = at if grazing else ~at
    return both_grads(js, xs[keep], ys[keep], spp=4, seed=3,
                      integrator=integrator)


@pytest.fixture(scope="module")
def grads():
    return analytic_grads("iterative_rrnee")


def test_loss_matches_jax(grads):
    jl, _, tl, _ = grads
    assert tl == pytest.approx(jl, rel=1e-5)


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradient_leaf_matches_jax(grads, leaf):
    _, jg, _, tg = grads
    assert set(tg) == set(jg)
    assert_leaf_close(jg, tg, leaf)
