"""Port gradients against central finite differences with common random
numbers: the cases, indices, eps values and tolerance of
``tests/test_gradients.py`` (the tolerance is
``max(0.08 * max(|fd|, |ad|), 2e-3)``), on the port alone.

Also: a checkpointed gradient equal to the one plain autograd takes without
checkpoints, and the SGD step of ``make_train_step``.  The 32-spp case is in
``test_torch_grad_spp32.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import simplepath_tpu_torch as T
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.diff import grad as TG
from test_gradients import SCENE

torch.set_num_threads(1)


def pixels(side):
    n = side * side
    return torch.arange(n) % side, torch.arange(n) // side


def loss_fn(scene, side, spp, seed):
    xs, ys = pixels(side)
    target = torch.full((side * side, 3), 0.25)

    def loss(p):
        with torch.no_grad():
            return float(TG.render_loss(scene, p, target, xs, ys, spp,
                                        prng_key(seed), device="cpu"))

    def loss_and_grad(p):
        return TG.render_loss_and_grad(scene, p, target, xs, ys, spp,
                                       prng_key(seed), device="cpu")
    return loss, loss_and_grad


def fd(loss, params, path, idx, eps):
    def bump(sign):
        p = dict(params)
        p[path] = params[path].clone()
        p[path][idx] += sign * eps
        return loss(p)
    return (bump(+1) - bump(-1)) / (2 * eps)


def assert_fd_close(g_ad, g_fd, what):
    tol = max(0.08 * max(abs(g_fd), abs(g_ad)), 2e-3)
    assert abs(g_ad - g_fd) < tol, f"{what}: ad={g_ad:.6f} fd={g_fd:.6f}"


@pytest.fixture(scope="module")
def setup():
    scene = T.build_scene(T.parse_sp(SCENE), device="cpu")
    loss, loss_and_grad = loss_fn(scene, 16, 4, 3)
    params = TG.get_params(scene)
    return scene, loss, params, loss_and_grad(params)[1]


@pytest.mark.parametrize("path,idx,eps", [
    ("mat_albedo", (0, 0), 1e-3),
    ("mat_albedo", (1, 2), 1e-3),
    ("mat_roughness", (0,), 1e-3),
    ("light_radiance", (0, 1), 1e-2),
    ("env_radiance", (0,), 1e-3),
    ("cam_eye", (2,), 1e-4),
    ("cam_to", (1,), 3e-5),
    ("cam_fov", (), 3e-4),
])
def test_grad_matches_fd(setup, path, idx, eps):
    _, loss, params, grads = setup
    g_ad = float(grads[path][idx])
    assert_fd_close(g_ad, fd(loss, params, path, idx, eps), f"{path}{idx}")


def test_gradients_nonzero(setup):
    grads = setup[3]
    for leaf in ("mat_albedo", "light_radiance", "cam_eye", "cam_fov"):
        assert float(grads[leaf].abs().sum()) > 0, leaf


def test_checkpointed_gradient_equals_plain_autograd(setup):
    """Checkpointing recomputes samples and bounces exactly (threefry keys,
    no torch RNG): the gradient equals the one autograd takes through the
    same render without checkpoints, up to the order of accumulation."""
    scene, _, params, grads = setup
    xs, ys = pixels(16)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    img = T.render_rays(TG.set_params(scene, leaves), xs, ys, 4, prng_key(3),
                        device="cpu")
    loss = torch.mean((img - 0.25) ** 2)
    plain = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    for (k, _), g in zip(leaves.items(), plain):
        g = torch.zeros_like(grads[k]) if g is None else g
        torch.testing.assert_close(grads[k], g, rtol=1e-5, atol=1e-9,
                                   msg=lambda m: f"{k}: {m}")


def test_train_step_is_sgd_and_lowers_the_loss(setup):
    """make_train_step: new params = params - lr * grad; a few steps from a
    flat albedo toward the scene's own render lower the loss."""
    scene, _, params, _ = setup
    xs, ys = pixels(8)
    dscene = dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, differentiable=True))
    with torch.no_grad():
        target = T.render_rays(dscene, xs, ys, 1, prng_key(5), device="cpu")
    step = TG.make_train_step(scene, spp=1, lr=0.5, device="cpu")
    p = dict(params, mat_albedo=torch.full_like(params["mat_albedo"], 0.5))
    loss0, grads = TG.render_loss_and_grad(scene, p, target, xs, ys, 1,
                                           prng_key(5), device="cpu")
    p1, loss = step(p, target, xs, ys, prng_key(5))
    assert float(loss) == float(loss0)
    for k in p:
        torch.testing.assert_close(p1[k], p[k] - 0.5 * grads[k])
        assert not p1[k].requires_grad
    for _ in range(3):
        p1, loss = step(p1, target, xs, ys, prng_key(5))
    assert float(loss) < 0.5 * float(loss0)


def test_train_step_over_named_leaves(setup):
    """make_train_step(leaves=...): only the named leaves get a gradient and
    move (p - lr * g, g equal to the full gradient's); the others pass
    through unchanged."""
    scene, _, params, _ = setup
    xs, ys = pixels(8)
    target = torch.full((64, 3), 0.25)
    p = dict(params, mat_albedo=torch.full_like(params["mat_albedo"], 0.5))
    _, grads = TG.render_loss_and_grad(scene, p, target, xs, ys, 1,
                                       prng_key(5), device="cpu")
    step = TG.make_train_step(scene, spp=1, lr=0.5, device="cpu",
                              leaves=("mat_albedo", "cam_fov"))
    p1, _ = step(p, target, xs, ys, prng_key(5))
    assert set(p1) == set(p)
    for k in p:
        want = p[k] - 0.5 * grads[k] if k in ("mat_albedo", "cam_fov") else p[k]
        torch.testing.assert_close(p1[k], want, rtol=1e-6, atol=1e-9)
    assert not torch.equal(p1["mat_albedo"], p["mat_albedo"])
