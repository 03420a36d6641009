"""Inverse rendering on the port: ``tests/test_inverse.py``'s albedo
recovery with ``torch.optim.Adam`` in place of optax, the same scene, key,
steps, learning rate and thresholds (the joint albedo-radiance case is in
``test_torch_inverse_joint.py``).

The loss is ``render_loss``'s MSE taken through plain autograd, without the
differentiable mode's checkpoints: ``test_torch_grad_fd.py`` shows the two
gradients equal, and without the recomputes a step takes ~0.7 s on one CPU
thread instead of ~3 s.  The target is the port's own render at the true
parameters with the same key, so the optimum is exactly loss 0.
"""

import numpy as np
import pytest
import torch

import simplepath_tpu_torch as T
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.diff import grad as TG
from test_inverse import SCENE

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    scene = T.build_scene(T.parse_sp(SCENE), device="cpu")
    n = 16 * 16
    xs, ys = torch.arange(n) % 16, torch.arange(n) // 16
    p_true = TG.get_params(scene)

    def render(p):
        return T.render_rays(TG.set_params(scene, p), xs, ys, 4, prng_key(9),
                             device="cpu")

    with torch.no_grad():
        target = render(p_true)
    return p_true, lambda p: torch.mean((render(p) - target) ** 2)


def optimize(p0, loss_fn, trainable, steps, lr):
    leaves = {k: p0[k].clone().requires_grad_(True) for k in trainable}
    opt = torch.optim.Adam(list(leaves.values()), lr=lr)

    def loss_now():
        return loss_fn({**p0, **leaves})
    with torch.no_grad():
        loss0 = float(loss_now())
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_now()
        loss.backward()
        opt.step()
    return {k: v.detach() for k, v in leaves.items()}, loss0, float(loss.detach())


def test_inverse_albedo_recovery(problem):
    """From a flat 0.5 albedo under known lighting, 60 Adam steps recover
    the true albedo to < 0.05 and drop the loss >= 10x (measured on the
    CPU: 4,310x, max error 0.0049; the JAX package's test: ~4,000x,
    0.005)."""
    p_true, loss_fn = problem
    p0 = dict(p_true, mat_albedo=torch.full_like(p_true["mat_albedo"], 0.5))
    params, loss0, lossN = optimize(p0, loss_fn, ["mat_albedo"], steps=60,
                                    lr=0.05)
    assert loss0 / max(lossN, 1e-30) >= 10, (loss0, lossN)
    err = float((params["mat_albedo"] - p_true["mat_albedo"]).abs().max())
    print(f"loss drop {loss0 / lossN:.0f}x, albedo error {err:.4f}")
    assert err < 0.05, f"albedo recovery error {err}"
