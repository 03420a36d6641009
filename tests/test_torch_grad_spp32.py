"""High-spp reverse mode on the port: 32 samples, each bounce checkpointed
(``tests/test_gradients.py``'s 32-spp case: 8x8 pixels, key 11, central
differences on mat_albedo[1, 2])."""

import torch

import simplepath_tpu_torch as T
from simplepath_tpu_torch.diff import grad as TG
from test_gradients import SCENE
from test_torch_grad_fd import assert_fd_close, fd, loss_fn

torch.set_num_threads(1)


def test_grad_spp32_checkpointed_matches_fd():
    """32 samples, each bounce checkpointed: finite gradients that match
    central differences on mat_albedo[1, 2]."""
    scene = T.build_scene(T.parse_sp(SCENE), device="cpu")
    loss, loss_and_grad = loss_fn(scene, 8, 32, 11)
    params = TG.get_params(scene)
    _, grads = loss_and_grad(params)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert_fd_close(float(grads["mat_albedo"][1, 2]),
                    fd(loss, params, "mat_albedo", (1, 2), 1e-3),
                    "mat_albedo(1, 2)")
