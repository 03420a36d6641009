"""Gradients through the triangle BVH path: ``tests/test_gradients.py``'s
mesh scene (an 80-face icosphere, written by the port's own
``io.meshgen``, above BVH_MIN_TRIS so the record table and the traversal
wrappers are used), against central differences on the port and against
``jax.grad`` on the same PLY (tolerances as in ``test_torch_grad.py``)."""

import os

import numpy as np
import pytest
import torch

import simplepath_tpu_torch as T
from simplepath_tpu import build_scene, parse_sp
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.diff import grad as TG
from simplepath_tpu_torch.io.meshgen import icosphere, write_ply
from test_gradients import MESH_SCENE
from test_torch_grad import LEAVES, assert_leaf_close, both_grads
from test_torch_grad_fd import assert_fd_close, fd

torch.set_num_threads(1)

N = 16 * 16
XS, YS = np.arange(N) % 16, np.arange(N) // 16


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    v, f = icosphere(1)
    write_ply(os.path.join(d, "ico.ply"), v.astype(np.float32), f)
    return str(d)


@pytest.fixture(scope="module")
def grads(mesh_dir):
    js = build_scene(parse_sp(MESH_SCENE, base_dir=mesh_dir))
    assert js.static.num_triangles == 80 and js.static.has_bvh
    return both_grads(js, XS, YS, spp=4, seed=5)


def test_mesh_albedo_grad_matches_fd(mesh_dir):
    scene = T.build_scene(T.parse_sp(MESH_SCENE, base_dir=mesh_dir),
                          device="cpu")
    assert scene.static.num_triangles == 80 and scene.static.has_bvh
    xs, ys = torch.from_numpy(XS), torch.from_numpy(YS)
    target = torch.full((N, 3), 0.25)
    params = TG.get_params(scene)
    _, grads = TG.render_loss_and_grad(scene, params, target, xs, ys, 4,
                                       prng_key(5), device="cpu")
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())

    def loss(p):
        with torch.no_grad():
            return float(TG.render_loss(scene, p, target, xs, ys, 4,
                                        prng_key(5), device="cpu"))
    g_ad = float(grads["mat_albedo"][0, 0])       # material 0: the mesh's
    assert_fd_close(g_ad, fd(loss, params, "mat_albedo", (0, 0), 1e-3),
                    "mat_albedo(0, 0)")
    assert abs(g_ad) > 1e-5, "mesh albedo gradient is zero"


def test_loss_matches_jax(grads):
    jl, _, tl, _ = grads
    assert tl == pytest.approx(jl, rel=1e-5)


@pytest.mark.parametrize("leaf", [l for l in LEAVES if not l.startswith("env")])
def test_gradient_leaf_matches_jax(grads, leaf):
    _, jg, _, tg = grads
    assert set(tg) == set(jg)
    assert_leaf_close(jg, tg, leaf)
