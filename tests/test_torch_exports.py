"""The JAX package's remaining exported names in the port, and a guard that
keeps every exported name ported.

- ``scene.bvh.make_bvh_arrays``: records byte-identical to the JAX
  function's and the same triangle order, on tests/test_bvh.py's mesh; the
  device rule (``device=None`` raises without a CUDA device).
- ``render.traverse.scene_intersect`` / ``scene_intersect_p``, the one-ray
  forms, ray by ray against the JAX package's one-ray forms on g_blob (a
  triangle BVH and a plane) and g_glossy (spheres and a plane).  Tolerances
  are tests/test_torch_traverse.py's: valid, kind and idx exact, t rtol
  1e-5, beta/gamma rtol 1e-4, occlusion exact; dt/d(ro) against
  ``jax.grad`` at rtol 1e-4.
- Every name in an ``__all__`` of ``simplepath_tpu/`` is a top-level name
  of the port's module at the same path, or a named departure.  Both
  sides are read with ``ast``: nothing is imported or compiled.
"""

import ast
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import simplepath_tpu as J
import simplepath_tpu_torch as T
from simplepath_tpu.io.meshgen import displaced_blob
from simplepath_tpu.render import traverse as JTr
from simplepath_tpu.render.camera import generate_ray as j_generate_ray
from simplepath_tpu.scene.bvh import make_bvh_arrays as j_make_bvh_arrays
from simplepath_tpu_torch.render import traverse as TTr
from simplepath_tpu_torch.scene.bvh import make_bvh_arrays as t_make_bvh_arrays

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS = 64
N_GRAD = 8


def _blob_triangles():
    """tests/test_bvh.py's mesh (displaced_blob(3), 1,280 triangles) as
    the triangle soup and boxes that its ``tri_scene`` hands the builder."""
    v, f = displaced_blob(3)
    v0, v1, v2 = (v[f[:, i]].astype(np.float32) for i in range(3))
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    return lo, hi, v0, v1, v2


def test_make_bvh_arrays_matches_the_jax_package():
    tris = _blob_triangles()
    jb, jorder = j_make_bvh_arrays(*tris)
    tb, torder = t_make_bvh_arrays(*tris, device="cpu")
    assert tb.records.device.type == "cpu"
    assert tb.records.dtype == torch.float32
    assert np.asarray(jb.records).tobytes() == tb.records.numpy().tobytes()
    np.testing.assert_array_equal(torder, np.asarray(jorder))


def test_make_bvh_arrays_needs_a_cuda_device_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_make_bvh_arrays(*_blob_triangles())


# ------------------------------------------------------- the one-ray forms

def _rays(js, seed):
    """32 camera rays through seeded pixels and 32 seeded rays from inside
    the scene's box in every direction, a few with a collapsed interval."""
    rs = np.random.RandomState(seed)
    half = N_RAYS // 2
    px = (rs.rand(half) * js.static.width).astype(np.float32)
    py = (rs.rand(half) * js.static.height).astype(np.float32)
    cro, crd = j_generate_ray(js.camera, jnp.asarray(px), jnp.asarray(py))
    ro = (rs.rand(half, 3) * [3, 2.5, 3] - [1.5, 0.2, 1.5]).astype(np.float32)
    d = rs.randn(half, 3).astype(np.float32)
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ro = np.concatenate([np.asarray(cro), ro]).astype(np.float32)
    rd = np.concatenate([np.asarray(crd), rd]).astype(np.float32)
    t_min = np.full(N_RAYS, 1e-3, np.float32)
    t_max = np.where(rs.rand(N_RAYS) < 0.5, np.inf,
                     0.3 + 3 * rs.rand(N_RAYS)).astype(np.float32)
    t_max[half:][rs.rand(half) < 0.1] = -np.inf
    return ro, rd, t_min, t_max


@pytest.fixture(scope="module", params=["g_blob", "g_glossy"])
def one_ray_case(request):
    path = os.path.join(ROOT, "tests", "scenes", request.param + ".sp")
    js = J.load_scene(path)
    ts = T.load_scene(path, device="cpu")
    assert js.static.has_bvh == (request.param == "g_blob")
    return request.param, js, ts, _rays(js, {"g_blob": 11, "g_glossy": 12}[request.param])


def test_scene_intersect_matches_the_jax_one_ray_form(one_ray_case):
    name, js, ts, (ro, rd, t_min, t_max) = one_ray_case
    j_one = jax.jit(lambda o, d, a, b: JTr.scene_intersect(js, o, d, a, b))
    hits, kinds = 0, set()
    for i in range(N_RAYS):
        ref = j_one(ro[i], rd[i], t_min[i], t_max[i])
        out = TTr.scene_intersect(ts, torch.from_numpy(ro[i]), torch.from_numpy(rd[i]),
                                  float(t_min[i]), float(t_max[i]))
        assert isinstance(out, TTr.Hit)
        for f in out:
            assert f.shape == ()
        assert bool(out.valid) == bool(ref.valid), i
        if not bool(ref.valid):
            continue
        hits += 1
        kinds.add(int(out.kind))
        assert int(out.kind) == int(ref.kind), i
        assert int(out.idx) == int(ref.idx), i
        np.testing.assert_allclose(float(out.t), float(ref.t), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(out.beta), float(ref.beta), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(out.gamma), float(ref.gamma), rtol=1e-4, atol=1e-5)
    assert hits >= N_GRAD
    # triangles (kind 0) through the BVH on g_blob, spheres (1) on g_glossy,
    # the plane (2) on both
    assert kinds == ({0, 2} if name == "g_blob" else {1, 2})


def test_scene_intersect_p_matches_the_jax_one_ray_form(one_ray_case):
    _, js, ts, (ro, rd, t_min, t_max) = one_ray_case
    j_one = jax.jit(lambda o, d, a, b: JTr.scene_intersect_p(js, o, d, a, b))
    seen = set()
    for i in range(N_RAYS):
        ref = bool(j_one(ro[i], rd[i], t_min[i], t_max[i]))
        out = TTr.scene_intersect_p(ts, torch.from_numpy(ro[i]), torch.from_numpy(rd[i]),
                                    float(t_min[i]), float(t_max[i]))
        assert out.shape == () and out.dtype == torch.bool
        assert bool(out) == ref, i
        seen.add(ref)
    assert seen == {False, True}


def test_scene_intersect_dt_dro_matches_jax_grad(one_ray_case):
    """The search is detached and the winner re-intersected in the graph,
    so dt/d(ro) is the winning surface's; the JAX one-ray form's gradient
    on the first N_GRAD hitting rays."""
    _, js, ts, (ro, rd, t_min, t_max) = one_ray_case
    j_t = jax.jit(jax.grad(lambda o, d, a, b: JTr.scene_intersect(js, o, d, a, b).t))
    j_valid = jax.jit(lambda o, d, a, b: JTr.scene_intersect(js, o, d, a, b).valid)
    done = 0
    for i in range(N_RAYS):
        if done == N_GRAD:
            break
        if not bool(j_valid(ro[i], rd[i], t_min[i], t_max[i])):
            continue
        ref = np.asarray(j_t(ro[i], rd[i], t_min[i], t_max[i]))
        o = torch.from_numpy(ro[i].copy()).requires_grad_(True)
        hit = TTr.scene_intersect(ts, o, torch.from_numpy(rd[i]),
                                  float(t_min[i]), float(t_max[i]))
        hit.t.backward()
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(o.grad.numpy(), ref, rtol=1e-4, atol=1e-6)
        done += 1
    assert done == N_GRAD


# ------------------------------------------ every exported name is ported

JAX_PKG = os.path.join(ROOT, "simplepath_tpu")
PORT_PKG = os.path.join(ROOT, "simplepath_tpu_torch")
# Chosen departures (CHANGES.md): the Pallas module, whose kernels are
# render/cuda_traverse.py's; the JAX mesh context, which the port's
# GeomMesh / make_geom_mesh replace; a log handler the CLI does not use.
DEPARTED_MODULES = {"render/pallas_traverse.py"}
DEPARTED_NAMES = {
    "parallel/geom_shard.py": {"set_geom_mesh", "get_geom_mesh", "GEOM_AXIS", "RAY_AXIS"},
    "utils.py": {"AccumulatedLogHandler"},
}


def _module_names(path):
    """(the literal ``__all__`` or None, the module's top-level names)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    exported, top = None, set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            top.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                top.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
                if isinstance(target, ast.Name) and target.id == "__all__":
                    exported = ast.literal_eval(node.value)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            top.update((a.asname or a.name).split(".")[0] for a in node.names)
    return exported, top


def _exporting_modules():
    for root, _, files in os.walk(JAX_PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                path = os.path.join(root, name)
                exported, _ = _module_names(path)
                if exported is not None:
                    yield os.path.relpath(path, JAX_PKG).replace(os.sep, "/"), exported


def test_every_exported_name_of_the_jax_package_is_ported():
    missing, modules = [], 0
    for rel, exported in _exporting_modules():
        modules += 1
        if rel in DEPARTED_MODULES:
            continue
        port = os.path.join(PORT_PKG, rel)
        assert os.path.exists(port), f"no port module for simplepath_tpu/{rel}"
        _, top = _module_names(port)
        departed = DEPARTED_NAMES.get(rel, set())
        missing += [f"{rel}:{n}" for n in exported if n not in top and n not in departed]
        # a departure that the port has since gained is no longer one
        assert not departed & top, (rel, departed & top)
    assert modules >= 20
    assert not missing, missing
    assert all(os.path.exists(os.path.join(JAX_PKG, m)) for m in DEPARTED_MODULES)
    assert not any(os.path.exists(os.path.join(PORT_PKG, m)) for m in DEPARTED_MODULES)
