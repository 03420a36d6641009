"""The port's quaternions, Morton codes, mesh generator and geometry cache
against the JAX package's, on seeded inputs: equal values (float32 math to
1e-6 where XLA and PyTorch round differently), the same meshes, PLY/STL
files equal byte for byte, and the cache cases of ``tests/test_scene_io.py``
(warm load equals cold, the bake-only key, no bake entry served to a BVH
load) plus the two packages' entries kept apart."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplepath_tpu as J
import simplepath_tpu_torch as T
from simplepath_tpu.core import morton as jm
from simplepath_tpu.core import quaternion as jq
from simplepath_tpu.io import meshgen as jmesh
from simplepath_tpu.scene import cache as jcache
from simplepath_tpu_torch.core import morton as tm
from simplepath_tpu_torch.core import quaternion as tq
from simplepath_tpu_torch.io import meshgen as tmesh
from simplepath_tpu_torch.scene import cache as tcache

RS = np.random.RandomState(21)

# ------------------------------------------------------------------ morton


def test_morton32_equals_jax():
    xs = RS.randint(0, 1 << 16, 512).astype(np.uint32)
    ys = RS.randint(0, 1 << 16, 512).astype(np.uint32)
    ref = np.asarray(jm.morton_encode32(xs, ys)).astype(np.int64)
    code = tm.morton_encode32(torch.from_numpy(xs.astype(np.int64)),
                              torch.from_numpy(ys.astype(np.int64)))
    assert code.dtype == torch.int64
    np.testing.assert_array_equal(code.numpy(), ref)
    assert int(code.max()) > 1 << 31          # the unsigned top bit survives
    dx, dy = tm.morton_decode32(code)
    np.testing.assert_array_equal(dx.numpy(), xs)
    np.testing.assert_array_equal(dy.numpy(), ys)
    # numpy inputs too, as the JAX package takes them
    np.testing.assert_array_equal(tm.morton_encode32(xs, ys).numpy(), ref)


def test_morton32_tile_order_prefix():
    codes = tm.morton_encode32(torch.arange(8), torch.zeros(8, dtype=torch.int64))
    assert codes.tolist() == [0, 1, 4, 5, 16, 17, 20, 21]


def test_morton64_equals_jax():
    xs = RS.randint(0, 1 << 32, 256, dtype=np.uint64)
    ys = RS.randint(0, 1 << 32, 256, dtype=np.uint64)
    code = tm.morton_encode64(xs, ys)
    np.testing.assert_array_equal(code, jm.morton_encode64(xs, ys))
    dx, dy = tm.morton_decode64(code)
    np.testing.assert_array_equal(dx, xs)
    np.testing.assert_array_equal(dy, ys)


# -------------------------------------------------------------- quaternion

def _quats(n=64):
    return RS.randn(n, 4).astype(np.float32), RS.randn(n, 4).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["quat_mul", "quat_dot"])
def test_quat_binary_ops_equal_jax(name):
    a, b = _quats()
    _close(getattr(tq, name)(torch.from_numpy(a), torch.from_numpy(b)),
           getattr(jq, name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["quat_conj", "quat_abs", "quat_rcp",
                                  "quat_normalize"])
def test_quat_unary_ops_equal_jax(name):
    a, _ = _quats()
    _close(getattr(tq, name)(torch.from_numpy(a)),
           getattr(jq, name)(jnp.asarray(a)))


def test_quat_constructors_equal_jax():
    axis = RS.randn(32, 3).astype(np.float32)
    ang = RS.uniform(0, np.pi, 32).astype(np.float32)
    _close(tq.quat_rotate_axis_angle(axis, ang),
           jq.quat_rotate_axis_angle(jnp.asarray(axis), jnp.asarray(ang)))
    y, p, r = (RS.uniform(-np.pi, np.pi, 32).astype(np.float32) for _ in range(3))
    _close(tq.quat_yaw_pitch_roll(y, p, r),
           jq.quat_yaw_pitch_roll(jnp.asarray(y), jnp.asarray(p), jnp.asarray(r)))
    _close(tq.quat(1.0, 2.0, 3.0, 4.0), jq.quat(1.0, 2.0, 3.0, 4.0))
    _close(tq.quat_identity(), jq.quat_identity())


def test_quat_apply_lerp_and_from_basis_equal_jax():
    a, b = _quats()
    q = tq.quat_normalize(torch.from_numpy(a))
    jqq = jq.quat_normalize(jnp.asarray(a))
    v = RS.randn(64, 3).astype(np.float32)
    _close(tq.quat_apply(q, torch.from_numpy(v)), jq.quat_apply(jqq, jnp.asarray(v)))
    f = RS.rand(64).astype(np.float32)
    _close(tq.quat_lerp(torch.from_numpy(a), torch.from_numpy(b), f),
           jq.quat_lerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(f)))
    # bases of every case of the trace construction: rotations of the frame
    basis = [tq.quat_apply(q, torch.eye(3)[i].expand(64, 3)) for i in range(3)]
    jbasis = [np.asarray(x) for x in basis]
    out = tq.quat_from_basis(*basis)
    _close(out, jq.quat_from_basis(*(jnp.asarray(x) for x in jbasis)))
    # q and -q are one rotation
    d = torch.minimum((out - q).norm(dim=-1), (out + q).norm(dim=-1))
    assert float(d.max()) < 1e-3


def test_quat_rotation_matches_matrix():
    q = tq.quat_rotate_axis_angle([0.0, 0.0, 1.0], np.pi / 2)
    _close(tq.quat_apply(q, torch.tensor([1.0, 0.0, 0.0])), [0.0, 1.0, 0.0])


# ----------------------------------------------------------------- meshgen

@pytest.mark.parametrize("fn, args", [
    ("icosphere", (2,)), ("displaced_blob", (2,)), ("displaced_grid", (17,))])
def test_meshgen_equals_jax(fn, args):
    v, f = getattr(tmesh, fn)(*args)
    jv, jf = getattr(jmesh, fn)(*args)
    assert v.dtype == jv.dtype and f.dtype == jf.dtype
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


@pytest.mark.parametrize("writer", ["write_ply", "write_stl"])
def test_mesh_writers_byte_equal(tmp_path, writer):
    v, f = tmesh.displaced_blob(1)
    a, b = tmp_path / "port.bin", tmp_path / "jax.bin"
    getattr(tmesh, writer)(str(a), v, f)
    getattr(jmesh, writer)(str(b), v, f)
    assert a.read_bytes() == b.read_bytes() and len(a.read_bytes()) > 84


# ------------------------------------------------------------------- cache

SCENE = """version: 1
scene_parameters {{ output_file_name: "c.pfm" width: 8 height: 8 }}
perspective_camera {{ origin: 0 0 -3 look_at: 0 0 0 fov: 45 }}
material_lambertian {{ name: "m" diffuse: 0.5 0.5 0.5 }}
mesh {{ file: "{ply}" material: "m" translate: 0.1 0.2 0.3 }}
"""


@pytest.fixture
def cached_scene(tmp_path, monkeypatch):
    monkeypatch.setattr(tcache, "CACHE_MIN_TRIS", 0)
    monkeypatch.setattr(jcache, "CACHE_MIN_TRIS", 0)
    monkeypatch.delenv("SIMPLEPATH_CACHE", raising=False)
    v, f = tmesh.icosphere(2)  # 320 triangles, above BVH_MIN_TRIS
    tmesh.write_ply(str(tmp_path / "ball.ply"), v, f)
    sp = tmp_path / "s.sp"
    sp.write_text(SCENE.format(ply="ball.ply"))
    return str(sp), tmp_path / ".spcache"


def _tables(scene):
    tri = scene.triangles
    out = {"v0x": tri.v0x, "v2z": tri.v2z, "n1y": tri.n1y,
           "material_id": tri.material_id}
    if scene.bvh is not None:
        out["records"] = scene.bvh.records
    return {k: np.asarray(v) for k, v in out.items()}


def test_cache_warm_load_equals_cold(cached_scene):
    sp, cache_dir = cached_scene
    cold = T.load_scene(sp, device="cpu")
    assert tcache.LAST_HIT is None and cold.static.has_bvh
    names = os.listdir(cache_dir)
    assert len(names) == 1 and names[0].startswith(tcache.PREFIX), names
    warm = T.load_scene(sp, device="cpu")
    assert tcache.LAST_HIT == str(cache_dir / names[0])
    a, b = _tables(cold), _tables(warm)
    assert a.keys() == b.keys() and "records" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_cache_off_switch(cached_scene, monkeypatch):
    sp, cache_dir = cached_scene
    monkeypatch.setenv("SIMPLEPATH_CACHE", "0")
    T.load_scene(sp, device="cpu")
    T.load_scene(sp, device="cpu")
    assert tcache.LAST_HIT is None and not cache_dir.exists()


def test_cache_bake_only_key(cached_scene):
    sp, cache_dir = cached_scene
    s1 = T.load_scene(sp, use_bvh=False, device="cpu")
    assert s1.bvh is None
    names = os.listdir(cache_dir)
    assert len(names) == 1 and names[0].endswith("_bake.npz"), names
    s2 = T.load_scene(sp, use_bvh=False, device="cpu")
    assert s2.bvh is None and tcache.LAST_HIT is not None
    np.testing.assert_array_equal(s1.triangles.v0x.numpy(), s2.triangles.v0x.numpy())
    # the bake entry is not served to a load that wants a BVH
    s3 = T.load_scene(sp, device="cpu")
    assert tcache.LAST_HIT is None
    assert s3.bvh is not None and s3.bvh.records.shape[0] > 0


def test_cache_never_serves_the_jax_packages_entry(cached_scene):
    """An entry the JAX package wrote for the same scene is never read by
    the port: the port builds its own table (equal to the JAX package's),
    and its entry sits beside the other under its own prefix."""
    sp, cache_dir = cached_scene
    js = J.load_scene(sp)
    (jax_entry,) = os.listdir(cache_dir)
    # poison the JAX package's entry: a port that read it would load this
    path = cache_dir / jax_entry
    with np.load(path) as z:
        poisoned = {k: z[k] for k in z.files}
    poisoned["records"] = np.full_like(poisoned["records"], 7.0)
    np.savez(path, **poisoned)

    ts = T.load_scene(sp, device="cpu")
    assert tcache.LAST_HIT is None
    np.testing.assert_array_equal(ts.bvh.records.numpy(), np.asarray(js.bvh.records))
    names = sorted(os.listdir(cache_dir))
    assert len(names) == 2 and sum(n.startswith(tcache.PREFIX) for n in names) == 1
    T.load_scene(sp, device="cpu")
    assert os.path.basename(tcache.LAST_HIT).startswith(tcache.PREFIX)


def test_cache_invalidated_by_mesh_change(cached_scene):
    sp, _ = cached_scene
    s1 = T.load_scene(sp, device="cpu")
    v, f = tmesh.icosphere(3)                  # another mesh, same file name
    ply = os.path.join(os.path.dirname(sp), "ball.ply")
    tmesh.write_ply(ply, v, f)
    os.utime(ply)
    s2 = T.load_scene(sp, device="cpu")
    assert tcache.LAST_HIT is None
    assert s2.static.num_triangles == len(f) != s1.static.num_triangles
