"""The port's BVH forest (``parallel/geom_shard.py``) against the JAX
package's, on the same triangles of ``tests/scenes/g_blob.sp``:

* ``_morton_slices`` and ``shard_scene_geometry`` at D = 2 and 4: the
  stacked records ``[D, M, 128]``, the reordered triangle tables and the
  material ids are equal (host numpy both sides; the JAX side shards over
  the virtual CPU devices of tests/conftest.py);
* fewer triangles than shards raises ``ValueError``; the forest cache hits
  on a second build and misses after one vertex moves;
* a JAX forest carried over with ``convert.scene_from_numpy`` is the
  port's own forest;
* the combine: one batch of primary and incoherent rays through the JAX
  ``sharded_closest`` / ``sharded_anyhit`` on a 2-shard CPU mesh and
  through the port's, on the real forest and on a forest of two copies of
  one table (every hit a tie, broken by the lowest shard): equal hits, the
  tolerances of test_torch_traverse.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import simplepath_tpu as J
import simplepath_tpu_torch as T
from simplepath_tpu.parallel import geom_shard as JG
from simplepath_tpu_torch.convert import scene_from_numpy
from simplepath_tpu_torch.parallel import geom_shard as TG
from simplepath_tpu_torch.scene import cache
from simplepath_tpu_torch.scene.bvh import build_nodes, pack_records

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
BLOB = os.path.join(HERE, "scenes", "g_blob.sp")
TRI_FIELDS = [f"{v}{a}" for v in ("v0", "v1", "v2", "n0", "n1", "n2")
              for a in "xyz"] + ["material_id"]


def jax_mesh(d):
    return Mesh(np.asarray(jax.devices()[:d]), (JG.GEOM_AXIS,))


@pytest.fixture(scope="module")
def blobs():
    return (J.load_scene(BLOB, use_bvh=False),
            T.load_scene(BLOB, use_bvh=False, device="cpu"))


@pytest.mark.parametrize("d", [2, 4])
def test_forest_equals_jax(blobs, d):
    js, ts = blobs
    tri = ts.triangles
    rows = [tri._stack(n).numpy() for n in ("v0", "v1", "v2")]
    for a, b in zip(TG._morton_slices(*rows, d), JG._morton_slices(*rows, d)):
        np.testing.assert_array_equal(a, b)

    jf = JG.shard_scene_geometry(js, jax_mesh(d))
    tf = TG.shard_scene_geometry(ts, TG.make_geom_mesh(d))
    assert tf.static.geom_shards == jf.static.geom_shards == d
    assert tf.static.has_bvh
    rec = np.asarray(jf.bvh.records)
    assert rec.shape[0] == d and tf.bvh.records.shape == rec.shape
    assert tf.bvh.records.numpy().tobytes() == rec.tobytes()
    for f in TRI_FIELDS:
        np.testing.assert_array_equal(getattr(tf.triangles, f).numpy(),
                                      np.asarray(getattr(jf.triangles, f)),
                                      err_msg=f)

    # the JAX forest carried over is the port's own
    arrays = {f"{g.name}.{f.name}": np.asarray(getattr(getattr(jf, g.name),
                                                       f.name))
              for g in dataclasses.fields(jf)
              if g.name != "static" and getattr(jf, g.name) is not None
              for f in dataclasses.fields(getattr(jf, g.name))}
    cs = scene_from_numpy(dataclasses.asdict(jf.static), arrays, device="cpu")
    assert cs.static == tf.static and cs.geom_mesh is None
    assert torch.equal(cs.bvh.records, tf.bvh.records)
    assert TG.scene_geom_mesh(cs).shards == tuple(range(d))


def test_too_many_shards_raises(blobs):
    _, ts = blobs
    with pytest.raises(ValueError, match="at least one triangle per shard"):
        TG.shard_scene_geometry(ts, TG.make_geom_mesh(5121))


def test_forest_cache_hits_then_misses_after_a_vertex_moves(blobs, tmp_path,
                                                            monkeypatch):
    _, ts = blobs
    monkeypatch.setattr(cache, "CACHE_MIN_TRIS", 0)   # g_blob has 5,120
    monkeypatch.setenv("SIMPLEPATH_CACHE", "1")
    mesh = TG.make_geom_mesh(2)
    first = TG.shard_scene_geometry(ts, mesh, cache_dir=str(tmp_path))
    assert cache.LAST_HIT is None
    entries = os.listdir(tmp_path / ".spcache")
    assert len(entries) == 1 and entries[0].startswith("torch_")
    again = TG.shard_scene_geometry(ts, mesh, cache_dir=str(tmp_path))
    assert cache.LAST_HIT is not None
    assert torch.equal(again.bvh.records, first.bvh.records)
    assert torch.equal(again.triangles.v0x, first.triangles.v0x)

    v0x = ts.triangles.v0x.clone()
    v0x[17] += 1e-3
    moved = dataclasses.replace(ts, triangles=dataclasses.replace(
        ts.triangles, v0x=v0x))
    TG.shard_scene_geometry(moved, mesh, cache_dir=str(tmp_path))
    assert cache.LAST_HIT is None
    assert len(os.listdir(tmp_path / ".spcache")) == 2


def _rays(ts, seed=3):
    """256 primary rays over the frame, and 301 rays from points around the
    mesh toward points inside its box, as bounces would cross it (15 % dead
    lanes, a quarter of finite reach)."""
    from simplepath_tpu_torch.render.camera import generate_ray
    g = (torch.arange(16, dtype=torch.float32) + 0.5) * 3.0
    py, px = torch.meshgrid(g, g, indexing="ij")
    pro, prd = generate_ray(ts.camera, px.reshape(-1), py.reshape(-1))
    v0 = ts.triangles.v0.numpy()
    lo, hi = v0.min(0), v0.max(0)
    rs = np.random.RandomState(seed)
    n = 301
    aim = lo + rs.rand(n, 3) * (hi - lo)
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = aim - d * 2.0 * np.linalg.norm(hi - lo)
    t_max = np.where(rs.rand(n) < 0.75, np.inf, 1.0 + 3 * rs.rand(n))
    t_max[rs.rand(n) < 0.15] = -np.inf
    ro = np.concatenate([pro.numpy(), o]).astype(np.float32)
    rd = np.concatenate([prd.numpy(), d]).astype(np.float32)
    n = ro.shape[0]
    return (ro, rd, np.full(n, 1e-3, np.float32),
            np.concatenate([np.full(256, np.inf), t_max]).astype(np.float32))


def test_combine_equals_jax_sharded_queries(blobs):
    js, ts = blobs
    mesh = jax_mesh(2)
    forest = np.array(JG.shard_scene_geometry(js, mesh).bvh.records)
    # two copies of one table, the second indexing triangles T..2T-1: every
    # hit of shard 1 ties with shard 0's, which must win
    tri = ts.triangles
    v = [tri._stack(n).numpy() for n in ("v0", "v1", "v2")]
    nodes, order = build_nodes(np.minimum(np.minimum(*v[:2]), v[2]),
                               np.maximum(np.maximum(*v[:2]), v[2]))
    vo = [x[order] for x in v]
    twins = np.stack([pack_records(nodes, *vo),
                      pack_records(nodes, *vo, base_offset=len(order))])
    rays = _rays(ts)
    jrays = [jnp.asarray(a) for a in rays]
    trays = [torch.from_numpy(a) for a in rays]
    with JG.set_geom_mesh(mesh):
        for rec in (forest, twins):
            jrec = jax.device_put(rec, NamedSharding(mesh, P(JG.GEOM_AXIS)))
            ref = [np.asarray(x) for x in JG.sharded_closest(jrec, *jrays)]
            rocc = np.asarray(JG.sharded_anyhit(jrec, *jrays))
            trec = torch.from_numpy(rec.copy())
            t, idx, beta, gamma, valid = [
                x.numpy() for x in TG.sharded_closest(trec, *trays)]
            rt, ridx, rbeta, rgamma, rvalid = ref
            np.testing.assert_array_equal(valid, rvalid)
            assert valid.sum() > 150
            np.testing.assert_array_equal(idx, ridx)
            np.testing.assert_allclose(t[valid], rt[valid], rtol=1e-5,
                                       atol=1e-6)
            assert np.isinf(t[~valid]).all() and np.isinf(rt[~valid]).all()
            np.testing.assert_allclose(beta, rbeta, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(gamma, rgamma, rtol=1e-4, atol=1e-5)
            np.testing.assert_array_equal(
                TG.sharded_anyhit(trec, *trays).numpy(), rocc)
    assert (idx[valid] < len(order)).all()   # the twins: shard 0 won
