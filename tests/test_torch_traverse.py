"""The plain PyTorch versions of the two CUDA traversal kernels
(``cuda_traverse.closest_plain`` / ``anyhit_plain``) and the scene-level
queries built on them, against the JAX package on the same record table and
the same rays: the per-ray XLA formulation (``_bvh_closest`` / ``_bvh_any``)
and the Pallas packet kernels in interpret mode.

Tolerances are those of tests/test_pallas_path.py: ``valid`` and ``idx``
exact, ``t`` rtol 1e-5, beta/gamma rtol 1e-4; occlusion exact.  The CUDA
kernels themselves cannot run without a GPU: ``chip_smoke.py`` holds them
against these plain versions on the card.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import simplepath_tpu as J
import simplepath_tpu_torch as T
from simplepath_tpu.render import traverse as JTr
from simplepath_tpu.render.camera import generate_ray as j_generate_ray
from simplepath_tpu.render.pallas_traverse import packet_anyhit, packet_closest
from simplepath_tpu_torch.render import cuda_traverse as ct, traverse as TTr

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)


@pytest.fixture(scope="module")
def scenes():
    path = os.path.join(HERE, "scenes", "g_blob.sp")
    js = J.load_scene(path)
    ts = T.load_scene(path, device="cpu")
    assert js.static.has_bvh
    return js, ts


def _primary(js, side):
    ys, xs = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    px = (xs.reshape(-1).astype(np.float32) + 0.5) * (js.static.width / side)
    py = (ys.reshape(-1).astype(np.float32) + 0.5) * (js.static.height / side)
    ro, rd = j_generate_ray(js.camera, jnp.asarray(px), jnp.asarray(py))
    n = px.shape[0]
    return (np.asarray(ro), np.asarray(rd), np.full(n, 1e-3, np.float32),
            np.full(n, np.inf, np.float32))


def _incoherent(n, seed, dead=True):
    rs = np.random.RandomState(seed)
    ro = (rs.rand(n, 3) * [3, 2.5, 3] - [1.5, 0.2, 1.5]).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_min = np.full(n, 1e-3, np.float32)
    t_max = np.where(rs.rand(n) < 0.5, np.inf, 0.3 + 3 * rs.rand(n)).astype(np.float32)
    if dead:
        t_max[rs.rand(n) < 0.15] = -np.inf
    return ro, rd, t_min, t_max


def _axis_aligned(js, n=97):
    """Rays with exactly-zero direction components whose origins lie ON box
    planes of the root's children: (lo - ro) * inf is NaN there, and both
    packages must cull such a child the same way (NaN-propagating min/max)."""
    rec = np.asarray(js.bvh.records)
    lo = rec[0, 0:24].reshape(3, 8)      # child lo.x/y/z of the root row
    rs = np.random.RandomState(5)
    ro = np.zeros((n, 3), np.float32)
    rd = np.zeros((n, 3), np.float32)
    for i in range(n):
        c = rs.randint(0, 8)
        axis, along = rs.randint(0, 3), rs.randint(0, 3)
        ro[i] = [rs.uniform(-1, 1), rs.uniform(0.2, 1.8), rs.uniform(-1, 1)]
        if np.isfinite(lo[axis, c]):
            ro[i, axis] = lo[axis, c]
        rd[i, along] = rs.choice([-1.0, 1.0])
        ro[i, along] -= 4.0 * rd[i, along]
    return ro, rd, np.full(n, 1e-3, np.float32), np.full(n, np.inf, np.float32)


RAY_SETS = {
    "primary": lambda js: _primary(js, 20),            # 400 rays
    "incoherent": lambda js: _incoherent(333, 1),      # N % 32 != 0, dead lanes
    "single": lambda js: _incoherent(1, 2, dead=False),
    "axis_aligned": _axis_aligned,
}


@pytest.fixture(scope="module", params=list(RAY_SETS))
def rays(request, scenes):
    return RAY_SETS[request.param](scenes[0])


def _t(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _check_closest(out, ref):
    t, idx, beta, gamma, valid = [x.numpy() for x in out]
    rt, ridx, rbeta, rgamma, rvalid = [np.asarray(x) for x in ref]
    np.testing.assert_array_equal(valid, rvalid)
    np.testing.assert_array_equal(idx[valid], ridx[valid])
    assert (idx[~valid] == -1).all() and np.isinf(t[~valid]).all()
    np.testing.assert_allclose(t[valid], rt[valid], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(beta[valid], rbeta[valid], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gamma[valid], rgamma[valid], rtol=1e-4, atol=1e-5)


def test_closest_plain_matches_bvh_closest(scenes, rays):
    js, ts = scenes
    h = jax.vmap(lambda o, d, a, b: JTr._bvh_closest(js, o, d, a, b))(
        *map(jnp.asarray, rays))
    out = ct.closest_plain(ts.bvh.records, *_t(rays))
    assert out[1].dtype == torch.int32 and out[4].dtype == torch.bool
    _check_closest(out, (h.t, h.idx, h.beta, h.gamma, h.valid))
    dead = rays[3] == -np.inf
    assert not out[4].numpy()[dead].any()


@pytest.fixture(scope="module")
def all_rays(scenes):
    """Every ray set in one batch (831 rays): the interpreted Pallas kernels
    compile once per batch shape, which is what their tests cost."""
    sets = [make(scenes[0]) for make in RAY_SETS.values()]
    return [np.concatenate(parts) for parts in zip(*sets)]


def test_closest_plain_matches_packet_closest(scenes, all_rays):
    js, ts = scenes
    ref = packet_closest(js.bvh.records, *map(jnp.asarray, all_rays), interpret=True)
    _check_closest(ct.closest_plain(ts.bvh.records, *_t(all_rays)), ref)


def test_anyhit_plain_matches_bvh_any(scenes, rays):
    js, ts = scenes
    ref = jax.vmap(lambda o, d, a, b: JTr._bvh_any(js, o, d, a, b))(
        *map(jnp.asarray, rays))
    out = ct.anyhit_plain(ts.bvh.records, *_t(rays))
    assert out.dtype == torch.bool
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_anyhit_plain_matches_packet_anyhit(scenes, all_rays):
    js, ts = scenes
    ref = packet_anyhit(js.bvh.records, *map(jnp.asarray, all_rays), interpret=True)
    np.testing.assert_array_equal(
        ct.anyhit_plain(ts.bvh.records, *_t(all_rays)).numpy(), np.asarray(ref))


def test_wrappers_take_the_plain_version_on_cpu_tensors(scenes, rays):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    _, ts = scenes
    ct.reset_launch_counts()
    args = _t(rays)
    for a, b in zip(ct.closest(ts.bvh.records, *args),
                    ct.closest_plain(ts.bvh.records, *args)):
        assert torch.equal(a, b)
    assert torch.equal(ct.anyhit(ts.bvh.records, *args),
                       ct.anyhit_plain(ts.bvh.records, *args))
    assert ct.launch_counts == {"closest": 0, "anyhit": 0}


def test_anyhit_agrees_with_closest(scenes, rays):
    _, ts = scenes
    args = _t(rays)
    assert torch.equal(ct.anyhit_plain(ts.bvh.records, *args),
                       ct.closest_plain(ts.bvh.records, *args)[4])


def test_visit_stats_are_counted(scenes):
    _, ts = scenes
    args = _t(_incoherent(64, 3))
    stats = {}
    ct.closest_plain(ts.bvh.records, *args, stats=stats)
    assert stats["internal_visits"] >= 64      # every ray visits the root
    assert stats["triangle_tests"] >= stats["leaf_visits"] > 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "limits", "records"])
def test_wrappers_raise_on_what_the_kernels_do_not_take(scenes, bad):
    _, ts = scenes
    rec, (ro, rd, t_min, t_max) = ts.bvh.records, _t(_incoherent(8, 4))
    if bad == "dtype":
        ro = ro.double()
    elif bad == "shape":
        rd = rd[:, :2]
    elif bad == "limits":
        t_max = t_max[:4]
    else:
        rec = rec[:, :64]
    with pytest.raises((TypeError, ValueError)):
        ct.closest(rec, ro, rd, t_min, t_max)
    with pytest.raises((TypeError, ValueError)):
        ct.anyhit(rec, ro, rd, t_min, t_max)


def test_batcher_network_is_the_jax_packages():
    assert ct.batcher_pairs(8) == JTr.batcher_pairs(8)
    assert len(ct.batcher_pairs(8)) == 19
    assert ct.STACK_DEPTH == JTr.STACK_DEPTH


def test_stack_limit_is_the_jax_packages():
    """At this process's topology (the topology test files run this file at
    W=16 and at K=24): the pack-time stack cap that a tree must fit, the
    plain versions' stack and the sorting network are the JAX package's; a
    table the JAX package accepts is accepted, one it refuses is refused."""
    from simplepath_tpu.scene import bvh as JB
    from simplepath_tpu_torch.scene import bvh as TB
    assert (TB.WIDTH, TB.LEAF_SIZE, TB.LEAF_ROWS) == (JB.WIDTH, JB.LEAF_SIZE,
                                                      JB.LEAF_ROWS)
    assert TB._stack_limit() == JB._stack_limit() == (64 if TB.WIDTH <= 8 else 96)
    assert ct.KERNEL_STACK == TB._stack_limit()
    assert ct.STACK_DEPTH == JTr.STACK_DEPTH
    assert ct.batcher_pairs(TB.WIDTH) == JTr.batcher_pairs(TB.WIDTH)


# ------------------------------------------------- scene-level queries

def _check_hit(out, ref):
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), valid)
    np.testing.assert_array_equal(out.kind.numpy()[valid], np.asarray(ref.kind)[valid])
    np.testing.assert_array_equal(out.idx.numpy()[valid], np.asarray(ref.idx)[valid])
    np.testing.assert_allclose(out.t.numpy()[valid], np.asarray(ref.t)[valid],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.beta.numpy()[valid], np.asarray(ref.beta)[valid],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.gamma.numpy()[valid], np.asarray(ref.gamma)[valid],
                               rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", params=["g_blob", "g_glossy", "g_mesh_ply"])
def scene_pair(request):
    """BVH + plane (g_blob), spheres + plane without triangles (g_glossy),
    brute-force triangles below BVH_MIN_TRIS + plane + lights (g_mesh_ply)."""
    path = os.path.join(HERE, "scenes", request.param + ".sp")
    return J.load_scene(path), T.load_scene(path, device="cpu")


def test_scene_intersect_batch_matches_jax(scene_pair):
    js, ts = scene_pair
    for rays in (_primary(js, 12), _incoherent(150, 7)):
        ref = JTr.scene_intersect_batch(js, *map(jnp.asarray, rays))
        out = TTr.scene_intersect_batch(ts, *_t(rays))
        _check_hit(out, ref)
        assert len(set(out.kind.numpy()[out.valid.numpy()])) >= 1


def test_hit_shading_matches_jax(scene_pair):
    js, ts = scene_pair
    rays = _primary(js, 12)
    jro, jrd = jnp.asarray(rays[0]), jnp.asarray(rays[1])
    ref_hit = JTr.scene_intersect_batch(js, *map(jnp.asarray, rays))
    out_hit = TTr.scene_intersect_batch(ts, *_t(rays))
    rp, rn, rm = jax.vmap(lambda h, o, d: JTr.hit_shading(js, h, o, d))(ref_hit, jro, jrd)
    p, n, m = TTr.hit_shading(ts, out_hit, *_t(rays[:2]))
    v = np.asarray(ref_hit.valid)
    np.testing.assert_allclose(p.numpy()[v], np.asarray(rp)[v], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n.numpy()[v], np.asarray(rn)[v], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(m.numpy()[v], np.asarray(rm)[v])


def test_scene_intersect_p_batch_matches_jax(scene_pair):
    js, ts = scene_pair
    for rays in (_primary(js, 12), _incoherent(150, 8)):
        ref = JTr.scene_intersect_p_batch(js, *map(jnp.asarray, rays))
        out = TTr.scene_intersect_p_batch(ts, *_t(rays))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_scene_intersect_lights_matches_jax(scene_pair):
    js, ts = scene_pair
    rays = _incoherent(150, 9)
    rays[1][::3] = [0.0, 1.0, 0.0]       # some straight up, towards the lights
    rh, rd_, rL = jax.vmap(lambda o, d, a, b: JTr.scene_intersect_lights(js, o, d, a, b))(
        *map(jnp.asarray, rays))
    h, dist, L = TTr.scene_intersect_lights(ts, *_t(rays))
    np.testing.assert_array_equal(h.numpy(), np.asarray(rh))
    v = h.numpy()
    np.testing.assert_allclose(dist.numpy()[v], np.asarray(rd_)[v], rtol=1e-5)
    np.testing.assert_allclose(L.numpy()[v], np.asarray(rL)[v], rtol=1e-6)


def test_geometry_shards_name_the_later_slice(scenes):
    """A scene that says it is geometry-sharded goes through the forest
    combine (parallel/geom_shard.py): a flat record table there raises, and
    a forest of one shard gives the unsharded hits."""
    import dataclasses
    _, ts = scenes
    rays = _t(_incoherent(64, 1))
    sharded = dataclasses.replace(ts, static=dataclasses.replace(ts.static, geom_shards=2))
    with pytest.raises(ValueError, match="forest of 2 shard"):
        TTr.scene_intersect_batch(sharded, *rays)
    with pytest.raises(ValueError, match="forest of 2 shard"):
        TTr.scene_intersect_p_batch(sharded, *rays)
    one = dataclasses.replace(
        ts, static=dataclasses.replace(ts.static, geom_shards=1),
        bvh=dataclasses.replace(ts.bvh, records=ts.bvh.records[None]))
    for a, b in zip(TTr.scene_intersect_batch(one, *rays),
                    TTr.scene_intersect_batch(ts, *rays)):
        assert torch.equal(a, b)
    assert torch.equal(TTr.scene_intersect_p_batch(one, *rays),
                       TTr.scene_intersect_p_batch(ts, *rays))
