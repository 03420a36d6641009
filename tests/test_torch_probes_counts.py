"""The counting and chasing probes of the port (``render/cuda_probes.py``:
``closest_count``, ``row_chase``) on CPU tensors, which run their plain
versions, against the JAX package's TPU probes run in interpret mode:
``tools/prof_visits.py::counting_closest`` and ``dma_chase``,
``tools/prof_npush.py::hist_closest`` and ``tools/prof_dma_chains.py::chase``.

The TPU probes count per 1,024-ray packet, the port per ray.  A packet that
holds one live ray (the other 1,023 lanes dead, as ``_to_packets`` pads:
t_min = +inf, t_max = -inf) visits exactly the rows that ray visits, so each
ray here gets a packet of its own.  Everything is compared exactly: visit
counts, n_push buckets and refs are integers, and the hits are the plain
closest-hit's.  The CUDA kernels are held against these plain versions on
the card by ``chip_smoke.py``'s probes phase.

The probes call ``pl.pallas_call`` when they run; pytest's monkeypatch gives
it ``interpret=True`` for this module, and puts ``tools/`` on ``sys.path``
(``prof_visits.py`` imports ``_prof_util``).  ``prof_dma_chains.py`` runs
its benchmark when imported, so only its ``chase`` function is taken from
its source.
"""

import ast
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas
from jax.experimental.pallas import tpu as pltpu

import simplepath_tpu as J
import simplepath_tpu_torch as T
from simplepath_tpu.render import pallas_traverse as pt
from simplepath_tpu.render.camera import generate_ray as j_generate_ray
from simplepath_tpu_torch.render import cuda_probes as cp, cuda_traverse as ct
from simplepath_tpu_torch.scene import bvh

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS = os.path.join(os.path.dirname(HERE), "tools")
PACKET = pt.PACKET
HOPS = 50


@pytest.fixture(scope="module")
def tpu_probes():
    """The tools/ probe modules, with pallas_call in interpret mode while
    this module's tests run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(TOOLS)
        mp.setattr(pallas, "pallas_call",
                   functools.partial(pallas.pallas_call, interpret=True))
        import prof_npush
        import prof_visits
        yield prof_visits, prof_npush, _chase_from_source()


def _chase_from_source():
    """``chase`` of tools/prof_dma_chains.py, compiled alone from the
    file's source (importing the file would run its benchmark)."""
    path = os.path.join(TOOLS, "prof_dma_chains.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    fn = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "chase"]
    assert len(fn) == 1
    ns = {"jax": jax, "jnp": jnp, "pl": pallas, "pltpu": pltpu, "pt": pt}
    exec(compile(ast.Module(body=fn, type_ignores=[]), path, "exec"), ns)
    return ns["chase"]


@pytest.fixture(scope="module")
def scenes():
    path = os.path.join(HERE, "scenes", "g_blob.sp")
    return J.load_scene(path), T.load_scene(path, device="cpu")


def _rays(js, seed=3):
    """Eight rays made with numpy from a seed: four camera rays through
    random pixels of the middle of g_blob's frame (where the blob is), and
    four from random origins around and inside the blob in random
    directions."""
    rs = np.random.RandomState(seed)
    w, h = js.static.width, js.static.height
    px = ((0.25 + 0.5 * rs.rand(4)) * w).astype(np.float32)
    py = ((0.25 + 0.5 * rs.rand(4)) * h).astype(np.float32)
    ro1, rd1 = j_generate_ray(js.camera, jnp.asarray(px), jnp.asarray(py))
    ro2 = (rs.rand(4, 3) * 2.0 - [1.0, 0.0, 1.0]).astype(np.float32)
    d = rs.randn(4, 3).astype(np.float32)
    rd2 = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ro = np.concatenate([np.asarray(ro1), ro2]).astype(np.float32)
    rd = np.concatenate([np.asarray(rd1), rd2]).astype(np.float32)
    n = ro.shape[0]
    return ro, rd, np.full(n, 1e-3, np.float32), np.full(n, np.inf, np.float32)


def _one_live_ray_a_packet(rays):
    """Each ray at the head of a packet of its own, the other lanes dead as
    the TPU probes pad them."""
    ro, rd, t_min, t_max = rays
    n = ro.shape[0]
    RO = np.zeros((n * PACKET, 3), np.float32)
    RD = np.ones((n * PACKET, 3), np.float32)
    TMN = np.full(n * PACKET, np.inf, np.float32)
    TMX = np.full(n * PACKET, -np.inf, np.float32)
    RO[::PACKET], RD[::PACKET], TMN[::PACKET], TMX[::PACKET] = ro, rd, t_min, t_max
    return [jnp.asarray(a) for a in (RO, RD, TMN, TMX)]


@pytest.fixture(scope="module")
def tpu_counts(tpu_probes, scenes):
    prof_visits, prof_npush, _ = tpu_probes
    js, _ = scenes
    packets = _one_live_ray_a_packet(_rays(js))
    internal, leaf = prof_visits.counting_closest(js.bvh.records, *packets)
    by_push = prof_npush.hist_closest(js.bvh.records, *packets)
    return internal, leaf, by_push


@pytest.fixture(scope="module")
def port_counts(scenes):
    js, ts = scenes
    args = [torch.from_numpy(a) for a in _rays(js)]
    return args, cp.closest_count(ts.bvh.records, *args)


def test_the_rays_visit_leaves(tpu_counts):
    """The ray set is not trivial: most rays reach a leaf, several visit
    more than two internal rows."""
    internal, leaf, _ = tpu_counts
    assert (leaf > 0).sum() >= 4 and (internal > 2).sum() >= 4


def test_visits_equal_counting_closest(tpu_counts, port_counts):
    internal, leaf, _ = tpu_counts
    _, out = port_counts
    assert out[5].dtype == out[6].dtype == torch.int32
    np.testing.assert_array_equal(out[5].numpy(), internal)
    np.testing.assert_array_equal(out[6].numpy(), leaf)


def test_npush_buckets_equal_hist_closest(tpu_counts, port_counts):
    internal, _, by_push = tpu_counts
    _, out = port_counts
    assert out[7].shape == (8, 4) and out[7].dtype == torch.int32
    np.testing.assert_array_equal(out[7].numpy(), by_push)
    np.testing.assert_array_equal(by_push.sum(axis=1), internal)


def test_hits_are_closest_plains(scenes, port_counts):
    _, ts = scenes
    args, out = port_counts
    for a, b in zip(out[:5], ct.closest_plain(ts.bvh.records, *args)):
        assert torch.equal(a, b)
    assert bool(out[4].any())


def test_counts_of_many_rays(scenes):
    """Per ray: the buckets add up to the internal visits, the totals are
    the plain traversal's, and a ray with an empty interval counts 0 (the
    kernel reads no row for it)."""
    _, ts = scenes
    rs = np.random.RandomState(12)
    n = 200
    ro = (rs.rand(n, 3) * [3, 2.5, 3] - [1.5, 0.2, 1.5]).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    rd = d / np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.rand(n) < 0.5, np.inf, 0.3 + 3 * rs.rand(n)).astype(np.float32)
    t_max[rs.rand(n) < 0.2] = -np.inf
    args = [torch.from_numpy(a) for a in (ro, rd, np.full(n, 1e-3, np.float32), t_max)]
    out = cp.closest_count(ts.bvh.records, *args)
    internal, leaf, by_push = out[5:]
    dead = torch.from_numpy(t_max < 1e-3)
    assert int(dead.sum()) > 0
    assert not bool(internal[dead].any() | leaf[dead].any() | by_push[dead].any())
    assert torch.equal(by_push.sum(dim=1).int(), internal)
    assert bool((internal[~dead] >= 1).all())
    stats = {}
    ct.closest_plain(ts.bvh.records, *args, stats=stats)
    assert int(internal.sum()) == stats["internal_visits"] - int(dead.sum())
    assert int(leaf.sum()) == stats["leaf_visits"]


def _plain_chase(records: np.ndarray, start: int, hops: int) -> float:
    """The chase written out with numpy: ref = R[|ref| - 1, 6W] where that
    is positive, else the start ref."""
    ref = np.float32(start)
    for _ in range(hops):
        child = records[int(abs(ref)) - 1, 6 * bvh.WIDTH]
        ref = child if child > 0 else np.float32(start)
    return float(ref)


def test_chase_equals_dma_chase(tpu_probes, scenes):
    prof_visits, _, _ = tpu_probes
    js, ts = scenes
    ref = float(np.asarray(prof_visits.dma_chase(js.bvh.records, HOPS))[0, 0])
    assert ref == _plain_chase(ts.bvh.records.numpy(), 1, HOPS)
    out = cp.row_chase(ts.bvh.records, 1, HOPS)
    assert out.dtype == torch.float32 and out.shape == (1,)
    assert float(out[0]) == ref


def test_chase_of_four_chains_equals_chase(tpu_probes, scenes):
    """prof_dma_chains.chase interleaves four chains and writes chain 0's
    ref; the other chains equal the numpy loop started at ref 1 + c."""
    _, _, chase = tpu_probes
    js, ts = scenes
    ref = float(np.asarray(chase(js.bvh.records, HOPS, 4))[0, 0])
    out = cp.row_chase(ts.bvh.records, 4, HOPS)
    assert float(out[0]) == ref
    table = ts.bvh.records.numpy()
    assert [float(x) for x in out] == [_plain_chase(table, 1 + c, HOPS)
                                       for c in range(4)]


@pytest.mark.parametrize("chains", cp.CHAINS)
def test_chains_are_independent(scenes, chains):
    """Chain c's ref does not depend on how many chains run beside it."""
    _, ts = scenes
    table = ts.bvh.records.numpy()
    for hops in (0, 1, 7, 64):
        got = cp.row_chase(ts.bvh.records, chains, hops).tolist()
        assert got == [_plain_chase(table, 1 + c, hops) for c in range(chains)]


def test_probe_wrappers_take_the_plain_versions_on_cpu_tensors(scenes):
    _, ts = scenes
    cp.reset_launch_counts()
    ct.reset_launch_counts()
    args = [torch.from_numpy(a) for a in _rays(scenes[0])]
    out = cp.closest_count(ts.bvh.records, *args)
    for a, b in zip(out, cp.closest_count_plain(ts.bvh.records, *args)):
        assert torch.equal(a, b)
    assert torch.equal(cp.row_chase(ts.bvh.records, 2, 9),
                       cp.row_chase_plain(ts.bvh.records, 2, 9))
    assert cp.launch_counts == {"closest_count": 0, "row_chase": 0,
                                "visit_body_lane": 0, "visit_body_group": 0}
    assert ct.launch_counts == {"closest": 0, "anyhit": 0}
