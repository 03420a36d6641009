"""The visit-body probe of the port (``render/cuda_probes.py::visit_body``)
on CPU tensors, which run its plain version, against the JAX package's TPU
probe ``tools/prof_visit_vpu.py::make_kernel`` run in interpret mode under
``run``'s specs (``prof_visit_vpu.py:97-106``), in all four modes
(``internal``, ``internal_norel``, ``sort_only``, ``leaf``) at M = 1 and 3
bodies.

The probe's output only keeps its work from being optimised away, so it
takes few values: NaN where a child of the row is not hit (``internal``) or
a box is infinite, inf, or the nearest hit t of a leaf row.  The fixed ray
(origin (0.1 + 1e-6 s, 2, 5), inverse direction (3, -7, 2)) runs away from
the blob of g_blob, so NO leaf row of g_blob is hit (checked below): the
``leaf`` mode on g_blob gives inf only.  Two more tables
(``cuda_probes.crossed_table``, made with numpy from a seed) hold an internal
row whose W child boxes all lie on the ray (in one of them two boxes are
equal, so the keys tie) and a leaf row whose triangles the ray crosses or
passes, so that every mode also gives its other value there.  Outputs
compare NaN-equal and otherwise exact.

The check launch (``visit_body_lanes``) also gives what each lane holds
after the last body; its plain version is held here against the outputs
above and against a numpy slab test and sort on the crossed table.  The
CUDA kernel is held against these plain versions, output and lanes, on the
card by ``chip_smoke.py``'s probes phase.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas
from jax.experimental.pallas import tpu as pltpu

import simplepath_tpu as J
from simplepath_tpu.render import pallas_traverse as pt
from simplepath_tpu_torch.render import cuda_probes as cp
from simplepath_tpu_torch.scene import bvh

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS = os.path.join(os.path.dirname(HERE), "tools")
W, K = bvh.WIDTH, bvh.LEAF_SIZE


@pytest.fixture(scope="module")
def make_kernel():
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(TOOLS)
        import prof_visit_vpu
        yield prof_visit_vpu.make_kernel


def _tpu(make_kernel, records, mode, bodies, seed):
    """make_kernel(mode, bodies) under run's specs, interpreted: f32[1,8,128]."""
    call = pallas.pallas_call(
        make_kernel(mode, bodies),
        in_specs=[pallas.BlockSpec((1, 1), memory_space=pltpu.SMEM),
                  pallas.BlockSpec(memory_space=pltpu.MemorySpace.ANY)],
        out_specs=pallas.BlockSpec((1, pt.SUB, pt.LANES), lambda: (0, 0, 0),
                                   memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, pt.SUB, pt.LANES), jnp.float32),
        scratch_shapes=[pltpu.SMEM((2, pt.REC), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True)
    return np.asarray(call(jnp.full((1, 1), seed, jnp.float32), jnp.asarray(records)))


@pytest.fixture(scope="module")
def tables():
    js = J.load_scene(os.path.join(HERE, "scenes", "g_blob.sp"))
    return {"g_blob": np.array(js.bvh.records),
            "crossed": cp.crossed_table().numpy(),
            "crossed_no_tie": cp.crossed_table(tie=False).numpy()}


# seed 1: the root row and the row after it; seed 10: rows 9 and 10 of
# g_blob, the first internal row with an empty (infinite, inverted) child box
CASES = [("g_blob", 1.0), ("g_blob", 10.0), ("crossed", 1.0),
         ("crossed_no_tie", 1.0)]


@pytest.mark.parametrize("mode", cp.BODY_MODES)
@pytest.mark.parametrize("table,seed", CASES)
def test_visit_body_equals_make_kernel(make_kernel, tables, table, seed, mode):
    records = tables[table]
    for bodies in (1, 3):
        ref = _tpu(make_kernel, records, mode, bodies, seed)
        assert np.unique(ref).size == 1          # one fixed ray, broadcast
        out = cp.visit_body(torch.from_numpy(records), seed, mode, bodies, 5)
        assert out.dtype == torch.float32 and out.shape == (5,)
        np.testing.assert_array_equal(out.numpy(), np.full(5, ref.flat[0]))


def test_each_mode_takes_its_other_value(tables):
    """What the cases cover: a NaN and an inf in each internal mode, and a
    finite leaf t."""
    got = {(table, seed, mode): float(cp.visit_body(
        torch.from_numpy(tables[table]), seed, mode, 1, 1)[0])
        for table, seed in CASES for mode in cp.BODY_MODES}
    for mode in ("internal", "internal_norel", "sort_only"):
        vals = [got[(t, s, mode)] for t, s in CASES]
        assert any(np.isnan(v) for v in vals) and np.inf in vals, (mode, vals)
    assert np.isnan(got[("g_blob", 1.0, "internal")])
    leaf = got[("crossed", 1.0, "leaf")]
    assert np.isfinite(leaf) and 1.0 < leaf < 8.0


def test_g_blob_has_no_leaf_row_the_fixed_ray_hits(tables):
    """The fixed ray misses every row of g_blob read as a leaf (hence the
    crossed table)."""
    records = torch.from_numpy(tables["g_blob"])
    seeds = np.arange(1, records.shape[0] - 1, dtype=np.float32)
    assert all(float(cp.visit_body(records, float(s), "leaf", 1, 1)[0]) == np.inf
               for s in seeds)


@pytest.mark.parametrize("mode", cp.BODY_MODES)
def test_no_body_gives_the_initial_limit(tables, mode):
    out = cp.visit_body(torch.from_numpy(tables["crossed"]), 1.0, mode, 0, 3)
    assert out.tolist() == [np.inf] * 3


@pytest.mark.parametrize("mode", cp.BODY_MODES)
@pytest.mark.parametrize("table,seed", CASES)
def test_lanes_agree_with_the_output(tables, table, seed, mode):
    """The check launch's output is visit_body's, and its lanes give it:
    ``internal`` is NaN exactly where fewer than W children are hit, ``leaf``
    is the group's first minimum (after one body, and after three, where
    each body's limit is the last one's result)."""
    records = torch.from_numpy(tables[table])
    for bodies in (1, 3):
        out, lanes = cp.visit_body_lanes(records, seed, mode, bodies, 3)
        assert lanes.shape == (3, W, 4) and lanes.dtype == torch.float32
        ref = cp.visit_body(records, seed, mode, bodies, 3)
        assert torch.equal(torch.isnan(out), torch.isnan(ref))
        assert torch.equal(out[~torch.isnan(out)], ref[~torch.isnan(ref)])
        if mode == "internal":
            assert torch.equal(torch.isnan(out), lanes[:, 0, 2] < W)
        if mode == "leaf":
            assert torch.equal(out, lanes[:, 0, 2])
            assert torch.equal(lanes[:, :, 2], lanes[:, :1, 2].expand(3, W))


def _slab(records, seed):
    """Each child's tnear (the key) and whether it is hit, by numpy."""
    o = np.array([np.float32(0.1) + np.float32(seed) * np.float32(1e-6),
                  2.0, 5.0], np.float32)
    inv = np.array([3.0, -7.0, 2.0], np.float32)
    row = records[0]
    lo = row[:3 * W].reshape(3, W).T
    hi = row[3 * W:6 * W].reshape(3, W).T
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    tnear = np.minimum(t0, t1).max(axis=1)
    tfar = np.maximum(t0, t1).min(axis=1)
    return tnear, (np.maximum(tnear, np.float32(1e-3)) <= tfar)


@pytest.mark.parametrize("mode", cp.BODY_MODES)
def test_lanes_on_the_crossed_table(tables, mode):
    """One body on the crossed table without a tie, against numpy: every
    child hit and placed far to near by its tnear; ``sort_only`` the row's
    first W values in descending order with the next W beside them; the
    leaf's hit triangles those at even slots, and the group's minimum the
    nearest of them."""
    records = tables["crossed_no_tie"]
    _, lanes = cp.visit_body_lanes(torch.from_numpy(records), 1.0, mode, 1, 2)
    lanes = lanes[0].numpy()
    refs = records[0, 6 * W:7 * W]
    tnear, hit = _slab(records, 1.0)
    if mode in ("internal", "internal_norel"):
        assert hit.all()
    if mode == "internal":
        order = np.argsort(-tnear, kind="stable")
        np.testing.assert_array_equal(lanes[:, 1], refs[order])
        np.testing.assert_allclose(lanes[:, 0], tnear[order], rtol=1e-6)
        np.testing.assert_array_equal(lanes[:, 2], np.full(W, W))
    elif mode == "internal_norel":
        np.testing.assert_array_equal(lanes[:, 3], refs)
        np.testing.assert_allclose(lanes[:, 0], tnear, rtol=1e-6)
        assert (lanes[:, 1] <= lanes[:, 2]).all()
    elif mode == "sort_only":
        keys, vals = records[0, :W], records[0, W:2 * W]
        order = np.argsort(-keys, kind="stable")
        np.testing.assert_array_equal(lanes[:, 0], keys[order])
        np.testing.assert_array_equal(lanes[:, 1], vals[order])
    else:
        hit_slots = np.flatnonzero(np.isfinite(lanes[:, 0]))
        assert hit_slots.size and (lanes[hit_slots, 1] % 2 == 0).all()
        assert lanes[0, 2] == lanes[:, 0].min()
        assert lanes[0, 3] == lanes[np.argmin(lanes[:, 0]), 1]


def test_a_check_launch_runs_a_body(tables):
    with pytest.raises(ValueError):
        cp.visit_body_lanes(torch.from_numpy(tables["crossed"]), 1.0,
                            "internal", 0, 3)
