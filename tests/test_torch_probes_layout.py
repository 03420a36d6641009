"""The visit-body probe's two layouts (``render/cuda_probes.py``:
``BODY_LAYOUTS``, ``"lane"`` the default) on the CPU, where both give the
plain version, and what the lane layout's CUDA kernel rests on:

* every layout gives the plain version on CPU tensors, and that equals the
  JAX package's TPU probe ``tools/prof_visit_vpu.py::make_kernel`` (run in
  interpret mode under ``run``'s specs) in ``internal`` and ``sort_only`` on
  the crossed table with a tie, whose order is the Batcher network's, which
  the lane layout runs;
* an unknown layout raises ``ValueError`` before any launch;
* a numpy model of one ray of the lane layout's sequence (children in
  column order, the pairs of ``batcher_pairs(W)`` in order with the swap
  rule key[a] < key[b], pushes at places 0 .. count - 1; the K triangles in
  slot order, the first minimum of each class of slots and of the ray) gives
  the check lanes of ``visit_body_lanes_plain`` on the crossed tables in
  every mode, NaN-equal and otherwise exact;
* ``chip_smoke.py``'s kernels line names the visit body by layout
  (``visit_body_lane``, ``visit_body_group``, and so at the topology
  phase's topologies) and never as a bare ``visit_body``.

The CUDA kernels are held against the plain version on the card by
``chip_smoke.py``'s probes and topology phases.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas
from jax.experimental.pallas import tpu as pltpu

import chip_smoke as cs
from simplepath_tpu.render import pallas_traverse as pt
from simplepath_tpu_torch.render import cuda_probes as cp
from simplepath_tpu_torch.render import cuda_traverse as ct
from simplepath_tpu_torch.scene import bvh

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS = os.path.join(os.path.dirname(HERE), "tools")
W, K, G = bvh.WIDTH, bvh.LEAF_SIZE, ct.LANES_PER_RAY
F = np.float32
NEG_BIG = F(ct._NEG_BIG)
# crossed_table's arguments: (tie, miss)
TABLES = {"crossed_tie": (True, False), "crossed": (False, False),
          "crossed_tie_miss": (True, True)}


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
    return np.asarray(call(jnp.full((1, 1), seed, jnp.float32),
                           jnp.asarray(records)))


@pytest.mark.parametrize("mode", ["internal", "sort_only"])
def test_every_layout_gives_make_kernel_on_the_tied_table(make_kernel, mode):
    records = cp.crossed_table(tie=True)
    for bodies in (1, 3):
        ref = _tpu(make_kernel, records.numpy(), mode, bodies, 1.0)
        assert np.unique(ref).size == 1          # one fixed ray, broadcast
        plain = cp.visit_body_plain(records, 1.0, mode, bodies, 4)
        for layout in cp.BODY_LAYOUTS:
            out = cp.visit_body(records, 1.0, mode, bodies, 4, layout)
            got, lanes = cp.visit_body_lanes(records, 1.0, mode, bodies, 4,
                                             layout)
            ref_out, ref_lanes = cp.visit_body_lanes_plain(records, 1.0, mode,
                                                           bodies, 4)
            np.testing.assert_array_equal(out.numpy(), np.full(4, ref.flat[0]))
            np.testing.assert_array_equal(out.numpy(), plain.numpy())
            np.testing.assert_array_equal(got.numpy(), ref_out.numpy())
            np.testing.assert_array_equal(lanes.numpy(), ref_lanes.numpy())


@pytest.mark.parametrize("call", ["visit_body", "visit_body_lanes",
                                  "body_blocks_per_sm", "body_rays_per_block"])
def test_an_unknown_layout_raises(call):
    records = cp.crossed_table()
    args = {"visit_body": (records, 1.0, "internal", 1, 2),
            "visit_body_lanes": (records, 1.0, "internal", 1, 2),
            "body_blocks_per_sm": ("internal",),
            "body_rays_per_block": ()}[call]
    with pytest.raises(ValueError, match="layout"):
        getattr(cp, call)(*args, layout="warp")


def test_layouts_are_the_sources():
    """BODY_LAYOUTS is the kernel's BodyLayout numbering, BODY_BLOCK its
    BLOCK, and a block holds a ray a thread or a ray a group of W lanes."""
    with open(ct.KERNEL_SOURCE) as f:
        source = f.read()
    enum = re.search(r"enum BodyLayout \{([^}]*)\}", source).group(1)
    numbered = {int(v): n for n, v in re.findall(r"LAYOUT_(\w+)\s*=\s*(\d+)", enum)}
    assert tuple(numbered[i].lower() for i in sorted(numbered)) == cp.BODY_LAYOUTS
    assert re.search(rf"^constexpr int BLOCK = {cp.BODY_BLOCK};", source, re.M)
    assert cp.body_rays_per_block("lane") == cp.BODY_BLOCK
    assert cp.body_rays_per_block("group") == cp.BODY_BLOCK // W
    assert cp.body_rays_per_block() == cp.body_rays_per_block("lane")


# ------------------------------------------------- one ray, the lane layout

def _ray(seed):
    o = np.array([F(0.1) + F(seed) * F(1e-6), 2.0, 5.0], F)
    inv = np.array([3.0, -7.0, 2.0], F)
    return o, F(1.0) / inv, inv, F(1e-3)


def _network(key, val):
    """batcher_pairs(W) in order, pair (a, b) swapped where key[a] < key[b]."""
    key, val = key.copy(), val.copy()
    for a, b in ct.batcher_pairs(W):
        if key[a] < key[b]:
            key[a], key[b] = key[b], key[a]
            val[a], val[b] = val[b], val[a]
    return key, val


def _placed(skey, sval):
    """Lane j: the key and ref at place j, the count, 0; past the count
    (-inf, 0, count, 0): the pushes at places 0 .. count - 1."""
    count = int((skey > NEG_BIG).sum())
    live = np.arange(W) < count
    return np.stack([np.where(live, skey, -np.inf), np.where(live, sval, 0),
                     np.full(W, count), np.zeros(W)], 1).astype(F)


def _slab(row, o, inv, t_min, limit):
    """The W slab tests, each against its own limit, operation for
    operation: (key, ref, near, far) a child."""
    lo = row[0:3 * W].reshape(3, W)
    hi = row[3 * W:6 * W].reshape(3, W)
    cref = row[6 * W:7 * W].astype(np.int64)
    t0 = [(lo[a] - o[a]) * inv[a] for a in range(3)]
    t1 = [(hi[a] - o[a]) * inv[a] for a in range(3)]
    mn, mx = np.minimum, np.maximum
    tnear = mx(mx(mn(t0[0], t1[0]), mn(t0[1], t1[1])), mn(t0[2], t1[2]))
    tfar = mn(mn(mx(t0[0], t1[0]), mx(t0[1], t1[1])), mx(t0[2], t1[2]))
    near, far = mx(tnear, t_min), mn(tfar, limit)
    hit = (near <= far) & (tfar >= t_min) & (cref != 0)
    return np.where(hit, tnear, F(-np.inf)), cref, near, far


def _triangles(leaf, o, d, t_min, limit):
    """tri_test on the K slots, in its operation order: (t, ok) a slot."""
    v0x, v0y, v0z, A, B, C, D, E, Ff = (leaf[f * K:(f + 1) * K] for f in range(9))
    G_, H, I = d
    J, Kk, L = v0x - o[0], v0y - o[1], v0z - o[2]
    EIHF = E * I - H * Ff
    GFDI = G_ * Ff - D * I
    DHEG = D * H - E * G_
    denom = A * EIHF + B * GFDI + C * DHEG
    inv = F(1.0) / np.where(denom == 0, F(1.0), denom)
    beta = (J * EIHF + Kk * GFDI + L * DHEG) * inv
    AKJB = A * Kk - J * B
    JCAL = J * C - A * L
    BLKC = B * L - Kk * C
    gamma = (I * AKJB + H * JCAL + G_ * BLKC) * inv
    t = -(Ff * AKJB + E * JCAL + D * BLKC) * inv
    ok = ((denom != 0) & (beta > 0) & (beta < 1) & (gamma > 0)
          & (beta + gamma < 1) & (t >= t_min) & (t <= limit))
    return t, ok


@np.errstate(invalid="ignore")                  # inf * 0: the probe's NaN
def _lane_model(records, seed, mode, bodies):
    """One ray of the lane layout after ``bodies`` bodies: (output, lanes)."""
    o, d, inv, t_min = _ray(seed)
    node = records[int(seed) - 1]
    leaf = records[int(seed):int(seed) + bvh.LEAF_ROWS].reshape(-1)
    carry = np.full(W, np.inf, F)
    for _ in range(bodies):
        if mode in ("internal", "internal_norel"):
            key, cref, near, far = _slab(node, o, inv, t_min, carry)
            if mode == "internal":
                skey, sref = _network(key, cref)
                lanes = _placed(skey, sref)
                carry = carry + key * F(0) + F(lanes[0, 2]) * F(0)
            else:
                lanes = np.stack([key, near, far, cref], 1).astype(F)
                carry = carry + (near * F(0) + far * F(0)) * F(0)
        elif mode == "sort_only":
            skey, sval = _network(node[:W], node[W:2 * W])
            lanes = _placed(skey, sval)
            carry[0] = carry[0] + (skey[0] * F(0) + sval[0] * F(0))
        else:
            t, ok = _triangles(leaf, o, d, t_min, carry[0])
            best_t, best_k = np.full(G, np.inf, F), np.arange(G)
            my_t = F(np.inf)
            for k in range(K):                   # slot order, strict <
                if ok[k] and t[k] < my_t:
                    my_t = t[k]
                if ok[k] and t[k] < best_t[k % G]:
                    best_t[k % G], best_k[k % G] = t[k], k
            win = min(range(G), key=lambda c: (best_t[c], best_k[c]))
            lanes = np.stack([best_t, best_k, np.full(G, best_t[win]),
                              np.full(G, best_k[win])], 1).astype(F)
            carry[0] = my_t if my_t < carry[0] else carry[0]
    if mode in ("internal", "internal_norel"):   # NaN-propagating max
        return F(np.nan if np.isnan(carry).any() else carry.max()), lanes
    return carry[0], lanes


def _nan_equal(a, b):
    a, b = np.asarray(a, F), np.asarray(b, F)
    return np.array_equal(np.isnan(a), np.isnan(b)) and np.array_equal(
        a[~np.isnan(a)], b[~np.isnan(b)])


@pytest.mark.parametrize("mode", cp.BODY_MODES)
@pytest.mark.parametrize("table", TABLES)
def test_one_ray_of_the_lane_layout_gives_the_check_lanes(table, mode):
    tie, miss = TABLES[table]
    records = cp.crossed_table(tie=tie, miss=miss)
    for bodies in (1, 3):
        out, lanes = _lane_model(records.numpy(), 1.0, mode, bodies)
        ref_out, ref_lanes = cp.visit_body_lanes_plain(records, 1.0, mode,
                                                       bodies, 2)
        assert _nan_equal(out, ref_out[0].item()), (bodies, out, ref_out)
        assert _nan_equal(lanes, ref_lanes[0].numpy()), (bodies, lanes,
                                                         ref_lanes[0])


def test_the_model_sees_what_it_checks():
    """On the crossed tables every child is hit, the tie reaches the
    network, and the leaf has hit slots in more than one class."""
    tie = cp.crossed_table(tie=True).numpy()
    _, lanes = _lane_model(tie, 1.0, "internal", 3)
    assert (lanes[:, 2] == W).all()
    keys = lanes[:, 0]
    assert len(set(keys.tolist())) < W           # two keys tie
    _, leaf = _lane_model(tie, 1.0, "leaf", 1)
    assert (np.isfinite(leaf[:, 0])).sum() >= 2 and np.isfinite(leaf[0, 2])


@np.errstate(invalid="ignore")
def test_a_missed_child_leaves_the_other_limits_alone():
    """On the tied table with child 0 missed, every hit child is hit again
    in later bodies: a child's next limit carries its own key.  Carrying
    the key the network places at the child's index instead (where a tie
    runs the network across the lanes of a group, lane c holds place c)
    culls, from the second body on, the hit child whose index the missed
    child's -inf lands on."""
    records = cp.crossed_table(tie=True, miss=True)
    for bodies in (1, 2, 3):
        _, lanes = cp.visit_body_lanes_plain(records, 1.0, "internal",
                                             bodies, 1)
        assert lanes[0, 0, 2] == W - 1
    o, _, inv, t_min = _ray(1.0)
    carry, counts = np.full(W, np.inf, F), []
    for _ in range(3):
        key, cref, _, _ = _slab(records.numpy()[0], o, inv, t_min, carry)
        skey, _ = _network(key, cref)
        counts.append(int((skey > NEG_BIG).sum()))
        carry = carry + skey * F(0) + F(counts[-1]) * F(0)
    assert counts[0] == W - 1 and max(counts[1:]) < W - 1


def test_the_tables_differ_only_where_asked():
    plain, tie, miss = (cp.crossed_table(tie=t, miss=m).numpy() for t, m in
                        ((False, False), (True, False), (True, True)))
    assert (plain != tie).any() and (tie != miss).any()
    changed = np.flatnonzero((tie != miss).any(axis=0))
    assert set(changed) == {W, 4 * W}          # box 0's y bounds only


# ------------------------------------------------------- the kernels line

BODY_TABLES = ("bench", *TABLES)       # chip_smoke.body_tables' names

def _body_readings():
    """Synthetic probe_visit_body readings: every layout, table, mode and
    shape, MAIN_BODY_CASE timed."""
    rows = []
    for layout in cp.BODY_LAYOUTS:
        for table in BODY_TABLES:
            for mode in cp.BODY_MODES:
                for shape in ("one_warp", "every_sm", "traversal_occupancy"):
                    r = dict(kernel="visit_body", layout=layout, table=table,
                             mode=mode, shape=shape, rays=128,
                             blocks_per_sm=8, output="inf",
                             checked_bodies=[1, 3], max_abs_err=0.0)
                    if (table, mode, shape) == cs.MAIN_BODY_CASE:
                        r.update(kernel_ms=2.0, ns_per_body=20.0,
                                 bound_ms=0.5, bound_by="operations",
                                 kernel_ms_at_plain_bodies=0.02,
                                 plain_ms_at_plain_bodies=900.0,
                                 bound_ms_at_plain_bodies=0.005)
                    rows.append(r)
    return rows


def _kernel_case(kernel, case):
    return dict(kernel=kernel, case=case, n=65536, kernel_ms=0.06,
                plain_ms=200.0, bound_ms=0.002, bound_by="bytes",
                max_abs_err=0.0)


def test_the_kernels_line_names_the_visit_body_by_layout():
    probes = {
        "closest_count": [dict(kernel="closest_count", case="primary",
                               kernel_ms=0.07, plain_ms=160.0, bound_ms=0.002,
                               bound_by="bytes", max_abs_err=0.0)],
        "row_chase": [dict(kernel="row_chase", feed=feed, table="bench",
                           chains=1, kernel_ms=1.3, plain_ms=2000.0,
                           bound_ms=1e-6, bound_by="bytes", max_abs_err=0.0)
                      for feed in cp.FEEDS],
        "visit_body": _body_readings()}
    topo = "w16_k12"
    topo_results = {topo: {(k, c): _kernel_case(k, c)
                           for k in ("closest", "anyhit")
                           for c in ("primary", "incoherent")}}
    frame = {"closest": 120, "anyhit": 120, "closest_count": 0,
             "row_chase": 0, "visit_body_lane": 0, "visit_body_group": 0}
    line = cs.kernels_line({}, frame, {}, (topo_results, {topo: frame},
                                           {topo: _body_readings()}), probes)
    names = [e["name"] for e in line["kernels"]]
    bodies = [n for n in names if n.startswith("visit_body")]
    assert bodies == ["visit_body_lane", "visit_body_group",
                      f"visit_body_lane_{topo}", f"visit_body_group_{topo}"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in line["kernels"]:
        assert keys <= set(e), e["name"]
    for e in (e for e in line["kernels"] if e["name"] in bodies):
        assert e["replaces"] == cs.TPU_KERNEL["visit_body"]
        assert (e["ms"], e["plain_ms"], e["bound_ms"]) == (0.02, 900.0, 0.005)
        assert e["launches"] == 0 and e["library_ms"] is None
        assert e["layout"] in e["name"]
        assert {c["table"] for c in e["cases"]} == set(BODY_TABLES)
        assert len(e["cases"]) == len(BODY_TABLES) * len(cp.BODY_MODES) * 3
    lane = next(e for e in line["kernels"] if e["name"] == "visit_body_lane")
    frame["visit_body_lane"] = 2
    relined = cs.kernels_line({}, frame, {}, probes=probes)
    assert next(e for e in relined["kernels"]
                if e["name"] == "visit_body_lane")["launches"] == 2
    assert lane["launches"] == 0
