"""What the CUDA traversal kernels' lanes-per-ray design rests on, checked on
the CPU (the kernels themselves run only on a GPU, where ``chip_smoke.py``
holds them against their plain versions):

* the staged form of the 19-pair Batcher network that a group of lanes runs
  with shuffles gives the order of the sequential pair list, ties and -inf
  keys included;
* the constants and the stage table written into ``csrc/traverse.cu`` are
  those of ``scene/bvh.py`` and ``render/cuda_traverse.py``;
* the group's butterfly reduction (smaller t, then smaller slot) picks what
  ``argmin`` picks in the plain version;
* the plain versions' per-ray visit counts add up to the totals they report;
* the wrappers return ``torch.bool`` flags.

Everything here is exact: integers, orders and equal floats, no tolerance.
"""

import os
import re

import numpy as np
import pytest
import torch

import simplepath_tpu_torch as T
from simplepath_tpu_torch.render import cuda_traverse as ct
from simplepath_tpu_torch.scene import bvh

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
INF = float("inf")


# ------------------------------------------------------- the staged sort

def _apply(pairs, keys, vals):
    """Compare-exchanges in the given order, the kernels' swap rule."""
    k, v = keys.clone(), vals.clone()
    for a, b in pairs:
        swap = k[:, a] < k[:, b]
        ka, kb, va, vb = k[:, a].clone(), k[:, b].clone(), v[:, a].clone(), v[:, b].clone()
        k[:, a], k[:, b] = torch.where(swap, kb, ka), torch.where(swap, ka, kb)
        v[:, a], v[:, b] = torch.where(swap, vb, va), torch.where(swap, va, vb)
    return k, v


def _apply_staged(words, keys, vals):
    """The kernel's form: every element of a stage looks at its partner's OLD
    (key, val) at once (a shuffle) and keeps or takes by the pair's rule."""
    k, v = keys.clone(), vals.clone()
    n = k.shape[1]
    for word in words:
        partner = torch.tensor([(word >> (4 * e)) & 7 for e in range(n)])
        ok, ov = k[:, partner], v[:, partner]
        e = torch.arange(n)
        swap = torch.where(e < partner, k < ok, ok < k)
        k, v = torch.where(swap, ok, k), torch.where(swap, ov, v)
    return k, v


def _keys(kind, n=2000):
    rs = np.random.RandomState({"random": 0, "ties": 1, "neg_inf": 2,
                                "ties_and_neg_inf": 3, "all_equal": 4}[kind])
    k = rs.rand(n, 8).astype(np.float32)
    if "ties" in kind:
        k = np.round(k * 3) / 3            # four distinct values in eight lanes
    if "neg_inf" in kind:
        k[rs.rand(n, 8) < 0.4] = -np.inf
    if kind == "all_equal":
        k[:] = 0.25
    return torch.from_numpy(k), torch.arange(8).expand(n, 8).clone()


def test_sort_stages_are_the_19_pairs_in_disjoint_stages():
    stages = ct.sort_stages(8)
    assert sorted(p for s in stages for p in s) == sorted(ct.batcher_pairs(8))
    assert sum(len(s) for s in stages) == 19 and len(stages) == 6
    for stage in stages:
        touched = [e for pair in stage for e in pair]
        assert len(touched) == len(set(touched))
    # within each element's history the sequential order is kept
    flat = [p for s in stages for p in s]
    for e in range(8):
        assert [p for p in flat if e in p] == [p for p in ct.batcher_pairs(8) if e in p]


@pytest.mark.parametrize("kind", ["random", "ties", "neg_inf",
                                  "ties_and_neg_inf", "all_equal"])
def test_staged_sort_gives_the_sequential_order(kind):
    keys, vals = _keys(kind)
    rk, rv = _apply(ct.batcher_pairs(8), keys, vals)
    by_stage = _apply([p for s in ct.sort_stages(8) for p in s], keys, vals)
    shuffled = _apply_staged(ct.sort_stage_partners(8), keys, vals)
    for k, v in (by_stage, shuffled):
        assert torch.equal(k, rk) and torch.equal(v, rv)
    assert bool((rk[:, :-1] >= rk[:, 1:]).all())          # descending
    # pushed entries (key > NEG_BIG) are a prefix: the kernel counts them
    # with a ballot and lane j < count writes slot j
    pushed = rk > ct._NEG_BIG
    assert bool((pushed[:, :-1] | ~pushed[:, 1:]).all())
    # and it is the plain version's sort
    pk, pv = ct._sortw_desc(keys, vals)
    assert torch.equal(pk, rk) and torch.equal(pv, rv)


def _pushed_by_place(keys, vals):
    """What the kernel pushes on an internal visit, slot by slot (-1 = not
    written): a hit child goes to the slot numbered by how many keys lie
    above its own; rows in which two hit children have equal keys run the
    staged network instead and push its order."""
    n, w = keys.shape
    hit = keys > ct._NEG_BIG
    above = (keys[:, None, :] > keys[:, :, None]).sum(-1)        # [n, e]
    same = (keys[:, None, :] == keys[:, :, None]).sum(-1) - 1    # others equal
    tie = ((same > 0) & hit).any(dim=1)
    sk, sv = _apply_staged(ct.sort_stage_partners(w), keys, vals)
    place = torch.where(tie[:, None], torch.arange(w).expand(n, w), above)
    k = torch.where(tie[:, None], sk, keys)
    v = torch.where(tie[:, None], sv, vals)
    out = torch.full((n, w), -1, dtype=vals.dtype)
    rows = torch.arange(n)[:, None].expand(n, w)
    sel = k > ct._NEG_BIG
    out[rows[sel], place[sel]] = v[sel]
    return out, tie


@pytest.mark.parametrize("kind", ["random", "ties", "neg_inf",
                                  "ties_and_neg_inf", "all_equal"])
def test_placing_by_rank_pushes_the_networks_order(kind):
    keys, vals = _keys(kind)
    rk, rv = _apply(ct.batcher_pairs(8), keys, vals)
    expected = torch.where(rk > ct._NEG_BIG, rv, -1)
    out, tie = _pushed_by_place(keys, vals)
    assert torch.equal(out, expected)
    # the network is the exception: only rows with equal keys of hit children
    # (equal -inf keys of culled children do not count)
    assert bool(tie.any()) == ("ties" in kind or kind == "all_equal")


# ---------------------------------------------- constants in the source

@pytest.fixture(scope="module")
def source():
    with open(ct.KERNEL_SOURCE) as f:
        return f.read()


def _constant(source, name):
    m = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*([^;]+);", source)
    assert m, f"constexpr {name} not found in traverse.cu"
    return m.group(1).strip()


@pytest.mark.parametrize("name,expected", [
    ("W", lambda: bvh.WIDTH), ("K", lambda: bvh.LEAF_SIZE),
    ("ROW", lambda: bvh.RECORD_WIDTH), ("STACK", lambda: ct.STACK_DEPTH),
    ("SORT_STAGES", lambda: len(ct.sort_stages(bvh.WIDTH)))])
def test_source_constants_are_the_packages(source, name, expected):
    assert int(_constant(source, name)) == expected()


def test_source_lanes_per_ray(source):
    assert int(_constant(source, "G")) == ct.LANES_PER_RAY == bvh.WIDTH
    assert "SP_LANES_PER_RAY" not in source      # one design, no build switch
    block = int(_constant(source, "BLOCK"))
    assert block % 32 == 0 and 32 % ct.LANES_PER_RAY == 0
    assert float(_constant(source, "NEG_BIG").rstrip("f")) == ct._NEG_BIG


def test_source_stage_table_is_sort_stage_partners(source):
    m = re.search(r"#define\s+SP_SORT_PARTNERS\s*\{([^}]*)\}", source)
    assert m, "SP_SORT_PARTNERS not found in traverse.cu"
    words = tuple(int(w, 16) for w in re.findall(r"0x[0-9a-fA-F]+", m.group(1)))
    assert words == ct.sort_stage_partners(8)


def test_source_has_no_per_thread_stack(source):
    assert re.search(r"__shared__\s+int\s+stacks\[RAYS\]\[STACK\]", source)
    assert not re.search(r"\bint\s+stack\[STACK\]", source)
    assert "0xffffffff" not in source.lower()   # group masks only


# -------------------------------------------------- the group reduction

def _group_first_min(tv, lanes=ct.LANES_PER_RAY):
    """The kernel's leaf reduction over [N,K] candidates (t where the test
    passed, +inf elsewhere): lane c walks its slots c, c+lanes, ... with a
    strict <, then log2(lanes) butterfly steps keep the smaller t and, at
    equal t, the smaller slot.  Returns (t, slot) as every lane ends up."""
    n, k = tv.shape
    my_t = torch.full((n, lanes), INF)
    my_k = torch.arange(lanes).expand(n, lanes).clone()
    for slot in range(k):
        c = slot % lanes
        take = tv[:, slot] < my_t[:, c]
        my_t[:, c] = torch.where(take, tv[:, slot], my_t[:, c])
        my_k[:, c] = torch.where(take, slot, my_k[:, c])
    m = lanes // 2
    while m:
        src = torch.arange(lanes) ^ m
        ot, ok = my_t[:, src], my_k[:, src]
        take = (ot < my_t) | ((ot == my_t) & (ok < my_k))
        my_t, my_k = torch.where(take, ot, my_t), torch.where(take, ok, my_k)
        m //= 2
    assert bool((my_t == my_t[:, :1]).all()) and bool((my_k == my_k[:, :1]).all())
    return my_t[:, 0], my_k[:, 0]


@pytest.mark.parametrize("kind", ["random", "ties", "sparse", "all_invalid"])
def test_group_reduction_picks_what_argmin_picks(kind):
    rs = np.random.RandomState(11)
    n = 3000
    t = rs.rand(n, bvh.LEAF_SIZE).astype(np.float32)
    if kind == "ties":
        t = np.round(t * 2) / 2
    valid = rs.rand(n, bvh.LEAF_SIZE) < {"random": 0.7, "ties": 0.7,
                                         "sparse": 0.1, "all_invalid": 0.0}[kind]
    tv = torch.where(torch.from_numpy(valid), torch.from_numpy(t), INF)
    win_t, win_k = _group_first_min(tv)
    j = tv.argmin(dim=1)                       # closest_plain's "first min"
    hit = torch.from_numpy(valid).any(dim=1)
    assert torch.equal(win_t, tv.gather(1, j[:, None])[:, 0])
    assert torch.equal(win_k[hit], j[hit])
    assert bool(torch.isinf(win_t[~hit]).all())   # no candidate: never taken


# ------------------------------------------------------ per-ray counts

@pytest.fixture(scope="module")
def scene():
    return T.load_scene(os.path.join(HERE, "scenes", "g_blob.sp"), device="cpu")


def _rays(n, seed, dead=0.15):
    rs = np.random.RandomState(seed)
    ro = (rs.rand(n, 3) * [3, 2.5, 3] - [1.5, 0.2, 1.5]).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.where(rs.rand(n) < 0.5, np.inf, 0.3 + 3 * rs.rand(n)).astype(np.float32)
    t_max[rs.rand(n) < dead] = -np.inf
    return [torch.from_numpy(a) for a in
            (ro, rd, np.full(n, 1e-3, np.float32), t_max)]


@pytest.mark.parametrize("which", ["closest", "anyhit"])
def test_per_ray_visit_counts_sum_to_the_totals(scene, which):
    plain = ct.closest_plain if which == "closest" else ct.anyhit_plain
    args = _rays(301, 5)
    stats = {}
    out = plain(scene.bvh.records, *args, stats=stats)
    ri, rl = stats["ray_internal_visits"], stats["ray_leaf_visits"]
    assert ri.shape == rl.shape == (301,) and ri.dtype == torch.int64
    assert int(ri.sum()) == stats["internal_visits"]
    assert int(rl.sum()) == stats["leaf_visits"]
    by_count = stats["leaf_visits_by_count"]
    assert len(by_count) == bvh.LEAF_SIZE + 1
    assert sum(by_count) == stats["leaf_visits"]
    assert sum(k * v for k, v in enumerate(by_count)) == stats["triangle_tests"]
    assert bool((ri >= 1).all())                 # every ray pops the root
    dead = args[3] == -INF
    assert bool((ri[dead] == 1).all()) and bool((rl[dead] == 0).all())
    if which == "closest":
        assert bool((rl[out[4]] >= 1).all())     # a hit was found in a leaf
    # rows that live rays touched: the root, and a leaf row for every hit
    rows_i, rows_l = stats["internal_rows_visited"], stats["leaf_rows_visited"]
    n_rows = scene.bvh.records.shape[0]
    assert rows_i.shape == rows_l.shape == (n_rows,) and rows_i.dtype == torch.bool
    assert bool(rows_i[0]) and not bool((rows_i & rows_l).any())
    assert 1 <= int(rows_i.sum()) <= int(ri[~dead].sum())
    assert int(rows_l.sum()) <= int(rl.sum())
    # one live ray never visits a row twice: its masks hold its counts
    live = int((~dead).nonzero()[0])
    one = {}
    plain(scene.bvh.records, *[a[live:live + 1] for a in args], stats=one)
    assert int(one["internal_rows_visited"].sum()) == int(ri[live])
    assert int(one["leaf_rows_visited"].sum()) == int(rl[live])
    # a ray with an empty interval reads no row in the kernel
    none = {}
    plain(scene.bvh.records, *[a[dead] for a in args], stats=none)
    assert not bool(none["internal_rows_visited"].any())
    assert not bool(none["leaf_rows_visited"].any())
    # totals add up over calls, per-ray counts are the last call's
    plain(scene.bvh.records, *_rays(40, 6), stats=stats)
    assert stats["ray_internal_visits"].shape == (40,)
    assert stats["internal_visits"] > int(ri.sum())
    assert sum(stats["leaf_visits_by_count"]) == stats["leaf_visits"]


def test_stats_do_not_change_the_results(scene):
    args = _rays(150, 8)
    a = ct.closest_plain(scene.bvh.records, *args)
    b = ct.closest_plain(scene.bvh.records, *args, stats={})
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(ct.anyhit_plain(scene.bvh.records, *args),
                       ct.anyhit_plain(scene.bvh.records, *args, stats={}))


# ------------------------------------------------------------ wrappers

@pytest.mark.parametrize("n", [0, 1, 77])
def test_wrappers_return_bool_flags(scene, n):
    args = _rays(n, 9)
    t, idx, beta, gamma, valid = ct.closest(scene.bvh.records, *args)
    occ = ct.anyhit(scene.bvh.records, *args)
    assert valid.dtype == torch.bool and occ.dtype == torch.bool
    assert valid.shape == occ.shape == (n,)
    assert idx.dtype == torch.int32 and t.dtype == torch.float32
    assert torch.equal(valid, occ)
