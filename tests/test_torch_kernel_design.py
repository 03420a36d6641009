"""What the CUDA traversal kernels' lanes-per-ray design rests on, checked on
the CPU (the kernels themselves run only on a GPU, where ``chip_smoke.py``
holds them against their plain versions):

* the staged form of the Batcher network that a group of lanes runs with
  shuffles (19 pairs in 6 stages at W=8, 63 in 10 at W=16) gives the order
  of the sequential pair list, ties and -inf keys included;
* the constants and the stage tables written into ``csrc/traverse.cu``, at
  each topology the kernel template is built for (``-DSP_W`` / ``-DSP_K``),
  are those of ``scene/bvh.py`` and ``render/cuda_traverse.py``, and a
  topology outside the template raises;
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
        partner = torch.tensor([(word >> (4 * e)) & (n - 1) for e in range(n)])
        ok, ov = k[:, partner], v[:, partner]
        e = torch.arange(n)
        swap = torch.where(e < partner, k < ok, ok < k)
        k, v = torch.where(swap, ok, k), torch.where(swap, ov, v)
    return k, v


KINDS = ["random", "ties", "neg_inf", "ties_and_neg_inf", "all_equal"]


def _keys(kind, n=2000, w=8):
    rs = np.random.RandomState({"random": 0, "ties": 1, "neg_inf": 2,
                                "ties_and_neg_inf": 3, "all_equal": 4}[kind])
    k = rs.rand(n, w).astype(np.float32)
    if "ties" in kind:
        k = np.round(k * 3) / 3            # four distinct values in w lanes
    if "neg_inf" in kind:
        k[rs.rand(n, w) < 0.4] = -np.inf
    if kind == "all_equal":
        k[:] = 0.25
    return torch.from_numpy(k), torch.arange(w).expand(n, w).clone()


def _check_stages(n, n_pairs, n_stages):
    stages = ct.sort_stages(n)
    assert len(ct.batcher_pairs(n)) == n_pairs
    assert sorted(p for s in stages for p in s) == sorted(ct.batcher_pairs(n))
    assert sum(len(s) for s in stages) == n_pairs and len(stages) == n_stages
    for stage in stages:
        touched = [e for pair in stage for e in pair]
        assert len(touched) == len(set(touched))
    # within each element's history the sequential order is kept
    flat = [p for s in stages for p in s]
    for e in range(n):
        assert [p for p in flat if e in p] == [p for p in ct.batcher_pairs(n) if e in p]


def test_sort_stages_are_the_19_pairs_in_disjoint_stages():
    _check_stages(8, 19, 6)


def test_sort_stages_16_are_the_63_pairs_in_10_disjoint_stages():
    _check_stages(16, 63, 10)


def _check_staged_sort(kind, w):
    keys, vals = _keys(kind, w=w)
    rk, rv = _apply(ct.batcher_pairs(w), keys, vals)
    by_stage = _apply([p for s in ct.sort_stages(w) for p in s], keys, vals)
    shuffled = _apply_staged(ct.sort_stage_partners(w), keys, vals)
    for k, v in (by_stage, shuffled):
        assert torch.equal(k, rk) and torch.equal(v, rv)
    assert bool((rk[:, :-1] >= rk[:, 1:]).all())          # descending
    # pushed entries (key > NEG_BIG) are a prefix: the kernel counts them
    # with a ballot and lane j < count writes slot j
    pushed = rk > ct._NEG_BIG
    assert bool((pushed[:, :-1] | ~pushed[:, 1:]).all())
    return keys, vals, rk, rv


@pytest.mark.parametrize("kind", KINDS)
def test_staged_sort_gives_the_sequential_order(kind):
    keys, vals, rk, rv = _check_staged_sort(kind, 8)
    # and it is the plain version's sort
    pk, pv = ct._sortw_desc(keys, vals)
    assert torch.equal(pk, rk) and torch.equal(pv, rv)


@pytest.mark.parametrize("kind", KINDS)
def test_staged_sort_16_gives_the_sequential_order(kind):
    _check_staged_sort(kind, 16)


@pytest.mark.parametrize("w", [8, 16])
def test_partner_words_round_trip(w):
    """Each stage's word decodes to an involution whose moved elements are
    exactly that stage's pairs, and fits the kernel's word (32 bits at W=8,
    64 at W=16)."""
    words = ct.sort_stage_partners(w)
    assert len(words) == len(ct.sort_stages(w))
    for word, stage in zip(words, ct.sort_stages(w)):
        assert 0 <= word < 1 << (4 * w)
        partner = [(word >> (4 * e)) & (w - 1) for e in range(w)]
        assert all(partner[partner[e]] == e for e in range(w))
        assert sorted((e, p) for e, p in enumerate(partner) if e < p) == sorted(stage)
        assert sum(p << (4 * e) for e, p in enumerate(partner)) == word


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


def _check_placing(kind, w):
    keys, vals = _keys(kind, w=w)
    rk, rv = _apply(ct.batcher_pairs(w), keys, vals)
    expected = torch.where(rk > ct._NEG_BIG, rv, -1)
    out, tie = _pushed_by_place(keys, vals)
    assert torch.equal(out, expected)
    # the network is the exception: only rows with equal keys of hit children
    # (equal -inf keys of culled children do not count)
    assert bool(tie.any()) == ("ties" in kind or kind == "all_equal")


@pytest.mark.parametrize("kind", KINDS)
def test_placing_by_rank_pushes_the_networks_order(kind):
    _check_placing(kind, 8)


@pytest.mark.parametrize("kind", KINDS)
def test_placing_by_rank_16_pushes_the_networks_order(kind):
    _check_placing(kind, 16)


# ---------------------------------------------- constants in the source
#
# The source is a template over the topology: W and K come from the build's
# -DSP_W / -DSP_K (cuda_traverse.topology_flags), what depends on W alone
# from a specialisation of Width<W>.  Each constant is resolved here as the
# compiler would at each topology the chip checks.

TOPOLOGIES = [(8, 12), (16, 12), (8, 24)]


@pytest.fixture(scope="module")
def source():
    with open(ct.KERNEL_SOURCE) as f:
        return f.read()


def _constant(source, name):
    """The initialiser of a constexpr at namespace scope (no indentation)."""
    m = re.search(rf"^constexpr\s+\w+\s+{name}\s*=\s*([^;]+);", source, re.M)
    assert m, f"constexpr {name} not found in traverse.cu"
    return m.group(1).strip()


def _width_table(source, w):
    """The members of ``template <> struct Width<w>``."""
    m = re.search(rf"template\s*<>\s*struct\s+Width<{w}>\s*\{{(.*?)\n\}};",
                  source, re.S)
    assert m, f"no Width<{w}> in traverse.cu"
    body = m.group(1)
    table = {name: int(v) for name, v in re.findall(
        r"static\s+constexpr\s+int\s+(\w+)\s*=\s*(\d+);", body)}
    table["Word"] = re.search(r"using\s+Word\s*=\s*([\w ]+);", body).group(1).strip()
    macro = re.search(r"=\s*(SP_SORT_PARTNERS_\d+);", body).group(1)
    words = re.search(rf"#define\s+{macro}\s*\{{([^}}]*)\}}", source)
    assert words, f"{macro} not found in traverse.cu"
    table["words"] = tuple(int(x, 16) for x in re.findall(r"0x[0-9a-fA-F]+",
                                                          words.group(1)))
    return table


def _resolve(source, name, w, k):
    """A namespace-scope constant of the source built with
    topology_flags(w, k)."""
    defines = dict(f[2:].split("=") for f in ct.topology_flags(w, k))
    expr = _constant(source, name)
    if expr in defines:
        return int(defines[expr])
    if expr == "W":
        return _resolve(source, "W", w, k)
    m = re.fullmatch(r"Width<W>::(\w+)", expr)
    if m:
        return _width_table(source, w)[m.group(1)]
    return int(expr)


@pytest.mark.parametrize("name,expected", [
    ("W", lambda w, k: w), ("K", lambda w, k: k),
    ("ROW", lambda w, k: bvh.RECORD_WIDTH),
    ("STACK", lambda w, k: ct.kernel_stack(w)),
    ("SORT_STAGES", lambda w, k: len(ct.sort_stages(w)))])
def test_source_constants_are_the_packages(source, name, expected):
    for w, k in TOPOLOGIES:
        if name == "SORT_STAGES":
            got = _width_table(source, w)["SORT_STAGES"]
        else:
            got = _resolve(source, name, w, k)
        assert got == expected(w, k), (name, w, k)
    # and at this process's own topology
    assert ct.topology_flags() == [f"-DSP_W={bvh.WIDTH}", f"-DSP_K={bvh.LEAF_SIZE}"]


def test_source_lanes_per_ray(source):
    assert ct.LANES_PER_RAY == bvh.WIDTH
    for w, k in TOPOLOGIES:
        assert _resolve(source, "G", w, k) == w
    assert "SP_LANES_PER_RAY" not in source      # one design, no build switch
    block = int(_constant(source, "BLOCK"))
    for w in ct.WIDTHS:
        assert block % 32 == 0 and 32 % w == 0
    assert float(_constant(source, "NEG_BIG").rstrip("f")) == ct._NEG_BIG


def test_source_stage_table_is_sort_stage_partners(source):
    for w, bits in ((8, 32), (16, 64)):
        table = _width_table(source, w)
        assert table["words"] == ct.sort_stage_partners(w)
        assert len(table["words"]) == table["SORT_STAGES"]
        assert table["Word"] == {32: "unsigned int", 64: "unsigned long long"}[bits]
        assert all(word < 1 << bits for word in table["words"])


def test_source_has_no_per_thread_stack(source):
    assert re.search(r"__shared__\s+int\s+stacks\[RAYS\]\[STACK\]", source)
    assert not re.search(r"\bint\s+stack\[STACK\]", source)
    assert "0xffffffff" not in source.lower()   # group masks only


def test_source_covers_the_wrappers_topologies(source):
    """The source's static_asserts admit exactly cuda_traverse's WIDTHS and
    LEAF_SIZES, and it refuses a build without the topology."""
    m = re.search(r"static_assert\(([^,]*\bW\b[^,]*),", source)
    widths = tuple(int(x) for x in re.findall(r"W\s*==\s*(\d+)", m.group(1)))
    assert widths == ct.WIDTHS
    lo, hi = re.search(r"static_assert\(K\s*>=\s*(\d+)\s*&&\s*K\s*<=\s*(\d+)",
                       source).groups()
    assert range(int(lo), int(hi) + 1) == ct.LEAF_SIZES
    assert re.search(r"#if\s+!defined\(SP_W\)\s*\|\|\s*!defined\(SP_K\)\s*\n#error",
                     source)
    assert set(ct.WIDTHS) == {int(w) for w in re.findall(r"struct\s+Width<(\d+)>", source)}


def test_each_topology_has_its_own_library():
    paths = {ct.library_path(w, k) for w in ct.WIDTHS for k in (12, 24)}
    assert len(paths) == 4
    assert os.path.basename(ct.library_path(16, 12)) == "libsp_traverse_w16_k12.so"
    assert ct.library_path() == ct.library_path(bvh.WIDTH, bvh.LEAF_SIZE)
    assert os.path.dirname(ct.library_path()) == ct.BUILD_DIR


def test_stack_capacities_are_the_jax_packages():
    """Plain versions: the XLA traversal's STACK_DEPTH (64 at W <= 8, else
    128); kernels and the pack-time check: min(96, that), the packet
    kernels' MAX_STACK (the JAX package's own values at each width are held
    in the topology test files, one subprocess a width)."""
    assert [ct.stack_depth(w) for w in ct.WIDTHS] == [64, 128]
    assert [ct.kernel_stack(w) for w in ct.WIDTHS] == [64, 96]
    assert bvh._stack_limit() == ct.KERNEL_STACK == ct.kernel_stack(bvh.WIDTH)
    for w in ct.WIDTHS:
        # a tree of the deepest depth the kernels' stack holds fits, one
        # level deeper does not
        depth = (ct.kernel_stack(w) - 1) // (w - 1)
        assert depth * (w - 1) + 1 <= ct.kernel_stack(w) < (depth + 1) * (w - 1) + 1


@pytest.mark.parametrize("knob,value", [("WIDTH", 4), ("WIDTH", 32),
                                        ("LEAF_SIZE", 0), ("LEAF_SIZE", 33)])
def test_unsupported_topology_raises(scene, monkeypatch, knob, value):
    """A topology outside the template raises NotImplementedError, and the
    plain versions on the CPU refuse it as the kernels would on the card."""
    args = _rays(16, 12)
    monkeypatch.setattr(ct, knob, value)
    w, k = ct.WIDTH, ct.LEAF_SIZE
    for fn in (ct.closest, ct.anyhit, ct.closest_plain, ct.anyhit_plain):
        with pytest.raises(NotImplementedError, match="traversal covers"):
            fn(scene.bvh.records, *args)
    with pytest.raises(NotImplementedError):
        ct.topology_flags(w, k)


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


def _check_group_reduction(kind, lanes, k):
    rs = np.random.RandomState(11)
    n = 3000
    t = rs.rand(n, k).astype(np.float32)
    if kind == "ties":
        t = np.round(t * 2) / 2
    valid = rs.rand(n, k) < {"random": 0.7, "ties": 0.7,
                             "sparse": 0.1, "all_invalid": 0.0}[kind]
    tv = torch.where(torch.from_numpy(valid), torch.from_numpy(t), INF)
    win_t, win_k = _group_first_min(tv, lanes)
    j = tv.argmin(dim=1)                       # closest_plain's "first min"
    hit = torch.from_numpy(valid).any(dim=1)
    assert torch.equal(win_t, tv.gather(1, j[:, None])[:, 0])
    assert torch.equal(win_k[hit], j[hit])
    assert bool(torch.isinf(win_t[~hit]).all())   # no candidate: never taken


REDUCTION_KINDS = ["random", "ties", "sparse", "all_invalid"]


@pytest.mark.parametrize("kind", REDUCTION_KINDS)
def test_group_reduction_picks_what_argmin_picks(kind):
    _check_group_reduction(kind, ct.LANES_PER_RAY, bvh.LEAF_SIZE)


@pytest.mark.parametrize("kind", REDUCTION_KINDS)
@pytest.mark.parametrize("lanes,k", [(16, 12), (8, 24), (16, 24), (8, 13)])
def test_group_reduction_at_other_topologies(kind, lanes, k):
    """16 lanes over 12 slots (lanes 12-15 own none), 3 slots a lane over a
    two-row leaf, and a K that does not fill its last slot round."""
    _check_group_reduction(kind, lanes, k)


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
