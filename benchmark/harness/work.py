"""What a traversal call asks of the card at the least: the bound of the
``traversal_roofline`` metrics.

Frozen copies, at commit d1155b91, of the port's plain traversal with its
visit statistics (``render/cuda_traverse.py``: ``closest_plain``,
``anyhit_plain``, ``_VisitCounter`` and their helpers) and of
``chip_smoke.py``'s ``traversal_work`` and ``visit_costs``.  The work is
counted from a call's inputs (the record table and the rays), so it stays
the same whatever kernel a later change puts behind the call.  The record
layout's branching factor W and leaf size K are the table's own, read from
the program's ``scene/bvh.py``.

Bytes: each table row that a live ray visits is read once, at what a visit
of its kind reads; the rays once; the results written once.  Operations:
every visit's arithmetic.  The bound is the larger of bytes over the HBM
rate and operations over the float32 rate of the chip's data sheet.
"""

from __future__ import annotations

import torch
from torch import Tensor

# Published peaks of one H100 SXM (NVIDIA data sheet): the memory rate and
# the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# One triangle test, counted from csrc/traverse.cu: 44 mul/add/sub, one
# divide and 8 compares.
FLOPS_TRIANGLE_TEST = 53
RECORD_WIDTH = 128
# rays a block of the plain traversal walks at once (its row gathers are
# [block, 128] floats)
BLOCK = 1 << 17
_INF = float("inf")
_NEG_BIG = -3.0e38


def batcher_pairs(n: int) -> tuple[tuple[int, int], ...]:
    def merge(lo, hi, r):
        step = r * 2
        if step < hi - lo:
            yield from merge(lo, hi, step)
            yield from merge(lo + r, hi, step)
            for i in range(lo + r, hi - r, step):
                yield (i, i + r)
        else:
            yield (lo, lo + r)

    def sort(lo, hi):
        if hi - lo >= 1:
            mid = lo + (hi - lo) // 2
            yield from sort(lo, mid)
            yield from sort(mid + 1, hi)
            yield from merge(lo, hi, 1)

    return tuple(sort(0, n - 1))


def visit_costs(w: int, k: int) -> tuple[int, int, int]:
    """(operations of an internal row: W slab tests of 6 sub, 6 mul, 12
    min/max and 3 compares, plus the sorting network's compare-exchanges;
    bytes of an internal visit: 7 fields of W children; bytes of a leaf
    visit: 16 B of meta and 9 fields of all K slots)."""
    return 27 * w + len(batcher_pairs(w)), 28 * w, 16 + 36 * k


class Topology:
    def __init__(self, w: int, k: int):
        self.w, self.k = w, k
        self.leaf_rows = -(-(9 * k + 3) // RECORD_WIDTH)
        self.stack = 64 if w <= 8 else 128
        self.pairs = batcher_pairs(w)


def _child_keys(tp, rec, ro, inv_d, t_min, cur_t_max):
    W = tp.w
    t0x = (rec[:, 0:W] - ro[:, 0:1]) * inv_d[:, 0:1]
    t0y = (rec[:, W:2 * W] - ro[:, 1:2]) * inv_d[:, 1:2]
    t0z = (rec[:, 2 * W:3 * W] - ro[:, 2:3]) * inv_d[:, 2:3]
    t1x = (rec[:, 3 * W:4 * W] - ro[:, 0:1]) * inv_d[:, 0:1]
    t1y = (rec[:, 4 * W:5 * W] - ro[:, 1:2]) * inv_d[:, 1:2]
    t1z = (rec[:, 5 * W:6 * W] - ro[:, 2:3]) * inv_d[:, 2:3]
    mn, mx = torch.minimum, torch.maximum
    tnear = mx(mx(mn(t0x, t1x), mn(t0y, t1y)), mn(t0z, t1z))
    tfar = mn(mn(mx(t0x, t1x), mx(t0y, t1y)), mx(t0z, t1z))
    near, far = mx(tnear, t_min), mn(tfar, cur_t_max)
    cref = rec[:, 6 * W:7 * W].to(torch.int64)
    hit = (near <= far) & (tfar >= t_min) & (cref != 0)
    return torch.where(hit, tnear, -_INF), cref


def _visit_internal(tp, rec, is_leaf, ro, inv_d, t_min, cur_t_max):
    key, cref = _child_keys(tp, rec, ro, inv_d, t_min[:, None], cur_t_max[:, None])
    key = torch.where(is_leaf[:, None], -_INF, key)
    k = list(key.unbind(1))
    v = list(cref.unbind(1))
    for a, b in tp.pairs:
        swap = k[a] < k[b]
        k[a], k[b] = torch.where(swap, k[b], k[a]), torch.where(swap, k[a], k[b])
        v[a], v[b] = torch.where(swap, v[b], v[a]), torch.where(swap, v[a], v[b])
    skey, packed = torch.stack(k, 1), torch.stack(v, 1)
    return packed, (skey > _NEG_BIG).sum(dim=1)


def _visit_leaf(tp, rec, ro, rd, t_min, cur_t_max):
    K = tp.k
    v0x, v0y, v0z = rec[:, 0:K], rec[:, K:2 * K], rec[:, 2 * K:3 * K]
    A, B, C = rec[:, 3 * K:4 * K], rec[:, 4 * K:5 * K], rec[:, 5 * K:6 * K]
    D, E, F = rec[:, 6 * K:7 * K], rec[:, 7 * K:8 * K], rec[:, 8 * K:9 * K]
    lane = torch.arange(K, dtype=torch.int64, device=rec.device)
    in_leaf = lane < rec[:, 9 * K + 2].to(torch.int64)[:, None]
    G, H, I = rd[:, 0:1], rd[:, 1:2], rd[:, 2:3]
    J = v0x - ro[:, 0:1]
    Kk = v0y - ro[:, 1:2]
    L = v0z - ro[:, 2:3]
    EIHF = E * I - H * F
    GFDI = G * F - D * I
    DHEG = D * H - E * G
    denom = A * EIHF + B * GFDI + C * DHEG
    inv = 1.0 / torch.where(denom == 0.0, 1.0, denom)
    beta = (J * EIHF + Kk * GFDI + L * DHEG) * inv
    AKJB = A * Kk - J * B
    JCAL = J * C - A * L
    BLKC = B * L - Kk * C
    gamma = (I * AKJB + H * JCAL + G * BLKC) * inv
    t = -(F * AKJB + E * JCAL + D * BLKC) * inv
    valid = ((denom != 0.0) & in_leaf
             & (beta > 0.0) & (beta < 1.0)
             & (gamma > 0.0) & (beta + gamma < 1.0)
             & (t >= t_min[:, None]) & (t <= cur_t_max[:, None]))
    return t, valid


def _pop(tp, records, stack, sp, active):
    ar = torch.arange(sp.shape[0], device=sp.device)
    ref = torch.where(active, stack[ar, torch.clamp_min(sp - 1, 0)], 1)
    sp = torch.where(active, sp - 1, sp)
    row = torch.abs(ref) - 1
    if tp.leaf_rows == 1:
        return ref, sp, records[row]
    rows = torch.clamp_max(row[:, None] + torch.arange(tp.leaf_rows, device=row.device),
                           records.shape[0] - 1)
    return ref, sp, records[rows].reshape(row.shape[0], tp.leaf_rows * RECORD_WIDTH)


def _push(tp, stack, sp, packed, n_push):
    sp_safe = torch.clamp_max(sp, tp.stack - tp.w)
    slot = torch.arange(tp.w, device=sp.device)
    sel = slot[None, :] < n_push[:, None]
    rows = torch.arange(sp.shape[0], device=sp.device)[:, None].expand_as(sel)
    stack[rows[sel], (sp_safe[:, None] + slot)[sel]] = packed[sel]
    return sp_safe + n_push


class Counts:
    """Visits of one call, summed over its blocks of rays."""

    def __init__(self, n_rows: int, k: int, device):
        self.internal = 0
        self.triangle_tests = 0
        self.dead = 0
        self.internal_rows = torch.zeros(n_rows, dtype=torch.int32, device=device)
        self.leaf_rows = torch.zeros(n_rows, dtype=torch.int32, device=device)
        self.k = k

    def visit(self, ref, rec, is_leaf, active, live):
        at_leaf = is_leaf & active
        at_internal = ~is_leaf & active
        self.internal += at_internal.sum()
        row = torch.abs(ref) - 1
        self.internal_rows.index_add_(0, row, (at_internal & live).to(torch.int32))
        self.leaf_rows.index_add_(0, row, (at_leaf & live).to(torch.int32))
        self.triangle_tests += torch.where(at_leaf, rec[:, 9 * self.k + 2], 0.0
                                           ).to(torch.int64).sum()


def _walk(tp, records, ro, rd, t_min, t_max, anyhit: bool, counts: Counts):
    """One block of the plain traversal, counting its visits."""
    n, dev = ro.shape[0], records.device
    live = ~(t_max < t_min)
    counts.dead += int((~live).sum())
    inv_d = 1.0 / rd
    stack = torch.zeros((n, tp.stack), dtype=torch.int64, device=dev)
    stack[:, 0] = 1
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    best_t = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    while True:
        active = (sp > 0) & ~found if anyhit else sp > 0
        if not bool(active.any()):
            break
        ref, sp, rec = _pop(tp, records, stack, sp, active)
        is_leaf = ref < 0
        cur = t_max if anyhit else torch.minimum(t_max, best_t)
        packed, n_push = _visit_internal(tp, rec, is_leaf, ro, inv_d, t_min, cur)
        t, valid = _visit_leaf(tp, rec, ro, rd, t_min, cur)
        valid = valid & (is_leaf & active)[:, None]
        if anyhit:
            found = found | valid.any(dim=1)
        else:
            best_t = torch.minimum(best_t, torch.where(valid, t, _INF).amin(dim=1))
        sp = _push(tp, stack, sp, packed, torch.where(active, n_push, 0))
        counts.visit(ref, rec, is_leaf, active, live)


def call_work(records: Tensor, ro: Tensor, rd: Tensor, t_min: Tensor,
              t_max: Tensor, anyhit: bool, w: int, k: int) -> dict:
    """The least one traversal call asks of the card → bytes, operations,
    the bound in seconds and what sets it."""
    tp = Topology(w, k)
    counts = Counts(records.shape[0], k, records.device)
    for s in range(0, ro.shape[0], BLOCK):
        sl = slice(s, s + BLOCK)
        _walk(tp, records, ro[sl], rd[sl], t_min[sl], t_max[sl], anyhit, counts)
    internal_ops, internal_bytes, leaf_bytes = visit_costs(w, k)
    n = ro.shape[0]
    internal_visits = int(counts.internal) - counts.dead
    triangle_tests = int(counts.triangle_tests)
    table_bytes = (int((counts.internal_rows > 0).sum()) * internal_bytes
                   + int((counts.leaf_rows > 0).sum()) * leaf_bytes)
    out_bytes = n * (1 if anyhit else 17)
    total_bytes = table_bytes + n * (3 + 3 + 1 + 1) * 4 + out_bytes
    flops = internal_visits * internal_ops + triangle_tests * FLOPS_TRIANGLE_TEST
    bytes_s = total_bytes / HBM_BYTES_PER_S
    ops_s = flops / FP32_FLOPS
    return dict(rays=n, bytes=total_bytes, flops=flops,
                bound_s=max(bytes_s, ops_s),
                bound_by="bytes" if bytes_s >= ops_s else "operations")
