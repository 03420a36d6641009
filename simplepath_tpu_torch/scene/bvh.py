"""Host-side wide-BVH builder over triangle soup.

Replacement for the reference's pointer-based binary BVH with
virtual-dispatch nodes (``shapes/BVHAccelerator.h:37-121``):
we build a shallow W-ary BVH — each node partitions its range into
``min(W, ceil(n/leaf_size))`` groups sized proportionally to near-equal
leaf budgets, cutting on the widest centroid axis like the reference's
recursive median split (BVHAccelerator.h:175-209) — and flatten it into
packed SoA arrays for the device traversal loop.  A wide branching factor trades pointer-chasing depth
for vectorized box tests.

The builder runs on host in numpy (an optional C++ fast path lives in
``simplepath_tpu_torch/native``); triangles are reordered so every leaf references
a contiguous range of the triangle table.

The device-side structure is a **unified record table** ``f32[M, 128]`` — one
512-byte row per BVH node, whether internal or leaf — so each traversal
iteration issues exactly ONE wide, contiguous row fetch (read by the CUDA
kernels as 16-byte vector loads through the read-only path).  Rows
are tagged by the sign of the stack reference.  All refs and triangle
indices are stored as EXACT SMALL FLOATS (not bitcasts) so both the plain
gather path and the CUDA kernels consume them directly
(exact up to 2^24 — build asserts enforce this).  The layout is the JAX
package's, byte for byte, so both packages traverse identical tables.

  internal row (ref = +row+1):
    [  0:48]  8 child boxes, SoA: lo.x*8, lo.y*8, lo.z*8, hi.x*8, hi.y*8, hi.z*8
    [ 48:56]  8 child refs (f32 value): 0 empty, +r+1 internal, -(r+1) leaf
    [ 56:128] pad
  leaf row (ref = -(row+1)), up to LEAF_SIZE=12 triangles:
    [  0:36]  v0 SoA: x*12, y*12, z*12
    [ 36:72]  e1 = v0-v1 SoA   (the Shirley A,B,C terms, Triangle.h:107-112)
    [ 72:108] e2 = v0-v2 SoA   (the D,E,F terms)
    [108]     base_lo: leaf's first triangle index mod 2^12  (exact f32)
    [109]     base_hi: leaf's first triangle index div 2^12  (exact f32)
    [110]     count: triangles in this leaf (1..LEAF_SIZE)
    [111:128] pad

Because the triangle table is REORDERED so each leaf owns a contiguous range,
lane k's triangle index is simply base + k.  Storing the base split into
two small exact floats (instead of 12 per-lane f32 indices) lifts the old
2^24 triangle-count ceiling: indices are reassembled in int32 on device
(supports up to 2^36 triangles — far past lucy's 28M).  Node ROW refs stay
exact f32 (row count ~T/10 stays well under 2^24 for any scene that fits
in device memory; pack asserts enforce it).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["build_bvh_wide", "build_nodes", "tree_depth", "table_stats",
           "pack_records", "make_bvh_arrays", "make_packed_records",
           "LEAF_SIZE", "WIDTH", "RECORD_WIDTH", "LEAF_ROWS"]

# Topology knobs (A/B-able via env, read once at import).  The CUDA kernels
# are built for the topology set here (render/cuda_traverse.py: WIDTHS x
# LEAF_SIZES; the wrappers raise on any other).  Defaults are the shipped
# configuration; the geometry cache key salts both, so switching never
# serves a stale layout.
LEAF_SIZE = int(os.environ.get("SIMPLEPATH_BVH_LEAF", "12"))
                # triangles per leaf (reference uses 4, BVHAccelerator.h:211
                # — topology is ours to choose); >12 spills to multi-row
                # leaves (LEAF_ROWS consecutive record rows per leaf)
WIDTH = int(os.environ.get("SIMPLEPATH_BVH_WIDTH", "8"))
                # branching factor (power of two; 6W+... floats must fit a row)
RECORD_WIDTH = 128

# rows per leaf record: 9 floats/triangle (v0, e1, e2) + 3 meta floats
LEAF_ROWS = -(-(9 * LEAF_SIZE + 3) // RECORD_WIDTH)
assert 7 * WIDTH <= RECORD_WIDTH, "internal row overflow (boxes+refs)"


def _cut_range(idx: np.ndarray, centroids: np.ndarray, L: int, k: int,
               out: list) -> None:
    """Partition ``idx`` into ``k`` groups sized proportionally to
    near-equal shares of the leaf budget ``L``, by recursive widest-axis
    argpartition cuts (the spatial strategy mirrors BVHAccelerator.h:175-209;
    the proportional-to-leaf-share sizing keeps leaves near-full — see the
    native builder's header comment for the measured pathology it fixes)."""
    if k == 1:
        out.append(idx)
        return
    kl = k // 2
    base, extra = divmod(L, k)
    Ll = kl * base + min(kl, extra)
    cut = (len(idx) * Ll) // L
    c = centroids[idx]
    axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
    order = np.argpartition(c[:, axis], cut)
    _cut_range(idx[order[:cut]], centroids, Ll, kl, out)
    _cut_range(idx[order[cut:]], centroids, L - Ll, k - kl, out)


def build_bvh_wide(tri_lo: np.ndarray, tri_hi: np.ndarray,
                   leaf_size: int = LEAF_SIZE,
                   width: int = WIDTH) -> tuple[dict, np.ndarray]:
    """Returns (node arrays dict, prim_order).

    node arrays: child_box [N,W,6] f32 (lo,hi; empty slots inverted),
    child_meta [N,W,3] i32 (node, first, count).
    """
    T = tri_lo.shape[0]
    assert T > 0
    levels = int(np.log2(width))
    assert 2 ** levels == width
    centroids = 0.5 * (tri_lo + tri_hi)

    boxes, metas = [], []
    prim_order: list[np.ndarray] = []
    prim_count = 0

    def alloc_node() -> int:
        box = np.empty((width, 6), np.float32)
        box[:, :3] = np.inf
        box[:, 3:] = -np.inf
        boxes.append(box)
        metas.append(np.array([[-1, 0, 0]] * width, np.int32))
        return len(boxes) - 1

    def split_wide(idx: np.ndarray) -> list[np.ndarray]:
        n = len(idx)
        L = -(-n // leaf_size)          # this range's leaf budget
        if L == 1:
            return [idx]
        groups: list[np.ndarray] = []
        _cut_range(idx, centroids, L, min(width, L), groups)
        return [g for g in groups if len(g)]

    root = alloc_node()
    stack: list[tuple[int, np.ndarray]] = []

    def fill_node(node_id: int, idx: np.ndarray) -> None:
        nonlocal prim_count
        for w, g in enumerate(split_wide(idx)):
            boxes[node_id][w, :3] = tri_lo[g].min(axis=0)
            boxes[node_id][w, 3:] = tri_hi[g].max(axis=0)
            if len(g) <= leaf_size:
                metas[node_id][w] = (-1, prim_count, len(g))
                prim_order.append(g.astype(np.int32))
                prim_count += len(g)
            else:
                cid = alloc_node()
                metas[node_id][w, 0] = cid
                stack.append((cid, g))

    fill_node(root, np.arange(T, dtype=np.int64))
    while stack:
        node_id, idx = stack.pop()
        fill_node(node_id, idx)

    nodes = {"child_box": np.stack(boxes), "child_meta": np.stack(metas)}
    order = np.concatenate(prim_order) if prim_order else np.zeros(0, np.int32)
    assert order.shape[0] == T
    return nodes, order


NATIVE_MIN_TRIS = 20_000  # below this the numpy builder is fast enough
LAST_BUILDER = None       # "native" | "numpy": which builder build_nodes ran


def build_nodes(tri_lo: np.ndarray, tri_hi: np.ndarray) -> tuple[dict, np.ndarray]:
    """Build the wide-BVH node arrays, dispatching to the native C++
    builder for large inputs (lucy-class meshes take minutes through the
    Python builder); numpy is the documented path when no C++ compiler
    exists (host code only: this is not a device fallback)."""
    global LAST_BUILDER
    if tri_lo.shape[0] >= NATIVE_MIN_TRIS:
        from ..native import native_build_bvh_wide
        result = native_build_bvh_wide(tri_lo.astype(np.float32),
                                       tri_hi.astype(np.float32),
                                       LEAF_SIZE, WIDTH)
        if result is not None:
            LAST_BUILDER = "native"
            print(f"BVH builder: native C++ ({tri_lo.shape[0]} triangles)")
            return result
        print(f"BVH builder: numpy (no C++ compiler; "
              f"{tri_lo.shape[0]} triangles)")
    LAST_BUILDER = "numpy"
    return build_bvh_wide(tri_lo, tri_hi)


def tree_depth(child_meta: np.ndarray) -> int:
    """Number of internal levels from the root (row 0) to the deepest leaf,
    by vectorized level-order descent."""
    depth = 0
    frontier = np.array([0], np.int32)
    while frontier.size:
        depth += 1
        kids = child_meta[frontier][:, :, 0].ravel()
        frontier = kids[kids >= 0].astype(np.int32)
    return depth


def table_stats(records) -> dict:
    """What a packed record table holds, read off the table itself (a
    table loaded from the geometry cache carries no node arrays): the
    internal levels from row 0 to the deepest leaf (what ``tree_depth``
    counts), the stack slots that depth needs against the kernels'
    ``KERNEL_STACK``, the internal rows, the leaves and their mean
    occupancy (the count ``pack_records`` writes at flat offset 9K+2 of a
    leaf's rows), and the rows in use (zero rows past them pad a shard of a
    forest)."""
    rec = np.asarray(records)
    refs = rec[:, 6 * WIDTH:7 * WIDTH]
    depth, internal, firsts = 0, 0, []
    frontier = np.array([0], np.int64)
    while frontier.size:            # only internal rows are read as refs
        depth += 1
        internal += frontier.size
        r = refs[frontier].ravel()
        firsts.append(-r[r < 0].astype(np.int64) - 1)
        frontier = r[r > 0].astype(np.int64) - 1
    firsts = np.sort(np.concatenate(firsts))       # in row order
    row, col = divmod(9 * LEAF_SIZE + 2, RECORD_WIDTH)
    counts = rec[firsts + row, col]
    return dict(rows=int(rec.shape[0]), bytes=int(rec.nbytes), depth=depth,
                stack_needed=depth * (WIDTH - 1) + 1, kernel_stack=_stack_limit(),
                internal_rows=internal, leaves=int(firsts.size),
                used_rows=internal + int(firsts.size) * LEAF_ROWS,
                mean_leaf_occupancy=float(counts.mean()) if counts.size else 0.0,
                leaf_size=LEAF_SIZE)


def _stack_limit() -> int:
    """The tighter of the two traversal paths' fixed stack capacities: the
    CUDA kernels' shared-memory stack (96 refs at most) and the plain
    versions' (64 at W <= 8, else 128), as in the JAX package."""
    from ..render.cuda_traverse import KERNEL_STACK
    return KERNEL_STACK


BASE_SHIFT = 12  # leaf base index split: base = hi * 2^12 + lo, both exact f32


def pack_records(nodes: dict, v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                 leaf_cap: int = LEAF_SIZE, base_offset: int = 0) -> np.ndarray:
    """Flatten (child_box, child_meta) + REORDERED triangles into the unified
    f32[M, 128] record table (layout in the module docstring).

    Internal rows come first (root = row 0, ref +1); leaf rows follow.
    ``base_offset`` shifts the leaf base triangle indices — used by the
    geometry-sharded build (parallel/geom_shard.py), where each shard's
    sub-BVH indexes its contiguous slice of the GLOBAL triangle table.
    """
    child_box = nodes["child_box"]      # [Nn, W, 6]
    child_meta = nodes["child_meta"]    # [Nn, W, 3]
    Nn, W, _ = child_box.shape
    assert W == WIDTH

    # Stack-safety invariant: traversal pops one ref and pushes up to W
    # children per internal visit, so the worst-case live stack is
    # depth*(W-1)+1 entries.  The kernels and their plain versions use
    # FIXED per-ray stacks (_stack_limit() slots at least); a builder
    # change that deepens the tree must fail HERE, at pack time, not as a
    # silent stack overflow in the kernel.
    depth = tree_depth(child_meta)
    need = depth * (W - 1) + 1
    limit = _stack_limit()
    assert need <= limit, (
        f"BVH depth {depth} needs stack {need} > traversal capacity {limit}")

    counts = child_meta[:, :, 2]
    leaf_mask = counts > 0
    leaf_first = child_meta[:, :, 1][leaf_mask].astype(np.int64)  # [L]
    leaf_count = counts[leaf_mask]                                # [L]
    assert leaf_count.max(initial=0) <= leaf_cap
    L = leaf_first.shape[0]
    M = Nn + L * LEAF_ROWS
    assert M < (1 << 24), "record ROW refs stored as exact f32 (row count limit)"
    assert base_offset + v0.shape[0] < (1 << (24 + BASE_SHIFT)), \
        "leaf base_hi must stay exact f32"
    rec = np.zeros((M, RECORD_WIDTH), np.float32)

    # child refs: 0 empty, +row+1 internal, -(first row+1) leaf (exact f32);
    # a leaf owns LEAF_ROWS consecutive rows starting at its referenced row
    ref = np.zeros((Nn, W), np.float32)
    internal = child_meta[:, :, 0] >= 0
    ref[internal] = child_meta[:, :, 0][internal] + 1
    ref[leaf_mask] = -(Nn + LEAF_ROWS * np.arange(L, dtype=np.float32) + 1)

    # internal rows: box SoA at [0:6W] (lo.x*W, lo.y*W, lo.z*W, hi.*), refs
    # at [6W:7W] — identical to the historical layout at W=8
    for axis in range(3):
        rec[:Nn, axis * W:axis * W + W] = child_box[:, :, axis]
        rec[:Nn, (3 + axis) * W:(4 + axis) * W] = child_box[:, :, 3 + axis]
    rec[:Nn, 6 * W:7 * W] = ref

    if L:
        K = leaf_cap
        lane = np.arange(K, dtype=np.int64)
        idx = leaf_first[:, None] + lane[None, :]         # [L, K]
        valid = lane[None, :] < leaf_count[:, None]
        idxc = np.where(valid, idx, 0)
        V0 = np.where(valid[..., None], v0[idxc], 0.0)
        E1 = np.where(valid[..., None], v0[idxc] - v1[idxc], 0.0)
        E2 = np.where(valid[..., None], v0[idxc] - v2[idxc], 0.0)
        # leaf payload is FLAT over the leaf's LEAF_ROWS*RECORD_WIDTH floats
        # (v0 SoA, e1 SoA, e2 SoA, then base_lo/base_hi/count at 9K..9K+2) —
        # identical to the historical single-row layout at K=12
        flat = np.zeros((L, LEAF_ROWS * RECORD_WIDTH), np.float32)
        for axis in range(3):
            flat[:, axis * K:axis * K + K] = V0[:, :, axis]
            flat[:, (3 + axis) * K:(4 + axis) * K] = E1[:, :, axis]
            flat[:, (6 + axis) * K:(7 + axis) * K] = E2[:, :, axis]
        gfirst = leaf_first + base_offset
        flat[:, 9 * K] = (gfirst & ((1 << BASE_SHIFT) - 1)).astype(np.float32)
        flat[:, 9 * K + 1] = (gfirst >> BASE_SHIFT).astype(np.float32)
        flat[:, 9 * K + 2] = leaf_count.astype(np.float32)
        rec[Nn:] = flat.reshape(L * LEAF_ROWS, RECORD_WIDTH)
    return rec


def make_packed_records(tri_lo: np.ndarray, tri_hi: np.ndarray,
                        v0: np.ndarray, v1: np.ndarray,
                        v2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Build the wide BVH and pack the unified record table (host numpy);
    also returns prim_order so the caller can reorder the triangle table
    itself (leaves then index contiguously).

    Uses the native C++ builder for large meshes (lucy-class inputs take
    minutes through the Python builder), numpy otherwise."""
    nodes, order = build_nodes(tri_lo, tri_hi)
    return pack_records(nodes, v0[order], v1[order], v2[order]), order


def make_bvh_arrays(tri_lo: np.ndarray, tri_hi: np.ndarray,
                    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                    device=None):
    """make_packed_records + the upload → ``(BVHArrays, prim_order)``.

    ``device=None`` means CUDA and raises without one (pass ``device="cpu"``
    for the plain path)."""
    import torch

    from ..device import resolve_device
    from .types import BVHArrays

    dev = resolve_device(device)
    records, order = make_packed_records(tri_lo, tri_hi, v0, v1, v2)
    return BVHArrays(records=torch.from_numpy(records).to(dev)), order
