"""The measuring kernels: counterparts of the five Pallas kernels of the JAX
package's ``tools/`` probes, each wrapper with its plain PyTorch version.

* :func:`closest_count` ← ``tools/prof_visits.py::counting_closest`` and
  ``tools/prof_npush.py::hist_closest``: the closest-hit traversal, which
  also counts each ray's internal and leaf visits and its internal visits by
  n_push, the number of hit children (0, 1, 2, >= 3);
* :func:`row_chase` ← ``tools/prof_visits.py::dma_chase`` and
  ``tools/prof_dma_chains.py::chase``: C serial pointer chases over the
  record table, one row copy a hop, fed by a TMA bulk copy on an mbarrier
  (the TPU's row DMA on a semaphore) or by ``__ldg`` (the traversal's feed)
  (:data:`FEEDS`); :func:`cycle_table` is its input that the caches cannot
  hold;
* :func:`visit_body` ← ``tools/prof_visit_vpu.py::make_kernel``: M
  back-to-back visit bodies on rows held in shared memory, for one fixed
  ray, in four modes (:data:`BODY_MODES`) and two layouts of the same
  function (:data:`BODY_LAYOUTS`): ``"lane"`` (the default), one thread a
  ray with the row broadcast from shared memory and the Batcher network in
  registers, the TPU kernel's own layout; ``"group"``, the traversal's
  visit, W lanes a ray through ``sp_closest``'s device functions;
  :func:`visit_body_lanes` is its check launch, which also gives what each
  of a ray's W lanes holds after the last body.

The kernels (``sp_closest_count``, ``sp_row_chase``, ``sp_visit_body``) live
in ``csrc/traverse.cu`` beside the traversal kernels whose device functions
they run, and are built into the same library (``cuda_traverse.build_library``)
at first use.  No render path calls them: they count and time, for
``chip_smoke.py``'s probes phase and ``tools/torch_prof_*.py``.  Their launch
counts are kept here, apart from ``cuda_traverse.launch_counts`` (what a
render launched).

The TPU probes count per 1,024-ray packet; these count per ray, the card's
unit: a packet of one live ray gives the same numbers.

Dispatch rule, as in ``cuda_traverse``: a CUDA tensor goes to the kernel or
the call raises; a CPU tensor goes to the plain version;
``cuda_traverse.plain_versions()`` forces the plain versions for comparisons.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import Tensor

from ..device import resolve_device
from ..scene.bvh import LEAF_ROWS, LEAF_SIZE, RECORD_WIDTH, WIDTH
from . import cuda_traverse as ct

__all__ = ["closest_count", "closest_count_plain", "row_chase",
           "row_chase_plain", "visit_body", "visit_body_plain",
           "visit_body_lanes", "visit_body_lanes_plain", "crossed_table",
           "cycle_table", "body_blocks_per_sm", "body_rays_per_block",
           "closest_blocks_per_sm", "launch_counts", "reset_launch_counts",
           "BODY_MODES", "BODY_LAYOUTS", "CHAINS", "FEEDS"]

# the visit-body probe's modes, in the kernel's numbering (csrc/traverse.cu
# BodyMode)
BODY_MODES = ("internal", "internal_norel", "sort_only", "leaf")
# the visit body's layouts, in the kernel's numbering (csrc/traverse.cu
# BodyLayout): one thread a ray, or the traversal's W lanes a ray
BODY_LAYOUTS = ("lane", "group")
# threads a block of the visit body (csrc/traverse.cu BLOCK)
BODY_BLOCK = 128
# chains one warp runs in sp_row_chase
CHAINS = (1, 2, 4, 8)
# sp_row_chase's row feeds, in the kernel's numbering (csrc/traverse.cu
# ChaseFeed): a TMA bulk copy on an mbarrier, or __ldg through L1
FEEDS = ("bulk", "ldg")
# refs are float32: every integer up to 2**24 is exact
MAX_CYCLE_ROWS = 2 ** 24

# launches per kernel: +1 exactly where a wrapper launches its kernel
launch_counts = {"closest_count": 0, "row_chase": 0,
                 **{f"visit_body_{layout}": 0 for layout in BODY_LAYOUTS}}

_bound = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    """The traversal library with the probes' entry points declared."""
    global _bound
    lib = ct._library()
    if _bound is not lib:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sp_closest_count.restype = i
        lib.sp_closest_count.argtypes = [p, p, p, p, p, i] + [p] * 9
        lib.sp_row_chase.restype = i
        lib.sp_row_chase.argtypes = [p, i, i, i, i, p, p]
        lib.sp_visit_body.restype = i
        lib.sp_visit_body.argtypes = [p, i, f, i, i, i, i, p, p, p]
        lib.sp_visit_body_blocks_per_sm.restype = i
        lib.sp_visit_body_blocks_per_sm.argtypes = [i, i, ctypes.POINTER(i)]
        lib.sp_closest_blocks_per_sm.restype = i
        lib.sp_closest_blocks_per_sm.argtypes = [ctypes.POINTER(i)]
        _bound = lib
    return lib


def _on_kernel(records: Tensor) -> bool:
    return records.device.type == "cuda" and not ct._force_plain


def _check_records(records: Tensor) -> None:
    ct.check_topology(WIDTH, LEAF_SIZE)
    if records.dim() != 2 or records.shape[1] != RECORD_WIDTH:
        raise ValueError(f"records must be [M,{RECORD_WIDTH}], got "
                         f"{tuple(records.shape)}")
    if records.dtype != torch.float32:
        raise TypeError(f"records must be float32, got {records.dtype}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ------------------------------------------------------ closest + counts

def closest_count(records: Tensor, ro: Tensor, rd: Tensor, t_min: Tensor,
                  t_max: Tensor):
    """:func:`cuda_traverse.closest` that also counts, per ray: internal
    visits, leaf visits (int32[N] each) and internal visits by n_push = 0,
    1, 2, >= 3 (int32[N,4]).  The hits are ``closest``'s, bit for bit.  A ray
    with an empty interval (t_max < t_min) visits nothing and counts 0.

    Returns (t, tri_idx, beta, gamma, valid, internal, leaf, by_push)."""
    n = ct._check_inputs(records, ro, rd, t_min, t_max)
    records, ro, rd = records.detach(), ro.detach(), rd.detach()
    t_min, t_max = t_min.detach(), t_max.detach()
    if not _on_kernel(records):
        return closest_count_plain(records, ro, rd, t_min, t_max)
    ct._check_kernel_layout(records=records, ro=ro, rd=rd, t_min=t_min,
                            t_max=t_max)
    dev = records.device
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    i32 = lambda *shape: torch.empty(shape, dtype=torch.int32, device=dev)
    t, beta, gamma = f32(n), f32(n), f32(n)
    idx, internal, leaf, by_push = i32(n), i32(n), i32(n), i32(n, 4)
    valid = torch.empty(n, dtype=torch.bool, device=dev)   # kernel writes 0/1
    out = (t, idx, beta, gamma, valid, internal, leaf, by_push)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.sp_closest_count(
            records.data_ptr(), ro.data_ptr(), rd.data_ptr(), t_min.data_ptr(),
            t_max.data_ptr(), n, *(x.data_ptr() for x in out), _stream(dev))
    launch_counts["closest_count"] += 1
    ct._raise_on(err, "sp_closest_count")
    return out


def closest_count_plain(records: Tensor, ro: Tensor, rd: Tensor,
                        t_min: Tensor, t_max: Tensor,
                        stats: dict | None = None):
    """Plain version of :func:`closest_count`: ``closest_plain`` and its
    per-ray stats (added to ``stats`` where one is given); a ray with an
    empty interval pops the root there and counts 0 here, as in the kernel,
    which reads no row for it."""
    stats = {} if stats is None else stats
    hits = ct.closest_plain(records, ro, rd, t_min, t_max, stats=stats)
    dead = t_max < t_min
    counts = [torch.where(dead, 0, stats["ray_internal_visits"]),
              torch.where(dead, 0, stats["ray_leaf_visits"]),
              torch.where(dead[:, None], 0, stats["ray_internal_visits_by_push"])]
    return (*hits, *(c.to(torch.int32) for c in counts))


# ------------------------------------------------------------- row chase

def _check_chase(records: Tensor, chains: int, hops: int, feed: str) -> None:
    _check_records(records)
    if feed not in FEEDS:
        raise ValueError(f"feed must be one of {FEEDS}, got {feed!r}")
    if chains not in CHAINS:
        raise ValueError(f"chains must be one of {CHAINS}, got {chains}")
    if hops < 0:
        raise ValueError(f"hops must be >= 0, got {hops}")
    if records.shape[0] < LEAF_ROWS:
        raise ValueError(f"the table has {records.shape[0]} rows, fewer than "
                         f"one copy's {LEAF_ROWS}")


def row_chase(records: Tensor, chains: int, hops: int,
              feed: str = "bulk") -> Tensor:
    """``chains`` serial pointer chases of ``hops`` hops each over the
    record table, one warp: chain c starts at ref 1 + c; a hop copies the
    LEAF_ROWS rows of row |ref| - 1 and takes slot 6W of the copy (an
    internal row's first child ref) if it is positive, else ref 1 + c.
    Returns each chain's last ref, float32[chains] (the TPU probe returns
    chain 0's).  A ref outside the table reads its last full row.

    ``feed`` picks how a hop's rows reach shared memory (one instance of
    the kernel each, the same refs): ``"bulk"``, one TMA bulk copy that
    completes on an mbarrier (the TPU's row DMA on a semaphore), or
    ``"ldg"``, the lanes' loads through L1 (the traversal's feed).  On a
    CUDA tensor either feed launches its own kernel or raises."""
    _check_chase(records, chains, hops, feed)
    records = records.detach()
    if not _on_kernel(records):
        return row_chase_plain(records, chains, hops)
    ct._check_kernel_layout(records=records)
    dev = records.device
    out = torch.empty(chains, dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.sp_row_chase(records.data_ptr(), records.shape[0], chains,
                               hops, FEEDS.index(feed), out.data_ptr(),
                               _stream(dev))
    launch_counts["row_chase"] += 1
    ct._raise_on(err, "sp_row_chase")
    return out


def row_chase_plain(records: Tensor, chains: int, hops: int,
                    visited: bool = False):
    """Plain version of :func:`row_chase`: the chains side by side, one row
    gather a hop.  With ``visited``, returns (refs, the row each chain
    copied at each hop, int64[hops, chains])."""
    dev = records.device
    start = 1.0 + torch.arange(chains, dtype=torch.float32, device=dev)
    rows = torch.arange(LEAF_ROWS, device=dev)
    last = records.shape[0] - LEAF_ROWS
    ref, trace = start, []
    for _ in range(hops):
        row = torch.clamp(ref.abs().to(torch.int64) - 1, 0, last)
        if visited:
            trace.append(row)
        copy = records[row[:, None] + rows].reshape(chains, -1)
        child = copy[:, 6 * WIDTH]
        ref = torch.where(child > 0.0, child, start)
    if not visited:
        return ref
    return ref, (torch.stack(trace) if trace else
                 torch.empty((0, chains), dtype=torch.int64, device=dev))


# ------------------------------------------------------------ visit body

def _body_rows(records: Tensor, seed: float) -> int:
    """The first of the rows the visit body reads: |seed| - 1 (LEAF_ROWS
    rows from there, and LEAF_ROWS from |seed|); raises if they are not all
    in the table."""
    first = int(abs(seed)) - 1
    if first < 0 or first + 1 + LEAF_ROWS > records.shape[0]:
        raise ValueError(f"seed {seed} reads rows {first}..{first + LEAF_ROWS} "
                         f"of a table of {records.shape[0]}")
    return first


def _check_layout(layout: str) -> None:
    if layout not in BODY_LAYOUTS:
        raise ValueError(f"layout must be one of {BODY_LAYOUTS}, got "
                         f"{layout!r}")


def _check_body(records: Tensor, seed: float, mode: str, bodies: int,
                n: int, layout: str) -> int:
    _check_records(records)
    _check_layout(layout)
    if mode not in BODY_MODES:
        raise ValueError(f"mode must be one of {BODY_MODES}, got {mode!r}")
    if bodies < 0 or n < 0:
        raise ValueError(f"bodies and rays must be >= 0, got {bodies}, {n}")
    return _body_rows(records, seed)


def _launch_body(records: Tensor, seed: float, mode: str, bodies: int, n: int,
                 first: int, check: bool, layout: str):
    ct._check_kernel_layout(records=records)
    dev = records.device
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lanes = (torch.empty((n, ct.LANES_PER_RAY, 4), dtype=torch.float32,
                         device=dev) if check else None)
    if n == 0:
        return out, lanes
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.sp_visit_body(records.data_ptr(), first, float(seed),
                                BODY_MODES.index(mode),
                                BODY_LAYOUTS.index(layout), bodies, n,
                                out.data_ptr(),
                                lanes.data_ptr() if check else None,
                                _stream(dev))
    launch_counts[f"visit_body_{layout}"] += 1
    ct._raise_on(err, "sp_visit_body")
    return out, lanes


def visit_body(records: Tensor, seed: float, mode: str, bodies: int,
               n: int, layout: str = "lane") -> Tensor:
    """``bodies`` back-to-back visit bodies of ``mode`` for the probe's fixed
    ray (origin (0.1 + 1e-6 seed, 2, 5), inverse direction (3, -7, 2)) on rows |seed| - 1 (the internal modes) and |seed|
    (``leaf``), for ``n`` copies of the ray; each body's result is the next
    one's limit.  Returns float32[n], every entry the TPU probe's output
    value: ``internal`` NaN where a child of the row is not hit, else inf;
    ``internal_norel`` and ``sort_only`` inf unless the row holds an
    infinite box; ``leaf`` the nearest hit t of the row's K triangles (all
    of them live), or inf.  ``layout`` (:data:`BODY_LAYOUTS`) picks the
    kernel instance on a CUDA tensor; both compute this function, so on a
    CPU tensor either gives the plain version."""
    first = _check_body(records, seed, mode, bodies, n, layout)
    records = records.detach()
    if not _on_kernel(records):
        return visit_body_plain(records, seed, mode, bodies, n)
    return _launch_body(records, seed, mode, bodies, n, first, False,
                        layout)[0]


def visit_body_lanes(records: Tensor, seed: float, mode: str, bodies: int,
                     n: int, layout: str = "lane") -> tuple[Tensor, Tensor]:
    """The check launch of :func:`visit_body` (``bodies`` >= 1): its output
    and what each of a ray's LANES_PER_RAY lanes holds after the last body,
    float32[n, LANES_PER_RAY, 4]:

    * ``internal`` and ``sort_only``, lane j: the key and ref at place j of
      the placed children (the pushed order, nearest last), the count of
      keys above -3e38 (n_push), 0; lanes past the count (-inf, 0, count, 0);
    * ``internal_norel``, lane c: child c's key, near, far and ref;
    * ``leaf``, lane c: the t and slot of its first minimum over slots
      c, c + W, ..., and the group's first minimum (t, slot).

    Keys and refs are the row's values, so a body that was skipped or wrong
    shows where the TPU probe's NaN / inf output cannot.  Both layouts
    write these lanes: in the lane layout one thread writes all of its
    ray's."""
    first = _check_body(records, seed, mode, bodies, n, layout)
    if bodies < 1:
        raise ValueError(f"a check launch runs at least one body, got {bodies}")
    records = records.detach()
    if not _on_kernel(records):
        return visit_body_lanes_plain(records, seed, mode, bodies, n)
    return _launch_body(records, seed, mode, bodies, n, first, True, layout)


def body_blocks_per_sm(mode: str, layout: str = "lane") -> int:
    """Blocks of the visit body's ``mode`` and ``layout`` that one SM
    holds at once (the CUDA occupancy calculator): a launch of that many
    blocks a SM fills the card in one wave."""
    _check_layout(layout)
    blocks = ctypes.c_int(0)
    ct._raise_on(_library().sp_visit_body_blocks_per_sm(
        BODY_MODES.index(mode), BODY_LAYOUTS.index(layout),
        ctypes.byref(blocks)), "occupancy query")
    return blocks.value


def body_rays_per_block(layout: str = "lane") -> int:
    """Rays a block of the visit body's ``layout`` holds: one a thread, or
    one a group of W lanes."""
    _check_layout(layout)
    return BODY_BLOCK if layout == "lane" else BODY_BLOCK // ct.LANES_PER_RAY


def closest_blocks_per_sm() -> int:
    """Blocks of ``sp_closest`` that one SM holds at once: a visit body
    launched with as many runs at the traversal's occupancy, where its own
    allows as many."""
    blocks = ctypes.c_int(0)
    ct._raise_on(_library().sp_closest_blocks_per_sm(ctypes.byref(blocks)),
                 "occupancy query")
    return blocks.value


def crossed_table(tie: bool = True, seed: int = 4, device=None,
                  miss: bool = False) -> Tensor:
    """A table of 1 + LEAF_ROWS rows that the fixed ray at seed 1 crosses,
    made with numpy from ``seed``: an internal row whose W child boxes
    (refs 2..W+1) all lie on the ray, boxes 1 and 3 equal where ``tie`` (so
    that two keys tie and the network runs), box 0 moved off the ray where
    ``miss`` (a missed child, which the network moves to the last place),
    and a leaf of K triangles centred on the ray at random distances, every
    other one moved off it.  The fixed ray misses every row of the bench's
    table and of g_blob's; here each mode computes values a wrong or
    skipped body would not."""
    rs = np.random.RandomState(seed)
    W, K = WIDTH, LEAF_SIZE
    f = np.float32
    o = np.array([f(0.1) + f(1e-6), 2.0, 5.0], f)    # the fixed ray at seed 1
    d = f(1.0) / np.array([3.0, -7.0, 2.0], f)
    table = np.zeros((1 + LEAF_ROWS, RECORD_WIDTH), np.float32)
    ts = 0.5 + 6.0 * rs.rand(W)
    if tie:
        ts[3] = ts[1]
    centre = o + ts[:, None] * d
    if miss:
        centre[0, 1] += 3.0
    half = 0.1 + 0.3 * rs.rand(W, 3)
    if tie:
        half[3] = half[1]
    lo, hi = centre - half, centre + half
    for axis in range(3):
        table[0, axis * W:(axis + 1) * W] = lo[:, axis]
        table[0, (3 + axis) * W:(4 + axis) * W] = hi[:, axis]
    table[0, 6 * W:7 * W] = np.arange(2, W + 2)
    tk = 1.0 + 7.0 * rs.rand(K)
    p = o + tk[:, None] * d
    p[1::2] += 3.0                                   # these miss
    a, b = 0.4 * rs.randn(K, 3), 0.4 * rs.randn(K, 3)
    v0, v1, v2 = p + a, p + b, p - a - b             # centroid on p
    leaf = np.concatenate([v0.T.reshape(-1), (v0 - v1).T.reshape(-1),
                           (v0 - v2).T.reshape(-1), [0.0, 0.0, 5.0]])
    table[1:].reshape(-1)[:leaf.size] = leaf
    return torch.from_numpy(table).to(device)


def cycle_table(rows: int, seed: int = 0, device=None) -> Tensor:
    """A record table of ``rows`` rows that the row chase walks as one
    cycle: f32[rows, RECORD_WIDTH] of zeros but slot 6W, which makes one
    random cyclic order of rows 0 .. rows - LEAF_ROWS (numpy's
    ``default_rng(seed)``; no copy is clamped) by holding in each row the
    ref (row + 1, an exact float32 integer) of the next row in the order.
    Each hop copies a row that no earlier hop of its chain copied, until
    the cycle wraps, so the table's size sets the level of the card's
    memory that serves a hop.  Built on ``device`` (None: CUDA, raising
    without one) with only the ref column from the host."""
    dev = resolve_device(device)
    if not LEAF_ROWS <= rows <= MAX_CYCLE_ROWS:
        raise ValueError(f"a cycle table has {LEAF_ROWS} to {MAX_CYCLE_ROWS} "
                         f"rows (refs exact in float32), got {rows}")
    n = rows - LEAF_ROWS + 1
    order = np.random.default_rng(seed).permutation(n)
    ref = np.empty(n, np.float32)
    ref[order] = np.roll(order, -1) + 1
    table = torch.zeros((rows, RECORD_WIDTH), dtype=torch.float32, device=dev)
    table[:n, 6 * WIDTH] = torch.from_numpy(ref).to(dev)
    return table


def _body_ray(seed: float, n: int, device):
    """The visit-body probe's fixed ray (tools/prof_visit_vpu.py:30-35), in
    float32 as the kernel makes it: origin (0.1 + seed * 1e-6, 2, 5),
    inverse direction (3, -7, 2), direction its reciprocal, t_min 1e-3;
    n copies of (ro, rd, inv_d, t_min)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    o = torch.stack([f32(0.1) + f32(seed) * f32(1e-6), f32(2.0), f32(5.0)])
    inv = f32((3.0, -7.0, 2.0))
    one = lambda v: v[None, :].expand(n, 3)
    return one(o), one(1.0 / inv), one(inv), torch.full(
        (n,), 1e-3, dtype=torch.float32, device=device)


def _placed(key: Tensor, val: Tensor) -> Tensor:
    """The check lanes of a placement: lane j the key and ref at place j
    (the network's descending order), the count of keys above -3e38, 0;
    lanes past the count (-inf, 0, count, 0)."""
    skey, sval = ct._sortw_desc(key, val)
    count = (skey > ct._NEG_BIG).sum(dim=1, keepdim=True)
    live = torch.arange(WIDTH, device=key.device) < count
    return torch.stack([torch.where(live, skey, -ct._INF),
                        torch.where(live, sval.to(torch.float32), 0.0),
                        count.to(torch.float32).expand_as(skey),
                        torch.zeros_like(skey)], dim=2)


def _leaf_lanes(t: Tensor, valid: Tensor) -> Tensor:
    """The check lanes of a leaf body: lane c's first minimum over its slots
    c, c + G, ... (strictly smaller t wins, as in the kernel) and the
    group's first minimum, smaller t and at equal t the smaller slot."""
    G, K = ct.LANES_PER_RAY, LEAF_SIZE
    tm = torch.where(valid, t, ct._INF)
    n = tm.shape[0]
    my_t = torch.full((n, G), ct._INF, dtype=torch.float32, device=t.device)
    my_k = torch.arange(G, device=t.device).expand(n, G).clone()
    for p in range(0, K, G):
        width = min(G, K - p)
        cand = tm[:, p:p + width]
        better = cand < my_t[:, :width]
        my_t[:, :width] = torch.where(better, cand, my_t[:, :width])
        my_k[:, :width] = torch.where(better, p + my_k.new_tensor(
            range(width)), my_k[:, :width])
    win_t = my_t.min(dim=1, keepdim=True).values
    win_k = torch.where(my_t == win_t, my_k, K + G).min(dim=1,
                                                         keepdim=True).values
    return torch.stack([my_t, my_k.to(torch.float32),
                        win_t.expand(n, G), win_k.to(torch.float32).expand(n, G)],
                       dim=2)


def visit_body_plain(records: Tensor, seed: float, mode: str, bodies: int,
                     n: int) -> Tensor:
    """Plain version of :func:`visit_body`: the same bodies with the rays
    side by side; the internal modes keep one limit a child, as the
    kernel's lanes do, and give the NaN-propagating max over them."""
    return _bodies_plain(records, seed, mode, bodies, n)[0]


def visit_body_lanes_plain(records: Tensor, seed: float, mode: str,
                           bodies: int, n: int) -> tuple[Tensor, Tensor]:
    """Plain version of :func:`visit_body_lanes`."""
    if bodies < 1:
        raise ValueError(f"a check launch runs at least one body, got {bodies}")
    return _bodies_plain(records, seed, mode, bodies, n)


def _bodies_plain(records: Tensor, seed: float, mode: str, bodies: int,
                  n: int) -> tuple[Tensor, Tensor | None]:
    """The bodies with the rays side by side: (output, the last body's
    check lanes, or None where no body ran)."""
    first = _body_rows(records, seed)
    dev = records.device
    ro, rd, inv, t_min = _body_ray(seed, n, dev)
    node = records[first][None, :].expand(n, RECORD_WIDTH)
    W = WIDTH
    lanes = None
    if mode == "leaf":
        leaf = records[first + 1:first + 1 + LEAF_ROWS].reshape(1, -1).clone()
        leaf[:, 9 * LEAF_SIZE + 2] = LEAF_SIZE          # every slot live
        leaf = leaf.expand(n, -1)
        best = torch.full((n,), ct._INF, dtype=torch.float32, device=dev)
        for _ in range(bodies):
            t, _, _, valid, _ = ct._visit_leaf(leaf, ro, rd, t_min, best)
            lanes = _leaf_lanes(t, valid)
            win = torch.where(valid, t, ct._INF).min(dim=1).values
            best = torch.where(win < best, win, best)
        return best, lanes
    if mode == "sort_only":
        carry = torch.full((n,), ct._INF, dtype=torch.float32, device=dev)
        for _ in range(bodies):
            key, val = ct._sortw_desc(node[:, 0:W], node[:, W:2 * W])
            carry = carry + key[:, 0] * 0.0 + val[:, 0] * 0.0
            lanes = _placed(node[:, 0:W], node[:, W:2 * W])
        return carry, lanes
    carry = torch.full((n, W), ct._INF, dtype=torch.float32, device=dev)
    for _ in range(bodies):
        key, cref, near, far = ct._child_keys(node, ro, inv, t_min[:, None],
                                              carry)
        if mode == "internal":
            lanes = _placed(key, cref)
            n_push = lanes[:, :, 2]
            carry = carry + key * 0.0 + n_push * 0.0
        else:
            lanes = torch.stack([key, near, far, cref.to(torch.float32)], 2)
            carry = carry + (near * 0.0 + far * 0.0) * 0.0
    return carry.amax(dim=1), lanes
