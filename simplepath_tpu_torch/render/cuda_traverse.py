"""BVH traversal over the unified record table: the two CUDA kernels'
wrappers and, beside each, its plain PyTorch version.

Counterpart of ``simplepath_tpu/render/pallas_traverse.py``:

* :func:`closest`  ← ``packet_closest``: closest triangle hit per ray,
  ``(t f32, tri_idx i32, beta f32, gamma f32, valid bool)``, a miss is
  ``t=+inf, idx=-1``;
* :func:`anyhit`   ← ``packet_anyhit``: occlusion per ray, ``bool[N]``.

The kernels are hand-written CUDA C++ (``csrc/traverse.cu``): a group of
:data:`LANES_PER_RAY` lanes of one warp walks one ray with the ray's own
stack — the per-ray semantics of the JAX package's ``_bvh_closest`` /
``_bvh_any``, including their tie rules (an equal-t hit found later does NOT
replace the earlier one; children are ordered far-to-near by the ray's own
unclamped ``tnear``, equal keys in the order the Batcher network leaves them
in — 19 pairs at W=8, 63 at W=16 — which the group then runs across its
lanes in the stages of :func:`sort_stages`).

The BVH topology (``scene/bvh.py``: WIDTH, LEAF_SIZE, set by
``SIMPLEPATH_BVH_WIDTH`` / ``SIMPLEPATH_BVH_LEAF`` before import) is a
compile-time parameter of the kernels: each topology has its own library,
``build/libsp_traverse_w{W}_k{K}.so``, built with ``nvcc -DSP_W=W -DSP_K=K``
at first use and loaded with ctypes; nothing is built or imported from CUDA
when this module is imported.  :data:`WIDTHS` × :data:`LEAF_SIZES` is what
the kernel template covers; any other topology raises
``NotImplementedError``, on the CPU as on the GPU.

Dispatch rule: a CUDA tensor goes to the kernel, or the call raises — there
is no fallback from kernel to plain version.  A CPU tensor goes to the plain
version.  :func:`plain_versions` is an explicit override for comparisons
(tests, ``chip_smoke.py``), never used by the render path on its own.

Both functions are detached from autograd, like the kernels they replace.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess

import torch
from torch import Tensor

from ..scene.bvh import LEAF_ROWS, LEAF_SIZE, RECORD_WIDTH, WIDTH

__all__ = ["closest", "anyhit", "closest_plain", "anyhit_plain",
           "launch_counts", "reset_launch_counts", "plain_versions",
           "build_library", "library_path", "topology_flags",
           "check_topology", "batcher_pairs", "sort_stages",
           "sort_stage_partners", "stack_depth", "kernel_stack",
           "STACK_DEPTH", "KERNEL_STACK", "MAX_STACK", "LANES_PER_RAY",
           "WIDTHS", "LEAF_SIZES"]

# The topologies the kernel template covers (csrc/traverse.cu): a group of W
# lanes a ray, so W divides a warp and 7W floats fit a row; at most 32
# triangles a leaf (at most 4 slots a lane, 3 rows a leaf).
WIDTHS = (8, 16)
LEAF_SIZES = range(1, 33)
# The kernels' shared-memory stack never holds more refs than this (the JAX
# package's packet kernels' MAX_STACK).
MAX_STACK = 96


def stack_depth(width: int) -> int:
    """The plain versions' per-ray stack at branching factor ``width``: the
    JAX package's XLA traversal's STACK_DEPTH."""
    return 64 if width <= 8 else 128


def kernel_stack(width: int) -> int:
    """The kernels' per-ray stack: min(MAX_STACK, stack_depth), the capacity
    scene/bvh.py::pack_records holds a tree to (worst case depth*(W-1)+1
    entries), as the JAX package's pack does."""
    return min(MAX_STACK, stack_depth(width))


STACK_DEPTH = stack_depth(WIDTH)
KERNEL_STACK = kernel_stack(WIDTH)
# Lanes of one warp that share a ray in the kernels: one lane per child of an
# internal row.
LANES_PER_RAY = WIDTH

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
KERNEL_SOURCE = os.path.join(_PKG, "csrc", "traverse.cu")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# launches per kernel: +1 exactly where a wrapper launches its kernel
launch_counts = {"closest": 0, "anyhit": 0}

_lib = None
_force_plain = False


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch versions even on CUDA tensors, inside the
    ``with`` block — for holding the kernels against them."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) \
            + ["/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    return "nvcc"  # on PATH, or the build raises


def check_topology(width: int, leaf_size: int) -> None:
    """Raise NotImplementedError for a BVH topology that the kernel template
    does not cover (the plain versions refuse it too, so a topology never
    runs on the CPU that the card cannot run)."""
    if width not in WIDTHS or leaf_size not in LEAF_SIZES:
        raise NotImplementedError(
            f"traversal covers WIDTH in {WIDTHS} and LEAF_SIZE in "
            f"{LEAF_SIZES.start}..{LEAF_SIZES.stop - 1}; got WIDTH={width}, "
            f"LEAF_SIZE={leaf_size}")


def topology_flags(width: int = WIDTH, leaf_size: int = LEAF_SIZE) -> list[str]:
    """The nvcc defines that instantiate csrc/traverse.cu at a topology."""
    check_topology(width, leaf_size)
    return [f"-DSP_W={width}", f"-DSP_K={leaf_size}"]


def library_path(width: int = WIDTH, leaf_size: int = LEAF_SIZE) -> str:
    """Where the library of one topology is built."""
    return os.path.join(BUILD_DIR, f"libsp_traverse_w{width}_k{leaf_size}.so")


def _compile_source(source: str, out: str, flags: tuple[str, ...] = (),
                   verbose: bool = False) -> str:
    """``nvcc`` one traversal source for sm_90a, at this process's topology
    (:func:`topology_flags`; a source without the parameters ignores them),
    into the shared library ``out``; returns what ptxas said (with
    ``verbose``: registers, shared memory and spills per kernel).  Raises if
    nvcc fails."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *topology_flags(), *flags] \
        + (["-Xptxas", "-v"] if verbose else []) + ["-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return proc.stderr.strip()


def build_library(verbose: bool = False) -> str:
    """Compile ``csrc/traverse.cu`` for sm_90a at this process's topology
    into ``build/`` unless an up-to-date library is there; returns its path.
    Raises if nvcc fails."""
    path = library_path()
    if (os.path.exists(path)
            and os.path.getmtime(path) >= os.path.getmtime(KERNEL_SOURCE)):
        return path
    log = _compile_source(KERNEL_SOURCE, path, verbose=verbose)
    if verbose:
        print(log)
    return path


def _bind_library(path: str):
    """Load a built traversal library and declare its C entry points."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sp_closest.restype = i
    lib.sp_closest.argtypes = [p, p, p, p, p, i, p, p, p, p, p, p]
    lib.sp_anyhit.restype = i
    lib.sp_anyhit.argtypes = [p, p, p, p, p, i, p, p]
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = _bind_library(build_library())
    return _lib


def _check_inputs(records: Tensor, ro: Tensor, rd: Tensor, t_min: Tensor,
                  t_max: Tensor) -> int:
    """Topology, shapes, dtypes, devices and layout both paths rely on;
    returns N."""
    check_topology(WIDTH, LEAF_SIZE)
    if records.dim() != 2 or records.shape[1] != RECORD_WIDTH:
        raise ValueError(f"records must be [M,{RECORD_WIDTH}], got "
                         f"{tuple(records.shape)}")
    n = ro.shape[0]
    if ro.shape != (n, 3) or rd.shape != (n, 3):
        raise ValueError(f"ro/rd must be [N,3], got {tuple(ro.shape)} and "
                         f"{tuple(rd.shape)}")
    if t_min.shape != (n,) or t_max.shape != (n,):
        raise ValueError(f"t_min/t_max must be [N]={n}, got "
                         f"{tuple(t_min.shape)} and {tuple(t_max.shape)}")
    for name, x in (("records", records), ("ro", ro), ("rd", rd),
                    ("t_min", t_min), ("t_max", t_max)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != records.device:
            raise ValueError(f"{name} is on {x.device}, records on "
                             f"{records.device}")
    return n


def _check_kernel_layout(**tensors: Tensor) -> None:
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    if tensors["records"].data_ptr() % 16 != 0:
        raise ValueError("records must be 16-byte aligned (rows are read as "
                         "float4)")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")


def closest(records: Tensor, ro: Tensor, rd: Tensor, t_min: Tensor,
            t_max: Tensor):
    """Closest triangle hit for a flat ray batch.

    records: f32[M,128] unified BVH table; ro/rd: f32[N,3]; t_min/t_max:
    f32[N], any N ≥ 0.  Returns (t, tri_idx i32, beta, gamma, valid bool),
    each [N]; misses carry t=+inf, tri_idx=-1.  Lanes with a collapsed
    interval (t_max=-inf) miss: the plain version after one row visit, the
    kernel before it reads a row.
    """
    n = _check_inputs(records, ro, rd, t_min, t_max)
    records, ro, rd = records.detach(), ro.detach(), rd.detach()
    t_min, t_max = t_min.detach(), t_max.detach()
    if records.device.type != "cuda" or _force_plain:
        return closest_plain(records, ro, rd, t_min, t_max)
    _check_kernel_layout(records=records, ro=ro, rd=rd, t_min=t_min, t_max=t_max)
    dev = records.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    beta = torch.empty(n, dtype=torch.float32, device=dev)
    gamma = torch.empty(n, dtype=torch.float32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)   # kernel writes 0/1
    if n == 0:
        return t, idx, beta, gamma, valid
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.sp_closest(records.data_ptr(), ro.data_ptr(), rd.data_ptr(),
                             t_min.data_ptr(), t_max.data_ptr(), n,
                             t.data_ptr(), idx.data_ptr(), beta.data_ptr(),
                             gamma.data_ptr(), valid.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    launch_counts["closest"] += 1
    _raise_on(err, "sp_closest")
    return t, idx, beta, gamma, valid


def anyhit(records: Tensor, ro: Tensor, rd: Tensor, t_min: Tensor,
           t_max: Tensor) -> Tensor:
    """Occlusion for a flat ray batch: bool[N], true where any triangle hits
    with t in [t_min, t_max] (the kernel returns at the first hit)."""
    n = _check_inputs(records, ro, rd, t_min, t_max)
    records, ro, rd = records.detach(), ro.detach(), rd.detach()
    t_min, t_max = t_min.detach(), t_max.detach()
    if records.device.type != "cuda" or _force_plain:
        return anyhit_plain(records, ro, rd, t_min, t_max)
    _check_kernel_layout(records=records, ro=ro, rd=rd, t_min=t_min, t_max=t_max)
    dev = records.device
    occ = torch.empty(n, dtype=torch.bool, device=dev)     # kernel writes 0/1
    if n == 0:
        return occ
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.sp_anyhit(records.data_ptr(), ro.data_ptr(), rd.data_ptr(),
                            t_min.data_ptr(), t_max.data_ptr(), n,
                            occ.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    launch_counts["anyhit"] += 1
    _raise_on(err, "sp_anyhit")
    return occ


# ------------------------------------------------------- plain versions
#
# The port of _bvh_closest/_bvh_any with the batch dimension written out: a
# lock-step masked loop over the whole batch — a per-ray [N,64] stack tensor
# and sp, ONE row gather per iteration, both row interpretations computed
# and selected by the tag, until every sp == 0 (any-hit: or found).

def batcher_pairs(n: int) -> tuple[tuple[int, int], ...]:
    """Batcher odd-even mergesort compare-exchange network for n lanes
    (n a power of two): 19 CEs at n=8."""
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


def sort_stages(n: int) -> tuple[tuple[tuple[int, int], ...], ...]:
    """The compare-exchanges of :func:`batcher_pairs`, each as early as the
    pairs before it on its two elements allow: stages whose pairs touch
    disjoint elements, so that a stage's pairs can run at once (the kernel
    runs a stage across the lanes of a group with shuffles).  Applying the
    stages in order gives the result of the sequential list, ties included.
    6 stages at n=8."""
    level = [0] * n
    stages: list[list[tuple[int, int]]] = []
    for a, b in batcher_pairs(n):
        at = max(level[a], level[b])
        if at == len(stages):
            stages.append([])
        stages[at].append((a, b))
        level[a] = level[b] = at + 1
    return tuple(tuple(s) for s in stages)


def sort_stage_partners(n: int = WIDTH) -> tuple[int, ...]:
    """:func:`sort_stages` as the kernel holds it: one word a stage, nibble e
    = the element that element e is compared with (e itself where it
    rests); 32-bit words at n=8, 64-bit at n=16."""
    words = []
    for stage in sort_stages(n):
        partner = list(range(n))
        for a, b in stage:
            partner[a], partner[b] = b, a
        words.append(sum(p << (4 * e) for e, p in enumerate(partner)))
    return tuple(words)


_SORTW_PAIRS = batcher_pairs(WIDTH)
_NEG_BIG = -3.0e38
_INF = float("inf")


def _sortw_desc(keys: Tensor, vals: Tensor) -> tuple[Tensor, Tensor]:
    """Sort the W (key, val) columns of [N,W] tensors descending by key via
    the sorting network (ties keep the network's order, as in the kernel)."""
    k = list(keys.unbind(1))
    v = list(vals.unbind(1))
    for a, b in _SORTW_PAIRS:
        swap = k[a] < k[b]
        k[a], k[b] = torch.where(swap, k[b], k[a]), torch.where(swap, k[a], k[b])
        v[a], v[b] = torch.where(swap, v[b], v[a]), torch.where(swap, v[a], v[b])
    return torch.stack(k, 1), torch.stack(v, 1)


def _child_keys(rec, ro, inv_d, t_min, cur_t_max):
    """The slab test of the W children of each lane's row (the kernel's
    ``child_key``): the key, the ray's unclamped ``tnear`` where the child is
    hit and -inf where it is not, [N,W]; the child refs (int64); and
    ``near`` / ``far``, the clamped entry and exit the hit test compares.
    ``t_min`` / ``cur_t_max`` broadcast against [N,W].  torch.minimum /
    maximum propagate NaN, which culls a child whose slab product is NaN."""
    W = WIDTH
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
    cref = rec[:, 6 * W:7 * W].to(torch.int64)   # refs are exact f32 values
    hit = (near <= far) & (tfar >= t_min) & (cref != 0)
    return torch.where(hit, tnear, -_INF), cref, near, far


def _visit_internal(rec, is_leaf, ro, inv_d, t_min, cur_t_max):
    """Slab-test the W children of each lane's row and pack the hit child
    refs far-to-near (LIFO stack → nearest pops first).

    Returns (packed_refs [N,W] int64, n_push [N])."""
    key, cref, _, _ = _child_keys(rec, ro, inv_d, t_min[:, None],
                                  cur_t_max[:, None])
    key = torch.where(is_leaf[:, None], -_INF, key)
    skey, packed = _sortw_desc(key, cref)
    n_push = (skey > _NEG_BIG).sum(dim=1)
    return packed, n_push


def _visit_leaf(rec, ro, rd, t_min, cur_t_max):
    """Shirley barycentric test on each lane's leaf row (≤K triangles; A,B,C
    / D,E,F are the precomputed v0-v1 / v0-v2 edges).  One reciprocal and
    three multiplies, in the kernel's operation order.

    Returns (t, beta, gamma, valid, tri_idx), each [N,K]."""
    K = LEAF_SIZE
    v0x, v0y, v0z = rec[:, 0:K], rec[:, K:2 * K], rec[:, 2 * K:3 * K]
    A, B, C = rec[:, 3 * K:4 * K], rec[:, 4 * K:5 * K], rec[:, 5 * K:6 * K]
    D, E, F = rec[:, 6 * K:7 * K], rec[:, 7 * K:8 * K], rec[:, 8 * K:9 * K]
    base = (rec[:, 9 * K + 1].to(torch.int64) << 12) + rec[:, 9 * K].to(torch.int64)
    lane = torch.arange(K, dtype=torch.int64, device=rec.device)
    tri_idx = base[:, None] + lane
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
    return t, beta, gamma, valid, tri_idx


def _pop(records, stack, sp, active):
    """Pop each active lane's top ref and gather its row, flattened: one row
    at LEAF_ROWS=1, the LEAF_ROWS consecutive rows of a multi-row leaf
    otherwise (an internal visit reads only the first 7W floats of them),
    as the JAX package's ``_fetch_rows``.  Inactive lanes read the root
    row; all their results are masked."""
    ar = torch.arange(sp.shape[0], device=sp.device)
    ref = torch.where(active, stack[ar, torch.clamp_min(sp - 1, 0)], 1)
    sp = torch.where(active, sp - 1, sp)
    row = torch.abs(ref) - 1
    if LEAF_ROWS == 1:
        return ref, sp, records[row]
    rows = torch.clamp_max(row[:, None] + torch.arange(LEAF_ROWS, device=row.device),
                           records.shape[0] - 1)
    return ref, sp, records[rows].reshape(row.shape[0], LEAF_ROWS * RECORD_WIDTH)


def _push(stack, sp, packed, n_push):
    """Write packed[n, 0:n_push[n]] at stack[n, sp[n]:...] by real indexing."""
    sp_safe = torch.clamp_max(sp, STACK_DEPTH - WIDTH)
    slot = torch.arange(WIDTH, device=sp.device)
    sel = slot[None, :] < n_push[:, None]
    rows = torch.arange(sp.shape[0], device=sp.device)[:, None].expand_as(sel)
    stack[rows[sel], (sp_safe[:, None] + slot)[sel]] = packed[sel]
    return sp_safe + n_push


def _init_stack(n: int, device):
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=device)
    stack[:, 0] = 1                                   # root ref = +1
    return stack, torch.ones(n, dtype=torch.int64, device=device)


# internal visits by n_push, the number of hit children: 0, 1, 2, >= 3
N_PUSH_BUCKETS = 4


class _VisitCounter:
    """Per-ray visit counts of one plain traversal and the table rows it
    touched, for its ``stats``."""

    def __init__(self, n_rows: int, live: Tensor):
        n, device = live.shape[0], live.device
        self.live = live
        self.internal = torch.zeros(n, dtype=torch.int64, device=device)
        self.leaf = torch.zeros(n, dtype=torch.int64, device=device)
        self.by_push = torch.zeros((n, N_PUSH_BUCKETS), dtype=torch.int64,
                                   device=device)
        self.by_count = torch.zeros(LEAF_SIZE + 1, dtype=torch.int64, device=device)
        self.internal_rows = torch.zeros(n_rows, dtype=torch.bool, device=device)
        self.leaf_rows = torch.zeros(n_rows, dtype=torch.bool, device=device)

    def visit(self, ref: Tensor, rec: Tensor, is_leaf: Tensor,
              active: Tensor, n_push: Tensor) -> None:
        at_leaf = is_leaf & active
        self.leaf += at_leaf
        self.internal += ~is_leaf & active
        bucket = torch.clamp_max(n_push, N_PUSH_BUCKETS - 1)
        self.by_push += (torch.nn.functional.one_hot(bucket, N_PUSH_BUCKETS)
                         * (~is_leaf & active)[:, None])
        row = torch.abs(ref) - 1
        self.internal_rows[row[~is_leaf & active & self.live]] = True
        self.leaf_rows[row[at_leaf & self.live]] = True
        counts = rec[at_leaf, 9 * LEAF_SIZE + 2].to(torch.int64)
        self.by_count += torch.bincount(counts, minlength=LEAF_SIZE + 1)

    def add_to(self, stats: dict) -> None:
        """Totals add up over calls; the per-ray counts are this call's."""
        by_count = self.by_count.tolist()
        n_tris = sum(k * v for k, v in enumerate(by_count))
        for name, v in (("internal_visits", int(self.internal.sum())),
                        ("leaf_visits", int(self.leaf.sum())),
                        ("triangle_tests", n_tris)):
            stats[name] = stats.get(name, 0) + v
        prev = stats.get("leaf_visits_by_count", [0] * (LEAF_SIZE + 1))
        stats["leaf_visits_by_count"] = [a + b for a, b in zip(prev, by_count)]
        stats["ray_internal_visits"] = self.internal
        stats["ray_leaf_visits"] = self.leaf
        stats["ray_internal_visits_by_push"] = self.by_push
        stats["internal_rows_visited"] = self.internal_rows
        stats["leaf_rows_visited"] = self.leaf_rows


def closest_plain(records: Tensor, ro: Tensor, rd: Tensor, t_min: Tensor,
                  t_max: Tensor, stats: dict | None = None):
    """Plain PyTorch version of :func:`closest` (same outputs).  With a
    ``stats`` dict, adds the number of internal rows, leaf rows and leaf
    triangles visited, summed over rays — the kernel visits the same rows in
    the same order — and, per call, ``leaf_visits_by_count`` (leaf visits by
    the leaf's triangle count, 0..K), the int64[N] per-ray counts
    ``ray_internal_visits`` / ``ray_leaf_visits``, the int64[N,4]
    ``ray_internal_visits_by_push`` (a ray's internal visits by the number of
    children it pushed: 0, 1, 2, >= 3), and the bool[M] masks
    ``internal_rows_visited`` / ``leaf_rows_visited`` of the table rows that
    rays with a non-empty interval (t_max >= t_min) visited: the distinct
    rows a traversal of these rays has to read.  A ray with an empty interval
    pops the root here and reads nothing in the kernel."""
    n = _check_inputs(records, ro, rd, t_min, t_max)
    dev = records.device
    inv_d = 1.0 / rd   # IEEE inf for zero components is fine for slabs
    stack, sp = _init_stack(n, dev)
    best_valid = torch.zeros(n, dtype=torch.bool, device=dev)
    best_t = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    best_idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_beta = torch.zeros(n, dtype=torch.float32, device=dev)
    best_gamma = torch.zeros(n, dtype=torch.float32, device=dev)
    counter = (_VisitCounter(records.shape[0], ~(t_max < t_min))
               if stats is not None else None)

    while True:
        active = sp > 0
        if not bool(active.any()):
            break
        ref, sp, rec = _pop(records, stack, sp, active)
        is_leaf = ref < 0
        cur_t_max = torch.minimum(t_max, torch.where(best_valid, best_t, _INF))

        packed, n_push = _visit_internal(rec, is_leaf, ro, inv_d, t_min, cur_t_max)
        t, beta, gamma, valid, tri_idx = _visit_leaf(rec, ro, rd, t_min, cur_t_max)
        valid = valid & (is_leaf & active)[:, None]
        j = torch.where(valid, t, _INF).argmin(dim=1, keepdim=True)  # first min
        c_valid = valid.gather(1, j)[:, 0]
        c_t = t.gather(1, j)[:, 0]
        # _closer(best, cand): the earlier hit wins an equal-t tie
        tb = torch.where(c_valid, c_t, _INF)
        take_new = ~(torch.where(best_valid, best_t, _INF) <= tb)
        best_t = torch.where(take_new, c_t, best_t)
        best_idx = torch.where(take_new, tri_idx.gather(1, j)[:, 0], best_idx)
        best_beta = torch.where(take_new, beta.gather(1, j)[:, 0], best_beta)
        best_gamma = torch.where(take_new, gamma.gather(1, j)[:, 0], best_gamma)
        best_valid = best_valid | c_valid

        sp = _push(stack, sp, packed, torch.where(active, n_push, 0))
        if counter is not None:
            counter.visit(ref, rec, is_leaf, active, n_push)

    if counter is not None:
        counter.add_to(stats)
    return best_t, best_idx.to(torch.int32), best_beta, best_gamma, best_valid


def anyhit_plain(records: Tensor, ro: Tensor, rd: Tensor, t_min: Tensor,
                 t_max: Tensor, stats: dict | None = None) -> Tensor:
    """Plain PyTorch version of :func:`anyhit`; a lane stops at its first
    hit.  ``stats`` as in :func:`closest_plain`."""
    n = _check_inputs(records, ro, rd, t_min, t_max)
    dev = records.device
    inv_d = 1.0 / rd
    stack, sp = _init_stack(n, dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    counter = (_VisitCounter(records.shape[0], ~(t_max < t_min))
               if stats is not None else None)

    while True:
        active = (sp > 0) & ~found
        if not bool(active.any()):
            break
        ref, sp, rec = _pop(records, stack, sp, active)
        is_leaf = ref < 0
        packed, n_push = _visit_internal(rec, is_leaf, ro, inv_d, t_min, t_max)
        valid = _visit_leaf(rec, ro, rd, t_min, t_max)[3]
        found = found | (valid.any(dim=1) & is_leaf & active)
        sp = _push(stack, sp, packed, torch.where(active, n_push, 0))
        if counter is not None:
            counter.visit(ref, rec, is_leaf, active, n_push)

    if counter is not None:
        counter.add_to(stats)
    return found
