#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (simplepath_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, needs one CUDA device
    python3 chip_smoke.py --spp 2 --phases kernels,parity

Drives the port's render paths — load_scene → render_image_sharded →
render_rays → each integrator → PFM — on the bench scene
(scenes/bunny_bench.sp: 327,680 triangles, 1024x1024, depth 10), through
the two hand-written CUDA traversal kernels, and holds each kernel against
its plain PyTorch version on the card.  Phases, JSON lines:

  device   card name and power limit (nvidia-smi), torch and CUDA versions
  build    nvcc build of csrc/traverse.cu and g++ build of the BVH builder
  kernels  closest/anyhit vs their plain versions at N=65,536 primary rays,
           N=65,499 seeded incoherent rays (~10 % dead lanes) and the real
           wavefronts of bounces 0, 2 and 5 of one rendered 65,536-ray chunk:
           exact valid/idx/occluded, t rtol 1e-5, beta/gamma rtol 1e-4;
           times, visits a ray, lane-step shares, bytes the visits read;
           the one-ray forms (traverse.scene_intersect / scene_intersect_p)
           on 16 primary rays, one launch a call, each answer the batch
           form's through the plain versions
  probes   the three measuring kernels (render/cuda_probes.py), each against
           its plain version: sp_closest_count on the five ray sets (counts
           and n_push histograms exactly equal, hits bit-equal to
           sp_closest's, device ms in turns with sp_closest's: the cost of
           counting; visits a ray and a warp, the lock-step share, the n_push
           shares); sp_row_chase under both feeds (a TMA bulk copy on an
           mbarrier; __ldg) at 1, 2, 4 and 8 chains of 20,000 hops on the
           bench's table (refs equal, ns a hop, each feed timed once) and
           of 5,461 on a 2 MiB cuda_probes.cycle_table (refs equal, every
           chain away from its start); sp_visit_body in its
           four modes on the bench's table and on two tables whose rows the
           fixed ray crosses (output and each lane's keys, refs and slots
           after 1 and 3 bodies NaN-equal; ns a body at 100,000 bodies on
           one warp, on a launch that fills every SM and at sp_closest's
           occupancy)
  render   the flagship (iterative_rrnee) full frame at --spp samples;
           launch counts per kernel
  paths    the full frame at 1 spp with each other traced integrator, and
           with an image-based environment light (a 1024x2048 PFM written
           from a seed) under iterative_rrnee and direct_lighting; launch
           counts per kernel and path (sp_anyhit exactly where there is NEE)
  parity   128x128, 1 spp: kernels vs plain versions forced, on the card,
           for the flagship and every path above; adaptive RR at 64x64,
           20 spp; Mandelbrot at 256x256 with no kernel launch
  cli      simplepath_tpu_torch.cli on tests/scenes/g_ibl_rrnee.sp, 8 spp
           in passes of 4 with a checkpoint; a render cut after its first
           pass and resumed by the CLI equals the uninterrupted one bit for
           bit
  golden   the 15 goldens of tests/golden/manifest.json but the 512x512
           headline, rendered by render_image under the golden tests' key
           (17) and held to the C++ reference's PFMs with the gates of
           tests/test_golden_parity.py: the 11 scenes of matched_floors.json
           at the golden's spp (128-256) under the matched gates (mean
           within max(0.005, 3x the floor's), p90 and p99 under 1.5x the
           floor) and the blurred ones (mean within 5 %, 3x3-blurred p90
           < 0.35); the three IBL scenes at 128 spp under the blurred gates;
           mandelbrot at 1 spp (> 99 % of pixels within 2e-3); four scenes
           at a time, each in a worker process on the one card (the
           bounce loop is host-bound); one line a scene (seconds, launches,
           each metric beside its gate); the four mesh scenes launch both
           kernels, the others none
  train    diff.grad on the bench scene at depth 10: 3 make_train_step calls
           (plain SGD, the albedo trained) on 65,536 pixels (every 4th row
           and column) at 1 spp toward the port's own render at the true
           parameters, from a flat 0.5 albedo; seconds, launches and peak
           memory a step, one step at 4 spp; one step over every leaf and
           over each group of leaves alone; a step's forward,
           checkpointed and plain-autograd cost, and what a sample-level
           checkpoint would save; on a 64x64 crop the gradient through the
           kernels equals the one through their plain versions (rtol 1e-4,
           atol 1e-6), and matches central differences (4 spp) on the
           largest albedo and light-radiance gradients (and, recorded, on
           the largest camera and roughness ones); then the gradient
           parity on the crop's middle 32x32 (both gradients finite) for
           each other traced integrator on the bench and both
           image-based-light paths, from each scene's own parameters toward
           a flat 0.25: seconds, peak memory, the largest leaf difference,
           sp_closest launched on every path and sp_anyhit exactly where
           there is NEE
  geom     the bench scene as a BVH forest of 4 shards on the card
           (parallel/geom_shard.py: both kernels once a shard and query,
           then the combine): forest build cold and warm through the cache;
           the flagship full frame at 1 spp through one BVH, then through
           the forest (A B), the forest's frame against the
           one-BVH frame (max abs diff < 1e-4), its launches and peak memory;
           the forest's kernels vs plain versions at 128x128
  lucy     the lucy-class stress scene at its full size: scenes/lucy_bench.sp
           (1350x2000, depth 10) over a 28,895,202-triangle terrain
           (io/meshgen.displaced_grid(3802), written by
           io/meshgen.write_terrain into chip_smoke_out/lucy/), built
           cold and warm (rows, bytes, leaf occupancy, depth and the stack
           slots it needs, host peak memory); both kernels against their
           plain versions on the kernels phase's five ray sets built from
           lucy's scene (incoherent reach scaled by its size over the
           bench's; the deepest bounce reached stands in for one the chunk
           never reached, named so), at the kernels phase's gates and beside
           the bench's readings; sp_closest_count on its primary and
           incoherent rays (counts equal to the plain version's); the full
           frame at 1 spp (42 chunks, the last padded); a 128x128 render
           through the kernels bit-equal to the plain-version render; the
           full frame through a forest of 4, built once without the cache
           (the geom phase holds its cache path), held to the
           one-BVH frame at the lucy gate (< 1 % of pixels off by > 1e-3,
           means within 1 %); each step's seconds
  ranks    two processes on the one card, joined over gloo (NCCL takes one
           GPU a rank; gloo stages the CUDA tensors of a collective through
           the host): the bench frame at 1 spp by render_image_multihost,
           each rank's frame equal to the one-process frame (timed after the
           same warm-up, in this process after the ranks, and in
           a fresh process as a world of one), launches per rank; two
           train_step_multihost calls on the train phase's 65,536 pixels
           (the albedo), the first's loss and albedo against the
           one-process step (rtol 1e-5 / atol 1e-5); then the multi-GPU
           path's entry points with their ranks sharing the card over gloo:
           entry.dryrun_multichip(4) (a train step, the 2 x 2 rays x
           geometry render and its gradient, each against one process), and
           the CLI as 2 ranks under torchrun (--dist-backend gloo): the cli
           phase's scene in passes with a checkpoint, the same render cut
           after its first pass and resumed by the 2 ranks, and
           tests/scenes/g_blob.sp as a forest of 2 (g_ibl_rrnee.sp has no
           triangle), rank 0's PFM equal to the one-process CLI's bit for
           bit and written once
  topology the kernels at the BVH topologies other than the default
           (SIMPLEPATH_BVH_WIDTH=16; SIMPLEPATH_BVH_LEAF=24; and, checked
           without the visit body or the frame in turns, the leaf layouts
           (W, K) = (8, 5), (8, 29), (16, 29)), each in a fresh process,
           since the knobs are read at import, one at a time on the card
           while the next one starts up: the bench loaded
           and that topology's library built, registers and spills of every
           kernel in it from ptxas; both kernels against their
           plain versions on the kernels phase's five ray sets (times, rows
           visited, the bound from W and K); a 128x128 flagship render
           through the kernels bit-equal to the plain-version render; the
           1024x1024 flagship frame at 1 spp under the render phase's key
           within max abs diff 1e-4 of the default topology's frame, its
           seconds timed in turns with the default topology's (processes in
           the order default, W=16, K=24, default) and its
           launches of each kernel; the visit-body probe's four modes at W=16
           and K=24 (the probes phase's readings)

Each phase's seconds follow it on a line of their own, with what the host
took to enqueue one tiny kernel, and the live Python objects, just before
the phase.  A failed phase ends
the run: its traceback goes to stderr, the last line is {"ok": false, ...}
and the exit code is 1.  Without a CUDA device the script exits non-zero
before printing any result.  The last line of a run that passes is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SCENE = os.path.join(HERE, "scenes", "bunny_bench.sp")
OUT_DIR = os.path.join(HERE, "chip_smoke_out")
IBL_TEST_SCENE = os.path.join(HERE, "tests", "scenes", "g_ibl_rrnee.sp")
PHASES = ("device", "build", "kernels", "probes", "render", "paths", "parity",
          "cli", "golden", "train", "geom", "lucy", "ranks", "topology")
# the traced integrators besides the flagship, and whether each has NEE
# (next-event estimation: shadow rays through sp_anyhit)
PATHS = {"direct_lighting": True, "brute_force": False,
         "brute_force_iterative": False, "brute_force_iterative_rr": False,
         "brute_force_iterative_dynamic_rr": False, "whitted": True}
IBL_PATHS = {"iterative_rrnee": True, "direct_lighting": True}
IBL_SHAPE = (1024, 2048)

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Arithmetic of one triangle test, counted from csrc/traverse.cu: 44
# mul/add/sub, one divide and 8 compares (visit_costs: the rest).
FLOPS_TRIANGLE_TEST = 53
BOUNCES = (0, 2, 5)
TPU_KERNEL = {"closest": "simplepath_tpu/render/pallas_traverse.py:466",
              "anyhit": "simplepath_tpu/render/pallas_traverse.py:503",
              "closest_count": "tools/prof_visits.py:88, tools/prof_npush.py:97",
              "row_chase": "tools/prof_visits.py:127, tools/prof_dma_chains.py:42",
              "visit_body": "tools/prof_visit_vpu.py:97"}
PROBES = ("closest_count", "row_chase", "visit_body")
# the TPU probes' sizes: hops of a chase, bodies of a visit-body run
PROBE_HOPS = 20_000
PROBE_BODIES = 100_000
# the chase's check on a cycle table of L2's size (2 MiB): once round the
# cycle and a third of it again, so every chain ends away from its start
CYCLE_CHECK_ROWS = 4_096
CYCLE_CHECK_HOPS = CYCLE_CHECK_ROWS + CYCLE_CHECK_ROWS // 3
# bodies where the visit body is held against its plain version, and where
# the two are timed side by side (the plain version loops in Python)
CHECK_BODIES = 3
PLAIN_BODIES = 1_000
BODY_SEED = 1.0             # rows 0 and 1, the TPU probe's first call


def visit_costs() -> tuple:
    """What one visit costs at this process's BVH topology (W, K), counted
    from csrc/traverse.cu: (operations of an internal row: W slab tests of
    6 sub, 6 mul, 12 min/max and 3 compares, plus the compare-exchanges of
    the W-key sorting network; bytes an internal visit's loads ask for: the
    7 fields of W children; bytes a leaf visit's ask for: 16 B of meta and
    the 9 fields of all K triangle slots, whatever the leaf's count)."""
    from simplepath_tpu_torch.render.cuda_traverse import batcher_pairs
    from simplepath_tpu_torch.scene.bvh import LEAF_SIZE, WIDTH
    return 27 * WIDTH + len(batcher_pairs(WIDTH)), 28 * WIDTH, 16 + 36 * LEAF_SIZE


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def host_launch_us(n: int = 2000) -> float:
    """Host microseconds to enqueue one tiny kernel, the card idle: what a
    PyTorch op costs the launch-bound bounce loop at this point of the
    run."""
    x = torch.zeros(1, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# Cycles the card spins before a timed run of launches (~10 ms): the host
# queues them all meanwhile, so the events bracket device time only.  A
# kernel of 30 us is shorter than its wrapper's time on the host.
RUN_AHEAD_CYCLES = 20_000_000
RUN_AHEAD_TRIES = 4


def time_cuda(fn, reps: int, run_ahead: bool = True) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls (CUDA events).
    With ``run_ahead`` the calls must not wait for the device, and the card
    spins while the host queues them; if the spin ended before the host was
    done, the events would hold host time, so the run is made again with
    twice the spin, and raises after RUN_AHEAD_TRIES.  A function that
    synchronises is timed with ``run_ahead=False``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spun = torch.cuda.Event()
    for attempt in range(RUN_AHEAD_TRIES if run_ahead else 1):
        torch.cuda.synchronize()
        if run_ahead:
            torch.cuda._sleep(RUN_AHEAD_CYCLES << attempt)
        spun.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not (run_ahead and spun.query())
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps
    raise RuntimeError(
        f"the host did not queue {reps} launches while the card spun "
        f"{RUN_AHEAD_CYCLES << (RUN_AHEAD_TRIES - 1)} cycles: the events "
        "would include host time")


def l2_read_rate(device) -> float:
    """Bytes/s of a read-only pass over a 16 MB tensor that stays in L2 (a
    library reduction, repeated): the yardstick for the kernels' row
    traffic."""
    x = torch.ones(4 << 20, dtype=torch.float32, device=device)
    x.sum()
    ms = time_cuda(lambda: x.sum(), 200)
    return x.numel() * 4 / (ms * 1e-3)


# ------------------------------------------------------------------ rays

def primary_rays(scene, side: int = 256):
    """side*side camera rays through a regular grid over the whole frame."""
    from simplepath_tpu_torch.render.camera import generate_ray
    dev = scene.device
    st = scene.static
    g = (torch.arange(side, device=dev, dtype=torch.float32) + 0.5)
    ys, xs = torch.meshgrid(g * (st.height / side), g * (st.width / side),
                            indexing="ij")
    ro, rd = generate_ray(scene.camera, xs.reshape(-1), ys.reshape(-1))
    n = ro.shape[0]
    t_min = torch.full((n,), 1e-3, device=dev)
    t_max = torch.full((n,), float("inf"), device=dev)
    return ro.contiguous(), rd.contiguous(), t_min, t_max


def incoherent_rays(scene, n: int = 65499, seed: int = 7, reach: float = 1.0):
    """Seeded bounce-like rays: origins on the surfaces the primary rays hit
    (drawn with replacement, so in no spatial order), uniform directions;
    ~10 % dead lanes (t_max = -inf), the rest of finite or infinite reach
    (finite: 0.5-4.5 bench units times ``reach``, which scales them to
    another scene's size; reach_of); N is deliberately not a multiple of
    32."""
    from simplepath_tpu_torch.render.traverse import scene_intersect_batch
    ro, rd, t_min, t_max = primary_rays(scene)
    hit = scene_intersect_batch(scene, ro, rd, t_min, t_max)
    points = (ro + hit.t[:, None] * rd)[hit.valid].cpu().numpy()
    rs = np.random.RandomState(seed)
    origin = points[rs.randint(0, points.shape[0], n)].astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    direction = d / np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(n, 1e-3, np.float32)
    t_max = np.where(rs.rand(n) < 0.5, np.inf,
                     (0.5 + 4.0 * rs.rand(n)) * reach).astype(np.float32)
    t_max[rs.rand(n) < 0.1] = -np.inf
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(scene.device)
    return to(origin), to(direction), to(t_min), to(t_max)


def uniform_rays(n: int, seed: int, device):
    """The TPU probes' incoherent rays (tools/prof_visits.py:151-154), made
    with numpy from a seed: origins uniform in [-3, 3]^3, directions uniform
    on the sphere; t_min 1e-3, t_max inf."""
    rs = np.random.RandomState(seed)
    origin = rs.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    direction = d / np.linalg.norm(d, axis=1, keepdims=True)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    return (to(origin), to(direction), to(np.full(n, 1e-3)),
            to(np.full(n, np.inf)))


def scene_extent(scene) -> float:
    """The diagonal of the box around the scene's triangles."""
    tri = scene.triangles
    pts = torch.cat([tri._stack(name) for name in ("v0", "v1", "v2")])
    return float((pts.amax(dim=0) - pts.amin(dim=0)).norm())


def reach_of(scene, bench) -> float:
    """incoherent_rays' ``reach`` for ``scene``: its size over the bench's,
    so that its finite rays end as far into it as the bench's do."""
    return scene_extent(scene) / scene_extent(bench)


def middle_run(width: int, height: int, n: int = 65536) -> tuple:
    """The ``n`` linear pixel indices (row-major, as render_image_sharded
    chunks a frame) around the middle of a width x height frame → (start,
    stop); on the bench's 1024x1024, rows 480-543."""
    start = max(width * height // 2 - n // 2, 0)
    return start, min(start + n, width * height)


def bounce_rays(scene, stand_in: bool = False) -> tuple:
    """The integrator's own wavefronts: render one chunk (middle_run of the
    frame: 65,536 rays, 1 spp) with the two wrappers wrapped here so that
    the inputs of their calls of bounces BOUNCES are kept.  One render at 1
    spp calls each wrapper once a bounce.  A bounce the chunk did not reach
    (its paths all ended before it) raises; with ``stand_in`` the deepest
    bounce reached takes its place, named ``bounce{k}_deepest``.  Returns
    ({"closest": {case: rays}, "anyhit": {case: rays}}, {kernel: calls})."""
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.render import cuda_traverse as ct

    kept = {"closest": {}, "anyhit": {}}
    last = {}
    calls = {"closest": 0, "anyhit": 0}
    originals = {name: getattr(ct, name) for name in kept}

    def keeping(name):
        def wrapped(records, ro, rd, t_min, t_max):
            rays = tuple(x.clone() for x in (ro, rd, t_min, t_max))
            if calls[name] in BOUNCES:
                kept[name][f"bounce{calls[name]}"] = rays
            last[name] = (calls[name], rays)
            calls[name] += 1
            return originals[name](records, ro, rd, t_min, t_max)
        return wrapped

    for name in kept:
        setattr(ct, name, keeping(name))
    try:
        st = scene.static
        lin = torch.arange(*middle_run(st.width, st.height), device=scene.device)
        sp.render_rays(scene, lin % st.width, lin // st.width, 1, prng_key(1),
                       device=scene.device)
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(ct, name, fn)
    for name, cases in kept.items():
        if len(cases) == len(BOUNCES):
            continue
        if not stand_in or name not in last:
            raise AssertionError(f"the chunk render called {name} "
                                 f"{calls[name]} times; bounces {BOUNCES} "
                                 "were not all reached")
        deepest, rays = last[name]
        if deepest not in BOUNCES:
            cases[f"bounce{deepest}_deepest"] = rays
    return kept, calls


def lane_step_share(visits: torch.Tensor, rays_per_warp: int) -> float:
    """Share of a warp's lane-steps that do a ray's own visit when
    ``rays_per_warp`` neighbouring rays walk in lock step and the warp runs
    as long as its slowest ray: sum(visits) / sum(group size * group max)."""
    pad = -visits.numel() % rays_per_warp
    v = torch.nn.functional.pad(visits, (0, pad)).reshape(-1, rays_per_warp)
    paid = int(v.max(dim=1).values.sum()) * rays_per_warp
    return int(visits.sum()) / paid if paid else 1.0


# --------------------------------------------------------------- phases

def phase_device() -> dict:
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return {"nvidia_smi": smi}


def phase_build() -> None:
    from simplepath_tpu_torch import native
    from simplepath_tpu_torch.render import cuda_traverse as ct
    t0 = time.time()
    lib = ct.build_library(verbose=True)
    kernel_s = time.time() - t0
    t0 = time.time()
    have_native = native.get_lib() is not None
    native_s = time.time() - t0
    ct._library()  # load and bind; raises if the library does not load
    emit("build", kernel_library=os.path.relpath(lib, HERE),
         kernel_build_s=kernel_s, native_bvh_builder=have_native,
         native_build_s=native_s)


def compare_case(kernel: str, case: str, records, rays) -> dict:
    """One kernel on one ray set: mismatches against the plain version on
    the card, times, and the work this ray set needs."""
    from simplepath_tpu_torch.render import cuda_traverse as ct
    ro, rd, t_min, t_max = rays
    n = ro.shape[0]
    fn = ct.closest if kernel == "closest" else ct.anyhit
    plain = ct.closest_plain if kernel == "closest" else ct.anyhit_plain

    # on the CPU (a rehearsal) the wrapper runs the plain version, and
    # there is no device time to take
    cuda = records.is_cuda
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = fn(records, ro, rd, t_min, t_max)      # warm-up launch
    sync()                                       # surfaces a fault in the run
    stats: dict = {}
    ref = plain(records, ro, rd, t_min, t_max, stats=stats)
    sync()

    res = {"kernel": kernel, "case": case, "n": n}
    if kernel == "closest":
        t, idx, beta, gamma, valid = out
        rt, ridx, rbeta, rgamma, rvalid = ref
        res["valid_mismatches"] = int((valid != rvalid).sum())
        res["idx_mismatches"] = int((idx != ridx).sum())
        h = rvalid & valid
        close = lambda a, b, rtol, atol: int(
            (~torch.isclose(a[h], b[h], rtol=rtol, atol=atol)).sum())
        res["t_mismatches"] = close(t, rt, 1e-5, 1e-6)
        res["beta_mismatches"] = close(beta, rbeta, 1e-4, 1e-5)
        res["gamma_mismatches"] = close(gamma, rgamma, 1e-4, 1e-5)
        res["miss_t_not_inf"] = int((~torch.isinf(t[~valid])).sum())
        res["max_abs_err"] = float(torch.stack([
            (t[h] - rt[h]).abs().max(), (beta[h] - rbeta[h]).abs().max(),
            (gamma[h] - rgamma[h]).abs().max()]).max()) if bool(h.any()) else 0.0
        res["hits"] = int(valid.sum())
        out_bytes = n * (4 + 4 + 4 + 4 + 1)
    else:
        res["occ_mismatches"] = int((out != ref).sum())
        res["max_abs_err"] = float(res["occ_mismatches"] > 0)
        res["hits"] = int(out.sum())
        out_bytes = n
    bad = {k: v for k, v in res.items()
           if (k.endswith("_mismatches") or k == "miss_t_not_inf") and v}
    if bad:
        raise AssertionError(f"kernel {kernel} disagrees with its plain "
                             f"version on {case} rays: {bad}")

    res["kernel_ms"] = res["plain_ms"] = None
    if cuda:
        res["kernel_ms"] = time_cuda(lambda: fn(records, ro, rd, t_min, t_max),
                                     50)
        res["plain_ms"] = time_cuda(lambda: plain(records, ro, rd, t_min,
                                                  t_max), 1, run_ahead=False)

    # per-ray visit counts of the plain version, which walks the same rows:
    # how long the chains are, and what lock step costs when 32 rays share a
    # warp (one thread a ray) and when 32 / lanes_per_ray do
    # (a ray with an empty interval pops the root in the plain version and
    # walks nothing in the kernel: it counts no visit here)
    dead = t_max < t_min
    visits = stats.pop("ray_internal_visits") + stats.pop("ray_leaf_visits")
    visits = torch.where(dead, 0, visits)
    stats.pop("ray_internal_visits_by_push")
    rays_a_warp = 32 // ct.LANES_PER_RAY
    res.update(dead_rays=int(dead.sum()),
               visits_per_ray_mean=float(visits.float().mean()),
               visits_per_ray_max=int(visits.max()),
               lane_step_share_32_rays_a_warp=lane_step_share(visits, 32),
               **{f"lane_step_share_{rays_a_warp}_rays_a_warp":
                  lane_step_share(visits, rays_a_warp)})

    work = traversal_work(stats, n, res["dead_rays"], out_bytes)
    res.update(stats, **work)
    return res


def traversal_work(stats: dict, n: int, dead_rays: int, out_bytes: int) -> dict:
    """The least this run's rays ask of the card, from a plain traversal's
    ``stats`` (the row masks are taken out of it).  Bytes: each table row
    that a live ray visits is read once, at what a visit of its kind reads,
    the rays once, the results written once.  Operations: every visit's
    arithmetic.  The root pops of dead rays count in neither."""
    internal_ops, internal_bytes, leaf_bytes = visit_costs()
    internal_visits = stats["internal_visits"] - dead_rays
    distinct_internal = int(stats.pop("internal_rows_visited").sum())
    distinct_leaf = int(stats.pop("leaf_rows_visited").sum())
    table_bytes = distinct_internal * internal_bytes + distinct_leaf * leaf_bytes
    in_bytes = table_bytes + n * (3 + 3 + 1 + 1) * 4
    flops = (internal_visits * internal_ops
             + stats["triangle_tests"] * FLOPS_TRIANGLE_TEST)
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    return dict(rows_visited=internal_visits + stats["leaf_visits"],
                distinct_internal_rows=distinct_internal,
                distinct_leaf_rows=distinct_leaf, table_bytes=table_bytes,
                row_bytes=internal_visits * internal_bytes
                + stats["leaf_visits"] * leaf_bytes,
                min_bytes=in_bytes + out_bytes, flops=flops,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def kernel_ray_sets(scene, reach: float = 1.0, stand_in: bool = False) -> tuple:
    """Each kernel's five ray sets, and each wrapper's calls in the chunk
    of bounce_rays → ({"closest": {case: rays}, "anyhit": ...}, {kernel:
    calls}); ``reach`` is incoherent_rays', ``stand_in`` bounce_rays'."""
    shared = {"primary": primary_rays(scene),
              "incoherent": incoherent_rays(scene, reach=reach)}
    bounces, calls = bounce_rays(scene, stand_in)
    return {kernel: {**shared, **bounces[kernel]} for kernel in bounces}, calls


def phase_kernels(scene, sets: dict) -> dict:
    """Both kernels on their ray sets (kernel_ray_sets)."""
    dev = scene.device
    records = scene.bvh.records
    l2_rate = l2_read_rate(dev)
    results = {}
    for kernel in ("closest", "anyhit"):
        for case, rays in sets[kernel].items():
            res = compare_case(kernel, case, records, rays)
            res["l2_read_GBps_measured"] = l2_rate / 1e9
            res["row_traffic_ms"] = res["row_bytes"] / l2_rate * 1e3
            res["row_GBps_achieved"] = (res["row_bytes"]
                                        / (res["kernel_ms"] * 1e-3) / 1e9)
            emit("kernels", **res)
            results[(kernel, case)] = res
    return results


def one_ray_forms(scene, n: int = 16) -> dict:
    """``scene_intersect`` / ``scene_intersect_p``, the one-ray forms, on
    ``n`` of the primary rays, spread over the frame: each call launches its
    kernel once (N = 1), and each answer is the batch form's for that ray
    through the plain versions (valid, kind, idx and occlusion exact; t,
    beta, gamma at compare_case's tolerances)."""
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.render import traverse as tr
    rays = [a[::a.shape[0] // n][:n] for a in primary_rays(scene)]
    with ct.plain_versions():
        ref = tr.scene_intersect_batch(scene, *rays)
        ref_p = tr.scene_intersect_p_batch(scene, *rays)
    ct.reset_launch_counts()
    hits = [tr.scene_intersect(scene, *(a[i] for a in rays)) for i in range(n)]
    occluded = torch.stack([tr.scene_intersect_p(scene, *(a[i] for a in rays))
                            for i in range(n)])
    torch.cuda.synchronize()
    launches = dict(ct.launch_counts)
    out = tr.Hit(*(torch.stack(f) for f in zip(*hits)))
    v = ref.valid
    res = dict(check="one_ray_forms", n=n, launches=launches,
               hits=int(v.sum()), occluded=int(ref_p.sum()),
               valid_mismatches=int((out.valid != v).sum()),
               kind_mismatches=int((out.kind[v] != ref.kind[v]).sum()),
               idx_mismatches=int((out.idx[v] != ref.idx[v]).sum()),
               occ_mismatches=int((occluded != ref_p).sum()))
    for f, rtol, atol in (("t", 1e-5, 1e-6), ("beta", 1e-4, 1e-5),
                          ("gamma", 1e-4, 1e-5)):
        a, b = getattr(out, f)[v], getattr(ref, f)[v]
        res[f"{f}_mismatches"] = int((~torch.isclose(a, b, rtol=rtol, atol=atol)).sum())
    emit("kernels", **res)
    bad = {k: x for k, x in res.items() if k.endswith("_mismatches") and x}
    if bad or launches["closest"] != n or launches["anyhit"] != n or not res["hits"]:
        raise AssertionError(f"the one-ray forms: {res}")
    return launches


# --------------------------------------------------------------- probes

def visit_readings(internal, leaf, by_push, lanes_per_ray: int) -> dict:
    """What the counting kernel reads off the traversal: visits a ray (a
    ray with an empty interval counts 0, as in compare_case), visits a warp
    (the most of its 32 / lanes_per_ray rays: a warp runs as long as its
    slowest ray), the lock-step share, and the shares of internal visits by
    n_push (0, 1, 2, >= 3)."""
    visits = (internal + leaf).to(torch.int64)
    rays_a_warp = 32 // lanes_per_ray
    pad = -visits.numel() % rays_a_warp
    per_warp = torch.nn.functional.pad(visits, (0, pad)).reshape(
        -1, rays_a_warp).max(dim=1).values
    pushes = by_push.to(torch.int64).sum(dim=0)
    total = int(pushes.sum())
    return dict(rays_a_warp=rays_a_warp,
                visits_per_ray_mean=float(visits.float().mean()),
                visits_per_ray_max=int(visits.max()),
                internal_per_ray_mean=float(internal.float().mean()),
                leaf_per_ray_mean=float(leaf.float().mean()),
                visits_per_warp_mean=float(per_warp.float().mean()),
                visits_per_warp_max=int(per_warp.max()),
                lock_step_share=lane_step_share(visits, rays_a_warp),
                internal_visits=total,
                n_push_shares=[int(x) / total if total else 0.0
                               for x in pushes.tolist()])


def probe_counts(records, case: str, rays) -> dict:
    """sp_closest_count on one ray set: counts equal to its plain version's,
    hits bit-equal to sp_closest's; device ms in turns with sp_closest's."""
    from simplepath_tpu_torch.render import cuda_probes as cp
    from simplepath_tpu_torch.render import cuda_traverse as ct
    ro, rd, t_min, t_max = rays
    n = ro.shape[0]
    out = cp.closest_count(records, *rays)
    hits = ct.closest(records, *rays)
    torch.cuda.synchronize()
    stats: dict = {}
    ref = cp.closest_count_plain(records, *rays, stats=stats)
    names = ("t", "idx", "beta", "gamma", "valid", "internal", "leaf", "by_push")
    bad = {f"{k}_vs_sp_closest": int((a != b).sum())
           for k, a, b in zip(names, out, hits) if not torch.equal(a, b)}
    bad.update({f"{k}_vs_plain": int((a != b).sum())
                for k, a, b in zip(names[4:], out[4:], ref[4:])
                if not torch.equal(a, b)})
    h = out[4]
    if not torch.equal(out[1][h], ref[1][h]):
        bad["idx_vs_plain"] = int((out[1][h] != ref[1][h]).sum())
    errs = [(a[h] - b[h]).abs() for a, b in zip(
        (out[0], out[2], out[3]), (ref[0], ref[2], ref[3]))]
    max_err = float(torch.cat(errs).max()) if bool(h.any()) else 0.0
    if not torch.allclose(out[0][h], ref[0][h], rtol=1e-5, atol=1e-6):
        bad["t_vs_plain"] = max_err
    if bad:
        raise AssertionError(f"sp_closest_count disagrees on {case} rays: {bad}")

    turns = {"closest": [], "closest_count": []}
    launch = {"closest": lambda: ct.closest(records, *rays),
              "closest_count": lambda: cp.closest_count(records, *rays)}
    for r in range(4):                   # A B B A B A A B
        for name in (("closest", "closest_count") if r in (0, 3)
                     else ("closest_count", "closest")):
            turns[name].append(time_cuda(launch[name], 50))
    plain_ms = time_cuda(lambda: cp.closest_count_plain(records, *rays), 1,
                         run_ahead=False)
    dead = t_max < t_min
    work = traversal_work(stats, n, int(dead.sum()), n * (17 + 24))
    kernel_ms, closest_ms = min(turns["closest_count"]), min(turns["closest"])
    return dict(kernel="closest_count", case=case, n=n,
                dead_rays=int(dead.sum()), hits=int(h.sum()),
                max_abs_err=max_err, kernel_ms=kernel_ms,
                closest_ms_in_turns=closest_ms,
                kernel_ms_turns=turns["closest_count"],
                closest_ms_turns=turns["closest"],
                counting_cost=kernel_ms / closest_ms - 1.0, plain_ms=plain_ms,
                bound_ms=work["bound_ms"], bound_by=work["bound_by"],
                **visit_readings(*out[5:], ct.LANES_PER_RAY))


def chase_readings(table, name: str, hops: int, turns: tuple, flush=None,
                   plain_ms: bool = False) -> list:
    """sp_row_chase on one table under both feeds at every chain count:
    each feed's refs equal to one plain run's (at the most chains, whose
    first C refs are the C-chain chase's), then device ms with the feeds
    timed in the order ``turns`` (the least of each feed's; no time where
    ``turns`` is empty).  ``flush`` (a tensor of several L2s) is zeroed
    before each timed launch, and each launch is timed alone, so that no
    row of the last launch is still cached; without it the launches run
    back to back, warm.  Bound: the distinct rows' bytes (a copy is
    LEAF_ROWS rows) and one compare a hop; latency, not either, sets its
    time.  With ``plain_ms``, the plain version's ms at one chain (on the
    C=1 readings)."""
    from simplepath_tpu_torch.render import cuda_probes as cp
    from simplepath_tpu_torch.scene.bvh import LEAF_ROWS
    ref, visited = cp.row_chase_plain(table, max(cp.CHAINS), hops,
                                      visited=True)
    plain = (time_cuda(lambda: cp.row_chase_plain(table, 1, hops), 1,
                       run_ahead=False) if plain_ms else None)
    out = []
    for chains in cp.CHAINS:
        launch = {feed: (lambda f=feed: cp.row_chase(table, chains, hops, feed=f))
                  for feed in cp.FEEDS}
        for feed in cp.FEEDS:
            got = launch[feed]()
            torch.cuda.synchronize()
            if not torch.equal(got, ref[:chains]):
                raise AssertionError(
                    f"sp_row_chase ({feed}) at {chains} chains on the {name} "
                    f"table gives {got.tolist()}, its plain version "
                    f"{ref[:chains].tolist()}")
        times = {feed: [] for feed in cp.FEEDS}
        for feed in turns:
            times[feed].append(time_cold(launch[feed], 3, flush) if flush is not None
                               else time_cuda(launch[feed], 5))
        rows = int(torch.unique(visited[:, :chains]).numel())
        bytes_ms = (rows * LEAF_ROWS * 512 + 4 * chains) / HBM_BYTES_PER_S * 1e3
        ops_ms = hops * chains / FP32_FLOPS * 1e3
        for feed in cp.FEEDS:
            ms = min(times[feed], default=None)
            out.append(dict(kernel="row_chase", feed=feed, table=name,
                            table_bytes=table.numel() * 4, cold=flush is not None,
                            chains=chains, hops=hops, refs=ref[:chains].tolist(),
                            distinct_rows=rows, kernel_ms=ms,
                            kernel_ms_turns=times[feed],
                            ns_per_hop=None if ms is None else ms * 1e6 / hops,
                            ns_per_hop_per_chain=(None if ms is None else
                                                  ms * 1e6 / (hops * chains)),
                            plain_ms=plain if chains == 1 else None,
                            bound_ms=max(bytes_ms, ops_ms),
                            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                            max_abs_err=0.0))
    return out


def time_cold(fn, reps: int, flush) -> float:
    """Milliseconds per call of ``fn``, each call timed alone right after
    ``flush`` is zeroed (CUDA events around the call only; the zeroing
    keeps the card busy while the host queues the call)."""
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def probe_chase(records, hops: int = PROBE_HOPS) -> list:
    """sp_row_chase under both feeds at each chain count: on the bench's
    table (the left spine, cached) refs equal to the plain version's and
    each feed timed once; on cuda_probes.cycle_table's L2-sized table at
    CYCLE_CHECK_HOPS (it wraps and ends mid-lap, so every hop's row differs
    from the last and no chain ends at its start) refs equal, untimed.  The
    feeds in turns and the tables past L2 are tools/torch_prof_dma_chains.py's."""
    from simplepath_tpu_torch.render import cuda_probes as cp
    cycle = cp.cycle_table(CYCLE_CHECK_ROWS, device=records.device)
    checked = chase_readings(cycle, f"cycle_{CYCLE_CHECK_ROWS}",
                             CYCLE_CHECK_HOPS, turns=())
    ends = checked[-1]["refs"]
    if any(ref == 1 + c for c, ref in enumerate(ends)):
        raise AssertionError(f"the cycle table's chains end at {ends}: a "
                             "chain back at its start checks no hop")
    return chase_readings(records, "bench", hops, turns=cp.FEEDS,
                          plain_ms=True) + checked


def body_ops(mode: str) -> int:
    """Operations of one visit body of ``mode`` for one ray, counted from
    csrc/traverse.cu: a slab test is 6 sub, 6 mul, 12 min/max and 3
    compares (27; 24 without the compares), the network its pairs, a
    triangle test FLOPS_TRIANGLE_TEST."""
    from simplepath_tpu_torch.render.cuda_traverse import batcher_pairs
    from simplepath_tpu_torch.scene.bvh import LEAF_SIZE, WIDTH
    pairs = len(batcher_pairs(WIDTH))
    return {"internal": 27 * WIDTH + pairs, "internal_norel": 24 * WIDTH,
            "sort_only": pairs, "leaf": FLOPS_TRIANGLE_TEST * LEAF_SIZE}[mode]


def body_tables(records) -> dict:
    """The tables the visit body runs on, each with its seed: the bench's at
    BODY_SEED (the fixed ray misses every row of the bench's table: each
    child of row 0, and row 1 read as a leaf), and cuda_probes.crossed_table
    without and with a tie, whose rows the ray crosses."""
    from simplepath_tpu_torch.render import cuda_probes as cp
    dev = records.device
    return {"bench": (records, BODY_SEED),
            "crossed": (cp.crossed_table(tie=False, device=dev), 1.0),
            "crossed_tie": (cp.crossed_table(tie=True, device=dev), 1.0)}


def nan_equal(a, b) -> bool:
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def check_visit_body(records, seed: float, mode: str, n: int, table: str) -> str:
    """sp_visit_body's output, and its check launch's output and lanes (what
    each lane holds after the last body: keys, refs, near / far, slots),
    after 1 and CHECK_BODIES bodies, NaN-equal to the plain version's;
    returns the output."""
    from simplepath_tpu_torch.render import cuda_probes as cp
    for bodies in (1, CHECK_BODIES):
        out = cp.visit_body(records, seed, mode, bodies, n)
        got, lanes = cp.visit_body_lanes(records, seed, mode, bodies, n)
        torch.cuda.synchronize()
        ref, ref_lanes = cp.visit_body_lanes_plain(records, seed, mode,
                                                   bodies, n)
        for what, a, b in (("output", out, ref), ("check output", got, ref),
                           ("lanes", lanes, ref_lanes)):
            if not nan_equal(a, b):
                raise AssertionError(
                    f"sp_visit_body {mode} on the {table} table, {n} rays, "
                    f"{bodies} bodies: its {what} {a[0].tolist()}, the plain "
                    f"version's {b[0].tolist()}")
    return str(float(out[0]))


def probe_visit_body(records, bodies: int = PROBE_BODIES) -> list:
    """sp_visit_body in each mode on each of body_tables, checked against
    its plain version (check_visit_body) in three launch shapes: one warp
    (32 / W rays: the latency of a body), one full wave at the body's own
    occupancy (the throughput of bodies) and one at sp_closest's occupancy
    where the body's allows it.  ns a body at ``bodies`` on the bench's and
    the tieless crossed table; the plain version timed on the bench's full
    wave at PLAIN_BODIES."""
    from simplepath_tpu_torch.render import cuda_probes as cp
    from simplepath_tpu_torch.render import cuda_traverse as ct
    sms = torch.cuda.get_device_properties(records.device).multi_processor_count
    rays_a_block = 128 // ct.LANES_PER_RAY
    traversal_blocks = cp.closest_blocks_per_sm()
    out = []
    for table, (rec, seed) in body_tables(records).items():
        for mode in cp.BODY_MODES:
            blocks = cp.body_blocks_per_sm(mode)
            shapes = {"one_warp": 32 // ct.LANES_PER_RAY,
                      "every_sm": sms * blocks * rays_a_block,
                      "traversal_occupancy": sms * rays_a_block
                      * min(blocks, traversal_blocks)}
            for shape, n in shapes.items():
                output = check_visit_body(rec, seed, mode, n, table)
                if table == "crossed_tie":      # checked only
                    continue
                ms = time_cuda(lambda: cp.visit_body(rec, seed, mode, bodies,
                                                     n), 3)
                res = dict(kernel="visit_body", table=table, mode=mode,
                           shape=shape, rays=n, blocks_per_sm=blocks,
                           closest_blocks_per_sm=traversal_blocks,
                           bodies=bodies, output=output, kernel_ms=ms,
                           ns_per_body=ms * 1e6 / bodies,
                           ns_per_ray_body=ms * 1e6 / (bodies * n),
                           bodies_per_s=bodies * n / (ms * 1e-3),
                           ops_per_body=body_ops(mode),
                           bound_ms=bodies * n * body_ops(mode) / FP32_FLOPS * 1e3,
                           bound_by="operations", max_abs_err=0.0)
                if table == "bench" and shape == "every_sm":
                    res["kernel_ms_at_plain_bodies"] = time_cuda(
                        lambda: cp.visit_body(rec, seed, mode, PLAIN_BODIES,
                                              n), 5)
                    res["plain_ms_at_plain_bodies"] = time_cuda(
                        lambda: cp.visit_body_plain(rec, seed, mode,
                                                    PLAIN_BODIES, n),
                        1, run_ahead=False)
                    res["bound_ms_at_plain_bodies"] = (
                        res["bound_ms"] * PLAIN_BODIES / bodies)
                out.append(res)
    return out


def phase_probes(scene, sets: dict) -> dict:
    """The three measuring kernels against their plain versions, with their
    readings (the counting kernel on sp_closest's ray sets); their launches
    in this phase."""
    from simplepath_tpu_torch.render import cuda_probes as cp
    records = scene.bvh.records
    cp.reset_launch_counts()
    res = {"closest_count": [probe_counts(records, case, rays)
                             for case, rays in sets["closest"].items()],
           "row_chase": probe_chase(records),
           "visit_body": probe_visit_body(records)}
    for cases in res.values():
        for case in cases:
            emit("probes", **case)
    res["launches"] = dict(cp.launch_counts)
    emit("probes", launches_in_this_phase=res["launches"])
    return res


def phase_render(scene, spp: int, load_s: float, builder: str | None,
                 geometry_cache: str | None) -> dict:
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.io.pfm import write_image
    from simplepath_tpu_torch.parallel.mesh import render_image_sharded
    from simplepath_tpu_torch.render.materials import build_rho_tables

    key = prng_key(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    img = render_image_sharded(scene, spp, key)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches = frame_launches("render")

    st = scene.static
    if tuple(img.shape) != (st.height, st.width, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("render has non-finite pixels")
    mean = float(img.mean())
    if not mean > 0:
        raise AssertionError(f"render mean {mean} is not positive")
    for name in ("closest", "anyhit"):
        if launches[name] <= 0:
            raise AssertionError(f"the render never launched kernel {name}")

    os.makedirs(OUT_DIR, exist_ok=True)
    out_path = os.path.join(OUT_DIR, st.output_file_name)
    write_image(out_path, img.cpu().numpy())
    paths = st.width * st.height * spp
    peak = torch.cuda.max_memory_allocated()
    emit("render", scene=os.path.relpath(SCENE, HERE), width=st.width,
         height=st.height, max_depth=st.max_depth, spp=spp,
         triangles=st.num_triangles, record_rows=int(scene.bvh.records.shape[0]),
         load_s=load_s, load="warm" if geometry_cache else "cold",
         geometry_cache=geometry_cache and os.path.relpath(geometry_cache, HERE),
         bvh_builder=None if geometry_cache else builder, render_s=render_s,
         camera_paths_per_s=paths / render_s, launches=launches,
         image_mean=mean, output=os.path.relpath(out_path, HERE),
         max_memory_allocated=peak,
         rho_table_launches_per_render_rays=cuda_launches(
             lambda: build_rho_tables(scene.materials)))
    return launches


def write_ibl_map(path: str, seed: int = 0) -> None:
    """A 1024x2048 lat-long environment map from a seed: a sky gradient
    (bright toward the zenith, dark below the horizon), a small hot sun and
    seeded noise."""
    from simplepath_tpu_torch.io.pfm import write_pfm
    h, w = IBL_SHAPE
    rs = np.random.RandomState(seed)
    v = (np.arange(h, dtype=np.float32) + 0.5) / h          # 0 = zenith
    sky = np.stack([0.3 + 0.5 * (1 - v), 0.4 + 0.5 * (1 - v),
                    0.6 + 0.6 * (1 - v)], -1)
    sky[v > 0.5] *= 0.1                                      # the ground
    img = np.broadcast_to(sky[:, None, :], (h, w, 3)).copy()
    img *= 1.0 + 0.2 * rs.rand(h, w, 1)
    img[200:206, 700:709] = (800.0, 700.0, 500.0)            # the sun
    write_pfm(path, img.astype(np.float32))


def ibl_bench_scene():
    """The bench scene's text with an image-based environment light added;
    the map is written into OUT_DIR.  No file under scenes/ is touched."""
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.scene.parser import parse_sp
    os.makedirs(OUT_DIR, exist_ok=True)
    env_path = os.path.join(OUT_DIR, "bench_env.pfm")
    write_ibl_map(env_path)
    with open(SCENE) as f:
        text = f.read()
    text += ("\nenvironment_light {\n    rotate: 0.0 1.0 0.0 30.0\n"
             "    radiance: 1.0 1.0 1.0\n    max_radiance: 100\n"
             f"    image: \"{env_path}\"\n}}\n")
    t0 = time.time()
    scene = sp.build_scene(parse_sp(text, base_dir=os.path.dirname(SCENE)))
    torch.cuda.synchronize()
    h, w = IBL_SHAPE
    env = scene.env
    shapes = {"image": (h, w, 3), "cdf_cond_f": (2 * h, 2 * w),
              "cdf_cond": (2 * h, 2 * w + 1), "cdf_cond_int": (2 * h,),
              "cdf_marg_f": (2 * h,), "cdf_marg": (2 * h + 1,),
              "cdf_marg_int": ()}
    for field, shape in shapes.items():
        if tuple(getattr(env, field).shape) != shape:
            raise AssertionError(f"IBL table {field} has shape "
                                 f"{tuple(getattr(env, field).shape)}, not {shape}")
    return scene, time.time() - t0, shapes


def with_integrator(scene, name: str):
    return dataclasses.replace(
        scene, static=dataclasses.replace(scene.static, integrator=name))


def reset_launches() -> None:
    """Every kernel's launch count to 0: the traversal's and the probes'."""
    from simplepath_tpu_torch.render import cuda_probes as cp
    from simplepath_tpu_torch.render import cuda_traverse as ct
    ct.reset_launch_counts()
    cp.reset_launch_counts()


def frame_launches(path: str) -> dict:
    """Every kernel's launches since reset_launches; a frame launches no
    probe kernel."""
    from simplepath_tpu_torch.render import cuda_probes as cp
    from simplepath_tpu_torch.render import cuda_traverse as ct
    if any(cp.launch_counts.values()):
        raise AssertionError(f"{path}: the frame launched a probe kernel: "
                             f"{cp.launch_counts}")
    return {**ct.launch_counts, **cp.launch_counts}


def check_launches(path: str, launches: dict, nee: bool) -> None:
    """sp_closest on every traced path; sp_anyhit exactly where there is
    NEE."""
    if launches["closest"] <= 0:
        raise AssertionError(f"{path}: sp_closest was never launched")
    if nee and launches["anyhit"] <= 0:
        raise AssertionError(f"{path}: sp_anyhit was never launched")
    if not nee and launches["anyhit"] != 0:
        raise AssertionError(f"{path}: sp_anyhit launched "
                             f"{launches['anyhit']} times without NEE")


def render_path(path: str, scene, spp: int = 1) -> dict:
    """One full frame through render_image_sharded (see render_frame)."""
    return render_frame(path, scene, spp)[0]


def render_frame(path: str, scene, spp: int = 1, render=None) -> tuple:
    """One full frame through ``render`` (default render_image_sharded),
    the launch counts set to 0 just before it and read just after →
    (summary, image)."""
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel.mesh import render_image_sharded

    render = render or render_image_sharded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    img = render(scene, spp, prng_key(0))
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches = frame_launches(path)
    st = scene.static
    if tuple(img.shape) != (st.height, st.width, 3):
        raise AssertionError(f"{path}: image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{path}: non-finite pixels")
    mean = float(img.mean())
    if not mean > 0:
        raise AssertionError(f"{path}: image mean {mean} is not positive")
    return dict(path=path, integrator=st.integrator, width=st.width,
                height=st.height, max_depth=st.max_depth, spp=spp,
                render_s=render_s,
                camera_paths_per_s=st.width * st.height * spp / render_s,
                launches=launches, image_mean=mean,
                max_memory_allocated=torch.cuda.max_memory_allocated()), img


def cuda_launches(fn) -> int:
    """CUDA launches of one call of ``fn`` (after one warm-up call), counted
    with the profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def ibl_light_sample_launches(scene) -> int:
    """CUDA launches of one batched IBL light sample (the two dependent
    binary searches) on 65,536 lanes."""
    from simplepath_tpu_torch.render.lights import env_light_sample
    u = torch.rand((65536, 2), device=scene.device)
    return cuda_launches(
        lambda: env_light_sample(scene.env, scene.static.env_kind, u))


def phase_paths(scene, ibl) -> dict:
    """Every traced integrator besides the flagship on the bench frame, then
    the bench with an image-based light under rrnee and direct lighting."""
    by_path = {}
    for name, nee in PATHS.items():
        res = render_path(name, with_integrator(scene, name))
        check_launches(name, res["launches"], nee)
        emit("paths", **res)
        by_path[name] = res["launches"]
    ibl_scene, build_s, shapes = ibl
    per_sample = ibl_light_sample_launches(ibl_scene)
    for name, nee in IBL_PATHS.items():
        path = f"ibl_{name}"
        res = render_path(path, with_integrator(ibl_scene, name))
        check_launches(path, res["launches"], nee)
        emit("paths", **res, ibl_map=list(IBL_SHAPE), ibl_build_s=build_s,
             ibl_tables=shapes, ibl_launches_per_light_sample=per_sample)
        by_path[path] = res["launches"]
    return by_path


def shrink(scene, side: int):
    """The scene at side x side pixels (same camera, same geometry)."""
    wh = torch.tensor([side, side], dtype=torch.float32, device=scene.device)
    return dataclasses.replace(
        scene, static=dataclasses.replace(scene.static, width=side, height=side),
        camera=dataclasses.replace(scene.camera, wh=wh))


def parity_case(path: str, scene, side: int = 128, spp: int = 1) -> dict:
    """One render through the kernels and one with the plain versions
    forced, both on the card, same key: allclose at rtol 1e-4, atol 1e-5.
    Returns what it emitted."""
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel.mesh import render_image_sharded
    from simplepath_tpu_torch.render import cuda_traverse as ct

    small = shrink(scene, side)
    key = prng_key(3)
    ct.reset_launch_counts()
    a = render_image_sharded(small, spp, key)
    torch.cuda.synchronize()
    launches = dict(ct.launch_counts)
    t0 = time.time()
    with ct.plain_versions():
        b = render_image_sharded(small, spp, key)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    if dict(ct.launch_counts) != launches:
        raise AssertionError(f"{path}: the plain-version render launched a kernel")
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-5)
    res = dict(path=path, integrator=small.static.integrator, side=side,
               spp=spp, kernel_launches=launches, plain_render_s=plain_s,
               mismatched_values=int((~close).sum()),
               max_abs_diff=float((a - b).abs().max()),
               mean_kernels=float(a.mean()), mean_plain=float(b.mean()))
    emit("parity", **res)
    if not bool(close.all()) or not float(a.mean()) > 0:
        raise AssertionError(f"{path}: kernel render and plain-version "
                             "render differ")
    if launches["closest"] <= 0:
        raise AssertionError(f"{path}: the kernel render launched no sp_closest")
    return res


def dynamic_rr_buckets_filled(scene, side: int = 64, spp: int = 20) -> dict:
    """Adaptive RR at side x side, spp samples: the integrator is wrapped
    here to keep its statistics; how many (pixel, depth) buckets reached
    RR_MIN_SAMPLES observations, i.e. where RR could fire."""
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel.mesh import render_image_sharded
    from simplepath_tpu_torch.render import integrators as ti

    name = "brute_force_iterative_dynamic_rr"
    real = ti.INTEGRATOR_FNS[name]
    kept = {}

    def keeping(*args, **kw):
        L, kept["stats"] = real(*args, **kw)
        return L, kept["stats"]

    ti.INTEGRATOR_FNS[name] = keeping
    try:
        render_image_sharded(shrink(with_integrator(scene, name), side), spp,
                             prng_key(3))
    finally:
        ti.INTEGRATOR_FNS[name] = real
    count = kept["stats"][1]
    return {"buckets": int(count.numel()),
            "buckets_at_rr_min_samples": int((count >= ti.RR_MIN_SAMPLES).sum()),
            "max_count": int(count.max())}


def phase_parity(scene, ibl) -> None:
    """The flagship and every path of the paths phase at 128x128, 1 spp;
    adaptive RR at 64x64, 20 spp; Mandelbrot at 256x256, no launches."""
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel.mesh import render_image_sharded
    from simplepath_tpu_torch.render import cuda_traverse as ct

    parity_case("iterative_rrnee", scene)
    for name in PATHS:
        parity_case(name, with_integrator(scene, name))
    for name in IBL_PATHS:
        parity_case(f"ibl_{name}", with_integrator(ibl[0], name))

    # Russian roulette from depth 0, so that every pixel on geometry fills
    # its first bucket on every sample and RR acts from sample 17 on
    dyn = with_integrator(scene, "brute_force_iterative_dynamic_rr")
    dyn = dataclasses.replace(dyn, static=dataclasses.replace(
        dyn.static, russian_roulette_depth=0))
    parity_case("brute_force_iterative_dynamic_rr_20spp", dyn, side=64, spp=20)
    emit("parity", path="brute_force_iterative_dynamic_rr_20spp",
         side=64, spp=20, **dynamic_rr_buckets_filled(dyn))

    mandel = shrink(with_integrator(scene, "mandelbrot"), 256)
    ct.reset_launch_counts()
    t0 = time.time()
    img = render_image_sharded(mandel, 1, prng_key(3))
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches = dict(ct.launch_counts)
    emit("parity", path="mandelbrot", side=256, spp=1, render_s=render_s,
         kernel_launches=launches, image_mean=float(img.mean()))
    if any(launches.values()):
        raise AssertionError(f"mandelbrot launched traversal kernels: {launches}")
    if not bool(torch.isfinite(img).all()) or not float(img.mean()) > 0:
        raise AssertionError("mandelbrot image is not finite and positive")


def phase_cli() -> None:
    """The CLI end to end, in this process, on the card: an uninterrupted
    progressive render with a checkpoint, then a render cut after its first
    4-spp pass (its checkpoint holds 4 of 8 samples) that the CLI resumes.
    The two PFMs must be equal byte for byte."""
    from simplepath_tpu_torch import cli
    from simplepath_tpu_torch.utils import load_checkpoint

    out = os.path.join(OUT_DIR, "cli")
    os.makedirs(out, exist_ok=True)
    whole, cut = os.path.join(out, "whole.pfm"), os.path.join(out, "resumed.pfm")
    ck_whole, ck_cut = os.path.join(out, "ck.npz"), os.path.join(out, "ck_cut.npz")
    for f in (ck_whole, ck_cut):
        if os.path.exists(f):
            os.remove(f)
    args = [IBL_TEST_SCENE, "--samples", "8", "--spp-chunk", "4",
            "--no-progress"]
    t0 = time.time()
    if cli.main(args + ["--checkpoint", ck_whole, "--output", whole]) != 0:
        raise AssertionError("the CLI failed")
    cli_s = time.time() - t0
    cut_checkpoint(ck_cut)
    done_at_cut = load_checkpoint(ck_cut)[1]
    if done_at_cut != 4:
        raise AssertionError(f"the cut checkpoint holds {done_at_cut} samples")
    if cli.main(args + ["--checkpoint", ck_cut, "--output", cut]) != 0:
        raise AssertionError("the resuming CLI failed")
    with open(whole, "rb") as f:
        a = f.read()
    with open(cut, "rb") as f:
        b = f.read()
    emit("cli", scene=os.path.relpath(IBL_TEST_SCENE, HERE), samples=8,
         spp_chunk=4, cli_s=cli_s, samples_at_cut=done_at_cut,
         resumed_equals_whole=a == b, pfm_bytes=len(a))
    if a != b:
        raise AssertionError("the resumed film differs from the uninterrupted one")


def cut_checkpoint(path: str, scene: str = IBL_TEST_SCENE, spp: int = 8,
                   chunk: int = 4, device=None) -> None:
    """The CLI's progressive render of ``scene`` (by default the cli
    phase's: 8 spp in passes of 4) cut as its second pass starts: the
    checkpoint at ``path`` keeps the first pass's ``chunk`` samples."""
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel import mesh
    from simplepath_tpu_torch.render.film import render_image_progressive

    if os.path.exists(path):
        os.remove(path)
    real, passes = mesh.render_image_sharded, []

    def dying(*a, **kw):
        passes.append(kw["spp_offset"])
        if len(passes) == 2:
            raise KeyboardInterrupt("cut after the first pass")
        return real(*a, **kw)

    try:
        render_image_progressive(sp.load_scene(scene, device=device), spp,
                                 prng_key(0, device), chunk=chunk,
                                 checkpoint_path=path, checkpoint_every=chunk,
                                 render_fn=dying, device=device)
        raise AssertionError("the cut render was not cut")
    except KeyboardInterrupt:
        pass


# The golden tiers of tests/test_golden_parity.py: PFMs rendered by the C++
# reference binary, the port's render held to them statistically.  The gate
# math below mirrors that file and tools/headline_calibrate.py line for line;
# the golden tools import it from here.
GOLDEN = os.path.join(HERE, "tests", "golden")
GOLDEN_SCENES = os.path.join(HERE, "tests", "scenes")
GOLDEN_KEY = 17                 # the golden tests' render key
BLURRED_SPP_CAP = 32            # the blurred tier's spp (:43); the IBL scenes'
IBL_SPP_CAP = 128               # (:51): their 3x2-texel sun needs more
MESH_GOLDENS = ("g_blob", "g_combo_ibl", "g_mesh_ply", "g_mesh_stl")
# the scenes' bounce loops are host-bound, the card idle most of the time:
# four processes share it (the chip's host has 8 cores)
GOLDEN_WORKERS = 4
GOLDEN_TIMEOUT_S = 900


def box3(img):
    """3x3 box blur, edges repeated (test_golden_parity.py:33-41)."""
    p = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    out = np.zeros_like(img)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out += p[dy:dy + img.shape[0], dx:dx + img.shape[1]]
    return out / 9.0


def rel_err(ref, img, mean_ref: float | None = None):
    """Per-pixel error, channels averaged, over the reference's radiance
    floored at 5 % of ``mean_ref`` (default ``ref``'s own mean; the blurred
    tier passes the unblurred golden's) (test_golden_parity.py:148-151)."""
    if mean_ref is None:
        mean_ref = float(ref.mean())
    scale = np.maximum(ref.mean(axis=2), 0.05 * max(mean_ref, 1e-3))
    return np.abs(ref - img).mean(axis=2) / scale


def blurred_gates(ref, ours, integrator: str) -> dict:
    """test_golden's gates (test_golden_parity.py:64-81) → {metric: (value,
    gate, passed)}: for mandelbrot the share of pixels within 2e-3 (> 0.99),
    else the mean within 5 % and the blurred p90 relative error < 0.35."""
    if integrator == "mandelbrot":
        # escape-boundary pixels can flip an iteration under another fma
        # contraction
        close = float((np.abs(ours - ref).max(axis=2) < 2e-3).mean())
        return {"close_share": (close, 0.99, close > 0.99)}
    mean_ref, mean_ours = float(ref.mean()), float(ours.mean())
    rel_mean = abs(mean_ours - mean_ref) / max(mean_ref, 1e-6)
    p90 = float(np.percentile(rel_err(box3(ref), box3(ours), mean_ref), 90))
    return {"rel_mean": (rel_mean, 0.05, rel_mean < 0.05),
            "blur_p90": (p90, 0.35, p90 < 0.35)}


def matched_metrics(ref, img) -> dict:
    """The matched-spp comparison (test_golden_parity.py:107-115), as
    tools/calibrate_floors.py's floor_metrics takes it with ``ref`` as a."""
    mean_ref = float(ref.mean())
    rel_mean = abs(float(img.mean()) - mean_ref) / max(mean_ref, 1e-6)
    rel = rel_err(ref, img)
    return {"rel_mean": rel_mean, "p90": float(np.percentile(rel, 90)),
            "p99": float(np.percentile(rel, 99))}


def matched_gates(ref, img, floor: dict) -> dict:
    """test_golden_matched_spp's gates (test_golden_parity.py:107-117) →
    {metric: (value, gate, passed)}: the mean within max(0.005, 3x the
    floor's), p90 and p99 under 1.5x the floor's."""
    got = matched_metrics(ref, img)
    gate = {"rel_mean": max(0.005, 3 * floor["rel_mean"]),
            "p90": 1.5 * floor["p90"], "p99": 1.5 * floor["p99"]}
    return {k: (got[k], gate[k], got[k] < gate[k]) for k in gate}


def firefly_sym_p99(a, b, rel) -> tuple:
    """p99 of ``rel`` without the union of each image's brightest 0.05 %
    pixels → (p99, pixels left out) (tools/headline_calibrate.py:88-94)."""
    la, lb = a.mean(axis=2), b.mean(axis=2)
    keep = (la < np.quantile(la, 0.9995)) & (lb < np.quantile(lb, 0.9995))
    return float(np.percentile(rel[keep], 99)), int((~keep).sum())


def headline_metrics(a, b, label: str) -> dict:
    """tools/headline_calibrate.py's metrics (:73-100), ``a`` the reference
    side, ``b`` ours."""
    mean_a, mean_b = float(a.mean()), float(b.mean())
    rel = rel_err(a, b)
    ff_p99, excluded = firefly_sym_p99(a, b, rel)
    return {"label": label, "rel_mean": abs(mean_b - mean_a) / max(mean_a, 1e-6),
            "p50": float(np.percentile(rel, 50)),
            "p90": float(np.percentile(rel, 90)),
            "p99": float(np.percentile(rel, 99)),
            "blur_p99": float(np.percentile(rel_err(box3(a), box3(b)), 99)),
            "firefly_sym_p99": ff_p99, "n_excluded": excluded}


def headline_gates(metrics: dict, floor: dict) -> dict:
    """test_headline_spp_matched's gates (test_golden_parity.py:187-194) →
    {metric: (value, gate, passed)}: the mean within 1 %, the rest at 1.5x
    the calibration floor."""
    gate = {"rel_mean": 0.01, "p50": 1.5 * floor.get("p50", 0.139),
            "p90": 1.5 * floor.get("p90", 0.875), "p99": 1.5 * floor["p99"],
            "blur_p99": 1.5 * floor["blur_p99"]}
    return {k: (metrics[k], g, metrics[k] <= g) for k, g in gate.items()}


def failed_gates(gates: dict) -> list:
    return [f"{k}={v:.4f} (gate {g:.4f})" for k, (v, g, ok) in gates.items()
            if not ok]


def golden_json(name: str) -> dict:
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def golden_plan() -> list:
    """(scene, spp, matched floor or None) for every golden but the
    headline: the scenes of matched_floors.json at the golden's own spp
    (both tiers on one render), mandelbrot at its 1 spp, the rest at the
    blurred tier's spp (128 for the IBL scenes)."""
    manifest, floors = golden_json("manifest.json"), golden_json("matched_floors.json")
    plan = []
    for name in sorted(n for n in manifest if manifest[n].get("tier") is None):
        spp = manifest[name]["spp"]
        if name not in floors and manifest[name]["integrator"] != "mandelbrot":
            spp = min(spp, IBL_SPP_CAP if "ibl" in name else BLURRED_SPP_CAP)
        plan.append((name, spp, floors.get(name)))
    return plan


def golden_render(name: str, spp: int, key: int, device=None) -> tuple:
    """tests/scenes/<name>.sp loaded and rendered by ``render_image`` under
    ``prng_key(key)``, the launch counts set to 0 just before the render →
    (image as numpy, seconds, launches)."""
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.render.film import render_image

    scene = sp.load_scene(os.path.join(GOLDEN_SCENES, name + ".sp"),
                          device=device)
    if scene.device.type == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    img = render_image(scene, spp, prng_key(key, scene.device),
                       device=scene.device).cpu().numpy()
    return img, time.time() - t0, frame_launches(name)


def golden_scene(name: str, spp: int, floor: dict | None, device=None) -> dict:
    """One golden rendered by the port under the golden tests' key and held
    to the reference's PFM: the blurred tier's gates, and the matched
    tier's where ``floor`` is given → what the phase prints."""
    from simplepath_tpu_torch.io.pfm import read_pfm

    img, seconds, launches = golden_render(name, spp, GOLDEN_KEY, device)
    ref = read_pfm(os.path.join(GOLDEN, name + ".pfm"))
    if img.shape != ref.shape:
        raise AssertionError(f"{name}: image shape {img.shape}, golden "
                             f"{ref.shape}")
    integrator = golden_json("manifest.json")[name]["integrator"]
    gates = blurred_gates(ref, img, integrator)
    if floor is not None:
        gates.update({f"matched_{k}": v
                      for k, v in matched_gates(ref, img, floor).items()})
    return dict(scene=name, integrator=integrator, spp=spp, seconds=seconds,
                launches=launches,
                gates={k: [v, g] for k, (v, g, _) in gates.items()},
                failed=failed_gates(gates))


def phase_golden(device=None) -> dict:
    """The 15 goldens of tests/golden/manifest.json but the headline,
    rendered on ``device`` (None: the card) and held to the reference's
    PFMs (see golden_plan), a scene at a time in each of GOLDEN_WORKERS
    processes, the flagship's scenes first (its bounce loop is the
    longest); the mesh scenes launch both kernels, the others none.  Every
    scene is printed; a failed gate fails the phase after the last."""
    import multiprocessing

    manifest = golden_json("manifest.json")
    plan = sorted(golden_plan(), reverse=True, key=lambda job: (
        manifest[job[0]]["integrator"] == "iterative_rrnee",
        job[1] * manifest[job[0]]["max_depth"]))
    if device is None:      # built once here, not by every worker
        from simplepath_tpu_torch.render import cuda_traverse as ct
        ct.build_library()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(GOLDEN_WORKERS, len(plan))) as pool:
        results = pool.starmap_async(
            golden_scene, [(*job, device) for job in plan],
            chunksize=1).get(timeout=GOLDEN_TIMEOUT_S)
    total = {"closest": 0, "anyhit": 0}
    failed = []
    for res in results:
        emit("golden", **res)
        name = res["scene"]
        launched = [res["launches"][k] > 0 for k in total]
        if launched != [name in MESH_GOLDENS] * 2:
            raise AssertionError(f"{name}: launches {res['launches']}; a "
                                 "mesh golden launches both kernels, "
                                 "another neither")
        for k in total:
            total[k] += res["launches"][k]
        failed += [f"{name}: {f}" for f in res["failed"]]
    if failed:
        raise AssertionError("golden gates failed: " + "; ".join(failed))
    return {"golden": total}


TRAIN_SPP = 1
TRAIN_STEPS = 3
TRAIN_LR = 0.05             # make_train_step's default
# make_train_step's tested use on this scene: the albedo alone (the setup of
# tests/test_inverse.py).  A step over every leaf raises the loss here (see
# leaf_group_steps).
TRAIN_LEAVES = ("mat_albedo",)
CAMERA_LEAVES = ("cam_eye", "cam_to", "cam_up", "cam_fov")
LEAF_GROUPS = {"every_leaf": None, "mat_albedo": ("mat_albedo",),
               "mat_roughness": ("mat_roughness",),
               "mat_ior_and_clearcoat": ("mat_ior", "mat_cc_ior",
                                         "mat_cc_color"),
               "camera": CAMERA_LEAVES, "light_radiance": ("light_radiance",)}
CROP = (480, 544)            # the 64x64 crop of the gradient checks
PATH_CROP = (496, 528)       # its middle 32x32, for every other traced path


def bench_batch(scene, every: int = 4):
    """Every ``every``-th row and column of the frame: 256 x 256 = 65,536
    pixels spread over the 1024 x 1024 bench frame, one 65,536-ray chunk."""
    st = scene.static
    ys, xs = torch.meshgrid(torch.arange(0, st.height, every, device=scene.device),
                            torch.arange(0, st.width, every, device=scene.device),
                            indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def crop_batch(scene, crop: tuple = CROP):
    r = torch.arange(*crop, device=scene.device)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def finite(params: dict) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in params.values())


def argmax_index(t: torch.Tensor) -> tuple:
    return tuple(int(i) for i in np.unravel_index(int(t.abs().argmax()),
                                                  tuple(t.shape)))


def train_step_timed(step, params, target, xs, ys, key) -> tuple:
    """One make_train_step call → (new params, loss, seconds, launches of
    each kernel, peak bytes allocated)."""
    from simplepath_tpu_torch.render import cuda_traverse as ct
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(ct.launch_counts)
    t0 = time.time()
    new, loss = step(params, target, xs, ys, key)
    loss = float(loss)                         # synchronises
    torch.cuda.synchronize()
    return (new, loss, time.time() - t0,
            {k: ct.launch_counts[k] - before[k] for k in before},
            torch.cuda.max_memory_allocated())


def measured(fn) -> tuple:
    """(fn(), seconds, peak bytes allocated)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, torch.cuda.max_memory_allocated()


def step_cost(scene, params, target, xs, ys, key) -> dict:
    """Where a 1-spp step's time goes: the forward alone (no graph), the
    checkpointed gradient (device kernels and their busy time counted by
    the profiler), and the same gradient through plain autograd with no
    checkpoints (the scene not differentiable), with the peak memory of
    each and the largest difference between the two gradients.  Then the
    albedo gradient at 1 and 4 spp with the bounce checkpoints, and with a
    checkpoint around each sample as well: what a sample-level checkpoint
    would buy in memory and cost in time."""
    from torch.utils.checkpoint import checkpoint

    from simplepath_tpu_torch.diff import grad as G
    from simplepath_tpu_torch.render.film import render_rays

    def forward():
        with torch.no_grad():
            return G.render_loss(scene, params, target, xs, ys, TRAIN_SPP, key)

    def plain():
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        img = render_rays(G.set_params(scene, leaves), xs, ys, TRAIN_SPP, key)
        g = torch.autograd.grad(torch.mean((img - target) ** 2),
                                list(leaves.values()), allow_unused=True)
        return {k: torch.zeros_like(v) if x is None else x
                for (k, v), x in zip(leaves.items(), g)}

    _, fwd_s, fwd_peak = measured(forward)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        (_, g_ck), ck_s, ck_peak = measured(lambda: G.render_loss_and_grad(
            scene, params, target, xs, ys, TRAIN_SPP, key))
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    g_plain, plain_s, plain_peak = measured(plain)
    res = dict(forward_s=fwd_s, forward_peak_bytes=fwd_peak,
               checkpointed_s=ck_s, checkpointed_peak_bytes=ck_peak,
               checkpointed_cuda_launches=sum(e.count for e in cuda),
               checkpointed_device_busy_s=sum(
                   e.self_device_time_total for e in cuda) * 1e-6,
               plain_autograd_s=plain_s, plain_autograd_peak_bytes=plain_peak,
               grad_max_abs_diff={k: float((g_ck[k] - g_plain[k]).abs().max())
                                  for k in g_ck})

    def albedo_grad(spp, per_sample):
        """The albedo gradient at ``spp``; ``per_sample`` also checkpoints
        each sample around the bounce checkpoints (the JAX package's
        layout), rendering it as a 1-spp render at its absolute index."""
        leaf = params["mat_albedo"].detach().requires_grad_(True)
        scene_p = dataclasses.replace(G.set_params(
            scene, dict(params, mat_albedo=leaf)), static=dataclasses.replace(
                scene.static, differentiable=True))
        if per_sample:
            img = sum(checkpoint(render_rays, scene_p, xs, ys, 1, key, None, s,
                                 use_reentrant=False, preserve_rng_state=False)
                      for s in range(spp)) / spp
        else:
            img = render_rays(scene_p, xs, ys, spp, key)
        return torch.autograd.grad(torch.mean((img - target) ** 2), leaf)[0]

    for spp in (1, 4):
        g_bounce, s, peak = measured(lambda: albedo_grad(spp, False))
        res[f"bounce_checkpoints_spp{spp}"] = dict(s=s, peak_bytes=peak)
        g_both, s, peak = measured(lambda: albedo_grad(spp, True))
        res[f"sample_and_bounce_checkpoints_spp{spp}"] = dict(
            s=s, peak_bytes=peak,
            grad_max_abs_diff=float((g_both - g_bounce).abs().max()))
    emit("train", check="step_cost", pixels=int(xs.numel()), spp=TRAIN_SPP,
         **res)
    return res


def grad_parity(scene, params, target, xs, ys, key,
                path: str = "iterative_rrnee") -> dict:
    """The crop's gradient through the CUDA kernels and through their plain
    versions, both on the card: every leaf allclose at rtol 1e-4, atol 1e-6
    (the backward of the gathers accumulates with atomics, so the order of
    its sums varies), both gradients finite.  The kernels' run is timed,
    its peak memory read and its launches counted (set to 0 just before it
    and read just after)."""
    from simplepath_tpu_torch.diff import grad as G
    from simplepath_tpu_torch.render import cuda_traverse as ct
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ct.reset_launch_counts()
    t0 = time.time()
    loss_k, g_k = G.render_loss_and_grad(scene, params, target, xs, ys, 1, key)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(ct.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.time()
    with ct.plain_versions():
        loss_p, g_p = G.render_loss_and_grad(scene, params, target, xs, ys, 1,
                                             key)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    diffs = {k: float((g_k[k] - g_p[k]).abs().max()) for k in g_k}
    res = dict(path=path, integrator=scene.static.integrator,
               pixels=int(xs.numel()), spp=1, seconds=seconds,
               plain_seconds=plain_s, max_memory_allocated=peak,
               launches=launches, loss_kernels=float(loss_k),
               loss_plain=float(loss_p), largest_leaf_diff=max(diffs.values()),
               max_abs_diff=diffs,
               max_abs_grad={k: float(v.abs().max()) for k, v in g_k.items()})
    emit("train", check="gradient_parity", **res)
    for k in g_k:
        if not torch.allclose(g_k[k], g_p[k], rtol=1e-4, atol=1e-6):
            raise AssertionError(f"{path}: gradient {k}: kernels and plain "
                                 f"versions differ by {diffs[k]}")
    if not (finite(g_k) and finite(g_p)):
        raise AssertionError(f"{path}: the crop's gradient is not finite")
    return res


def path_grad_parity(scene, ibl_scene, key) -> dict:
    """grad_parity on the 32x32 crop for every other traced path: each
    integrator of PATHS on the bench, each of IBL_PATHS on the bench with
    the image-based light, from each scene's own parameters towards a flat
    0.25 target.  sp_closest launches on every path, sp_anyhit exactly
    where the path has NEE → {path: launches}."""
    from simplepath_tpu_torch.diff import grad as G
    by_path = {}
    cases = ([(name, with_integrator(scene, name), nee)
              for name, nee in PATHS.items()]
             + [(f"ibl_{name}", with_integrator(ibl_scene, name), nee)
                for name, nee in IBL_PATHS.items()])
    for path, pscene, nee in cases:
        cx, cy = crop_batch(pscene, PATH_CROP)
        ctarget = torch.full((cx.numel(), 3), 0.25, device=pscene.device)
        res = grad_parity(pscene, G.get_params(pscene), ctarget, cx, cy, key,
                          path)
        check_launches(f"train_{path}", res["launches"], nee)
        by_path[f"train_{path}"] = res["launches"]
    return by_path


def leaf_group_steps(scene, params, target, xs, ys, key) -> dict:
    """One SGD step at the default rate from ``params``, over every leaf
    (make_train_step's default) and over each group of leaves alone: the
    loss after each, so a rise is put down to the leaves that make it.  The
    full gradient must be finite."""
    from simplepath_tpu_torch.diff import grad as G
    loss0, g = G.render_loss_and_grad(scene, params, target, xs, ys,
                                      TRAIN_SPP, key)
    if not finite(g):
        raise AssertionError("the bench batch's gradient is not finite")
    after = {}
    for name, leaves in LEAF_GROUPS.items():
        p = {k: params[k] - TRAIN_LR * g[k]
             if leaves is None or k in leaves else params[k] for k in params}
        with torch.no_grad():
            after[name] = float(G.render_loss(scene, p, target, xs, ys,
                                              TRAIN_SPP, key))
    emit("train", check="leaf_groups", lr=TRAIN_LR, loss_before=float(loss0),
         loss_after_one_step=after,
         max_abs_grad={k: float(v.abs().max()) for k, v in g.items()},
         mat_roughness=params["mat_roughness"].tolist(),
         mat_roughness_grad=g["mat_roughness"].tolist(),
         camera_grad={k: g[k].tolist() for k in CAMERA_LEAVES})
    return g


def finite_difference(scene, params, target, xs, ys, key, spp, grads,
                      leaf: str, idx: tuple, eps: float) -> dict:
    """Central difference with common random numbers against the autodiff
    gradient ``grads`` (taken at the same spp), and tests/test_gradients.py's
    tolerance."""
    from simplepath_tpu_torch.diff import grad as G
    g_ad = float(grads[leaf][idx])

    def loss(sign):
        p = dict(params)
        p[leaf] = params[leaf].clone()
        p[leaf][idx] += sign * eps
        with torch.no_grad():
            return float(G.render_loss(scene, p, target, xs, ys, spp, key))
    g_fd = (loss(+1) - loss(-1)) / (2 * eps)
    return dict(leaf=leaf, index=list(idx), eps=eps, spp=spp,
                pixels=int(xs.numel()), ad=g_ad, fd=g_fd,
                tolerance=max(0.08 * max(abs(g_fd), abs(g_ad)), 2e-3))


def fd_check(*args) -> None:
    """finite_difference held to tests/test_gradients.py's tolerance and to
    1 % of the gradient: albedo and radiance enter the image polynomially,
    so with common random numbers the central difference is all but exact
    (measured within 6e-5), and the 2e-3 floor alone would pass a gradient
    half its size."""
    r = finite_difference(*args)
    emit("train", check="finite_differences", **r)
    if not (abs(r["ad"] - r["fd"]) < r["tolerance"]
            and abs(r["ad"] - r["fd"]) <= 1e-2 * abs(r["fd"])):
        raise AssertionError(f"{r['leaf']}{r['index']}: ad={r['ad']} "
                             f"fd={r['fd']}")


def fd_probe(scene, params, target, xs, ys, key, spp, grads) -> None:
    """Finite differences on the leaves a step over every leaf moves most
    (the largest camera and roughness gradients), recorded and not held to
    a tolerance: the estimator has no silhouette term, so a camera move
    that carries an edge across a pixel shows in the difference only."""
    for leaf in ("cam_to", "cam_up", "mat_roughness"):
        idx = argmax_index(grads[leaf])
        for eps in (1e-3, 1e-4):
            emit("train", probe="finite_differences", **finite_difference(
                scene, params, target, xs, ys, key, spp, grads, leaf, idx,
                eps))


def phase_train(scene, ibl) -> dict:
    """Reverse-mode rendering on the bench scene: the train path is the 3
    make_train_step calls over the albedo (launch counts set to 0 just
    before them and read just after); then one step over every leaf and
    over each group of leaves, the 4-spp step, the step's cost, the
    kernel/plain gradient parity and the finite differences; then the
    gradient parity of every other traced path (path_grad_parity).
    → {"train": launches of the steps, "train_<path>": each path's}."""
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.diff import grad as G
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.render.film import render_rays

    key = prng_key(7)
    xs, ys = bench_batch(scene)
    p_true = G.get_params(scene)
    dscene = dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, differentiable=True))
    t0 = time.time()
    with torch.no_grad():
        target = render_rays(dscene, xs, ys, TRAIN_SPP, key)
    torch.cuda.synchronize()
    target_s = time.time() - t0
    p0 = dict(p_true, mat_albedo=torch.full_like(p_true["mat_albedo"], 0.5))
    step = G.make_train_step(scene, TRAIN_SPP, lr=TRAIN_LR, leaves=TRAIN_LEAVES)

    ct.reset_launch_counts()
    steps = []
    params = p0
    for i in range(TRAIN_STEPS):
        new, loss, s, launches, peak = train_step_timed(step, params, target,
                                                        xs, ys, key)
        if not finite(new):
            raise AssertionError(f"step {i + 1}: non-finite gradient")
        moved = {k: float((new[k] - params[k]).abs().max()) for k in new}
        steps.append(dict(step=i + 1, loss=loss, seconds=s, launches=launches,
                          max_memory_allocated=peak, moved=moved))
        emit("train", **steps[-1], pixels=int(xs.numel()), spp=TRAIN_SPP,
             max_depth=scene.static.max_depth, lr=TRAIN_LR,
             leaves=list(TRAIN_LEAVES))
        if i == 0 and not moved["mat_albedo"] > 0:
            raise AssertionError("the albedo gradient is zero")
        params = new
    by_path = dict(ct.launch_counts)
    with torch.no_grad():
        loss_after = float(G.render_loss(scene, params, target, xs, ys,
                                         TRAIN_SPP, key))
    if not loss_after < steps[0]["loss"]:
        raise AssertionError(f"the loss did not fall: {steps[0]['loss']} -> "
                             f"{loss_after}")
    for name, count in by_path.items():
        if count <= 0:
            raise AssertionError(f"the train steps never launched {name}")

    step4 = G.make_train_step(scene, 4, lr=TRAIN_LR, leaves=TRAIN_LEAVES)
    _, loss4, s4, launches4, peak4 = train_step_timed(step4, params, target,
                                                      xs, ys, key)
    emit("train", check="steps", target_s=target_s,
         loss_before=steps[0]["loss"], loss_after=loss_after,
         step_s=[x["seconds"] for x in steps], launches=by_path,
         peak_bytes_spp1=max(x["max_memory_allocated"] for x in steps),
         peak_bytes_spp4=peak4, step_s_spp4=s4, launches_spp4=launches4)

    leaf_group_steps(scene, p0, target, xs, ys, key)
    step_cost(scene, params, target, xs, ys, key)

    cx, cy = crop_batch(scene)
    ctarget = torch.full((cx.numel(), 3), 0.25, device=scene.device)
    grad_parity(scene, p_true, ctarget, cx, cy, key)
    _, g4 = G.render_loss_and_grad(scene, p_true, ctarget, cx, cy, 4, key)
    crop = (scene, p_true, ctarget, cx, cy, key, 4, g4)
    fd_check(*crop, "mat_albedo", argmax_index(g4["mat_albedo"]), 1e-3)
    fd_check(*crop, "light_radiance", argmax_index(g4["light_radiance"]), 1e-2)
    fd_probe(*crop)
    return {"train": by_path, **path_grad_parity(scene, ibl[0], key)}


GEOM_SHARDS = 4
GEOM_SPP = 1


def held_against(img, ref) -> dict:
    """How far a frame is from a reference frame, per pixel (max over the
    channels)."""
    diff = (img - ref).abs().amax(dim=2)
    return dict(max_abs_diff=float(diff.max()),
                pixels_over_1e4=int((diff > 1e-4).sum()),
                pixels_over_1e3=int((diff > 1e-3).sum()),
                share_over_1e3=float((diff > 1e-3).float().mean()),
                mean=float(img.mean()), ref_mean=float(ref.mean()))


def forest_builds(scene, mesh, cache_dir: str) -> tuple:
    """The forest built with an empty cache, then the same call served by
    the cache → (forest, cold seconds, warm seconds)."""
    import shutil

    from simplepath_tpu_torch.parallel.geom_shard import shard_scene_geometry
    from simplepath_tpu_torch.scene import cache
    shutil.rmtree(cache_dir, ignore_errors=True)
    os.makedirs(cache_dir)
    t0 = time.time()
    shard_scene_geometry(scene, mesh, cache_dir=cache_dir)
    torch.cuda.synchronize()
    cold = time.time() - t0
    t0 = time.time()
    forest = shard_scene_geometry(scene, mesh, cache_dir=cache_dir)
    torch.cuda.synchronize()
    warm = time.time() - t0
    if cache.LAST_HIT is None:
        raise AssertionError("the second forest build missed the cache")
    return forest, cold, warm


def phase_geom(scene) -> dict:
    """The bench scene as a forest of GEOM_SHARDS on the card: the full
    frame at GEOM_SPP through one BVH, then through the forest (A B, both
    warm), the forest's frame against the one-BVH frame (max abs diff <
    1e-4), and the forest's kernels against their plain versions at
    128x128."""
    from simplepath_tpu_torch.parallel.geom_shard import (
        make_geom_mesh, render_image_geom_sharded)

    mesh = make_geom_mesh(GEOM_SHARDS)
    forest, cold, warm = forest_builds(scene, mesh,
                                       os.path.join(OUT_DIR, "forest_cache"))
    turns, first = [], {}
    for path, sc, render in (("one_bvh", scene, None),
                             ("forest", forest, render_image_geom_sharded)):
        r, img = render_frame(path, sc, GEOM_SPP, render)
        turns.append((path, r["render_s"]))
        first.setdefault(path, (r, img))
    res, img = first["forest"]
    check_launches("geom_bench", res["launches"], nee=True)
    gate = held_against(img, first["one_bvh"][1])
    emit("geom", **dict(res, path="geom_bench"), shards=GEOM_SHARDS,
         record_rows=list(forest.bvh.records.shape[:2]),
         forest_build_cold_s=cold, forest_build_warm_s=warm,
         against_one_bvh=gate)
    if not gate["max_abs_diff"] < 1e-4:
        raise AssertionError(f"the forest's bench frame departs from the "
                             f"one-BVH frame: {gate}")
    parity_case("geom_bench", forest)
    one = [s for p, s in turns if p == "one_bvh"]
    four = [s for p, s in turns if p == "forest"]
    emit("geom", path="geom_bench_turns", spp=GEOM_SPP, order="A B",
         seconds=turns, one_bvh_s=one, forest_s=four,
         forest_over_one_bvh=sum(four) / sum(one))
    return {"geom_bench": res["launches"]}


LUCY_SCENE = os.path.join(HERE, "scenes", "lucy_bench.sp")
LUCY_MESH = "terrain_28m.ply"
LUCY_TRIS = 28_880_000          # tools/make_lucy_scene.py's default target
LUCY_FILM = (1350, 2000)
# what the scene file must say: its mesh, and its film
LUCY_SCENE_LINES = (f'file: "{LUCY_MESH}"', f"width: {LUCY_FILM[0]}",
                    f"height: {LUCY_FILM[1]}")
# the ray sets sp_closest_count reads on lucy's table
LUCY_COUNT_CASES = ("primary", "incoherent")
# the bench's readings set beside lucy's, case for case
BENCH_KEEP = ("kernel_ms", "plain_ms", "rows_visited", "distinct_internal_rows",
              "distinct_leaf_rows", "table_bytes", "bound_ms", "bound_by",
              "visits_per_ray_mean")


def host_peak_rss() -> int:
    """This process's peak resident bytes so far (Linux reports kB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def check_scene_text(path: str = LUCY_SCENE) -> str:
    """The scene's text, after checking that it names lucy's mesh and the
    1350x2000 film."""
    with open(path) as f:
        text = f.read()
    missing = [line for line in LUCY_SCENE_LINES if line not in text]
    if missing:
        raise ValueError(f"{path} does not say {missing}")
    return text


def lucy_scene(out: str) -> tuple:
    """The lucy-class stress scene, uncut: its mesh written into ``out``
    (``io/meshgen.write_terrain``) and scenes/lucy_bench.sp's own text
    parsed with ``out`` as its base directory, built cold (no cache entry
    beside the new PLY) and then warm → (scene, readings)."""
    from simplepath_tpu_torch import build_scene
    from simplepath_tpu_torch.io.meshgen import grid_triangles, write_terrain
    from simplepath_tpu_torch.scene import bvh, cache
    from simplepath_tpu_torch.scene.parser import parse_sp

    t0 = time.time()
    write_terrain(os.path.join(out, LUCY_MESH), LUCY_TRIS,
                  log=lambda _: None)
    res = dict(mesh_write_s=time.time() - t0)
    text = check_scene_text()
    scene = None
    for load in ("cold", "warm"):
        del scene                       # one copy on the card at a time
        t0 = time.time()
        scene = build_scene(parse_sp(text, base_dir=out))
        torch.cuda.synchronize()
        res[f"build_{load}_s"] = time.time() - t0
        if (cache.LAST_HIT is None) != (load == "cold"):
            raise AssertionError(f"the {load} lucy build "
                                 f"{'hit' if load == 'cold' else 'missed'} "
                                 "the geometry cache")
        if load == "cold":
            res["bvh_builder"] = bvh.LAST_BUILDER
    st = scene.static
    if ((st.num_triangles, (st.width, st.height))
            != (grid_triangles(LUCY_TRIS), LUCY_FILM)):
        raise AssertionError(f"lucy loaded {st.num_triangles} triangles at "
                             f"{st.width}x{st.height}")
    stats = bvh.table_stats(scene.bvh.records.cpu().numpy())
    # the refs are exact floats up to 2^24 rows (scene/bvh.py)
    res.update(triangles=st.num_triangles, width=st.width, height=st.height,
               **stats, rows_under_2_24=stats["rows"] < 1 << 24,
               host_peak_rss_bytes=host_peak_rss())
    if not (res["rows_under_2_24"]
            and stats["stack_needed"] <= stats["kernel_stack"]):
        raise AssertionError(f"lucy's table is past a limit: {res}")
    return scene, res


def phase_lucy(bench, bench_results: dict) -> tuple:
    """The lucy-class stress scene at its full size (28,895,202 triangles,
    1350x2000): builds cold and warm; both kernels against their plain
    versions on the kernels phase's five ray sets built from lucy's scene,
    beside the bench's readings (``bench_results``); sp_closest_count on
    its primary and incoherent rays; the full frame at 1 spp; a 128x128
    render through the kernels bit-equal to the plain-version render; the
    full frame through a forest of GEOM_SHARDS at the lucy gate
    (tests/test_geom_shard.py:133-135).  Each step's seconds in its line.
    Returns ({path: launches}, kernel results, sp_closest_count results)."""
    import shutil

    from simplepath_tpu_torch.parallel.geom_shard import (
        make_geom_mesh, render_image_geom_sharded, shard_scene_geometry)
    from simplepath_tpu_torch.parallel.mesh import CHUNK_RAYS_PER_DEVICE
    from simplepath_tpu_torch.scene import bvh

    out = os.path.join(OUT_DIR, "lucy")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t0 = time.time()
    scene, res = lucy_scene(out)
    emit("lucy", step="scene", **res, s=time.time() - t0)
    records = scene.bvh.records

    t0 = time.time()
    reach = reach_of(scene, bench)
    sets, calls = kernel_ray_sets(scene, reach=reach, stand_in=True)
    emit("lucy", step="ray_sets", incoherent_reach=reach,
         wrapper_calls_in_the_chunk=calls, bounces=list(BOUNCES),
         cases={k: list(v) for k, v in sets.items()},
         chunk=list(middle_run(scene.static.width, scene.static.height)),
         s=time.time() - t0)
    results = {}
    for kernel in ("closest", "anyhit"):
        for case, rays in sets[kernel].items():
            t0 = time.time()
            r = compare_case(kernel, case, records, rays)
            bench_case = bench_results.get((kernel, case))
            r.update(over_bound=r["kernel_ms"] / r["bound_ms"],
                     bench=bench_case and {k: bench_case[k] for k in BENCH_KEEP},
                     s=time.time() - t0)
            emit("lucy", step="kernels", **r)
            results[(kernel, case)] = r
    counts = []
    for case in LUCY_COUNT_CASES:
        t0 = time.time()
        counts.append(probe_counts(records, case, sets["closest"][case]))
        emit("lucy", step="closest_count", **counts[-1], s=time.time() - t0)
    del sets, records           # the forest's frame holds only the forest

    by_path = {}
    frame, img = render_frame("lucy", scene, 1)
    check_launches("lucy", frame["launches"], nee=True)
    by_path["lucy"] = frame["launches"]
    n = frame["width"] * frame["height"]
    emit("lucy", step="frame", **frame, chunks=-(-n // CHUNK_RAYS_PER_DEVICE),
         last_chunk_padding=-n % CHUNK_RAYS_PER_DEVICE)

    t0 = time.time()
    parity = parity_case("lucy", scene)
    if parity["max_abs_diff"] != 0.0:
        raise AssertionError("lucy's 128x128 kernel render is not bit-equal "
                             f"to the plain-version render: {parity}")
    emit("lucy", step="parity", bit_equal=True, s=time.time() - t0)

    # built once, without the cache: the geom phase holds the forest's
    # cache path on the bench
    t0 = time.time()
    forest = shard_scene_geometry(scene, make_geom_mesh(GEOM_SHARDS))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    del scene
    torch.cuda.empty_cache()
    shards = [bvh.table_stats(r) for r in forest.bvh.records.cpu().numpy()]
    fframe, fimg = render_frame("lucy_forest", forest, 1,
                                render_image_geom_sharded)
    check_launches("lucy_forest", fframe["launches"], nee=True)
    by_path["lucy_forest"] = fframe["launches"]
    gate = held_against(fimg, img)
    emit("lucy", step="forest", **fframe, shards=GEOM_SHARDS,
         forest_build_s=build_s,
         padded_rows=int(forest.bvh.records.shape[1]),
         used_rows=[s["used_rows"] for s in shards],
         mean_leaf_occupancy=[s["mean_leaf_occupancy"] for s in shards],
         depth=[s["depth"] for s in shards], against_one_bvh=gate,
         host_peak_rss_bytes=host_peak_rss())
    if not (gate["share_over_1e3"] < 0.01
            and abs(gate["mean"] - gate["ref_mean"]) < 0.01 * gate["ref_mean"]):
        raise AssertionError(f"lucy's forest fails the lucy gate: {gate}")
    del forest
    shutil.rmtree(out)              # gigabytes of PLY and cache entries
    torch.cuda.empty_cache()
    return by_path, results, counts


RANKS = 2
RANK_TIMEOUT_S = 600
# the multi-GPU entry points' ranks on this one card (over gloo)
DRYRUN_RANKS = 4
CLI_RANKS = 2


def run_rank(rank: int, world: int, out: str) -> None:
    """One rank of the ranks phase (``chip_smoke.py --rank R``): joins the
    others over gloo on this card, renders the bench frame at 1 spp and
    takes one train step, and saves what it computed in ``out``."""
    import datetime

    import torch.distributed as dist

    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.diff import grad as G
    from simplepath_tpu_torch.parallel import (init_distributed,
                                               make_ray_mesh,
                                               render_image_multihost,
                                               train_step_multihost,
                                               warmup_render)
    from simplepath_tpu_torch.render import cuda_traverse as ct

    init_distributed("file://" + os.path.join(out, "rendezvous"), world, rank,
                     backend="gloo",
                     timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        scene = sp.load_scene(SCENE)
        warm_s = warmup_render(scene, 1, make_ray_mesh())
        res = {"rank": rank, "world": world, "warmup_s": warm_s}
        torch.cuda.synchronize()
        ct.reset_launch_counts()
        t0 = time.time()
        img = render_image_multihost(scene, 1, prng_key(0))
        torch.cuda.synchronize()
        res.update(render_s=time.time() - t0, launches=dict(ct.launch_counts))

        xs, ys = bench_batch(scene)
        target = torch.load(os.path.join(out, "target.pt")).to(scene.device)
        p0 = G.get_params(scene)
        p0 = dict(p0, mat_albedo=torch.full_like(p0["mat_albedo"], 0.5))
        # two steps: the first meets the other rank at the coordination
        # barrier and carries the first-use costs; the second does neither
        steps, params = [], p0
        for _ in range(2):
            ct.reset_launch_counts()
            t0 = time.time()
            params, loss = train_step_multihost(
                scene, params, target, xs, ys, TRAIN_SPP, prng_key(7),
                lr=TRAIN_LR, leaves=TRAIN_LEAVES)
            torch.cuda.synchronize()
            steps.append((time.time() - t0, dict(ct.launch_counts), loss,
                          params))
        new, loss = steps[0][3], steps[0][2]
        res.update(train_s=[x[0] for x in steps], train_launches=steps[0][1],
                   loss=loss, loss_step2=steps[1][2],
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        np.save(os.path.join(out, f"img_{rank}.npy"), img.cpu().numpy())
        np.save(os.path.join(out, f"albedo_{rank}.npy"),
                new["mat_albedo"].cpu().numpy())
        with open(os.path.join(out, f"rank_{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(out: str, world: int) -> None:
    """Start ``world`` ranks of this script and wait for them; a rank that
    fails, or runs past RANK_TIMEOUT_S, ends them all and raises with the
    failing ranks' output (``parallel/launch.run_processes``)."""
    from simplepath_tpu_torch.parallel.launch import run_processes
    run_processes([[sys.executable, os.path.abspath(__file__), "--rank",
                    str(r), "--world", str(world), "--rank-out", out]
                   for r in range(world)], None, out, RANK_TIMEOUT_S)


def phase_ranks(scene) -> dict:
    """RANKS processes on this one card over gloo: each rank's 1-spp bench
    frame equals the one-process frame, and one train step matches the
    one-process step.  The one-process frame is also timed in a fresh
    process, a world of one running the ranks' own job."""
    import shutil

    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.diff import grad as G
    from simplepath_tpu_torch.parallel.mesh import (render_image_sharded,
                                                    warmup_render)
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.render.film import render_rays

    out = os.path.join(OUT_DIR, "ranks")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    key = prng_key(7)
    xs, ys = bench_batch(scene)
    dscene = dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, differentiable=True))
    with torch.no_grad():
        target = render_rays(dscene, xs, ys, TRAIN_SPP, key)
    torch.save(target.cpu(), os.path.join(out, "target.pt"))
    ct.build_library()          # built here, before the ranks load it

    def one_process():
        """The 1-spp frame in this process, timed as a rank times its own:
        after the same warm-up."""
        warmup_render(scene, 1)
        torch.cuda.synchronize()
        t0 = time.time()
        img = render_image_sharded(scene, 1, prng_key(0))
        torch.cuda.synchronize()
        return time.time() - t0, img.cpu().numpy()

    # the same job in a fresh process of its own, a world of one: the
    # one-process frame timed as a rank's is, free of this process's state
    lone = os.path.join(out, "world1")
    os.makedirs(lone)
    shutil.copy(os.path.join(out, "target.pt"), lone)
    spawn_ranks(lone, 1)
    with open(os.path.join(lone, "rank_0.json")) as f:
        fresh = json.load(f)
    fresh_img = np.load(os.path.join(lone, "img_0.npy"))
    t0 = time.time()
    spawn_ranks(out, RANKS)
    ranks_s = time.time() - t0
    s, one = one_process()
    one_s = [s]
    if not np.array_equal(fresh_img, one):
        raise AssertionError("the world-of-one rank's frame differs from "
                             "this process's")
    p0 = G.get_params(scene)
    p0 = dict(p0, mat_albedo=torch.full_like(p0["mat_albedo"], 0.5))
    step = G.make_train_step(scene, TRAIN_SPP, lr=TRAIN_LR,
                             leaves=TRAIN_LEAVES)
    new, loss = step(p0, target, xs, ys, key)
    albedo = new["mat_albedo"].cpu().numpy()
    by_path = {}
    for r in range(RANKS):
        with open(os.path.join(out, f"rank_{r}.json")) as f:
            res = json.load(f)
        img = np.load(os.path.join(out, f"img_{r}.npy"))
        a = np.load(os.path.join(out, f"albedo_{r}.npy"))
        res.update(one_process_render_s=one_s,
                   fresh_one_process_render_s=fresh["render_s"],
                   fresh_one_process_train_s=fresh["train_s"],
                   frame_equals_one_process=bool(np.array_equal(img, one)),
                   frame_max_abs_diff=float(np.abs(img - one).max()),
                   one_process_loss=float(loss),
                   loss_abs_diff=abs(res["loss"] - float(loss)),
                   albedo_max_abs_diff=float(np.abs(a - albedo).max()))
        emit("ranks", backend="gloo",
             why_gloo="NCCL takes one GPU a rank; the two ranks share this "
                      "card, and gloo stages their collectives through the "
                      "host", ranks_wall_s=ranks_s, **res)
        by_path[f"ranks_rank{r}"] = res["launches"]
        by_path[f"ranks_train_rank{r}"] = res["train_launches"]
        if not res["frame_equals_one_process"]:
            raise AssertionError(f"rank {r}'s frame differs from the "
                                 "one-process frame")
        if not (res["loss_abs_diff"] <= 1e-5 * abs(float(loss))
                and res["albedo_max_abs_diff"] <= 1e-5):
            raise AssertionError(f"rank {r}'s train step departs from the "
                                 f"one-process step: {res}")
        if min(res["launches"].values()) <= 0 or \
                min(res["train_launches"].values()) <= 0:
            raise AssertionError(f"rank {r} launched no kernel: {res}")
    ranks_entry_points(out)
    return by_path


def ranks_entry_points(out: str) -> None:
    """The multi-GPU path's entry points on this card, their ranks sharing
    it over gloo: the CLI as CLI_RANKS ranks under torchrun, each run's
    rank-0 PFM held to the one-process CLI's bit for bit and written by
    rank 0 alone, and meanwhile ``entry.dryrun_multichip(DRYRUN_RANKS)``:
    their ranks spend most of their lives starting up."""
    from concurrent.futures import ThreadPoolExecutor

    from simplepath_tpu_torch import cli
    from simplepath_tpu_torch.entry import dryrun_multichip
    from simplepath_tpu_torch.parallel.launch import package_env, run_processes
    from simplepath_tpu_torch.utils import load_checkpoint

    t0 = time.time()
    d = os.path.join(out, "cli")
    os.makedirs(d)
    ck_one, ck_ranks, ck_cut = (os.path.join(d, f) for f in
                                ("ck_one.npz", "ck_ranks.npz", "ck_cut.npz"))
    passes = [IBL_TEST_SCENE, "--samples", "8", "--spp-chunk", "4",
              "--no-progress"]
    forest = [os.path.join(GOLDEN_SCENES, "g_blob.sp"), "--samples", "2",
              "--geom-shards", "2"]
    one = {"passes": os.path.join(d, "one_passes.pfm"),
           "forest": os.path.join(d, "one_forest.pfm")}
    cut_checkpoint(ck_cut)
    runs = {"passes": (passes + ["--checkpoint", ck_ranks], one["passes"]),
            "resumed": (passes + ["--checkpoint", ck_cut], one["passes"]),
            "forest": (forest, one["forest"])}
    cmds = [[sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={CLI_RANKS}", "-m", "simplepath_tpu_torch.cli",
             *args, "--output", os.path.join(d, f"ranks_{name}.pfm"),
             "--dist-backend", "gloo"] for name, (args, _) in runs.items()]
    with ThreadPoolExecutor(1) as pool:
        cli_runs = pool.submit(run_processes, cmds,
                               [package_env()] * len(cmds),
                               os.path.join(d, "logs"), RANK_TIMEOUT_S,
                               names=list(runs), cwd=HERE)
        dry = dryrun_multichip(DRYRUN_RANKS, backend="gloo")
        emit("ranks", check="dryrun_multichip", world=DRYRUN_RANKS,
             backend="gloo", seconds=time.time() - t0, **dry)
        for name, args in (("passes", passes + ["--checkpoint", ck_one]),
                           ("forest", forest)):
            if cli.main(args + ["--output", one[name]]) != 0:
                raise AssertionError(f"the one-process CLI failed ({name})")
        logs = cli_runs.result()
    res = {}
    for (name, (_, ref)), log in zip(runs.items(), logs):
        with open(os.path.join(d, f"ranks_{name}.pfm"), "rb") as f, \
                open(ref, "rb") as g:
            equal = f.read() == g.read()
        res[name] = dict(equals_one_process=equal, wrote=log.count("Wrote "))
        if not equal or res[name]["wrote"] != 1:
            raise AssertionError(f"the CLI over {CLI_RANKS} ranks ({name}) "
                                 f"departs from one process: {res[name]}")
    done = load_checkpoint(ck_ranks)[1]
    emit("ranks", check="cli_over_ranks", world=CLI_RANKS, backend="gloo",
         checkpoint_samples=done, seconds_with_dryrun=time.time() - t0, **res)
    if done != 8:
        raise AssertionError(f"rank 0's checkpoint holds {done} of 8 samples")


# The BVH topologies besides the default that the topology phase drives,
# each as the environment its processes are started with (the knobs are read
# at import), and the order of its processes: the default topology's frame
# first and last, each other topology's kernels, parity and frame between
# them, so that every topology's frame is timed between two of the default's;
# then
# the leaf layouts that only need checking (the ``check`` job: kernels,
# parity and one frame): the leaf meta read as three floats (9K not a
# multiple of 4), one slot a lane with idle lanes (K=5), three-row leaves and
# four slots a lane (K=29 at W=8, where registers are scarcest) or two (W=16).
DEFAULT_TOPOLOGY = "w8_k12"
TOPOLOGIES = {"w8_k12": {"SIMPLEPATH_BVH_WIDTH": "8", "SIMPLEPATH_BVH_LEAF": "12"},
              "w16_k12": {"SIMPLEPATH_BVH_WIDTH": "16", "SIMPLEPATH_BVH_LEAF": "12"},
              "w8_k24": {"SIMPLEPATH_BVH_WIDTH": "8", "SIMPLEPATH_BVH_LEAF": "24"},
              "w8_k5": {"SIMPLEPATH_BVH_WIDTH": "8", "SIMPLEPATH_BVH_LEAF": "5"},
              "w8_k29": {"SIMPLEPATH_BVH_WIDTH": "8", "SIMPLEPATH_BVH_LEAF": "29"},
              "w16_k29": {"SIMPLEPATH_BVH_WIDTH": "16", "SIMPLEPATH_BVH_LEAF": "29"}}
TOPOLOGY_TURNS = (("w8_k12", "frame"), ("w16_k12", "full"), ("w8_k24", "full"),
                  ("w8_k12", "frame"),
                  ("w8_k5", "check"), ("w8_k29", "check"), ("w16_k29", "check"))
TOPOLOGY_TIMEOUT_S = 400


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name as the kernel and its template arguments,
    ``traverse_kernel<0,1>``."""
    k = re.search(r"\d+([a-z_]+_kernel)I(\w*?)EEv", mangled)
    return f"{k.group(1)}<{','.join(re.findall(r'L[bi](\d+)E', k.group(2)))}>"


def ptxas_summary(lines: list) -> dict:
    """What ``nvcc -Xptxas -v`` says of each kernel of the library, keyed
    by the kernel and its template arguments (``traverse_kernel<0,0>`` is
    sp_closest, ``<1,0>`` sp_anyhit, ``<0,1>`` sp_closest_count; the
    probes' ``row_chase_kernel<C,feed>`` and
    ``visit_body_kernel<mode,check>``): registers, spill stores and loads,
    stack frame and shared memory, in bytes."""
    out, name = {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack_frame=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            out[name].update(registers=int(m.group(1)), smem=int(m.group(2)))
    return out


def run_topology(job: str, out: str) -> None:
    """One process of the topology phase (``chip_smoke.py --topology-job
    JOB``), at the topology its environment sets: with ``full`` or
    ``check``, the library built anew with ptxas's verbose lines, both
    kernels against their plain versions on the bench's five ray sets and
    the 128x128 render parity (``full`` also times the visit body); with
    every job, the 1024x1024 flagship frame at 1 spp under prng_key(0),
    after a warm-up chunk.  The library and the scene are ready before the
    process waits for its turn on the card (``out/go``).  Writes
    result.json and frame.npy into ``out``."""
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.parallel.mesh import warmup_render
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.scene import bvh

    res = {"job": job, "width": bvh.WIDTH, "leaf_size": bvh.LEAF_SIZE,
           "leaf_rows": bvh.LEAF_ROWS, "kernel_stack": ct.KERNEL_STACK,
           "lanes_per_ray": ct.LANES_PER_RAY}
    checked = job in ("full", "check")
    t0 = time.time()
    if checked:             # built anew, for what ptxas says of it
        lib = ct.library_path()
        res["ptxas"] = ct._compile_source(ct.KERNEL_SOURCE, lib,
                                          verbose=True).splitlines()
    else:
        lib = ct.build_library()
    ct._library()
    res.update(library=os.path.relpath(lib, HERE), build_s=time.time() - t0)
    t0 = time.time()
    scene = sp.load_scene(SCENE)
    torch.cuda.synchronize()
    res.update(load_s=time.time() - t0,
               record_rows=int(scene.bvh.records.shape[0]))
    # ready for the card: wait for this process's turn (phase_topology)
    open(os.path.join(out, "ready"), "w").close()
    t0 = time.time()
    while not os.path.exists(os.path.join(out, "go")):
        if time.time() - t0 > TOPOLOGY_TIMEOUT_S:
            raise TimeoutError("the topology phase never gave this process its turn")
        time.sleep(0.05)
    res["waited_s"] = time.time() - t0
    if checked:
        res["kernels"] = list(phase_kernels(scene, kernel_ray_sets(scene)[0]).values())
        res["parity"] = parity_case("iterative_rrnee", scene)
        if res["parity"]["max_abs_diff"] != 0.0:
            raise AssertionError("the 128x128 kernel render is not bit-equal "
                                 f"to the plain-version render: {res['parity']}")
    if job == "full":
        res["visit_body"] = probe_visit_body(scene.bvh.records)
    res["warmup_s"] = warmup_render(scene, 1)
    summary, img = render_frame("topology_frame", scene, 1)
    check_launches("topology_frame", summary["launches"], nee=True)
    res["frame"] = summary
    np.save(os.path.join(out, "frame.npy"), img.cpu().numpy())
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(res, f)


def start_topology(name: str, job: str, out: str) -> tuple:
    """Start one topology-phase process in ``out`` → (process, its log,
    its start time)."""
    os.makedirs(out)
    log = open(os.path.join(out, "process.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--topology-job", job,
         "--topology-out", out], stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, **TOPOLOGIES[name]))
    return proc, log, time.time()


def await_topology(run: tuple, out: str, ready: bool) -> None:
    """Wait for a topology-phase process until it is ready for its turn on
    the card (``ready``: it wrote ``out/ready``) or until it exits; raise
    with its output if it exits non-zero or before it is ready, or runs
    past TOPOLOGY_TIMEOUT_S (it is killed then)."""
    proc, log, started = run
    while not (ready and os.path.exists(os.path.join(out, "ready"))):
        code = proc.poll()
        if code == 0 and not ready:
            return
        if code is not None or time.time() - started > TOPOLOGY_TIMEOUT_S:
            if code is None:
                proc.kill()
                proc.wait()
            log.seek(0)
            raise AssertionError(f"the topology process in {out} failed (exit "
                                 f"{proc.returncode}):\n{log.read()[-4000:]}")
        time.sleep(0.05)


def phase_topology() -> tuple:
    """The kernels at each non-default topology, in fresh processes in the
    order TOPOLOGY_TURNS: everything the full or check job checks, and its
    frame within max abs diff 1e-4 of the default topology's
    (tests/test_geom_shard.py's gate: only equal-t ties can differ).
    Returns ({topology: kernels results}, {topology: frame launches},
    {topology: visit-body readings, for the full jobs})."""
    import shutil

    out = os.path.join(OUT_DIR, "topology")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    # one process at a time has its turn on the card; the next one starts
    # up (imports, build, scene load) during that turn
    dirs = [os.path.join(out, f"{i}_{name}_{job}")
            for i, (name, job) in enumerate(TOPOLOGY_TURNS)]
    runs, procs = [], [start_topology(*TOPOLOGY_TURNS[0], dirs[0])]
    try:
        for i, (name, job) in enumerate(TOPOLOGY_TURNS):
            await_topology(procs[i], dirs[i], ready=True)
            t0 = time.time()
            open(os.path.join(dirs[i], "go"), "w").close()
            if i + 1 < len(TOPOLOGY_TURNS):
                procs.append(start_topology(*TOPOLOGY_TURNS[i + 1], dirs[i + 1]))
            await_topology(procs[i], dirs[i], ready=False)
            with open(os.path.join(dirs[i], "result.json")) as f:
                runs.append((name, job, json.load(f), time.time() - t0))
    finally:
        for proc, log, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    frames = {}                 # each topology's first frame
    for i, (name, job, _, _) in enumerate(runs):
        if name not in frames:
            frames[name] = torch.from_numpy(np.load(os.path.join(
                out, f"{i}_{name}_{job}", "frame.npy")))
    ref = frames[DEFAULT_TOPOLOGY]
    results, launches, bodies = {}, {}, {}
    for name, job, res, _ in runs:
        if job == "frame":
            continue
        for case in res["kernels"]:
            emit("topology", topology=name, check="kernel", **case)
        emit("topology", topology=name, check="parity", **res["parity"])
        for case in res.get("visit_body", []):
            emit("topology", topology=name, check="visit_body", **case)
        gate = held_against(frames[name], ref)
        frame_s = {n: [r["frame"]["render_s"] for n2, _, r, _ in runs if n2 == n]
                   for n in (name, DEFAULT_TOPOLOGY)}
        emit("topology", topology=name, check="frame", width=res["width"],
             leaf_size=res["leaf_size"], leaf_rows=res["leaf_rows"],
             kernel_stack=res["kernel_stack"],
             lanes_per_ray=res["lanes_per_ray"], record_rows=res["record_rows"],
             library=res["library"], build_s=res["build_s"],
             ptxas=ptxas_summary(res["ptxas"]),
             load_s=res["load_s"], launches=res["frame"]["launches"],
             image_mean=res["frame"]["image_mean"],
             max_memory_allocated=res["frame"]["max_memory_allocated"],
             frame_s_in_turns=frame_s[name],
             default_frame_s_in_turns=frame_s[DEFAULT_TOPOLOGY],
             against_default=gate)
        if not gate["max_abs_diff"] < 1e-4:
            raise AssertionError(f"the {name} frame departs from the default "
                                 f"topology's: {gate}")
        results[name] = {(c["kernel"], c["case"]): c for c in res["kernels"]}
        launches[name] = res["frame"]["launches"]
        if "visit_body" in res:
            bodies[name] = res["visit_body"]
    emit("topology", check="turns", order=[f"{n} {j}" for n, j, _, _ in runs],
         turn_s=[s for *_, s in runs],
         frame_s=[r["frame"]["render_s"] for _, _, r, _ in runs])
    return results, launches, bodies


def kernel_entry(kernel: str, name: str, results: dict, launches: dict,
                 width: int, leaf_size: int) -> dict:
    """One kernel at one topology: times from the N=65,536 primary-ray case
    (the main path's chunk size), every ray set under ``cases``."""
    main = results[(kernel, "primary")]
    cases = [c for k, c in results if k == kernel]
    return {
        "name": name, "route": "cuda",
        "source": "simplepath_tpu_torch/csrc/traverse.cu",
        "replaces": TPU_KERNEL[kernel],
        "launches": launches.get(kernel, 0),
        "max_abs_err": max(results[(kernel, c)]["max_abs_err"] for c in cases),
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "topology": f"w{width}_k{leaf_size}",
        "lanes_per_ray": width,
        "cases": [{k: v for k, v in results[(kernel, c)].items() if k in (
            "case", "n", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "rows_visited", "distinct_internal_rows", "distinct_leaf_rows",
            "table_bytes", "row_traffic_ms", "row_GBps_achieved", "hits",
            "dead_rays", "visits_per_ray_mean", "visits_per_ray_max")
            or k.startswith("lane_step_share_")} for c in cases],
    }


def probe_entry(name: str, main: dict, cases: list, launches: dict,
                keep: tuple) -> dict:
    """One measuring kernel: times and bound from its ``main`` case, every
    case's readings under ``cases``; its launches in the render phase's
    frame (it is on no render path: 0)."""
    kernel = main["kernel"]
    return {
        "name": name, "route": "cuda",
        "source": "simplepath_tpu_torch/csrc/traverse.cu",
        "replaces": TPU_KERNEL[kernel], "launches": launches.get(kernel, 0),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "cases": [{k: v for k, v in c.items() if k in keep} for c in cases],
    }


BODY_KEEP = ("table", "mode", "shape", "rays", "blocks_per_sm", "bodies",
             "output", "kernel_ms", "ns_per_body", "ns_per_ray_body",
             "bodies_per_s", "bound_ms", "kernel_ms_at_plain_bodies",
             "plain_ms_at_plain_bodies")


def visit_body_entry(name: str, bodies: list, launches: dict) -> dict:
    """The visit body: times at PLAIN_BODIES on the bench's full wave of
    the ``internal`` mode, where the plain version is timed too."""
    main = next(c for c in bodies if c["table"] == "bench"
                and c["mode"] == "internal" and c["shape"] == "every_sm")
    return probe_entry(name, {**main, "ms": main["kernel_ms_at_plain_bodies"],
                              "plain_ms": main["plain_ms_at_plain_bodies"],
                              "bound_ms": main["bound_ms_at_plain_bodies"]},
                       bodies, launches, BODY_KEEP)


COUNT_KEEP = ("case", "n", "kernel_ms", "closest_ms_in_turns", "counting_cost",
              "plain_ms", "bound_ms", "visits_per_ray_mean",
              "visits_per_warp_mean", "lock_step_share", "n_push_shares")


CHASE_KEEP = ("feed", "table", "chains", "hops", "kernel_ms", "ns_per_hop",
              "distinct_rows", "bound_ms")


def chase_entry(name: str, feed: str, chase: list, launches: dict) -> dict:
    """sp_row_chase under one feed: times from one chain on the bench's
    table, where the plain version is timed too."""
    cases = [c for c in chase if c["feed"] == feed]
    one = next(c for c in cases if c["chains"] == 1 and c["table"] == "bench")
    return {**probe_entry(name, {**one, "ms": one["kernel_ms"]}, cases,
                          launches, CHASE_KEEP), "feed": feed}


def probe_entries(probes: dict, launches: dict) -> list:
    counts, chase = probes["closest_count"], probes["row_chase"]
    main = next(c for c in counts if c["case"] == "primary")
    return [
        probe_entry("closest_count", {**main, "ms": main["kernel_ms"]}, counts,
                    launches, COUNT_KEEP),
        chase_entry("row_chase_bulk", "bulk", chase, launches),
        chase_entry("row_chase_ldg", "ldg", chase, launches),
        visit_body_entry("visit_body", probes["visit_body"], launches),
    ]


def kernels_line(results: dict, launches: dict, by_path: dict,
                 topologies: tuple = ({}, {}, {}), probes: dict | None = None,
                 lucy: tuple | None = None) -> dict:
    """The summary object: each kernel at this process's topology (named
    ``closest`` / ``anyhit``, launches from the render phase's frame), on
    lucy's table (``closest_lucy`` / ``anyhit_lucy`` / ``closest_count_lucy``,
    launches from lucy's 1-spp frame) and at every other topology the
    topology phase drove (``closest_w16_k12``, ..., launches from that
    topology's frame); the three measuring kernels (``closest_count``,
    ``row_chase_bulk`` / ``row_chase_ldg``, ``visit_body``, and the visit
    body at the topologies whose job timed it, ``visit_body_w16_k12``,
    ...)."""
    from simplepath_tpu_torch.scene.bvh import LEAF_SIZE, WIDTH
    entries = []
    if results:
        entries += [kernel_entry(k, k, results, launches, WIDTH, LEAF_SIZE)
                    for k in ("closest", "anyhit")]
    if probes:
        entries += probe_entries(probes, launches)
    if lucy:
        lucy_launches, lucy_results, counts = lucy
        entries += [kernel_entry(k, f"{k}_lucy", lucy_results,
                                 lucy_launches["lucy"], WIDTH, LEAF_SIZE)
                    for k in ("closest", "anyhit")]
        main = next(c for c in counts if c["case"] == "primary")
        entries.append(probe_entry(
            "closest_count_lucy", {**main, "ms": main["kernel_ms"]}, counts,
            lucy_launches["lucy"], COUNT_KEEP))
    topo_results, topo_launches, topo_bodies = topologies
    for topo, res in topo_results.items():
        knobs = TOPOLOGIES[topo]
        entries += [kernel_entry(k, f"{k}_{topo}", res, topo_launches[topo],
                                 int(knobs["SIMPLEPATH_BVH_WIDTH"]),
                                 int(knobs["SIMPLEPATH_BVH_LEAF"]))
                    for k in ("closest", "anyhit")]
        if topo in topo_bodies:
            entries.append(visit_body_entry(f"visit_body_{topo}",
                                            topo_bodies[topo], topo_launches[topo]))
    return {"kernels": entries, "launches_by_path": by_path}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=4,
                    help="samples per pixel of the full-frame render")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=RANKS,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--topology-job", choices=("full", "check", "frame"), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--topology-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on the GPU only", file=sys.stderr)
        return 1

    if args.rank is not None:               # one rank of the ranks phase
        run_rank(args.rank, args.world, args.rank_out)
        return 0
    if args.topology_job is not None:       # one process of the topology phase
        run_topology(args.topology_job, args.topology_out)
        return 0
    progress = {"phase": "setup"}
    try:
        return run(args, phases, progress)
    except Exception:
        import traceback
        traceback.print_exc()
        print(json.dumps({"ok": False, "failed_phase": progress["phase"]}),
              flush=True)
        return 1


def run(args, phases, progress: dict) -> int:
    """Every phase asked for, in order; ``progress["phase"]`` names the one
    running."""
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.scene import bvh, cache

    started = time.time()

    def timed(phase, fn, *args):
        progress["phase"] = phase
        before = dict(launch_us_before=host_launch_us(),
                      python_objects_before=len(gc.get_objects()))
        t0 = time.time()
        out = fn(*args)
        emit("seconds", of=phase, s=time.time() - t0, **before)
        return out

    info = timed("device", phase_device)
    if "build" in phases:
        timed("build", phase_build)

    t0 = time.time()
    scene = sp.load_scene(SCENE)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    geometry_cache = cache.LAST_HIT     # None: built now (and cached)

    results, by_path, probes = {}, {}, {}
    ibl = None
    if "paths" in phases or "parity" in phases or "train" in phases:
        ibl = timed("ibl_scene", ibl_bench_scene)
    if "kernels" in phases or "probes" in phases:
        sets = timed("ray_sets", kernel_ray_sets, scene)[0]
    if "kernels" in phases:
        results = timed("kernels", phase_kernels, scene, sets)
        by_path["one_ray_forms"] = timed("one_ray_forms", one_ray_forms, scene)
    if "probes" in phases:
        probes = timed("probes", phase_probes, scene, sets)
    if "render" in phases:
        by_path["iterative_rrnee"] = timed(
            "render", phase_render, scene, args.spp, load_s, bvh.LAST_BUILDER,
            geometry_cache)
    if "paths" in phases:
        by_path.update(timed("paths", phase_paths, scene, ibl))
    if "parity" in phases:
        timed("parity", phase_parity, scene, ibl)
    if "cli" in phases:
        timed("cli", phase_cli)
    if "golden" in phases:
        by_path.update(timed("golden", phase_golden))
    if "train" in phases:
        by_path.update(timed("train", phase_train, scene, ibl))
    if "geom" in phases:
        by_path.update(timed("geom", phase_geom, scene))
    lucy = None
    if "lucy" in phases:
        lucy = timed("lucy", phase_lucy, scene, results)
        by_path.update(lucy[0])
    if "ranks" in phases:
        by_path.update(timed("ranks", phase_ranks, scene))
    topologies = ({}, {}, {})
    if "topology" in phases:
        topologies = timed("topology", phase_topology)
        by_path.update({f"topology_{t}": n for t, n in topologies[1].items()})

    emit("seconds", of="run", s=time.time() - started)
    if results or probes or topologies[0] or lucy:
        print(json.dumps(kernels_line(
            results, by_path.get("iterative_rrnee", {}), by_path, topologies,
            probes, lucy)), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
