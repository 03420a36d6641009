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
           times, visits a ray, lane-step shares, bytes the visits read
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
  train    diff.grad on the bench scene at depth 10: 3 make_train_step calls
           (plain SGD, the albedo trained) on 65,536 pixels (every 4th row
           and column) at 1 spp toward the port's own render at the true
           parameters, from a flat 0.5 albedo; seconds, launches and peak
           memory a step, one step at 4 spp; one step over every leaf and
           over each group of leaves alone, and finite differences on the
           camera and roughness leaves (recorded); a step's forward,
           checkpointed and plain-autograd cost, and what a sample-level
           checkpoint would save; on a 64x64 crop the gradient through the
           kernels equals the one through their plain versions (rtol 1e-4,
           atol 1e-6), and matches central differences (4 spp) on the
           largest albedo and light-radiance gradients

Each phase's seconds follow it on a line of their own.  Any failed phase
raises (non-zero exit).  Without a CUDA device the script exits non-zero
before printing any result.  The last line of the output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
PHASES = ("device", "build", "kernels", "render", "paths", "parity", "cli",
          "train")
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
# Arithmetic of one visit, counted from csrc/traverse.cu: an internal row is
# 8 slab tests (6 sub, 6 mul, 12 min/max, 3 compares each) plus the 19
# compare-exchanges of the sorting network; a triangle test is 44 mul/add/sub,
# one divide and 8 compares.
FLOPS_INTERNAL_VISIT = 8 * 27 + 19
FLOPS_TRIANGLE_TEST = 53
# Bytes the kernels' loads ask for on one visit (csrc/traverse.cu): the 7
# fields of the 8 children of an internal row; of a leaf row its 16 B of meta
# and the 9 fields of all 12 triangle slots, whatever the leaf's count.
INTERNAL_VISIT_BYTES = 7 * 8 * 4
LEAF_VISIT_BYTES = 16 + 12 * 9 * 4
BOUNCES = (0, 2, 5)
TPU_KERNEL = {"closest": "simplepath_tpu/render/pallas_traverse.py:466",
              "anyhit": "simplepath_tpu/render/pallas_traverse.py:503"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def incoherent_rays(scene, n: int = 65499, seed: int = 7):
    """Seeded bounce-like rays: origins on the surfaces the primary rays hit
    (drawn with replacement, so in no spatial order), uniform directions;
    ~10 % dead lanes (t_max = -inf), the rest of finite or infinite reach;
    N is deliberately not a multiple of 32."""
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
                     0.5 + 4.0 * rs.rand(n)).astype(np.float32)
    t_max[rs.rand(n) < 0.1] = -np.inf
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(scene.device)
    return to(origin), to(direction), to(t_min), to(t_max)


def bounce_rays(scene, rows: tuple = (480, 544)) -> dict:
    """The integrator's own wavefronts: render one chunk (``rows`` of the
    frame: 65,536 rays of the bench scene, 1 spp) with the two wrappers
    wrapped here so that the inputs of their calls of bounces BOUNCES are
    kept.  One render at 1 spp calls each wrapper once a bounce.  Returns
    {"closest": {case: rays}, "anyhit": {case: rays}}."""
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.render import cuda_traverse as ct

    kept = {"closest": {}, "anyhit": {}}
    calls = {"closest": 0, "anyhit": 0}
    originals = {name: getattr(ct, name) for name in kept}

    def keeping(name):
        def wrapped(records, ro, rd, t_min, t_max):
            if calls[name] in BOUNCES:
                kept[name][f"bounce{calls[name]}"] = tuple(
                    x.clone() for x in (ro, rd, t_min, t_max))
            calls[name] += 1
            return originals[name](records, ro, rd, t_min, t_max)
        return wrapped

    for name in kept:
        setattr(ct, name, keeping(name))
    try:
        w = scene.static.width
        lin = torch.arange(rows[0] * w, rows[1] * w, device=scene.device)
        sp.render_rays(scene, lin % w, lin // w, 1, prng_key(1))
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(ct, name, fn)
    for name, cases in kept.items():
        if len(cases) != len(BOUNCES):
            raise AssertionError(f"the chunk render called {name} "
                                 f"{calls[name]} times; bounces {BOUNCES} "
                                 "were not all reached")
    return kept


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

    out = fn(records, ro, rd, t_min, t_max)      # warm-up launch
    torch.cuda.synchronize()                     # surfaces a fault in the run
    stats: dict = {}
    ref = plain(records, ro, rd, t_min, t_max, stats=stats)
    torch.cuda.synchronize()

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

    res["kernel_ms"] = time_cuda(lambda: fn(records, ro, rd, t_min, t_max), 50)
    res["plain_ms"] = time_cuda(lambda: plain(records, ro, rd, t_min, t_max), 1,
                                run_ahead=False)

    # per-ray visit counts of the plain version, which walks the same rows:
    # how long the chains are, and what lock step costs when 32 rays share a
    # warp (one thread a ray) and when 32 / lanes_per_ray do
    # (a ray with an empty interval pops the root in the plain version and
    # walks nothing in the kernel: it counts no visit here)
    dead = t_max < t_min
    visits = stats.pop("ray_internal_visits") + stats.pop("ray_leaf_visits")
    visits = torch.where(dead, 0, visits)
    res.update(dead_rays=int(dead.sum()),
               visits_per_ray_mean=float(visits.float().mean()),
               visits_per_ray_max=int(visits.max()),
               lane_step_share_32_rays_a_warp=lane_step_share(visits, 32),
               lane_step_share_4_rays_a_warp=lane_step_share(visits, 4))

    # The least this run's rays ask of the card.  Bytes: each table row that
    # a live ray visits is read once, at what a visit of its kind reads, the
    # rays once, the results written once.  Operations: every visit's
    # arithmetic.  The root pops of dead rays count in neither.
    internal_visits = stats["internal_visits"] - res["dead_rays"]
    distinct_internal = int(stats.pop("internal_rows_visited").sum())
    distinct_leaf = int(stats.pop("leaf_rows_visited").sum())
    table_bytes = (distinct_internal * INTERNAL_VISIT_BYTES
                   + distinct_leaf * LEAF_VISIT_BYTES)
    in_bytes = table_bytes + n * (3 + 3 + 1 + 1) * 4
    flops = (internal_visits * FLOPS_INTERNAL_VISIT
             + stats["triangle_tests"] * FLOPS_TRIANGLE_TEST)
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    res.update(stats, rows_visited=internal_visits + stats["leaf_visits"],
               distinct_internal_rows=distinct_internal,
               distinct_leaf_rows=distinct_leaf, table_bytes=table_bytes,
               row_bytes=internal_visits * INTERNAL_VISIT_BYTES
               + stats["leaf_visits"] * LEAF_VISIT_BYTES,
               min_bytes=in_bytes + out_bytes, flops=flops,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return res


def phase_kernels(scene) -> dict:
    dev = scene.device
    records = scene.bvh.records
    l2_rate = l2_read_rate(dev)
    ray_sets = {"primary": primary_rays(scene),
                "incoherent": incoherent_rays(scene)}
    bounces = bounce_rays(scene)
    results = {}
    for kernel in ("closest", "anyhit"):
        for case, rays in {**ray_sets, **bounces[kernel]}.items():
            res = compare_case(kernel, case, records, rays)
            res["l2_read_GBps_measured"] = l2_rate / 1e9
            res["row_traffic_ms"] = res["row_bytes"] / l2_rate * 1e3
            res["row_GBps_achieved"] = (res["row_bytes"]
                                        / (res["kernel_ms"] * 1e-3) / 1e9)
            emit("kernels", **res)
            results[(kernel, case)] = res
    return results


def phase_render(scene, spp: int, load_s: float, builder: str | None,
                 geometry_cache: str | None) -> tuple:
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.io.pfm import write_image
    from simplepath_tpu_torch.parallel.mesh import render_image_sharded
    from simplepath_tpu_torch.render import cuda_traverse as ct

    key = prng_key(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ct.reset_launch_counts()
    t0 = time.time()
    img = render_image_sharded(scene, spp, key)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches = dict(ct.launch_counts)

    st = scene.static
    if tuple(img.shape) != (st.height, st.width, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("render has non-finite pixels")
    mean = float(img.mean())
    if not mean > 0:
        raise AssertionError(f"render mean {mean} is not positive")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the render never launched kernel {name}")

    os.makedirs(OUT_DIR, exist_ok=True)
    out_path = os.path.join(OUT_DIR, st.output_file_name)
    write_image(out_path, img.cpu().numpy())
    paths = st.width * st.height * spp
    emit("render", scene=os.path.relpath(SCENE, HERE), width=st.width,
         height=st.height, max_depth=st.max_depth, spp=spp,
         triangles=st.num_triangles, record_rows=int(scene.bvh.records.shape[0]),
         load_s=load_s, load="warm" if geometry_cache else "cold",
         geometry_cache=geometry_cache and os.path.relpath(geometry_cache, HERE),
         bvh_builder=None if geometry_cache else builder, render_s=render_s,
         camera_paths_per_s=paths / render_s, launches=launches,
         image_mean=mean, output=os.path.relpath(out_path, HERE),
         max_memory_allocated=torch.cuda.max_memory_allocated())
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
    """One full frame through render_image_sharded, the launch counts set
    to 0 just before it and read just after."""
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel.mesh import render_image_sharded
    from simplepath_tpu_torch.render import cuda_traverse as ct

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ct.reset_launch_counts()
    t0 = time.time()
    img = render_image_sharded(scene, spp, prng_key(0))
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches = dict(ct.launch_counts)
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
                max_memory_allocated=torch.cuda.max_memory_allocated())


def ibl_light_sample_launches(scene) -> int:
    """CUDA launches of one batched IBL light sample (the two dependent
    binary searches), counted with the profiler on one 65,536-lane call."""
    from simplepath_tpu_torch.render.lights import env_light_sample
    u = torch.rand((65536, 2), device=scene.device)
    env_light_sample(scene.env, scene.static.env_kind, u)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        env_light_sample(scene.env, scene.static.env_kind, u)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


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


def parity_case(path: str, scene, side: int = 128, spp: int = 1) -> None:
    """One render through the kernels and one with the plain versions
    forced, both on the card, same key: allclose at rtol 1e-4, atol 1e-5."""
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
    emit("parity", path=path, integrator=small.static.integrator, side=side,
         spp=spp, kernel_launches=launches, plain_render_s=plain_s,
         mismatched_values=int((~close).sum()),
         max_abs_diff=float((a - b).abs().max()), mean_kernels=float(a.mean()),
         mean_plain=float(b.mean()))
    if not bool(close.all()) or not float(a.mean()) > 0:
        raise AssertionError(f"{path}: kernel render and plain-version "
                             "render differ")
    if launches["closest"] <= 0:
        raise AssertionError(f"{path}: the kernel render launched no sp_closest")


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
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch import cli
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel import mesh
    from simplepath_tpu_torch.render.film import render_image_progressive
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

    # the cut: the second pass dies, the checkpoint keeps the first
    real = mesh.render_image_sharded
    passes = []

    def dying(*a, **kw):
        passes.append(kw["spp_offset"])
        if len(passes) == 2:
            raise KeyboardInterrupt("cut after the first pass")
        return real(*a, **kw)

    mesh.render_image_sharded = dying
    try:
        render_image_progressive(sp.load_scene(IBL_TEST_SCENE), 8, prng_key(0),
                                 chunk=4, checkpoint_path=ck_cut,
                                 checkpoint_every=4)
        raise AssertionError("the cut render was not cut")
    except KeyboardInterrupt:
        pass
    finally:
        mesh.render_image_sharded = real
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


def bench_batch(scene, every: int = 4):
    """Every ``every``-th row and column of the frame: 256 x 256 = 65,536
    pixels spread over the 1024 x 1024 bench frame, one 65,536-ray chunk."""
    st = scene.static
    ys, xs = torch.meshgrid(torch.arange(0, st.height, every, device=scene.device),
                            torch.arange(0, st.width, every, device=scene.device),
                            indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def crop_batch(scene):
    r = torch.arange(*CROP, device=scene.device)
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


def grad_parity(scene, params, target, xs, ys, key) -> None:
    """The crop's gradient through the CUDA kernels and through their plain
    versions, both on the card: every leaf allclose at rtol 1e-4, atol 1e-6
    (the backward of the gathers accumulates with atomics, so the order of
    its sums varies)."""
    from simplepath_tpu_torch.diff import grad as G
    from simplepath_tpu_torch.render import cuda_traverse as ct
    loss_k, g_k = G.render_loss_and_grad(scene, params, target, xs, ys, 1, key)
    with ct.plain_versions():
        loss_p, g_p = G.render_loss_and_grad(scene, params, target, xs, ys, 1,
                                             key)
    diffs = {k: float((g_k[k] - g_p[k]).abs().max()) for k in g_k}
    emit("train", check="gradient_parity", pixels=int(xs.numel()), spp=1,
         loss_kernels=float(loss_k), loss_plain=float(loss_p),
         max_abs_diff=diffs,
         max_abs_grad={k: float(v.abs().max()) for k, v in g_k.items()})
    for k in g_k:
        if not torch.allclose(g_k[k], g_p[k], rtol=1e-4, atol=1e-6):
            raise AssertionError(f"gradient {k}: kernels and plain versions "
                                 f"differ by {diffs[k]}")
    if not finite(g_k):
        raise AssertionError("the crop's gradient is not finite")


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


def phase_train(scene) -> dict:
    """Reverse-mode rendering on the bench scene: the train path is the 3
    make_train_step calls over the albedo (launch counts set to 0 just
    before them and read just after); then one step over every leaf and
    over each group of leaves, the 4-spp step, the step's cost, the
    kernel/plain gradient parity and the finite differences."""
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

    g0 = leaf_group_steps(scene, p0, target, xs, ys, key)
    fd_probe(scene, p0, target, xs, ys, key, TRAIN_SPP, g0)
    step_cost(scene, params, target, xs, ys, key)

    cx, cy = crop_batch(scene)
    ctarget = torch.full((cx.numel(), 3), 0.25, device=scene.device)
    grad_parity(scene, p_true, ctarget, cx, cy, key)
    _, g4 = G.render_loss_and_grad(scene, p_true, ctarget, cx, cy, 4, key)
    crop = (scene, p_true, ctarget, cx, cy, key, 4, g4)
    fd_check(*crop, "mat_albedo", argmax_index(g4["mat_albedo"]), 1e-3)
    fd_check(*crop, "light_radiance", argmax_index(g4["light_radiance"]), 1e-2)
    fd_probe(*crop)
    return by_path


def kernels_line(results: dict, launches: dict, by_path: dict) -> dict:
    """The summary object: one entry per kernel, times from the N=65,536
    primary-ray case (the main path's chunk size), every ray set under
    ``cases``."""
    from simplepath_tpu_torch.render.cuda_traverse import LANES_PER_RAY
    entries = []
    for kernel in ("closest", "anyhit"):
        main = results[(kernel, "primary")]
        cases = [c for k, c in results if k == kernel]
        entries.append({
            "name": kernel, "route": "cuda",
            "source": "simplepath_tpu_torch/csrc/traverse.cu",
            "replaces": TPU_KERNEL[kernel],
            "launches": launches.get(kernel, 0),
            "max_abs_err": max(results[(kernel, c)]["max_abs_err"]
                               for c in cases),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "lanes_per_ray": LANES_PER_RAY,
            "cases": [{k: results[(kernel, c)][k] for k in (
                "case", "n", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "rows_visited", "distinct_internal_rows", "distinct_leaf_rows",
                "table_bytes", "row_traffic_ms", "row_GBps_achieved", "hits",
                "dead_rays", "visits_per_ray_mean", "visits_per_ray_max",
                "lane_step_share_32_rays_a_warp",
                "lane_step_share_4_rays_a_warp")}
                for c in cases],
        })
    return {"kernels": entries, "launches_by_path": by_path}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=4,
                    help="samples per pixel of the full-frame render")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs on the GPU only", file=sys.stderr)
        return 1

    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.scene import bvh, cache

    def timed(phase, fn, *args):
        t0 = time.time()
        out = fn(*args)
        emit("seconds", of=phase, s=time.time() - t0)
        return out

    info = timed("device", phase_device)
    if "build" in phases:
        timed("build", phase_build)

    t0 = time.time()
    scene = sp.load_scene(SCENE)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    geometry_cache = cache.LAST_HIT     # None: built now (and cached)

    results, by_path = {}, {}
    ibl = None
    if "paths" in phases or "parity" in phases:
        ibl = timed("ibl_scene", ibl_bench_scene)
    if "kernels" in phases:
        results = timed("kernels", phase_kernels, scene)
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
    if "train" in phases:
        by_path["train"] = timed("train", phase_train, scene)

    if results:
        print(json.dumps(kernels_line(
            results, by_path.get("iterative_rrnee", {}), by_path)), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
