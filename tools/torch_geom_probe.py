#!/usr/bin/env python3
"""What the BVH forest (parallel/geom_shard.py) costs on the GPU, against
one BVH, on the bench scene (scenes/bunny_bench.sp) — the port's
counterpart of tools/geom_tpu_probe.py.

    python3 tools/torch_geom_probe.py [--shards 1,2,4] [--repeat 3]

Prints one JSON object per line:

  query   one closest-hit and one any-hit query of 65,536 primary rays: the
          device milliseconds a query (CUDA events, the card spinning first
          so that the host's enqueue is not timed) and the host microseconds
          to enqueue one (no synchronisation), for one BVH and for each
          forest
          and the calls in one query that wait for the device
  chunk   one 65,536-ray chunk of the frame (rows 480-543) at 1 spp through
          render_rays, one BVH and each forest in turns, ``--repeat``
          rounds: wall seconds and host ms inside the closest-hit and
          occlusion queries; then once each under the profiler: launches
          of each kernel, device-busy ms, CUDA launches, the traversal
          kernels' device ms
  frame   the full frame at 1 spp in turns: one BVH, and the largest forest
          through render_image_geom_sharded and render_image_sharded

Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPIN_CYCLES = 100_000_000    # the host queues the launches meanwhile
SPIN_TRIES = 4               # each try spins twice as long


def device_ms(fn, reps: int = 10) -> float | None:
    """Device milliseconds a call, the card spinning while the host queues
    the ``reps`` calls; None if the host outlasted every spin.  ``reps`` is
    kept small: a forest query is ~60 launches, and past CUDA's queue
    of pending launches the host waits for the spinning card."""
    start, end, spun = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event())
    fn()
    for attempt in range(SPIN_TRIES):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES << attempt)
        spun.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        in_time = not spun.query()
        torch.cuda.synchronize()
        if in_time:
            return start.elapsed_time(end) / reps
    return None


def host_syncs(fn) -> list:
    """The synchronising calls one call of ``fn`` makes (CUDA's sync debug
    mode, as warnings)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message)[:200] for w in caught]


def host_us(fn, reps: int = 20) -> float:
    """Host microseconds to enqueue one call (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", default="1,2,4")
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel.geom_shard import (
        make_geom_mesh, shard_scene_geometry, sharded_anyhit, sharded_closest)
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.render.camera import generate_ray

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    one = sp.load_scene(os.path.join(ROOT, "scenes", "bunny_bench.sp"))
    scenes = {"one_bvh": one}
    for d in (int(x) for x in args.shards.split(",")):
        scenes[f"forest_{d}"] = shard_scene_geometry(one, make_geom_mesh(d))

    st = one.static
    g = torch.arange(256, device=one.device, dtype=torch.float32) + 0.5
    py, px = torch.meshgrid(g * (st.height / 256), g * (st.width / 256),
                            indexing="ij")
    ro, rd = generate_ray(one.camera, px.reshape(-1), py.reshape(-1))
    ro, rd = ro.contiguous(), rd.contiguous()
    t_min = torch.full((ro.shape[0],), 1e-3, device=one.device)
    t_max = torch.full((ro.shape[0],), float("inf"), device=one.device)
    for name, sc in scenes.items():
        rec = sc.bvh.records
        if name == "one_bvh":
            closest = lambda: ct.closest(rec, ro, rd, t_min, t_max)
            anyhit = lambda: ct.anyhit(rec, ro, rd, t_min, t_max)
        else:
            closest = lambda: sharded_closest(rec, ro, rd, t_min, t_max)
            anyhit = lambda: sharded_anyhit(rec, ro, rd, t_min, t_max)
        print(json.dumps({"query": {
            "card": smi, "scene": name, "rays": int(ro.shape[0]),
            "closest_device_ms": device_ms(closest),
            "closest_host_us": host_us(closest),
            "closest_syncs": host_syncs(closest),
            "anyhit_device_ms": device_ms(anyhit),
            "anyhit_host_us": host_us(anyhit),
            "anyhit_syncs": host_syncs(anyhit)}}), flush=True)

    w = st.width
    lin = torch.arange(480 * w, 544 * w, device=one.device)
    xs, ys = lin % w, lin // w

    def render(sc, seed):
        out = sp.render_rays(sc, xs, ys, 1, prng_key(seed))
        torch.cuda.synchronize()
        return out

    from simplepath_tpu_torch.render import integrators
    queries = {}                 # host ms inside the two scene queries
    for attr in ("scene_intersect_batch", "scene_intersect_p_batch"):
        def timed(*a, _fn=getattr(integrators, attr), _k=attr, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            queries[_k] = queries.get(_k, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        setattr(integrators, attr, timed)

    for sc in scenes.values():
        render(sc, 0)                            # first-use costs
    walls = {name: [] for name in scenes}
    query_ms = {name: [] for name in scenes}
    order = list(scenes)
    for r in range(args.repeat):
        for name in (order if r % 2 == 0 else order[::-1]):
            queries.clear()
            t0 = time.time()
            render(scenes[name], 1 + r)
            walls[name].append(time.time() - t0)
            query_ms[name].append(dict(queries))
    for name, sc in scenes.items():
        ct.reset_launch_counts()
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            render(sc, 100)
        wall = time.time() - t0
        dev = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
        busy = sum(ms for _, ms, _ in dev)
        print(json.dumps({"chunk": {
            "card": smi, "scene": name, "rays": int(lin.numel()), "spp": 1,
            "seconds": walls[name], "query_host_ms": query_ms[name],
            "seconds_under_profiler": wall,
            "traversal_launches": dict(ct.launch_counts),
            "cuda_launches": sum(c for _, _, c in dev), "busy_ms": busy,
            "busy_share_of_profiled_wall": busy / 1e3 / wall,
            "traversal_device_ms": sum(ms for k, ms, _ in dev
                                       if "traverse_kernel" in k)}}),
              flush=True)

    # whole frames at 1 spp in turns (A B C C B A): one BVH through
    # render_image_sharded, the largest forest through its own entry point
    # and through render_image_sharded
    from simplepath_tpu_torch.parallel import (render_image_geom_sharded,
                                               render_image_sharded)
    big = list(scenes)[-1]
    runs = {"one_bvh": (one, render_image_sharded),
            f"{big}_geom_entry": (scenes[big], render_image_geom_sharded),
            f"{big}_sharded_entry": (scenes[big], render_image_sharded)}
    frame_s = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        sc, fn = runs[name]
        torch.cuda.synchronize()
        t0 = time.time()
        fn(sc, 1, prng_key(0))
        torch.cuda.synchronize()
        frame_s[name].append(time.time() - t0)
    print(json.dumps({"frame": {"card": smi, "width": st.width,
                                "height": st.height, "spp": 1,
                                "seconds_in_turns": frame_s}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
