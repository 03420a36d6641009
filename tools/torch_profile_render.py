#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's main path: profile the
render of one 65,536-ray chunk of a scene (default the bench,
scenes/bunny_bench.sp) on the GPU: the 65,536 pixels around the middle of
its frame (chip_smoke.middle_run; the bench's rows 480-543).

    python3 tools/torch_profile_render.py [--spp 1] [--repeat 3] [--scene PATH]
    python3 tools/torch_profile_render.py --scene scenes/lucy_bench.sp
        # after tools/torch_make_lucy_scene.py (and, for a warm load,
        # tools/torch_lucy_bench.py)

Prints one JSON object per line:

  wall      seconds per chunk render without the profiler, ``--repeat``
            times (the spread says how far to trust a difference), and once
            under the profiler (what the instrumentation costs)
  device    device-busy milliseconds (sum of CUDA kernel times), its share of
            the profiled wall time and of the median wall time without the
            profiler (the card's busy share), the number of kernel launches,
            and the share of the two traversal kernels
  stages    host milliseconds spent inside each stage of the bounce loop
            (host clock around the stage's function, no synchronisation, in a
            run without the profiler) — the port is launch-bound, so host
            time is the breakdown; "rng" calls made inside "nee" count in
            both
  kernels   the ten CUDA kernels with the most device time

Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# (module, attribute) → stage label; each is wrapped with a host timer
STAGES = {
    ("integrators", "fold_in"): "rng",
    ("integrators", "uniform_sites"): "rng",
    ("integrators", "scene_intersect_lights"): "light_hits",
    ("integrators", "scene_intersect_batch"): "closest_hit",
    ("integrators", "hit_shading"): "shading",
    ("integrators", "_sample_batch"): "material_sample",
    ("integrators", "_estimate_direct_mis_all"): "nee",
    ("integrators", "_coherence_order"): "sort_key",
}


def time_stages() -> dict:
    """Wrap the bounce loop's stage functions with host timers; returns the
    dict they accumulate into ({label: {"host_ms", "calls"}})."""
    from simplepath_tpu_torch.render import integrators
    acc: dict = {}
    for (_, attr), label in STAGES.items():
        fn = getattr(integrators, attr)
        slot = acc.setdefault(label, {"host_ms": 0.0, "calls": 0})

        def wrapped(*a, _fn=fn, _slot=slot, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            _slot["host_ms"] += (time.perf_counter() - t0) * 1e3
            _slot["calls"] += 1
            return out
        setattr(integrators, attr, wrapped)
    return acc


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--scene", default=cs.SCENE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.scene import cache

    smi = cs.nvidia_smi_line()
    t0 = time.time()
    scene = sp.load_scene(args.scene)
    torch.cuda.synchronize()
    load = {"scene": os.path.relpath(os.path.abspath(args.scene), ROOT),
            "load_s": time.time() - t0,
            "load": "warm" if cache.LAST_HIT else "cold",
            "triangles": scene.static.num_triangles,
            "record_rows": int(scene.bvh.records.shape[0])}
    st = scene.static
    lin = torch.arange(*cs.middle_run(st.width, st.height), device=scene.device)
    xs, ys = lin % st.width, lin // st.width

    def render(seed):
        out = sp.render_rays(scene, xs, ys, args.spp, prng_key(seed))
        torch.cuda.synchronize()
        return out

    render(0)                                   # warm-up: builds the kernels
    walls = []
    for i in range(args.repeat):
        t0 = time.time()
        render(1 + i)
        walls.append(time.time() - t0)

    ct.reset_launch_counts()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render(100)
    profiled_wall = time.time() - t0
    print(json.dumps({"wall": {"card": smi, **load, "rays": int(lin.numel()),
                               "pixels": [int(lin[0]), int(lin[-1]) + 1],
                               "spp": args.spp, "seconds": walls,
                               "seconds_under_profiler": profiled_wall,
                               "traversal_launches": dict(ct.launch_counts)}}))

    # kernel events only: an operator's row repeats its kernels' device time
    events = prof.key_averages()
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in dev)
    launches = sum(c for _, _, c in dev)
    trav_ms = sum(ms for k, ms, _ in dev if "traverse_kernel" in k)
    print(json.dumps({"device": {
        "busy_ms": busy_ms, "busy_share_of_profiled_wall": busy_ms / 1e3 / profiled_wall,
        "busy_share_of_wall": busy_ms / 1e3 / statistics.median(walls),
        "kernel_launches": launches, "traversal_ms": trav_ms,
        "traversal_share_of_busy": trav_ms / busy_ms if busy_ms else None}}))
    top = sorted(dev, key=lambda x: -x[1])[:10]
    print(json.dumps({"kernels": [{"name": k[:90], "device_ms": ms, "count": c}
                                  for k, ms, c in top]}))

    stages = time_stages()
    t0 = time.time()
    render(200)
    print(json.dumps({"stages": stages, "wall_s": time.time() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
