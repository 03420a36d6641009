#!/usr/bin/env python3
"""Visits a ray and a warp, and the latency of a dependent row load, on the
GPU: the port's counterpart of tools/prof_visits.py.

    python3 tools/torch_prof_visits.py        # N=65536 rays; COUNT_ONLY=1: counts only

On the bench scene (scenes/bunny_bench.sp), for N primary rays (a regular
grid over the 1024x1024 frame) and N incoherent rays (origins uniform in
[-3, 3]^3, directions uniform, from a seed), the counting closest-hit kernel
(sp_closest_count) gives each ray's internal and leaf visits.  Printed: the
visits a ray (mean, max), the visits a warp (the most of its 32 / W rays:
a warp runs as long as its slowest ray) and the lock-step share, where the
TPU tool printed visits a 1,024-ray packet; then sp_closest's device time
over the visits (ns a visit, ns a warp step), and a serial chase of 20,000
row copies (sp_row_chase, one chain): ns a hop.  Times are CUDA events with
the card spinning first (chip_smoke.time_cuda).  Needs one CUDA device;
imports nothing of JAX.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.render import cuda_probes as cp
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.scene.bvh import LEAF_ROWS

    n = int(os.environ.get("N", "65536"))
    scene = sp.load_scene(cs.SCENE)
    rec = scene.bvh.records
    print(f"card: {cs.nvidia_smi_line()}")
    print(f"tris={scene.static.num_triangles} rows={tuple(rec.shape)}")
    side = int(n ** 0.5)
    sets = {"primary": cs.primary_rays(scene, side),
            "incoherent": cs.uniform_rays(side * side, 0, scene.device)}
    count_only = os.environ.get("COUNT_ONLY") == "1"
    for label, rays in sets.items():
        out = cp.closest_count(rec, *rays)
        r = cs.visit_readings(*out[5:], ct.LANES_PER_RAY)
        visits = int((out[5] + out[6]).sum())
        print(f"{label}: visits/ray mean={r['visits_per_ray_mean']:.2f} "
              f"(int {r['internal_per_ray_mean']:.2f} / leaf "
              f"{r['leaf_per_ray_mean']:.2f}) max={r['visits_per_ray_max']}; "
              f"visits/warp ({r['rays_a_warp']} rays) mean="
              f"{r['visits_per_warp_mean']:.2f} max={r['visits_per_warp_max']}; "
              f"lock-step share {r['lock_step_share']:.1%}", flush=True)
        if count_only:
            continue
        ms = cs.time_cuda(lambda: ct.closest(rec, *rays), 50)
        warp_steps = r["visits_per_warp_mean"] * -(-side * side // r["rays_a_warp"])
        print(f"  closest: {ms:.4f} ms -> {ms * 1e6 / visits:.2f} ns/visit "
              f"({ms * 1e6 / warp_steps:.2f} ns/warp-step)", flush=True)
    if count_only:
        return 0
    hops = cs.PROBE_HOPS
    cp.row_chase(rec, 1, hops)
    ms = cs.time_cuda(lambda: cp.row_chase(rec, 1, hops), 5)
    print(f"row chase: {ms * 1e6 / hops:.1f} ns/hop ({hops} serial "
          f"{LEAF_ROWS * 512}B row copies in {ms:.3f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
