#!/usr/bin/env python3
"""What one visit body costs on the GPU, with the row in shared memory: the
port's counterpart of tools/prof_visit_vpu.py.

    python3 tools/torch_prof_visit_vpu.py     # M=100000 bodies a mode

sp_visit_body runs M back-to-back visit bodies for the TPU probe's fixed ray
on rows 0 and 1 of the bench's table (which the ray misses) and on a table
whose rows it crosses (render/cuda_probes.py::crossed_table), in four modes:
``internal`` (slab test, placement by rank, the network on equal keys, the
ballot and push), ``internal_norel`` (the slab test alone), ``sort_only``
(the placement alone) and ``leaf`` (the lane's triangle slots and the
butterfly), each in three launch shapes: one warp (its ns a body is the
latency of one body), one full wave over every SM (ns a ray-body card-wide:
the throughput) and one at sp_closest's occupancy.  Each is first held
against its plain version (chip_smoke.check_visit_body).
Set SIMPLEPATH_BVH_WIDTH=16 or SIMPLEPATH_BVH_LEAF=24 for another topology.
Needs one CUDA device; imports nothing of JAX.
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
    from simplepath_tpu_torch.scene.bvh import LEAF_SIZE, WIDTH

    bodies = cs.PROBE_BODIES
    scene = sp.load_scene(cs.SCENE)
    print(f"card: {cs.nvidia_smi_line()}; W={WIDTH} K={LEAF_SIZE}")
    for r in cs.probe_visit_body(scene.bvh.records, bodies):
        line = (f"{r['table']:7s} {r['mode']:16s} {r['shape']:19s} "
                f"M={bodies} rays={r['rays']}: "
                f"{r['kernel_ms']:9.3f} ms -> {r['ns_per_body']:8.2f} ns/visit")
        if r["shape"] != "one_warp":
            line += (f", {r['ns_per_ray_body'] * 1e3:.3f} ps/ray-visit "
                     f"({r['bodies_per_s'] / 1e9:.1f} G visits/s; bound "
                     f"{r['bound_ms']:.3f} ms; {r['blocks_per_sm']} blocks "
                     f"an SM hold, sp_closest {r['closest_blocks_per_sm']})")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
