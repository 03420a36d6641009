#!/usr/bin/env python3
"""Histogram of hit children (n_push) per internal visit on the GPU: the
port's counterpart of tools/prof_npush.py.

    python3 tools/torch_prof_npush.py         # N=65536 rays

On the bench scene, for N primary and N incoherent rays (as
tools/torch_prof_visits.py makes them), the counting closest-hit kernel
(sp_closest_count) counts each ray's internal visits by the number of
children it pushed: 0, 1, 2, >= 3.  Printed: the shares over all internal
visits.  Where n_push <= 1 the kernel's placement is trivial; where the hit
children's keys tie it runs the sorting network.  Needs one CUDA device;
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

    n = int(os.environ.get("N", "65536"))
    scene = sp.load_scene(cs.SCENE)
    rec = scene.bvh.records
    print(f"card: {cs.nvidia_smi_line()}")
    side = int(n ** 0.5)
    sets = {"primary": cs.primary_rays(scene, side),
            "incoherent": cs.uniform_rays(side * side, 0, scene.device)}
    for label, rays in sets.items():
        out = cp.closest_count(rec, *rays)
        r = cs.visit_readings(*out[5:], ct.LANES_PER_RAY)
        h = r["n_push_shares"]
        print(f"{label}: internal visits {r['internal_visits']}; n_push "
              f"histogram 0: {h[0]:.1%}  1: {h[1]:.1%}  2: {h[2]:.1%}  "
              f">=3: {h[3]:.1%}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
