#!/usr/bin/env python3
"""How many dependent row loads one warp keeps in flight: the port's
counterpart of tools/prof_dma_chains.py.

    python3 tools/torch_prof_dma_chains.py    # H=20000 hops

sp_row_chase runs C = 1, 2, 4, 8 independent pointer chases over the bench's
table in one warp, each hop a copy of one row into shared memory, every
chain's copy of a step issued before any is waited on.  If C chains take as
long as one, the loads overlap and more chains in flight pay; if the time
grows with C, they serialise.  The chase cycles through a few rows, which
stay in L1/L2: it reads the latency of a cached dependent row load, as a
traversal's top rows are, not of device memory.  Needs one CUDA device;
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

    hops = cs.PROBE_HOPS
    scene = sp.load_scene(cs.SCENE)
    print(f"card: {cs.nvidia_smi_line()}")
    for r in cs.probe_chase(scene.bvh.records, hops):
        c = r["chains"]
        print(f"C={c}: {r['kernel_ms']:.3f} ms total, {r['ns_per_hop']:.1f} "
              f"ns/step, {r['ns_per_hop_per_chain']:.1f} ns/hop-effective "
              f"({r['distinct_rows']} distinct rows)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
