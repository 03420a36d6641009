#!/usr/bin/env python3
"""The lucy-class stress scene end to end on the GPU: record-table
statistics and the full 1350x2000 frame — the port's counterpart of
tools/lucy_bench.py.

    python3 tools/torch_make_lucy_scene.py     # first: the 28.9M-triangle PLY
    python3 tools/torch_lucy_bench.py [--spp 4]

Loads scenes/lucy_bench.sp with ``load_scene`` on the card (cold: the BVH
built and cached in scenes/.spcache/; warm: served from there), prints the
record table's statistics (rows, bytes, leaves and their mean occupancy,
the tree depth and the stack slots it needs against the kernels'), then
renders the frame through ``render_image_sharded`` at --spp samples and
prints its seconds, camera paths/s, film mean, the launches of each
traversal kernel and the peak device memory, beside the card's name and
power limit.  Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SCENE = os.path.join(ROOT, "scenes", "lucy_bench.sp")


def print_table(stats: dict) -> None:
    print(f"record rows {stats['rows']:,} ({stats['bytes'] / 1e9:.2f} GB); "
          f"leaf rows {stats['leaves']:,}; mean leaf occupancy "
          f"{stats['mean_leaf_occupancy']:.2f}/{stats['leaf_size']}; depth "
          f"{stats['depth']}, stack slots needed {stats['stack_needed']} of "
          f"{stats['kernel_stack']}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel.mesh import render_image_sharded
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.scene import bvh, cache

    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    t0 = time.time()
    scene = sp.load_scene(SCENE)
    torch.cuda.synchronize()
    load = "warm" if cache.LAST_HIT else "cold"
    print(f"load ({load}) {time.time() - t0:.1f}s; tris "
          f"{scene.static.num_triangles:,}; host peak "
          f"{cs.host_peak_rss() / 1e9:.1f} GB", flush=True)
    print_table(bvh.table_stats(scene.bvh.records.cpu().numpy()))

    st = scene.static
    torch.cuda.reset_peak_memory_stats()
    ct.reset_launch_counts()
    t0 = time.time()
    img = render_image_sharded(scene, args.spp, prng_key(0))
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches = dict(ct.launch_counts)
    paths = st.width * st.height * args.spp
    print(f"render {st.width}x{st.height} @ {args.spp}spp: {render_s:.2f}s "
          f"({paths / render_s / 1e3:.1f}k camera paths/s on one card); "
          f"mean {float(img.mean()):.5f}; launches {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0:
        raise AssertionError("the frame is not finite and positive")
    return 0


if __name__ == "__main__":
    sys.exit(main())
