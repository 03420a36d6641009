#!/usr/bin/env python3
"""The lucy-class stress scene as a BVH forest on the GPU: the forest
build, its cache and the sharded-combine render — the port's counterpart
of tools/lucy_geom_bench.py.

    python3 tools/torch_make_lucy_scene.py     # first: the 28.9M-triangle PLY
    python3 tools/torch_lucy_geom_bench.py [--res 135x200] [--spp 1]

Builds scenes/lucy_bench.sp without a BVH on the card, then its forest
(``parallel/geom_shard.shard_scene_geometry`` over ``make_geom_mesh(4)``:
the D shards on the one card) twice through a cache of its own,
scenes/.spcache/lucy_forest/ (chip_smoke.forest_builds): cold, the cache
emptied first, then warm, served by it.  Prints each shard's rows in use and
mean leaf occupancy, then renders the film at --res through
``render_image_geom_sharded`` and requires it finite with a positive
maximum; its seconds, film mean,
launches of each traversal kernel and peak device memory, beside the card's
name and power limit.  Needs one CUDA device; imports nothing of JAX.
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

SCENE_DIR = os.path.join(ROOT, "scenes")


def lucy_text(width: int, height: int) -> str:
    """scenes/lucy_bench.sp's text with a width x height film."""
    text = cs.check_scene_text()
    return (text.replace("width: 1350", f"width: {width}")
            .replace("height: 2000", f"height: {height}"))


def shard_stats(records) -> dict:
    """Each shard's table statistics (``bvh.table_stats``): rows in use and
    mean leaf occupancy, as lists over the shards."""
    from simplepath_tpu_torch.scene.bvh import table_stats
    rec = records.cpu().numpy()
    stats = [table_stats(rec[d]) for d in range(rec.shape[0])]
    return dict(padded_rows=int(rec.shape[1]),
                used_rows=[s["used_rows"] for s in stats],
                mean_leaf_occupancy=[s["mean_leaf_occupancy"] for s in stats],
                depth=[s["depth"] for s in stats])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="135x200")
    ap.add_argument("--spp", type=int, default=1)
    args = ap.parse_args()
    w, h = (int(x) for x in args.res.split("x"))
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from simplepath_tpu_torch import build_scene
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel.geom_shard import (
        make_geom_mesh, render_image_geom_sharded)
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.scene.parser import parse_sp

    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    t0 = time.time()
    scene = build_scene(parse_sp(lucy_text(w, h), base_dir=SCENE_DIR),
                        use_bvh=False)
    torch.cuda.synchronize()
    print(f"parse+load (no BVH): {time.time() - t0:.1f}s; tris "
          f"{scene.static.num_triangles:,}", flush=True)

    forest, cold, warm = cs.forest_builds(
        scene, make_geom_mesh(cs.GEOM_SHARDS),
        os.path.join(SCENE_DIR, ".spcache", "lucy_forest"))
    stats = shard_stats(forest.bvh.records)
    D, M = forest.bvh.records.shape[:2]
    print(f"forest build COLD (incl. cache save): {cold:.1f}s; {D} shards, "
          f"padded rows {M:,} each "
          f"({D * M * 512 / 1e9:.2f} GB stacked); per-shard used rows "
          f"{stats['used_rows']}; mean leaf occupancy "
          f"{[round(o, 2) for o in stats['mean_leaf_occupancy']]}; depth "
          f"{stats['depth']}", flush=True)
    print(f"forest build WARM (cache hit): {warm:.1f}s", flush=True)
    del scene

    torch.cuda.reset_peak_memory_stats()
    ct.reset_launch_counts()
    t0 = time.time()
    img = render_image_geom_sharded(forest, args.spp, prng_key(0))
    torch.cuda.synchronize()
    render_s = time.time() - t0
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0):
        raise AssertionError("broken render: not finite, or all zero")
    print(f"geom-sharded render {w}x{h} @ {args.spp}spp on {D} shards on one "
          f"card: {render_s:.2f}s; film mean {float(img.mean()):.5f}; "
          f"launches {dict(ct.launch_counts)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
