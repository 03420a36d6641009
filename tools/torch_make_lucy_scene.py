#!/usr/bin/env python3
"""Write the lucy-class stress scene's mesh with the PyTorch/CUDA port's
mesh generator — the port's counterpart of tools/make_lucy_scene.py.

    python3 tools/torch_make_lucy_scene.py [--tris 28_880_000] [--out DIR]

The mesh is a displaced n x n grid (``io/meshgen.write_terrain``) with the
JAX tool's rule n = int((tris / 2) ** 0.5) + 2, so that 2 (n - 1)^2 >=
tris: the default gives n = 3802 and 28,895,202 triangles (14,440,000 is a
perfect square, so the rule rounds up one row past displaced_grid(3801)'s
28,880,000), written as binary PLY to DIR/terrain_28m.ply (default
scenes/, where .gitignore lists it); the bytes are those the JAX tool
writes.  The scene file, scenes/lucy_bench.sp (in the repo), is not
rewritten: it is only checked to name that mesh and the 1350x2000 film.
Then:

    python3 tools/torch_lucy_bench.py
    python3 tools/torch_lucy_geom_bench.py

Imports nothing of JAX; needs no GPU.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from simplepath_tpu_torch.io.meshgen import write_terrain  # noqa: E402

SCENE_DIR = os.path.join(ROOT, "scenes")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tris", type=int, default=cs.LUCY_TRIS,
                    help="minimum triangle count (the grid rounds up)")
    ap.add_argument("--out", default=SCENE_DIR,
                    help="directory of the PLY (default: scenes/)")
    args = ap.parse_args()
    cs.check_scene_text()
    print(f"{cs.LUCY_SCENE} names {cs.LUCY_MESH} at 1350x2000 "
          "(not rewritten)")
    write_terrain(os.path.join(args.out, cs.LUCY_MESH), args.tris)
    return 0


if __name__ == "__main__":
    sys.exit(main())
