#!/usr/bin/env python3
"""The golden scenes and their assets, written by the port — the
counterpart of tools/make_goldens.py.

    python3 tools/torch_make_goldens.py                  # into chip_smoke_out/golden/scenes/
    python3 tools/torch_make_goldens.py --check          # and compare with tests/scenes/
    python3 tools/torch_make_goldens.py --ref BIN        # and render each golden with the C++ oracle

Writes the 15 golden scene texts (``<name>.sp``) and their assets (``ico.ply``,
``ico.stl``, ``blob.ply``, ``env.pfm``) into ``--out`` with the port's
``io/meshgen`` and ``io/pfm``.  ``--check`` compares every file written, byte
for byte, with the committed one in tests/scenes/ and exits non-zero on a
difference.  ``--ref BIN`` runs the reference binary on each scene in
``--out`` at the spp of ``all_scenes``, leaving ``<name>.pfm`` there and a
``manifest.json`` beside them.  It never writes under tests/.  Needs no
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from simplepath_tpu_torch.io.meshgen import (displaced_blob, icosphere,  # noqa: E402
                                             write_ply, write_stl)
from simplepath_tpu_torch.io.pfm import write_pfm  # noqa: E402

SCENES = os.path.join(ROOT, "tests", "scenes")
OUT = os.path.join(ROOT, "chip_smoke_out", "golden", "scenes")
ASSETS = ("ico.ply", "ico.stl", "blob.ply", "env.pfm")

COMMON_HEADER = """version: 1

scene_parameters {{
    output_file_name: "{name}.pfm"
    width: {w}
    height: {h}
    max_depth: {max_depth}
    russian_roulette_depth: 3
    integrator: {integrator}
}}

perspective_camera {{
    origin: 0.0 2.0 5.0
    look_at: 0.0 1.0 0.0
    fov: 45
}}
"""

BASIC_GEO = """
material_lambertian {
    name: "blue"
    diffuse: 0.2 0.3 0.7
}

material_lambertian {
    name: "grey"
    diffuse: 0.5 0.5 0.5
}

sphere {
    translate: -0.8 1.0 0.0
    material: "blue"
}

sphere {
    translate: 1.1 0.6 0.8
    scale: 0.6 0.6 0.6
    material: "grey"
}

plane {
    material: "grey"
}
"""

SPHERE_LIGHT = """
sphere_light {
    translate: 0.0 4.0 0.0
    radiance: 10.0 10.0 10.0
}
"""

ENV_LIGHT = """
environment_light {
    radiance: 0.6 0.7 0.8
}
"""

GLOSSY_GEO = """
material_glossy {
    name: "rough"
    diffuse: 0.7 0.3 0.2
    ior: 1.8
    roughness: 0.6
}

material_glossy {
    name: "shiny"
    diffuse: 0.3 0.6 0.3
    ior: 1.5
    roughness: 0.05
}

material_lambertian {
    name: "base_lam"
    diffuse: 0.2 0.3 0.7
}

material_clearcoat {
    name: "coat"
    base: "base_lam"
    ior: 1.5
    color: 1.0 0.9 0.9
}

material_lambertian {
    name: "grey"
    diffuse: 0.5 0.5 0.5
}

sphere {
    translate: -1.5 1.0 0.0
    material: "rough"
}

sphere {
    translate: 0.0 1.0 0.0
    material: "coat"
}

sphere {
    translate: 1.5 1.0 0.0
    material: "shiny"
}

plane {
    material: "grey"
}
"""

MESH_GEO = """
material_lambertian {{
    name: "grey"
    diffuse: 0.5 0.5 0.5
}}

material_lambertian {{
    name: "red"
    diffuse: 0.7 0.2 0.2
}}

mesh {{
    file: "{meshfile}"
    material: "red"
}}

plane {{
    material: "grey"
}}
"""

IBL_LIGHT = """
environment_light {
    rotate: 0.0 1.0 0.0 30.0
    radiance: 1.0 1.0 1.0
    max_radiance: 50
    image: "env.pfm"
}
"""

# every geometric, material and light kind in one golden, under the flagship
COMBO_GEO = """
material_lambertian {
    name: "grey"
    diffuse: 0.5 0.5 0.5
}

material_glossy {
    name: "rough"
    diffuse: 0.6 0.3 0.2
    ior: 1.6
    roughness: 0.4
}

material_lambertian {
    name: "base_lam"
    diffuse: 0.2 0.3 0.7
}

material_clearcoat {
    name: "coat"
    base: "base_lam"
    ior: 1.5
    color: 1.0 0.9 0.9
}

material_glossy {
    name: "shiny"
    diffuse: 0.3 0.6 0.3
    ior: 1.5
    roughness: 0.05
}

mesh {
    file: "blob.ply"
    translate: -0.9 0.0 0.0
    material: "rough"
}

sphere {
    translate: 1.2 1.0 0.3
    material: "coat"
}

sphere {
    translate: 0.3 0.6 1.3
    scale: 0.55 0.55 0.55
    material: "shiny"
}

plane {
    material: "grey"
}
"""


def scene_text(name, integrator, body, w=64, h=64, max_depth=8):
    return COMMON_HEADER.format(name=name, w=w, h=h, max_depth=max_depth,
                                integrator=integrator) + body


def all_scenes():
    return {
        # name: (integrator, body, spp, size, max_depth)
        "g_direct": ("direct_lighting", BASIC_GEO + SPHERE_LIGHT, 256, 64, 8),
        "g_combo_ibl": ("iterative_rrnee",
                        COMBO_GEO + SPHERE_LIGHT + IBL_LIGHT, 256, 64, 6),
        "g_direct_env": ("direct_lighting", BASIC_GEO + ENV_LIGHT, 256, 64, 8),
        "g_bf": ("brute_force", BASIC_GEO + ENV_LIGHT, 128, 48, 4),
        "g_bfiter": ("brute_force_iterative", BASIC_GEO + ENV_LIGHT, 128, 48, 5),
        "g_bfiterrr": ("brute_force_iterative_rr", BASIC_GEO + ENV_LIGHT, 128, 48, 8),
        "g_rrnee": ("iterative_rrnee", BASIC_GEO + SPHERE_LIGHT + ENV_LIGHT, 256, 64, 6),
        "g_whitted": ("whitted", GLOSSY_GEO + SPHERE_LIGHT, 128, 64, 4),
        "g_glossy": ("iterative_rrnee", GLOSSY_GEO + ENV_LIGHT, 256, 64, 5),
        "g_mesh_ply": ("iterative_rrnee",
                       MESH_GEO.format(meshfile="ico.ply") + SPHERE_LIGHT + ENV_LIGHT,
                       128, 64, 5),
        "g_mesh_stl": ("direct_lighting",
                       MESH_GEO.format(meshfile="ico.stl") + SPHERE_LIGHT, 128, 64, 5),
        "g_blob": ("iterative_rrnee",
                   MESH_GEO.format(meshfile="blob.ply") + ENV_LIGHT, 128, 48, 5),
        "g_ibl": ("direct_lighting", BASIC_GEO + IBL_LIGHT, 256, 64, 8),
        "g_ibl_rrnee": ("iterative_rrnee", BASIC_GEO + IBL_LIGHT, 256, 48, 5),
        "g_mandel": ("mandelbrot", "", 1, 64, 8),
    }


def make_assets(out: str) -> list:
    """The meshes and the environment map → the names written."""
    v, f = icosphere(3)  # 1280 tris
    v = v * 0.8
    v[:, 1] += 1.0
    write_ply(os.path.join(out, "ico.ply"), v, f)
    write_stl(os.path.join(out, "ico.stl"), v, f)

    vb, fb = displaced_blob(4)  # 5120 tris
    vb = vb * 0.8
    vb[:, 1] += 1.0
    write_ply(os.path.join(out, "blob.ply"), vb, fb)

    # smooth gradient + a bright 3x2-texel "sun"
    h, w = 16, 32
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img = np.stack([0.2 + 0.3 * xx, 0.3 + 0.2 * yy, 0.4 + 0.1 * xx * yy], axis=-1)
    img[3:5, 6:9] = [20.0, 18.0, 15.0]
    write_pfm(os.path.join(out, "env.pfm"), img.astype(np.float32))
    return list(ASSETS)


def write_scenes(out: str) -> list:
    """Every golden's scene text → the names written."""
    names = []
    for name, (integ, body, _, size, max_depth) in all_scenes().items():
        with open(os.path.join(out, name + ".sp"), "w") as f:
            f.write(scene_text(name, integ, body, w=size, h=size,
                               max_depth=max_depth))
        names.append(name + ".sp")
    return names


def differing(out: str, files: list, committed: str = SCENES) -> list:
    """The files of ``files`` in ``out`` whose bytes differ from (or are
    missing in) ``committed``."""
    bad = []
    for name in files:
        theirs = os.path.join(committed, name)
        with open(os.path.join(out, name), "rb") as f:
            ours = f.read()
        if not os.path.exists(theirs):
            bad.append(name)
            continue
        with open(theirs, "rb") as f:
            if f.read() != ours:
                bad.append(name)
    return bad


def run_oracle(ref: str, out: str, threads: int) -> dict:
    """Each golden rendered by the reference binary in ``out`` → the
    manifest entries (written to ``out``/manifest.json)."""
    manifest = {}
    for name, (integ, _, spp, size, max_depth) in all_scenes().items():
        print(f"render {name} ({integ}, {size}x{size} @ {spp}spp)...",
              flush=True)
        subprocess.run([ref, "--threads", str(threads), "--samples", str(spp),
                        name + ".sp"], cwd=out, check=True, capture_output=True)
        manifest[name] = {"spp": spp, "integrator": integ, "size": size,
                          "max_depth": max_depth}
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--check", action="store_true",
                    help="compare every file written with tests/scenes/")
    ap.add_argument("--ref", default=None,
                    help="the reference binary; renders the goldens in --out")
    ap.add_argument("--threads", type=int, default=os.cpu_count())
    args = ap.parse_args(argv)
    if args.ref is not None and not os.path.isfile(args.ref):
        ap.error(f"--ref {args.ref}: no such file")
    if os.path.abspath(args.out).startswith(os.path.join(ROOT, "tests") + os.sep):
        ap.error("--out must lie outside tests/")

    os.makedirs(args.out, exist_ok=True)
    files = make_assets(args.out) + write_scenes(args.out)
    print(f"wrote {len(files)} files into {args.out}", flush=True)
    rc = 0
    if args.check:
        bad = differing(args.out, files)
        print(json.dumps({"checked": len(files), "differ": bad}), flush=True)
        rc = 1 if bad else 0
    if args.ref is not None:
        print(f"done: {len(run_oracle(args.ref, args.out, args.threads))} "
              "goldens", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
