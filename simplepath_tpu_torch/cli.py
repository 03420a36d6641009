"""The command-line renderer.

Counterpart of ``simplepath_tpu/cli.py``, with the same flags:

    python -m simplepath_tpu_torch.cli [--samples N] [--integrator NAME]
                                       [--spp-chunk N] [--checkpoint PATH]
                                       [--geom-shards N] [--platform cpu]
                                       [--test] <scene.sp | ->

The render runs on CUDA and the command fails without a CUDA device, unless
``--platform`` names another torch device (``--platform cpu`` runs the
kernels' plain versions).  ``--threads`` is accepted and ignored.
``--integrator`` overrides the scene, which overrides the DirectLighting
default.  ``--test`` runs the port's tests (``tests/test_torch_*.py``).
Output is written to the scene's ``output_file_name`` next to the scene file
(the working directory for a scene read from stdin).

Rendering goes through the chunked path (bounded device memory at any
resolution).  With ``--spp-chunk`` or ``--checkpoint`` it runs
progressively in spp-chunk passes — resumable, with a progress bar — and
sample streams are keyed by absolute sample index, so the result equals an
uninterrupted render.  ``--geom-shards N`` builds the BVH as a forest of N
sub-BVHs on the render device (``parallel/geom_shard.py``; the forest is
cached beside the scene) and renders through it, progressive and
checkpointed passes included.  ``--profile DIR`` writes a
``torch.profiler`` trace.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import logging
import os
import sys
import time

from .scene.types import INTEGRATORS


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="simplepath_tpu_torch",
        description="PyTorch/CUDA path tracer (SimplePath-compatible)")
    ap.add_argument("scene", nargs="?", help=".sp scene file, or '-' for stdin")
    ap.add_argument("--samples", type=int, default=1,
                    help="samples per pixel (default 1, like the reference)")
    ap.add_argument("--threads", type=int, default=None,
                    help="accepted for compatibility; ignored")
    ap.add_argument("--integrator", choices=INTEGRATORS, default=None)
    ap.add_argument("--test", action="store_true",
                    help="run the port's tests and exit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default=None,
                    help="torch device to render on (default: cuda)")
    ap.add_argument("--output", default=None, help="override output file name")
    ap.add_argument("--stats", action="store_true", help="print render stats")
    ap.add_argument("--spp-chunk", type=int, default=0,
                    help="render progressively in passes of N spp "
                         "(default: one pass)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="save film+spp checkpoints to PATH and resume from "
                         "it (implies progressive rendering)")
    ap.add_argument("--no-progress", action="store_true",
                    help="disable the progress bar in progressive mode")
    ap.add_argument("--geom-shards", type=int, default=0, metavar="N",
                    help="build the BVH as a forest of N shards on the "
                         "render device and render through it")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the render into DIR")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    if args.test:
        import pytest
        tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             os.pardir, "tests")
        return pytest.main(["-q", *sorted(glob.glob(os.path.join(
            tests, "test_torch_*.py")))])
    if args.scene is None:
        ap.error("a scene file (or '-') is required")
    import numpy as np
    import torch

    from .core.rng import prng_key
    from .device import resolve_device
    from .io.pfm import write_image
    from .scene.build import build_scene, load_scene
    from .scene.parser import parse_sp
    from .utils import format_hms

    device = resolve_device(args.platform)
    t0 = time.time()
    use_bvh = False if args.geom_shards > 1 else None  # the forest replaces it
    if args.scene == "-":
        scene = build_scene(parse_sp(sys.stdin.read()),
                            cli_integrator=args.integrator, use_bvh=use_bvh,
                            device=device)
        out_dir = os.getcwd()
    else:
        scene = load_scene(args.scene, cli_integrator=args.integrator,
                           use_bvh=use_bvh, device=device)
        out_dir = os.path.dirname(os.path.abspath(args.scene))
    t_parse = time.time() - t0

    prof = contextlib.nullcontext()
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)

    t0 = time.time()
    with prof:
        img = _render(ap, args, scene, out_dir, prng_key(args.seed, device),
                      device)
        img = img.cpu().numpy()         # waits for the device
    t_render = time.time() - t0
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))

    out = args.output or os.path.join(out_dir, scene.static.output_file_name)
    write_image(out, np.asarray(img))

    rays = scene.static.width * scene.static.height * args.samples
    print(f"Wrote {out}")
    if args.profile:
        print(f"Profiler trace written to {args.profile}")
    print(f"Elapsed time: {format_hms(t_parse + t_render)}")
    if args.stats:
        print(f"parse: {t_parse:.2f}s  render: {t_render:.2f}s  "
              f"primary rays/s: {rays / max(t_render, 1e-9):,.0f}")
    return 0


def _render(ap, args, scene, out_dir, key, device):
    """The film: one chunked render, or progressive passes; through the
    forest with ``--geom-shards``."""
    from .parallel.mesh import render_image_sharded
    from .render.film import render_image_progressive

    render_fn = render_image_sharded
    if args.geom_shards > 1:
        from .parallel.geom_shard import (make_geom_mesh,
                                          render_image_geom_sharded,
                                          shard_scene_geometry)
        mesh = make_geom_mesh(args.geom_shards)
        try:
            scene = shard_scene_geometry(scene, mesh, cache_dir=out_dir)
        except ValueError as e:
            ap.error(str(e))
        render_fn = render_image_geom_sharded
    if args.checkpoint or 0 < args.spp_chunk < args.samples:
        return render_image_progressive(
            scene, args.samples, key, chunk=args.spp_chunk or min(16, args.samples),
            checkpoint_path=args.checkpoint, progress=not args.no_progress,
            render_fn=render_fn, device=device)
    return render_fn(scene, args.samples, key, device=device)


if __name__ == "__main__":
    sys.exit(main())
