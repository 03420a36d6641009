"""The command-line renderer.

Counterpart of ``simplepath_tpu/cli.py``, with the same flags:

    python -m simplepath_tpu_torch.cli [--samples N] [--integrator NAME]
                                       [--spp-chunk N] [--checkpoint PATH]
                                       [--geom-shards N] [--platform cpu]
                                       [--dist-backend nccl|gloo]
                                       [--test] <scene.sp | ->

Over every GPU of the host, one rank a GPU:

    torchrun --standalone --nproc-per-node 4 -m simplepath_tpu_torch.cli \
        scenes/bunny_bench.sp [--geom-shards 4]

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
``torch.profiler`` trace.  ``--stats`` and ``--profile`` turn the port's
tracing on for the load and the render (``tracing.py``): ``--stats`` reads
its load and render seconds from the ``load`` and ``frame`` spans and
prints every span and counter, and the profiler's trace holds the ``sp.*``
spans around the kernels they launched.

Launched as several ranks (``WORLD_SIZE`` > 1 in the environment, as
``torchrun`` sets it), every rank joins the process group
(``parallel/multihost.init_distributed``: GPU ``LOCAL_RANK``, NCCL unless
``--dist-backend`` names gloo) before it loads the scene.  Rank 0 loads
first, filling the geometry and forest caches, and the others load warm
after it.  A plain render gives each rank its block of every chunk
(``render_image_multihost``); ``--geom-shards N`` spreads the forest over
the ranks, N / world shards a rank (N must be a multiple of the world).
Only rank 0 prints and writes the PFM and the checkpoint, and only rank 0
reads the checkpoint to resume: it sends the film and its sample count to
the others, so ranks on hosts that share no file system (``torchrun
--nnodes 2``, each host on its own copy of the scene) resume together, and
only rank 0's host needs the file.  Each host builds its own caches.
Without ``WORLD_SIZE`` the CLI runs as one process, as it always has.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import logging
import os
import sys
from datetime import timedelta

from .scene.types import INTEGRATORS

# Over ranks: a collective waits at most this long for the others (they
# stay within a chunk of each other once loaded); the load, where rank 0
# may build a large scene's caches cold while the others wait, has longer.
COLLECTIVE_TIMEOUT = timedelta(minutes=3)
LOAD_TIMEOUT = timedelta(minutes=30)


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
                         "render device and render through it; over "
                         "ranks, N / world shards on each rank's GPU")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="over ranks (WORLD_SIZE > 1, e.g. under torchrun): "
                         "the process group's backend (default: nccl on "
                         "CUDA, one GPU a rank; gloo on the CPU; gloo lets "
                         "ranks share a GPU). Rank 0 builds the geometry "
                         "cache and the others load it warm; with "
                         "SIMPLEPATH_CACHE=0 every rank builds its own")
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
    ranks = _join_ranks(ap, args)
    try:
        return _run(ap, args, ranks)
    finally:
        if ranks is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


class _Ranks:
    """This process's place among the ranks of the CLI: ``rank`` of
    ``world`` over ``backend``, rendering on ``device``; ``coord`` is a
    gloo group of every rank for the load's barriers and the stats."""

    def __init__(self, device):
        import torch.distributed as dist
        self.device = device
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.backend = str(dist.get_backend())
        self.coord = dist.new_group(backend="gloo", timeout=LOAD_TIMEOUT)


def _join_ranks(ap, args):
    """Join the process group when launched as one of several ranks
    (``WORLD_SIZE`` > 1) → :class:`_Ranks`, or None for one process."""
    from .parallel.multihost import (env_topology, init_distributed,
                                     rank_device)
    world, _, local_rank, local_world = env_topology()
    if world <= 1:
        if args.dist_backend:
            ap.error("--dist-backend needs several ranks (WORLD_SIZE > 1, "
                     "as under torchrun)")
        return None
    try:
        device, backend = rank_device(local_rank, local_world,
                                      args.dist_backend, args.platform)
    except RuntimeError as e:
        ap.error(str(e))
    init_distributed("env://", backend=backend, device=device,
                     timeout=COLLECTIVE_TIMEOUT)
    return _Ranks(device)


def _run(ap, args, ranks) -> int:
    import numpy as np
    import torch

    from . import tracing
    from .core.rng import prng_key
    from .device import resolve_device
    from .io.pfm import write_image
    from .utils import Stopwatch

    lead = ranks is None or ranks.rank == 0
    device = ranks.device if ranks else resolve_device(args.platform)
    geom_mesh = None
    if args.geom_shards > 1:
        from .parallel.geom_shard import make_geom_mesh
        try:
            geom_mesh = make_geom_mesh(args.geom_shards)
        except ValueError as e:
            ap.error(str(e))

    watch = Stopwatch()                 # the whole run: "Elapsed time"
    traced = (tracing.recording() if args.stats or args.profile
              else contextlib.nullcontext())
    with traced as rec:
        text = None
        if args.scene == "-":           # rank 0 reads it, and sends it on
            text = [sys.stdin.read() if lead else None]
            if ranks is not None:
                import torch.distributed as dist
                dist.broadcast_object_list(text, src=0, group=ranks.coord)
            text = text[0]
        if ranks is None:
            scene, out_dir = _load(ap, args, device, geom_mesh, text)
        else:
            from .parallel.multihost import rank_zero_first
            with rank_zero_first(ranks.coord, LOAD_TIMEOUT):
                if lead and device.type == "cuda":
                    from .render import cuda_traverse
                    cuda_traverse.build_library()   # once, before the others
                scene, out_dir = _load(ap, args, device, geom_mesh, text)

        prof = contextlib.nullcontext()
        if args.profile:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        with prof:
            img = _render(args, scene, prng_key(args.seed, device), device,
                          ranks)
            img = img.cpu().numpy()     # waits for the device
    watch.stop()
    summary = rec.summary() if rec is not None else None
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        name = "trace.json" if ranks is None else f"trace_rank{ranks.rank}.json"
        prof.export_chrome_trace(os.path.join(args.profile, name))

    seconds = lambda name: summary["spans"].get(name, {}).get("total_s", 0.0)
    # this rank's own load (not its wait for rank 0), from its load span
    devices = _device_stats(device, ranks, seconds("load")) if args.stats else None
    if not lead:
        return 0
    out = args.output or os.path.join(out_dir, scene.static.output_file_name)
    write_image(out, np.asarray(img))

    rays = scene.static.width * scene.static.height * args.samples
    print(f"Wrote {out}")
    if args.profile:
        print(f"Profiler trace written to {args.profile}")
    print(f"Elapsed time: {watch}")
    if args.stats:
        t_render = seconds(tracing.FRAME)
        print(f"parse: {seconds('load'):.2f}s  render: {t_render:.2f}s  "
              f"primary rays/s: {rays / max(t_render, 1e-9):,.0f}")
        print(f"world: {1 if ranks is None else ranks.world}  backend: "
              f"{'none' if ranks is None else ranks.backend}")
        for r, (name, peak, load_s) in enumerate(devices):
            print(f"rank {r}: {name}  peak device memory: "
                  + ("n/a" if peak is None else f"{peak} B")
                  + f"  load: {load_s:.2f}s")
        _print_summary(summary)
    return 0


def _print_summary(summary: dict) -> None:
    """This rank's spans (count, total and self seconds) and counters."""
    print("span                     count    total s     self s")
    for name, row in sorted(summary["spans"].items(),
                            key=lambda kv: -kv[1]["total_s"]):
        print(f"{name:<24} {row['count']:>5} {row['total_s']:>10.4f} "
              f"{row['self_s']:>10.4f}")
    for name, n in sorted(summary["counters"].items()):
        print(f"counter {name}: {n:,}")


def _load(ap, args, device, geom_mesh, text):
    """The scene on ``device`` → (scene, directory of its output).  From
    the file, or from ``text`` for a scene given on stdin; with a geometry
    mesh, as its forest (kept in the scene directory's cache)."""
    from .scene.build import load_scene

    use_bvh = False if geom_mesh is not None else None  # the forest replaces it
    # load_scene parses a path or the scene's text alike
    scene = load_scene(args.scene if text is None else text,
                       cli_integrator=args.integrator, use_bvh=use_bvh,
                       device=device)
    out_dir = (os.getcwd() if args.scene == "-"
               else os.path.dirname(os.path.abspath(args.scene)))
    if geom_mesh is not None:
        from .parallel.geom_shard import shard_scene_geometry
        try:
            scene = shard_scene_geometry(scene, geom_mesh, cache_dir=out_dir)
        except ValueError as e:
            ap.error(str(e))
    return scene, out_dir


def _device_stats(device, ranks, load_s: float) -> list:
    """Every rank's (device and its name, peak device memory in bytes or
    None, seconds to load the scene), in rank order."""
    import torch

    if device.type == "cuda":
        mine = (f"{device} {torch.cuda.get_device_name(device)}",
                torch.cuda.max_memory_allocated(device), load_s)
    else:
        mine = (str(device), None, load_s)
    if ranks is None:
        return [mine]
    import torch.distributed as dist
    every = [None] * ranks.world
    dist.all_gather_object(every, mine, group=ranks.coord)
    return every


def _render(args, scene, key, device, ranks):
    """The film: one chunked render, or progressive passes; through the
    forest with ``--geom-shards``; over the ranks when there are several."""
    from .parallel.mesh import render_image_sharded
    from .render.film import render_image_progressive

    render_fn = render_image_sharded
    if args.geom_shards > 1:
        from .parallel.geom_shard import render_image_geom_sharded
        render_fn = render_image_geom_sharded
    elif ranks is not None:
        from .parallel.multihost import render_image_multihost
        render_fn = render_image_multihost
    if args.checkpoint or 0 < args.spp_chunk < args.samples:
        return render_image_progressive(
            scene, args.samples, key, chunk=args.spp_chunk or min(16, args.samples),
            checkpoint_path=args.checkpoint,
            progress=not args.no_progress and (ranks is None or ranks.rank == 0),
            render_fn=render_fn, device=device)
    return render_fn(scene, args.samples, key, device=device)


if __name__ == "__main__":
    sys.exit(main())
