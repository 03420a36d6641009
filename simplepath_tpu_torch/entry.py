"""A one-device forward check and a multi-process dry run: the port's
counterpart of ``__graft_entry__.py``.

    python -m simplepath_tpu_torch.entry      # entry() on CUDA, then
                                              # dryrun_multichip(every GPU, at most 8)

``entry(device=None)`` returns ``(fn, args)``: ``fn(*args)`` renders the
32x32 frame of a small scene (two analytic spheres, a plane and an 80-face
icosphere mesh, so that the BVH and both traversal kernels run) at 1 spp
with the flagship integrator.

``dryrun_multichip(n, backend=None, device=None)`` starts n ranks, one
process each, joined through a ``file://`` rendezvous in a temporary
directory (``parallel/launch.run_processes``: a rank that fails ends them
all), and runs on them what the JAX package's dry run runs on n devices:

* one ray-sharded SGD step over every parameter on a 16x16 pixel batch
  (``train_step_multihost``), with a finite loss and a moved albedo;
* for an even n >= 4, the rays x geometry grid (2 ray blocks x n/2 forest
  shards; 2 x 2 at n = 4): a 1-spp render through the forest, with a
  positive finite mean;
* on that grid, the gradient of the loss through the forest's combine over
  the ranks, on an 8x8 subsample that covers the whole frame.

Each part is held against the same job in this process (one device, the
forest's shards all on it) and prints one line.  ``device=None`` means
CUDA, a GPU a rank (NCCL unless ``backend`` names gloo, which lets ranks
share a GPU); ``device="cpu"`` runs the ranks on the CPU over gloo.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]

_TINY_SCENE = """version: 1

scene_parameters {
    output_file_name: "entry.pfm"
    width: 32
    height: 32
    max_depth: 4
    integrator: iterative_rrnee
}

perspective_camera {
    origin: 0.0 2.0 5.0
    look_at: 0.0 1.0 0.0
    fov: 45
}

material_lambertian {
    name: "blue"
    diffuse: 0.2 0.3 0.7
}

material_glossy {
    name: "shiny"
    diffuse: 0.6 0.3 0.2
    ior: 1.6
    roughness: 0.3
}

material_clearcoat {
    name: "coat"
    base: "shiny"
    ior: 1.5
}

sphere {
    translate: -0.8 1.0 0.0
    material: "coat"
}

sphere {
    translate: 1.0 0.6 0.5
    scale: 0.6 0.6 0.6
    material: "blue"
}

mesh {
    file: "ico.ply"
    translate: 0.9 1.6 -0.4
    scale: 0.5 0.5 0.5
    material: "shiny"
}

plane {
    material: "blue"
}

sphere_light {
    translate: 0.0 4.0 0.0
    radiance: 10.0 10.0 10.0
}

environment_light {
    radiance: 0.3 0.35 0.4
}
"""

# the directory of the scene's mesh, made at the first build and removed at
# interpreter exit
_TMPDIR = None
# the process group's and the ranks' time limits
RANK_TIMEOUT = datetime.timedelta(minutes=2)
RUN_TIMEOUT_S = 900
# the dry run's pixel batches: 16x16 for the step, 8x8 for the gradient
BATCH_SIDE = 16
GRAD_SIDE = 8


def _tiny_scene(device):
    """The scene of ``_TINY_SCENE`` on ``device``, its icosphere (one
    subdivision, 80 faces) written as PLY into a directory of its own."""
    from .io.meshgen import icosphere, write_ply
    from .scene.build import build_scene
    from .scene.parser import parse_sp

    global _TMPDIR
    if _TMPDIR is None:
        _TMPDIR = tempfile.TemporaryDirectory(prefix="sp_entry_")
        v, f = icosphere(1)
        write_ply(os.path.join(_TMPDIR.name, "ico.ply"), v.astype("float32"),
                  f)
    return build_scene(parse_sp(_TINY_SCENE, base_dir=_TMPDIR.name),
                       device=device)


def entry(device=None):
    """(fn, args): ``fn(*args)`` is the flagship's 1-spp render of the
    32x32 frame, [1024, 3].  ``device=None`` means CUDA and raises
    without one."""
    from .core.rng import prng_key
    from .device import resolve_device
    from .render.film import render_rays

    device = resolve_device(device)
    scene = _tiny_scene(device)
    n = 32 * 32
    xs = torch.arange(n, device=device) % 32
    ys = torch.arange(n, device=device) // 32

    def fn(scene, xs, ys, key):
        return render_rays(scene, xs, ys, 1, key, device=scene.device)

    return fn, (scene, xs, ys, prng_key(0, device))


# ------------------------------------------------------------ the dry run

def _pixels(side: int, step: int = 1, start: int = 0):
    """A side x side pixel grid, row by row, every ``step``-th pixel from
    ``start``."""
    g = torch.arange(side) * step + start
    ys, xs = torch.meshgrid(g, g, indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _jobs(n: int, device, over_ranks: bool) -> dict:
    """The dry run's parts on ``device`` → their results as numpy arrays:
    over the ranks of the process group (``over_ranks``), or the same jobs
    in this one process."""
    from .core.rng import prng_key
    from .convert import params_to_numpy
    from .diff.grad import get_params, make_train_step, render_loss_and_grad
    from .parallel.geom_shard import (make_geom_mesh,
                                      render_image_geom_sharded,
                                      shard_scene_geometry)
    from .parallel.multihost import train_step_multihost

    scene = _tiny_scene(device)
    xs, ys = _pixels(BATCH_SIDE)
    params = get_params(scene)
    target = torch.zeros(xs.numel(), 3)
    if over_ranks:
        new, loss = train_step_multihost(scene, params, target, xs, ys, 1,
                                         prng_key(1, device), device=device)
    else:
        step = make_train_step(scene, 1, device=device)
        new, loss = step(params, target.to(device), xs.to(device),
                         ys.to(device), prng_key(1, device))
    out = {"loss": np.float64(float(loss))}
    out.update({"p_" + k: v for k, v in params_to_numpy(new).items()})
    out["p0_mat_albedo"] = params["mat_albedo"].cpu().numpy()
    if not _grid(n):
        return out

    # the grid: 2 ray blocks x n/2 forest shards over the ranks; the same
    # forest with every shard in this process
    gmesh = make_geom_mesh(n // 2, 2 if over_ranks else 1)
    gscene = shard_scene_geometry(_tiny_scene(device), gmesh)
    out["img"] = render_image_geom_sharded(gscene, 1, prng_key(2, device),
                                           device=device).cpu().numpy()
    # an 8x8 subsample covering the whole 32x32 frame (its top rows alone
    # are sky, with a zero albedo gradient)
    gxs, gys = _pixels(GRAD_SIDE, 4, 2)
    _, grads = render_loss_and_grad(
        gscene, get_params(gscene), torch.zeros(gxs.numel(), 3, device=device),
        gxs.to(device), gys.to(device), 1, prng_key(3, device), device=device)
    out.update({"g_" + k: v.cpu().numpy() for k, v in grads.items()})
    return out


def _grid(n: int) -> bool:
    return n >= 4 and n % 2 == 0


def _rank_main(out_dir: str, backend: str | None, device) -> None:
    """One rank of a dry run: join the others through ``out_dir``'s
    rendezvous (rank and world from the environment), run the parts and
    save their results as ``out_dir/rank<R>.npz``."""
    import torch.distributed as dist

    from .parallel.multihost import init_distributed

    device = init_distributed("file://" + os.path.join(out_dir, "rendezvous"),
                              backend=backend, device=device,
                              timeout=RANK_TIMEOUT)
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        if device.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **_jobs(world, device, True))
    finally:
        dist.destroy_process_group()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n: int, backend: str | None = None, device=None) -> dict:
    """Run the dry run's parts on ``n`` ranks and hold each against the same
    job in this process → the readings each part printed.  Raises
    ``launch.RanksFailed`` naming the ranks that failed, and
    ``AssertionError`` on a result off its tolerance: the loss within rtol
    1e-4 and the parameters within 1e-5 of one process's step, the grid's
    frame within 1e-4 of the one-process forest's, every gradient finite
    and within rtol 1e-5 of one process's.  Every rank must return the
    same results.  ``n`` must divide the 256 pixels of the step's batch."""
    from .device import resolve_device
    from .parallel.launch import rank_env, run_processes
    from .parallel.multihost import rank_device

    if n < 1 or (BATCH_SIDE * BATCH_SIDE) % n:
        raise ValueError(f"{n} ranks do not divide the "
                         f"{BATCH_SIDE * BATCH_SIDE}-pixel batch")
    if device is None:
        rank_device(0, n, backend)      # NCCL: a GPU a rank, or raise
    here = resolve_device(device)
    if here.type == "cuda":
        from .render import cuda_traverse
        cuda_traverse.build_library()   # built once, before the ranks load it

    with tempfile.TemporaryDirectory(prefix="sp_dryrun_") as tmp:
        cmd = [sys.executable, "-m", "simplepath_tpu_torch.entry",
               "--rank-of", tmp]
        if backend is not None:
            cmd += ["--backend", backend]
        if device is not None:
            cmd += ["--device", str(device)]
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        run_processes([cmd] * n, [rank_env(r, n, env) for r in range(n)],
                      os.path.join(tmp, "logs"), RUN_TIMEOUT_S)
        ranks = []
        for r in range(n):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                ranks.append({k: z[k] for k in z.files})
    one = _jobs(n, here, False)

    for r, res in enumerate(ranks[1:], 1):
        for k in ranks[0]:
            _check(np.array_equal(res[k], ranks[0][k]),
                   f"rank {r}'s {k} differs from rank 0's")
    got = ranks[0]
    name = f"dryrun_multichip({n})"
    readings = {}

    loss, loss1 = float(got["loss"]), float(one["loss"])
    dp = max(float(np.abs(got[k] - one[k]).max())
             for k in got if k.startswith("p_"))
    _check(np.isfinite(loss), f"non-finite loss {loss}")
    _check(bool(np.any(got["p_mat_albedo"] != got["p0_mat_albedo"])),
           "albedo unchanged: gradient flow broken")
    _check(abs(loss - loss1) <= 1e-4 * abs(loss1),
           f"loss {loss} against one process's {loss1}")
    for k in got:
        if k.startswith("p_"):
            _check(np.allclose(got[k], one[k], rtol=1e-4, atol=1e-5),
                   f"{k[2:]} after the step departs from one process's")
    readings["train"] = dict(loss=loss, one_process_loss=loss1,
                             max_abs_param_diff=dp)
    print(f"{name}: loss={loss:.6f} OK (one process {loss1:.6f}, "
          f"params within {dp:.3g})", flush=True)
    if not _grid(n):
        return readings

    img, img1 = got["img"], one["img"]
    mean, diff = float(img.mean()), float(np.abs(img - img1).max())
    _check(np.isfinite(img).all() and mean > 0,
           f"geom-sharded render broken: mean {mean}")
    _check(diff <= 1e-4, f"the grid's frame is {diff} from one process's")
    readings["grid_render"] = dict(layout=[2, n // 2], mean=mean,
                                   max_abs_diff=diff)
    print(f"{name}: 2x{n // 2} rays x geom render mean={mean:.6f} OK "
          f"(max abs diff {diff:.3g} from one process)", flush=True)

    gk = [k for k in got if k.startswith("g_")]
    _check(all(np.isfinite(got[k]).all() for k in gk),
           "a geom-sharded gradient is not finite")
    _check(float(np.abs(got["g_mat_albedo"]).sum()) > 0,
           "geom-sharded albedo gradient is zero")
    for k in gk:
        _check(np.allclose(got[k], one[k], rtol=1e-5, atol=0.0),
               f"the gradient of {k[2:]} departs from one process's")
    gdiff = max(float(np.abs(got[k] - one[k]).max()) for k in gk)
    readings["grid_grad"] = dict(leaves=len(gk), max_abs_diff=gdiff)
    print(f"{name}: geom-sharded grad OK ({len(gk)} leaves, max abs diff "
          f"{gdiff:.3g} from one process)", flush=True)
    return readings


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank-of", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, a GPU a rank)")
    ap.add_argument("-n", type=int, default=None,
                    help="ranks of the dry run (default: every GPU, at most 8)")
    args = ap.parse_args(argv)
    if args.rank_of is not None:
        _rank_main(args.rank_of, args.backend, args.device)
        return 0
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry forward:", tuple(out.shape), float(out.mean()), flush=True)
    n = args.n or min(8, max(1, torch.cuda.device_count()))
    dryrun_multichip(n, args.backend, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
