"""Ranks of simplepath_tpu_torch over gloo on the CPU, for the multi-process
tests: ``run_ranks`` spawns one subprocess a rank, and this file, run as a
script, is one rank:

    python tests/torch_ranks.py JOB RANK WORLD OUT_DIR

Each rank joins a process group through a ``file://`` rendezvous in OUT_DIR
(no TCP port to clash between test workers), with a 60 s timeout, runs JOB
and saves what it computed as ``OUT_DIR/<job>_<rank>.npz``.  ``run_ranks``
runs the ranks under ``parallel/launch.run_processes``: one that fails, or
runs past the time limit, ends them all, so a failing rank fails the test
at once instead of leaving its peers waiting in a collective.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BLOB = os.path.join(HERE, "scenes", "g_blob.sp")
PG_TIMEOUT_S = 60

sys.path.insert(0, ROOT)
from simplepath_tpu_torch.parallel.launch import (RanksFailed,  # noqa: E402,F401
                                                  package_env, run_processes)


def run_ranks(job: str, world: int, out_dir, timeout: float = 150.0) -> list:
    """Run JOB on ``world`` ranks; → each rank's saved arrays (a dict of
    numpy arrays a rank), or raise RanksFailed with the failing rank's
    output."""
    out_dir = str(out_dir)
    env = package_env({k: v for k, v in os.environ.items()
                       if k not in ("XLA_FLAGS", "JAX_PLATFORMS")})
    env["OMP_NUM_THREADS"] = "1"
    run_processes([[sys.executable, os.path.abspath(__file__), job, str(r),
                    str(world), out_dir] for r in range(world)],
                  [env] * world, out_dir, timeout,
                  names=[f"{job} rank {r}" for r in range(world)])
    import numpy as np
    res = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"{job}_{r}.npz")) as z:
            res.append({k: z[k] for k in z.files})
    return res


def cut_checkpoint(path) -> None:
    """The CLI's progressive render of g_blob (2 spp in 1-spp passes) in
    one process on the CPU, cut as its second pass starts: the checkpoint at
    ``path`` holds the first pass's sample."""
    import chip_smoke
    from simplepath_tpu_torch.utils import load_checkpoint
    chip_smoke.cut_checkpoint(str(path), BLOB, 2, 1, "cpu")
    assert load_checkpoint(str(path))[1] == 1


# ---------------------------------------------------------------- the ranks

def _blob_forest(mesh):
    from simplepath_tpu_torch import load_scene
    from simplepath_tpu_torch.parallel.geom_shard import shard_scene_geometry
    return shard_scene_geometry(load_scene(BLOB, use_bvh=False, device="cpu"),
                                mesh)


def _pixels_12x12():
    import torch
    g = torch.arange(2, 48, 4)
    ys, xs = torch.meshgrid(g, g, indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def job_ray(rank, world):
    """The frame split over the ranks: whole at 2 spp; at 1 spp in chunks
    of 256 pixels a rank; and as two 1-spp passes at sample offsets 0 and
    1."""
    from simplepath_tpu_torch import load_scene
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel import render_image_multihost
    scene = load_scene(BLOB, device="cpu")
    kw = dict(device="cpu")
    img = render_image_multihost(scene, 2, prng_key(0), **kw)
    chunked = render_image_multihost(scene, 1, prng_key(0), chunk_rays=256,
                                     **kw)
    passes = [render_image_multihost(scene, 1, prng_key(0), spp_offset=s,
                                     **kw) for s in (0, 1)]
    return dict(img=img, chunked=chunked, pass0=passes[0], pass1=passes[1])


def job_train(rank, world):
    """Two 1-spp steps of train_step_multihost over every leaf on a 12x12
    pixel subsample; the ranks meet at the coordination barrier on the
    first step only."""
    import torch
    import torch.distributed as dist

    from simplepath_tpu_torch import load_scene
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.convert import params_to_numpy
    from simplepath_tpu_torch.diff.grad import get_params
    from simplepath_tpu_torch.parallel import multihost
    barriers = []
    barrier = dist.monitored_barrier
    dist.monitored_barrier = lambda *a, **kw: (barriers.append(1),
                                               barrier(*a, **kw))
    scene = load_scene(BLOB, device="cpu")
    xs, ys = _pixels_12x12()
    target = torch.full((xs.numel(), 3), 0.25)
    p1, loss1 = multihost.train_step_multihost(
        scene, get_params(scene), target, xs, ys, 1, prng_key(4),
        device="cpu")
    p2, loss2 = multihost.train_step_multihost(
        scene, p1, target, xs, ys, 1, prng_key(4), device="cpu")
    return dict(loss1=loss1, loss2=loss2, barriers=len(barriers),
                **{"p1_" + k: v for k, v in params_to_numpy(p1).items()},
                **{"p2_" + k: v for k, v in params_to_numpy(p2).items()})


def job_geom1d(rank, world):
    """The forest over the ranks, 1-D: D = world (a shard a rank) and
    D = 2 * world (two a rank)."""
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel.geom_shard import (
        make_geom_mesh, render_image_geom_sharded)
    out = {}
    for per in (1, 2):
        mesh = make_geom_mesh(per * world)
        scene = _blob_forest(mesh)
        assert scene.bvh.records.shape[0] == per
        assert mesh.shards == tuple(range(rank * per, (rank + 1) * per))
        out[f"d{per * world}"] = render_image_geom_sharded(
            scene, 2, prng_key(11), device="cpu")
    return out


def job_geom2d(rank, world):
    """The 2 x 2 grid (rays x geom) on 4 ranks: a render in chunks of 1152
    pixels (two chunks), and one train step over every leaf on a 12x12
    subsample split over the ray blocks."""
    import torch

    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.convert import params_to_numpy
    from simplepath_tpu_torch.diff.grad import get_params
    from simplepath_tpu_torch.parallel import (make_geom_mesh,
                                               render_image_geom_sharded,
                                               train_step_multihost)
    import datetime
    mesh = make_geom_mesh(2, 2, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    assert (mesh.ray_index, mesh.shards) == (rank // 2, (rank % 2,))
    scene = _blob_forest(mesh)
    img = render_image_geom_sharded(scene, 2, prng_key(11), chunk_rays=1152,
                                    device="cpu")
    xs, ys = _pixels_12x12()
    target = torch.full((xs.numel(), 3), 0.25)
    params, loss = train_step_multihost(
        scene, get_params(scene), target, xs, ys, 2, prng_key(2),
        mesh=mesh.ray_mesh("cpu"))
    return dict(img=img, loss=loss,
                **{"p_" + k: v for k, v in params_to_numpy(params).items()})


def job_barrier(rank, world):
    """Rank 0 waits at the coordination barrier with a 2 s timeout; rank 1
    never arrives (it waits until rank 0 has written its answer)."""
    import datetime

    from simplepath_tpu_torch.parallel import make_ray_mesh
    from simplepath_tpu_torch.parallel.multihost import _coordination_barrier
    mesh = make_ray_mesh(device="cpu")
    flag = os.path.join(OUT, "barrier_done")
    if rank == 0:
        t0 = time.time()
        try:
            _coordination_barrier(mesh, datetime.timedelta(seconds=2))
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        open(flag, "w").close()
        return dict(raised=raised, waited_s=time.time() - t0)
    while not os.path.exists(flag):
        time.sleep(0.05)
    return {}


def job_raise(rank, world):
    """Rank 1 raises at once; rank 0 waits in a collective for it."""
    import torch
    import torch.distributed as dist
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return {}


JOBS = {name[4:]: fn for name, fn in globals().items()
        if name.startswith("job_")}


if __name__ == "__main__":
    job, rank, world, OUT = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4]
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from simplepath_tpu_torch.parallel import init_distributed
    init_distributed("file://" + os.path.join(OUT, "rendezvous"), world, rank,
                     backend="gloo", device="cpu",
                     timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        res = JOBS[job](rank, world)
        np.savez(os.path.join(OUT, f"{job}_{rank}.npz"),
                 **{k: v.numpy() if torch.is_tensor(v) else np.asarray(v)
                    for k, v in res.items()})
    finally:
        dist.destroy_process_group()
