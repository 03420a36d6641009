"""Rendering and training with the pixels split over processes.

Counterpart of ``simplepath_tpu/parallel/multihost.py`` on
``torch.distributed``.  Every process calls :func:`init_distributed`, builds
the same scene (the build is deterministic) and calls
:func:`render_image_multihost` or :func:`train_step_multihost` with the
same arguments.  Each rank renders its block of every chunk of pixels on
its own device, so the forward render needs no collective until the film:
each chunk is all-gathered, and every rank returns the whole frame.  The
train step averages the loss and the gradients with one all-reduce, and
every rank applies the same SGD step.

Starting: under ``torchrun`` (or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``) a rank calls ``init_distributed()``, which joins through
``env://``; a caller that starts its ranks itself passes a ``file://``
rendezvous and the topology (``parallel/launch.py``).  A rank renders on
GPU ``LOCAL_RANK`` of its host.

Backends: NCCL needs a GPU for each rank of a host, and asking for it (or
taking it as the default on CUDA) with more local ranks than GPUs raises;
gloo runs on the CPU, and on CUDA tensors through the host
(``mesh.all_reduce``, ``mesh.all_gather_cat``), which is how several ranks
share one GPU.  ``backend=None`` picks NCCL on CUDA and gloo on the CPU;
the caller may name either.  Timeouts are the process group's: a barrier
or collective that times out raises, and under NCCL the watchdog tears the
process down (``TORCH_NCCL_ASYNC_ERROR_HANDLING=1`` unless set), so a hung
collective ends the rank and its launcher ends the others.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist
from torch import Tensor

from .. import tracing
from ..device import resolve_device
from ..render.film import render_rays
from ..scene.types import Scene
from .mesh import (CHUNK_RAYS_PER_DEVICE, RayMesh, all_gather_cat, all_reduce,
                   make_ray_mesh, pad_to_multiple, shard_pixels)

__all__ = ["init_distributed", "env_topology", "rank_device",
           "rank_zero_first",
           "render_image_multihost", "train_step_multihost",
           "DEFAULT_TIMEOUT"]

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def env_topology() -> tuple[int, int, int, int]:
    """(world size, rank, local rank, local world size) as ``torchrun``
    sets them in the environment; unset, a lone process on one host."""
    def get(name, default):
        value = os.environ.get(name, "")
        return int(value) if value else default

    world, rank = get("WORLD_SIZE", 1), get("RANK", 0)
    return world, rank, get("LOCAL_RANK", rank), get("LOCAL_WORLD_SIZE", world)


def rank_device(local_rank: int, local_world_size: int,
                backend: str | None = None, device=None
                ) -> tuple[torch.device, str]:
    """The device a rank renders on and the backend it joins with, checked
    before any process group starts.

    ``device=None`` means CUDA (raises without one): GPU ``local_rank``.
    NCCL, named or the default on CUDA, takes one GPU a rank: more local
    ranks than GPUs raises, naming both counts.  Named gloo lets the local
    ranks share the GPUs (GPU ``local_rank % count``).  A device given
    explicitly is taken as it is; NCCL on a device that is not CUDA
    raises.  ``backend=None`` means NCCL on CUDA and gloo on the CPU."""
    if device is None:
        resolve_device("cuda")                 # raises without CUDA
        n_gpus = torch.cuda.device_count()
        if backend in (None, "nccl") and local_world_size > n_gpus:
            raise RuntimeError(
                f"NCCL takes one GPU a rank: {local_world_size} ranks on "
                f"this host and {n_gpus} GPU(s) visible; start at most "
                f"{n_gpus} ranks a host, or name the gloo backend to share "
                "GPUs")
        device = torch.device("cuda", local_rank % n_gpus)
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise RuntimeError(f"NCCL runs on CUDA devices; this rank's device "
                           f"is {device}")
    return device, backend


def init_distributed(init_method: str = "env://",
                     world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     device=None) -> torch.device:
    """``torch.distributed.init_process_group`` → the device this rank
    renders on (:func:`rank_device`; a CUDA device is made current).

    ``init_method`` is ``"env://"`` (``torchrun``: ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``"tcp://host:port"`` or ``"file:///path"``.  With
    ``world_size`` and ``rank`` None they come from ``WORLD_SIZE`` and
    ``RANK``, and the rank's place on its host from ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``; given explicitly, every rank is taken to be on
    this host (local rank = rank).  ``backend=None`` means NCCL on CUDA and
    gloo on the CPU."""
    if rank is None or world_size is None:
        world_size, rank, local_rank, local_world = env_topology()
    else:
        local_rank, local_world = rank, world_size
    device, backend = rank_device(local_rank, local_world, backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend == "nccl":
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, timeout=timeout)
    return device


@contextlib.contextmanager
def rank_zero_first(group, timeout: datetime.timedelta):
    """Rank 0 runs the body first while the other ranks wait; then they run
    it together, and every rank leaves once all have finished.  For work
    whose first run fills a cache that the others then read (a scene's
    geometry and forest: one cold build, not one a rank).  ``group`` is a
    gloo group of every rank (``dist.new_group(backend="gloo")``, whatever
    the default backend), whose barrier names a rank that does not arrive
    within ``timeout``, and raises."""
    def barrier():
        dist.monitored_barrier(group, timeout=timeout)

    first = dist.get_rank() == 0
    if not first:
        barrier()
    yield
    if first:
        barrier()
    barrier()


def _coordination_barrier(mesh: RayMesh,
                          timeout: datetime.timedelta | None = None) -> None:
    """Align the ranks before their first collective, so that a rank that
    lags (a kernel build, a scene load) shows as a timeout naming it rather
    than inside a collective.  ``timeout=None`` is the process group's.  A
    timeout raises.  No-op on one rank."""
    if mesh.world <= 1:
        return
    if dist.get_backend(mesh.group) == dist.Backend.GLOO:
        dist.monitored_barrier(mesh.group, timeout=timeout)
    else:
        dist.barrier(mesh.group, device_ids=[mesh.device.index])


# Process groups whose ranks have met at the coordination barrier: a
# group's first train step runs it, later steps go straight to the
# all-reduce.
_ALIGNED: set = set()


def train_step_multihost(scene: Scene, params: dict, target_flat: Tensor,
                         xs: Tensor, ys: Tensor, spp: int, key: Tensor,
                         integrator: str | None = None, lr: float = 0.05,
                         mesh: RayMesh | None = None, leaves=None,
                         device=None) -> tuple[dict, float]:
    """One SGD step with the pixel batch split over the ranks → (new
    params on this rank's device, loss).

    Every rank passes the same ``scene``, ``params``, ``target_flat``,
    ``xs``, ``ys`` and ``key``; the batch must divide into equal blocks
    over the ranks.  Each rank differentiates the loss of its block
    (``diff.grad.render_loss_and_grad``), one all-reduce takes the mean of
    the loss and of the gradients, and every rank applies ``p - lr * g``,
    so the new parameters are the same on every rank.  ``leaves`` as in
    ``diff.grad.make_train_step``.  On a process group's first step the
    ranks meet at a barrier before the all-reduce (a timeout, the process
    group's, raises); later steps skip it.  Eager PyTorch has nothing to
    build or compile for a step, so nothing else is kept between calls."""
    from ..diff.grad import render_loss_and_grad

    mesh = mesh or make_ray_mesh(device=device)
    dev = mesh.device
    n = int(xs.numel())
    if n % mesh.world:
        raise ValueError(f"pixel batch ({n}) must divide over the "
                         f"{mesh.world} ranks")
    b = n // mesh.world
    sl = slice(mesh.rank * b, (mesh.rank + 1) * b)
    loss, grads = render_loss_and_grad(
        scene, params, target_flat[sl].to(dev), xs[sl].to(dev),
        ys[sl].to(dev), spp, key, integrator, dev, leaves)
    group = dist.group.WORLD if mesh.group is None else mesh.group
    if mesh.world > 1 and group not in _ALIGNED:
        _coordination_barrier(mesh)
        _ALIGNED.add(group)
    # the loss and every gradient in one all-reduce: the mean of the ranks'
    # means is the batch mean, the blocks being equal
    names = list(grads)
    flat = torch.cat([loss.reshape(1)] + [grads[k].reshape(-1)
                                          for k in names])
    if mesh.world > 1:
        flat = all_reduce(flat, dist.ReduceOp.SUM, mesh.group) / mesh.world
    new_params, at = {k: p.detach().to(dev) for k, p in params.items()}, 1
    with torch.no_grad():
        for k in names:
            g = flat[at:at + grads[k].numel()].reshape(grads[k].shape)
            at += grads[k].numel()
            new_params[k] = new_params[k] - lr * g
    return new_params, float(flat[0])


def render_image_multihost(scene: Scene, spp: int, key: Tensor,
                           integrator: str | None = None,
                           mesh: RayMesh | None = None,
                           chunk_rays: int | None = None,
                           spp_offset: int = 0, device=None) -> Tensor:
    """Full-frame render over the ranks → the whole [H, W, 3] frame on
    every rank (on its device).

    Every rank passes the same scene (on its own device) and key.  The
    frame is rendered in chunks of ``chunk_rays`` pixels per rank (default
    ``CHUNK_RAYS_PER_DEVICE``); each rank renders its block of every chunk,
    and each chunk's film is all-gathered, so memory stays bounded at any
    resolution.  The padding follows the JAX package: a frame that fits in
    one chunk is padded to a multiple of the world size, a larger one to
    whole chunks.  ``spp_offset`` renders absolute sample indices
    [offset, offset+spp), so progressive passes compose exactly.

    While tracing is on, the render is a ``frame`` span ending in
    ``wait.frame``; each rank's render of a chunk is a ``rank_render`` span
    ending in ``wait.rank`` (its own device time), and each gather a
    ``gather`` span ending in ``wait.gather``."""
    mesh = mesh or make_ray_mesh(device=device)
    h, w = scene.static.height, scene.static.width
    lin = torch.arange(h * w)
    xs_all, ys_all = lin % w, lin // w
    n = xs_all.shape[0]
    chunk = (chunk_rays or CHUNK_RAYS_PER_DEVICE) * mesh.world
    n_pad = pad_to_multiple(n, mesh.world if n <= chunk else chunk)
    xs_all = torch.nn.functional.pad(xs_all, (0, n_pad - n))
    ys_all = torch.nn.functional.pad(ys_all, (0, n_pad - n))

    with tracing.span(tracing.FRAME):
        pieces = []
        for c0 in range(0, n_pad, chunk):
            xs, ys, _ = shard_pixels(mesh, xs_all[c0:c0 + chunk],
                                     ys_all[c0:c0 + chunk])
            with tracing.span("rank_render"):
                flat = render_rays(scene, xs, ys, spp, key, integrator,
                                   spp_offset=spp_offset, device=mesh.device)
                tracing.wait("rank", mesh.device)
            if mesh.world > 1:
                with tracing.span("gather"):
                    flat = all_gather_cat(flat, mesh.group)
                    tracing.wait("gather", mesh.device)
            pieces.append(flat)
        img = torch.cat(pieces, dim=0)[:n].reshape(h, w, 3)
        tracing.wait("frame", mesh.device)
    return img
