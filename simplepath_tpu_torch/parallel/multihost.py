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

Backends: NCCL needs a GPU for each rank; gloo runs on the CPU, and on
CUDA tensors through the host (``mesh.all_reduce``, ``mesh.all_gather_cat``),
which is how two ranks share one GPU.  ``backend=None`` picks NCCL on CUDA
and gloo on the CPU; the caller may name either.  Timeouts are the process
group's: a barrier or collective that times out raises.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch import Tensor

from ..device import resolve_device
from ..render.film import render_rays
from ..scene.types import Scene
from .mesh import (CHUNK_RAYS_PER_DEVICE, RayMesh, all_gather_cat, all_reduce,
                   make_ray_mesh, pad_to_multiple, shard_pixels)

__all__ = ["init_distributed", "render_image_multihost",
           "train_step_multihost", "DEFAULT_TIMEOUT"]

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(init_method: str, world_size: int, rank: int,
                     backend: str | None = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     device=None) -> torch.device:
    """``torch.distributed.init_process_group`` with the topology given:
    ``init_method`` (``"tcp://host:port"`` or ``"file:///path"``),
    ``world_size`` and this process's ``rank``.  Returns the device this
    rank renders on: ``device=None`` means CUDA (raises without one), GPU
    ``rank % device_count``, one device per rank.  ``backend=None`` means
    NCCL on CUDA and gloo on the CPU."""
    if device is None:
        resolve_device(None)                   # raises without CUDA
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, timeout=timeout)
    return device


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
    [offset, offset+spp), so progressive passes compose exactly."""
    mesh = mesh or make_ray_mesh(device=device)
    h, w = scene.static.height, scene.static.width
    lin = torch.arange(h * w)
    xs_all, ys_all = lin % w, lin // w
    n = xs_all.shape[0]
    chunk = (chunk_rays or CHUNK_RAYS_PER_DEVICE) * mesh.world
    n_pad = pad_to_multiple(n, mesh.world if n <= chunk else chunk)
    xs_all = torch.nn.functional.pad(xs_all, (0, n_pad - n))
    ys_all = torch.nn.functional.pad(ys_all, (0, n_pad - n))

    pieces = []
    for c0 in range(0, n_pad, chunk):
        xs, ys, _ = shard_pixels(mesh, xs_all[c0:c0 + chunk],
                                 ys_all[c0:c0 + chunk])
        flat = render_rays(scene, xs, ys, spp, key, integrator,
                           spp_offset=spp_offset, device=mesh.device)
        pieces.append(all_gather_cat(flat, mesh.group) if mesh.world > 1
                      else flat)
    return torch.cat(pieces, dim=0)[:n].reshape(h, w, 3)
