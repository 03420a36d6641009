"""Chunked full-frame rendering, and the ranks that split a frame's pixels.

Counterpart of ``simplepath_tpu/parallel/mesh.py``.  On one GPU the frame is
rendered in equal fixed-size chunks of rays so device memory stays bounded
at any resolution (``render_image_sharded``).  Over several processes a
"mesh" is a :class:`RayMesh`: this process's rank and the world of a
``torch.distributed`` process group, and the one device the rank renders on
(one device per rank).  ``shard_pixels`` hands each rank its block of a
pixel batch, ``replicate_scene`` puts the scene on the rank's device, and
``warmup_render`` runs the first-use costs of a render before it is timed.
The collective helpers here stage CUDA tensors through the host when the
group's backend is gloo, which takes CPU tensors only for most collectives.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch
import torch.distributed as dist
from torch import Tensor

from .. import tracing
from ..device import resolve_device
from ..render.film import render_rays
from ..scene.types import Scene

__all__ = ["RayMesh", "make_ray_mesh", "shard_pixels", "replicate_scene",
           "render_image_sharded", "warmup_render", "pad_to_multiple",
           "all_reduce", "all_gather_cat", "CHUNK_RAYS_PER_DEVICE"]

# Per-chunk ray-batch cap (per rank): bounds the wavefront state (and the
# any-hit batch of nl or 2·nl shadow rays per ray) whatever the resolution.
CHUNK_RAYS_PER_DEVICE = 1 << 16


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """Ranks that split the pixels of a frame: this process is ``rank`` of
    ``world`` in ``group`` (None: the default group, or no process group at
    all when ``world`` is 1), rendering on ``device``."""
    rank: int
    world: int
    group: Any
    device: torch.device


def make_ray_mesh(group=None, device=None) -> RayMesh:
    """This process's place among the ranks of ``group`` (default: every
    rank of ``torch.distributed``'s default group; a lone process when no
    process group is initialised).  ``device=None`` means CUDA and raises
    without one."""
    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return RayMesh(dist.get_rank(group), dist.get_world_size(group), group,
                       device)
    if group is not None:
        raise ValueError("a process group was given but torch.distributed "
                         "is not initialised")
    return RayMesh(0, 1, None, device)


def shard_pixels(mesh: RayMesh, xs: Tensor, ys: Tensor
                 ) -> tuple[Tensor, Tensor, int]:
    """Pad the flat pixel batch with pixel (0, 0) to a multiple of the world
    size → (this rank's block of xs, of ys, on the mesh's device; the
    unpadded count n)."""
    n = xs.shape[0]
    n_pad = pad_to_multiple(n, mesh.world)
    b = n_pad // mesh.world
    sl = slice(mesh.rank * b, (mesh.rank + 1) * b)
    pad = lambda a: torch.nn.functional.pad(a, (0, n_pad - n))[sl]
    return pad(xs).to(mesh.device), pad(ys).to(mesh.device), n


def replicate_scene(mesh: RayMesh, scene: Scene) -> Scene:
    """The whole scene on this rank's device: every rank holds a copy."""
    return scene.to(mesh.device)


def _staged(x: Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce(x: Tensor, op, group=None) -> Tensor:
    """``dist.all_reduce`` that returns the result (it may reduce ``x`` in
    place).  A CUDA tensor in a gloo group goes through the host."""
    if _staged(x, group):
        h = x.cpu()
        dist.all_reduce(h, op=op, group=group)
        return h.to(x.device)
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_cat(x: Tensor, group=None) -> Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along dim 0 in rank
    order.  A CUDA tensor in a gloo group goes through the host."""
    src = x.cpu() if _staged(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=0).to(x.device)


def warmup_render(scene: Scene, spp: int, mesh: RayMesh | None = None,
                  chunk_rays: int | None = None, device=None) -> float:
    """Run the first-use costs of a later ``render_image_sharded`` /
    ``render_image_multihost`` call (kernel build and load, allocator
    growth): one ``render_rays`` call of this rank's real chunk shape,
    finished with a value read-back.  Returns the seconds it took."""
    from ..core.rng import prng_key

    mesh = mesh or make_ray_mesh(device=device)
    st = scene.static
    n_frame = st.width * st.height
    n_chunk = (chunk_rays or CHUNK_RAYS_PER_DEVICE) * mesh.world
    warm_n = n_chunk if n_frame > n_chunk else pad_to_multiple(n_frame,
                                                               mesh.world)
    lin = torch.arange(warm_n)
    xs, ys, _ = shard_pixels(mesh, lin % st.width, lin % st.height)
    t0 = time.time()
    out = render_rays(scene, xs, ys, spp, prng_key(0, mesh.device),
                      device=mesh.device)
    float(out.sum())                    # waits for the device
    return time.time() - t0


def render_image_sharded(scene: Scene, spp: int, key: Tensor,
                         integrator: str | None = None,
                         chunk_rays: int | None = None,
                         spp_offset: int = 0, device=None) -> Tensor:
    """Full-frame render on this process's device → [H, W, 3], in chunks
    of ``chunk_rays`` pixels (default ``CHUNK_RAYS_PER_DEVICE``).  The last
    chunk is padded with pixel (0, 0) to the chunk size and the padding
    dropped, as in the JAX package.  ``spp_offset`` renders absolute sample
    indices [offset, offset+spp) — see ``render_rays``.  ``device=None``
    means CUDA and raises without one.  Over several ranks see
    ``multihost.render_image_multihost``.  The render is a ``frame`` span
    that ends in ``wait.frame`` (while tracing is on)."""
    device = resolve_device(device)
    h, w = scene.static.height, scene.static.width
    ys_g, xs_g = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
    xs_all = xs_g.reshape(-1)
    ys_all = ys_g.reshape(-1)
    n = xs_all.shape[0]
    chunk = chunk_rays or CHUNK_RAYS_PER_DEVICE

    def render_chunk(xs, ys):
        return render_rays(scene, xs, ys, spp, key, integrator,
                           spp_offset=spp_offset, device=device)

    with tracing.span(tracing.FRAME):
        if n <= chunk:
            img = render_chunk(xs_all, ys_all).reshape(h, w, 3)
        else:
            n_pad = pad_to_multiple(n, chunk)
            xs_all = torch.nn.functional.pad(xs_all, (0, n_pad - n))
            ys_all = torch.nn.functional.pad(ys_all, (0, n_pad - n))
            out = [render_chunk(xs_all[c0:c0 + chunk], ys_all[c0:c0 + chunk])
                   for c0 in range(0, n_pad, chunk)]
            img = torch.cat(out, dim=0)[:n].reshape(h, w, 3)
        tracing.wait("frame", device)
    return img
