"""Chunked full-frame rendering on one GPU.

Counterpart of ``simplepath_tpu/parallel/mesh.py`` for a single device: the
frame is rendered in equal fixed-size chunks of rays so device memory stays
bounded at any resolution.  There is no device mesh in this slice (ray and
geometry sharding over several GPUs are later slices).
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..device import resolve_device
from ..render.film import render_rays
from ..scene.types import Scene

__all__ = ["render_image_sharded", "pad_to_multiple", "CHUNK_RAYS_PER_DEVICE"]

# Per-chunk ray-batch cap: bounds the wavefront state (and the any-hit batch
# of nl or 2·nl shadow rays per ray) whatever the resolution.
CHUNK_RAYS_PER_DEVICE = 1 << 16


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def render_image_sharded(scene: Scene, spp: int, key: Tensor,
                         integrator: str | None = None,
                         chunk_rays: int | None = None,
                         spp_offset: int = 0, device=None) -> Tensor:
    """Full-frame render → [H, W, 3], in chunks of ``chunk_rays`` pixels
    (default ``CHUNK_RAYS_PER_DEVICE``).  The last chunk is padded with
    pixel (0, 0) to the chunk size and the padding dropped, as in the JAX
    package.  ``spp_offset`` renders absolute sample indices
    [offset, offset+spp) — see ``render_rays``.  ``device=None`` means CUDA
    and raises without one."""
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

    if n <= chunk:
        return render_chunk(xs_all, ys_all).reshape(h, w, 3)

    n_pad = pad_to_multiple(n, chunk)
    xs_all = torch.nn.functional.pad(xs_all, (0, n_pad - n))
    ys_all = torch.nn.functional.pad(ys_all, (0, n_pad - n))
    out = [render_chunk(xs_all[c0:c0 + chunk], ys_all[c0:c0 + chunk])
           for c0 in range(0, n_pad, chunk)]
    return torch.cat(out, dim=0)[:n].reshape(h, w, 3)
