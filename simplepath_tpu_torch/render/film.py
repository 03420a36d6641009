"""Film: flat ray-batch accumulation over samples-per-pixel.

Counterpart of ``simplepath_tpu/render/film.py``: the pixel grid is one flat
batch dimension and spp is a Python loop that accumulates the film.  The
adaptive-RR integrator's per-pixel statistics are threaded across that loop.
``render_image_progressive`` renders in spp passes with checkpoint/resume.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from .. import tracing
from ..core.rng import fold_in, pixel_jitter
from ..device import resolve_device
from ..scene.types import Scene
from .camera import generate_ray
from .integrators import dynamic_rr_buckets, make_integrator
from .materials import build_rho_tables

__all__ = ["render_rays", "render_image", "render_image_progressive",
           "with_rho_table"]

_STATEFUL = "brute_force_iterative_dynamic_rr"


def _check_scene_device(scene: Scene, device: torch.device) -> None:
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device} but the render was "
                         f"asked for {device}; move it with scene.to(device)")


def with_rho_table(scene: Scene) -> Scene:
    """The scene with its materials' rho table built from its materials
    (in the autograd graph when they require grad): what ``render_rays``
    does on every call, and what a caller of an integrator itself does
    first, as the JAX package's caller passes the table."""
    return dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, rho_table=build_rho_tables(scene.materials)))


def render_rays(scene: Scene, xs: Tensor, ys: Tensor, spp: int, key: Tensor,
                integrator: str | None = None, spp_offset: int = 0,
                device=None, **integrator_kwargs) -> Tensor:
    """Render a flat batch of pixels → [N, 3] radiance means.

    xs, ys: integer pixel coordinates (flat).  ``key`` is a ``[2]`` threefry
    key (``core.rng.prng_key``).  Each sample s uses the reference's
    R-sequence pixel jitter and a per (pixel, sample) threefry key for the
    integrator, which also gets the jittered film position (``pcoords``).
    The adaptive-RR integrator's per-pixel, per-depth statistics start at
    zero and carry from sample to sample.

    ``spp_offset`` renders absolute sample indices [offset, offset+spp) —
    sample streams are keyed by the absolute index, so chunked/progressive
    renders compose to exactly the same film as one uninterrupted render.

    The materials' rho table is built anew from ``scene.materials`` on
    every call, as the JAX package builds it, so a scene whose materials
    were replaced renders with its own table (and roughness and ior
    gradients flow through it).

    ``device=None`` means CUDA and raises without one; the scene must
    already be there.  Extra keyword arguments go to the integrator
    (``sort=`` for ``iterative_rrnee``).
    """
    with tracing.span("chunk"):
        device = resolve_device(device)
        _check_scene_device(scene, device)
        with tracing.span("rho_table"):
            scene = with_rho_table(scene)
        name = integrator or scene.static.integrator
        fn = make_integrator(name)
        xs = xs.to(device=device, dtype=torch.int64)
        ys = ys.to(device=device, dtype=torch.int64)
        key = key.to(device)
        n = xs.shape[0]
        lin = ys * scene.static.width + xs
        pix_keys = fold_in(key.expand(n, 2), lin)
        xf, yf = xs.to(torch.float32), ys.to(torch.float32)
        if name == _STATEFUL:
            nd = dynamic_rr_buckets(scene)
            integrator_kwargs["stats"] = (
                torch.zeros((n, nd), dtype=torch.float32, device=device),
                torch.zeros((n, nd), dtype=torch.int32, device=device))

        film = torch.zeros((n, 3), dtype=torch.float32, device=device)
        for s in range(int(spp_offset), int(spp_offset) + spp):
            jitter = pixel_jitter(xs, ys, torch.full_like(xs, s))
            pcoords = torch.stack([xf + jitter[:, 0], yf + jitter[:, 1]],
                                  dim=-1)
            ro, rd = generate_ray(scene.camera, pcoords[:, 0], pcoords[:, 1])
            out = fn(scene, ro, rd, fold_in(pix_keys, s), pcoords=pcoords,
                     **integrator_kwargs)
            if name == _STATEFUL:
                out, integrator_kwargs["stats"] = out
            film = film + out
        return film / spp


def render_image(scene: Scene, spp: int, key: Tensor,
                 integrator: str | None = None, device=None) -> Tensor:
    """Full-frame render in one batch → [H, W, 3] (see
    ``parallel.mesh.render_image_sharded`` for the chunked form)."""
    device = resolve_device(device)
    h, w = scene.static.height, scene.static.width
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    flat = render_rays(scene, xs.reshape(-1), ys.reshape(-1), spp, key,
                       integrator, device=device)
    return flat.reshape(h, w, 3)


def render_image_progressive(scene: Scene, spp: int, key: Tensor,
                             integrator: str | None = None, chunk: int = 16,
                             checkpoint_path: str | None = None,
                             checkpoint_every: int = 64,
                             progress: bool = False,
                             render_fn=None, device=None) -> Tensor:
    """Render in ``chunk``-spp passes with optional checkpoint/resume →
    [H, W, 3] on ``device``.

    The passes accumulate an unaveraged film sum on the host (float32, as
    the JAX package does); with ``checkpoint_path`` the sum and the count of
    finished samples are saved every ``checkpoint_every`` samples and at the
    end, and a later call with the same ``spp`` and frame size resumes from
    them.  Each pass renders absolute samples [done, done+n) through
    ``parallel.mesh.render_image_sharded``, so a resumed render equals an
    uninterrupted one bit for bit.  The checkpoint file has the JAX
    package's layout: either package resumes the other's.

    ``render_fn(scene, spp, key, integrator=..., spp_offset=...,
    device=...)`` renders a pass instead of ``render_image_sharded``: the
    CLI passes ``geom_shard.render_image_geom_sharded`` and
    ``multihost.render_image_multihost`` this way.  Over the ranks of a
    ``torch.distributed`` process group, where every rank passes a
    ``checkpoint_path`` (each its own, on hosts that share no file system),
    rank 0 alone reads the checkpoint and sends its sum and count to the
    others, so all start at its sample whatever their disks hold; only
    rank 0 writes it.
    """
    import torch.distributed as dist

    from ..parallel.mesh import render_image_sharded
    from ..utils import ProgressBar, load_checkpoint, save_checkpoint

    device = resolve_device(device)
    ranks = dist.is_available() and dist.is_initialized()
    lead = not ranks or dist.get_rank() == 0
    render_fn = render_fn or render_image_sharded
    h, w = scene.static.height, scene.static.width
    film_sum = np.zeros((h, w, 3), np.float32)
    done = 0
    if checkpoint_path and lead:
        ck = load_checkpoint(checkpoint_path)
        if ck is not None:
            film_ck, done_ck, meta = ck
            if meta.get("spp_target") == spp and film_ck.shape == film_sum.shape:
                film_sum, done = film_ck, done_ck
    if checkpoint_path and ranks:
        # under NCCL through the current CUDA device (init_distributed)
        sent = [film_sum, done]
        dist.broadcast_object_list(sent, src=0)
        film_sum, done = sent

    bar = ProgressBar(spp, "spp") if progress else None
    if bar and done:
        bar.update(done)
        bar.draw()
    last_ck = done
    while done < spp:
        n = min(chunk, spp - done)
        img = render_fn(scene, n, key, integrator=integrator,
                        spp_offset=done, device=device)
        film_sum = film_sum + img.cpu().numpy() * n
        done += n
        if bar:
            bar.update(n)
            bar.draw()
        if checkpoint_path and (done - last_ck >= checkpoint_every or done == spp):
            if lead:
                save_checkpoint(checkpoint_path, film_sum, done,
                                {"spp_target": spp})
            last_ck = done
    if bar:
        bar.finish()
    return torch.from_numpy(film_sum / spp).to(device)
