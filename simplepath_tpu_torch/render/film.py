"""Film: flat ray-batch accumulation over samples-per-pixel.

Counterpart of ``simplepath_tpu/render/film.py`` (the non-stateful branch;
the progressive/checkpointed render is a later slice): the pixel grid is one
flat batch dimension and spp is a Python loop that accumulates the film.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..core.rng import fold_in, pixel_jitter
from ..device import resolve_device
from ..scene.types import Scene
from .camera import generate_ray
from .integrators import make_integrator

__all__ = ["render_rays", "render_image"]


def _check_scene_device(scene: Scene, device: torch.device) -> None:
    if scene.device != device:
        raise ValueError(f"scene is on {scene.device} but the render was "
                         f"asked for {device}; move it with scene.to(device)")


def render_rays(scene: Scene, xs: Tensor, ys: Tensor, spp: int, key: Tensor,
                integrator: str | None = None, spp_offset: int = 0,
                device=None, **integrator_kwargs) -> Tensor:
    """Render a flat batch of pixels → [N, 3] radiance means.

    xs, ys: integer pixel coordinates (flat).  ``key`` is a ``[2]`` threefry
    key (``core.rng.prng_key``).  Each sample s uses the reference's
    R-sequence pixel jitter and a per (pixel, sample) threefry key for the
    integrator.

    ``spp_offset`` renders absolute sample indices [offset, offset+spp) —
    sample streams are keyed by the absolute index, so chunked/progressive
    renders compose to exactly the same film as one uninterrupted render.

    ``device=None`` means CUDA and raises without one; the scene must
    already be there.  Extra keyword arguments go to the integrator
    (``sort=`` for ``iterative_rrnee``).
    """
    device = resolve_device(device)
    _check_scene_device(scene, device)
    fn = make_integrator(integrator or scene.static.integrator)
    xs = xs.to(device=device, dtype=torch.int64)
    ys = ys.to(device=device, dtype=torch.int64)
    key = key.to(device)
    n = xs.shape[0]
    lin = ys * scene.static.width + xs
    pix_keys = fold_in(key.expand(n, 2), lin)
    xf, yf = xs.to(torch.float32), ys.to(torch.float32)

    film = torch.zeros((n, 3), dtype=torch.float32, device=device)
    for s in range(int(spp_offset), int(spp_offset) + spp):
        jitter = pixel_jitter(xs, ys, torch.full_like(xs, s))
        ro, rd = generate_ray(scene.camera, xf + jitter[:, 0], yf + jitter[:, 1])
        film = film + fn(scene, ro, rd, fold_in(pix_keys, s), **integrator_kwargs)
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
