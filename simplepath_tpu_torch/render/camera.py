"""Perspective camera: raster→world ray generation.

Counterpart of ``simplepath_tpu/render/camera.py``: the look-at transform,
fov scale and film dimensions bake into four vec3s (vx, vy, vz, origin) so
ray generation is two multiply-adds and a normalize.  The bake runs from the
user-level parameters (eye, to, up, fov) on the scene's device at every
call — a handful of ops.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from ..core.transform import look_at
from ..core.vec import normalize
from ..scene.types import CameraArrays

__all__ = ["make_perspective_camera", "camera_vectors", "generate_ray"]


def make_perspective_camera(origin, to, up, fov_degrees, film_width: int,
                            film_height: int) -> CameraArrays:
    """Store the user parameters; the bake happens in :func:`camera_vectors`."""
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32).copy())
    return CameraArrays(eye=f32(origin), to=f32(to), up=f32(up),
                        fov=f32(fov_degrees),
                        wh=f32([film_width, film_height]))


def camera_vectors(camera: CameraArrays) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The raster→world bake → (vx, vy, vz, origin)."""
    fov_scale = 1.0 / torch.tan(0.5 * (camera.fov * (math.pi / 180.0)))
    c2w = look_at(camera.eye, camera.to, camera.up)
    u = c2w.linear[:, 0]
    v = c2w.linear[:, 1]
    z = c2w.linear[:, 2]
    w, h = camera.wh[0], camera.wh[1]
    vx = u
    vy = -v
    vz = (-0.5 * w) * u + (0.5 * h) * v + (0.5 * h * fov_scale) * z
    return vx, vy, vz, c2w.t


def generate_ray(camera: CameraArrays, pixel_x: Tensor, pixel_y: Tensor
                 ) -> tuple[Tensor, Tensor]:
    """(origin, direction) for raster coords."""
    vx, vy, vz, origin = camera_vectors(camera)
    d = pixel_x[..., None] * vx + pixel_y[..., None] * vy + vz
    return origin.expand(d.shape), normalize(d)
