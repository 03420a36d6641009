"""Affine transforms as (3x3 linear, translation) tensor pairs.

Counterpart of ``simplepath_tpu/core/transform.py``.  A transform is a
``[..., 3, 3]`` matrix whose COLUMNS are the images of the basis vectors
plus a ``[..., 3]`` translation; forward and inverse are carried together.
Host-side algebra (float32 tensors on the CPU unless the inputs say
otherwise); ``look_at`` is also used on device tensors by the camera.

Reference quirk reproduced deliberately: normals are transformed by the plain
linear matrix, NOT the inverse transpose.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from .vec import cross, matvec3, normalize

__all__ = ["Affine", "affine_identity", "affine_translate", "affine_rotate",
           "affine_scale", "affine_compose", "affine_inverse", "apply_point",
           "apply_vector", "apply_normal", "look_at", "Transform",
           "transform_identity", "transform_compose"]


class Affine(NamedTuple):
    """linear: [...,3,3] (columns = basis images), t: [...,3]."""
    linear: Tensor
    t: Tensor


class Transform(NamedTuple):
    """Forward + inverse pair."""
    fwd: Affine
    inv: Affine


def _f32(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def affine_identity() -> Affine:
    return Affine(torch.eye(3, dtype=torch.float32), torch.zeros(3))


def affine_translate(p) -> Affine:
    return Affine(torch.eye(3, dtype=torch.float32), _f32(p))


def affine_scale(s) -> Affine:
    return Affine(torch.diag(_f32(s)), torch.zeros(3))


def affine_rotate(axis, degrees) -> Affine:
    """Rotation about an arbitrary axis (built row-major from axis u and
    angle r, as the reference does)."""
    u = np.asarray(axis, dtype=np.float32)
    u = u / np.linalg.norm(u)
    r = math.radians(float(degrees))
    s, c = math.sin(r), math.cos(r)
    x, y, z = float(u[0]), float(u[1]), float(u[2])
    m = np.array([
        [x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s],
        [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c],
    ], dtype=np.float32)
    return Affine(torch.from_numpy(m), torch.zeros(3))


def affine_compose(a: Affine, b: Affine) -> Affine:
    """a ∘ b: apply b first, then a."""
    return Affine(a.linear @ b.linear, matvec3(a.linear, b.t) + a.t)


def affine_inverse(a: Affine) -> Affine:
    il = torch.linalg.inv(a.linear)
    return Affine(il, -matvec3(il, a.t))


def apply_point(a: Affine, p: Tensor) -> Tensor:
    return matvec3(a.linear, p) + a.t


def apply_vector(a: Affine, v: Tensor) -> Tensor:
    return matvec3(a.linear, v)


def apply_normal(a: Affine, n: Tensor) -> Tensor:
    # Reference quirk: same as vectors (no inverse transpose).
    return apply_vector(a, n)


def look_at(eye, point, up) -> Affine:
    """Camera-to-world: columns (u, v, z), origin eye."""
    eye, point, up = _f32(eye), _f32(point), _f32(up)
    z = normalize(point - eye)
    u = normalize(cross(up, z))
    v = normalize(cross(z, u))
    return Affine(torch.stack([u, v, z], dim=-1), eye)


def transform_identity() -> Transform:
    return Transform(affine_identity(), affine_identity())


def transform_compose(a: Transform, b: Transform) -> Transform:
    """forward = a.fwd∘b.fwd, inverse = b.inv∘a.inv."""
    return Transform(affine_compose(a.fwd, b.fwd), affine_compose(b.inv, a.inv))
