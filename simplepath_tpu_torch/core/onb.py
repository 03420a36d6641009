"""Branchless orthonormal basis (Pixar/Duff revisited), batched.

Counterpart of ``simplepath_tpu/core/onb.py``.  The shading frame is built
with ``onb_from_v`` (the normal becomes the +y axis); an ONB is a
``[..., 3, 3]`` tensor whose ROWS are (u, v, w).
"""

from __future__ import annotations

import torch
from torch import Tensor

from .vec import matvec3, normalize, vecmat3

__all__ = ["onb_create", "onb_from_v", "onb_to_world", "onb_to_local"]


def onb_create(n: Tensor) -> tuple[Tensor, Tensor]:
    """Two tangent vectors (b1, b2) for unit n, branchless."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.copysign(torch.ones_like(nz), nz)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    b1 = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    b2 = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return b1, b2


def onb_from_v(n: Tensor) -> Tensor:
    """ONB with n as the v (y) axis: rows (u, v, w).  As in the reference,
    ``create(v)`` returns (w, u): b1 is w and b2 is u."""
    v = normalize(n)
    w, u = onb_create(v)
    return torch.stack([u, v, w], dim=-2)


def onb_to_world(onb: Tensor, a: Tensor) -> Tensor:
    """a.x*u + a.y*v + a.z*w."""
    return vecmat3(a, onb)


def onb_to_local(onb: Tensor, a: Tensor) -> Tensor:
    """(dot(a,u), dot(a,v), dot(a,w))."""
    return matvec3(onb, a)
