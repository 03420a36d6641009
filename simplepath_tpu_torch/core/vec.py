"""Vector math over ``[..., 3]`` tensors (trailing axis = xyz).

Counterpart of ``simplepath_tpu/core/vec.py``.  Every function broadcasts
over the leading (ray) dimensions; dtype is float32 throughout the renderer.
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["vec3", "dot", "cross", "length", "sqr_length", "normalize",
           "matvec3", "vecmat3", "safe_normalize", "madd", "lerp", "safe_divide",
           "safe_sqrt", "is_normalized", "reflect_local", "reflect"]


def vec3(x: Tensor, y: Tensor, z: Tensor) -> Tensor:
    """Stack three batches into a trailing xyz axis."""
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Dot product over the trailing axis, summed x, y, z in order."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a: Tensor, b: Tensor) -> Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def sqr_length(a: Tensor) -> Tensor:
    return dot(a, a)


def length(a: Tensor) -> Tensor:
    return torch.sqrt(sqr_length(a))


def normalize(a: Tensor) -> Tensor:
    return a / length(a)[..., None]


def matvec3(m: Tensor, v: Tensor) -> Tensor:
    """Batched 3x3 matrix @ vec3 as elementwise multiply + ordered sum (full
    float32, no matmul unit).  Broadcasts over leading dims of either."""
    p = m * v[..., None, :]
    return p[..., 0] + p[..., 1] + p[..., 2]


def vecmat3(v: Tensor, m: Tensor) -> Tensor:
    """Batched vec3^T @ 3x3 (row-vector form of :func:`matvec3`)."""
    p = v[..., :, None] * m
    return p[..., 0, :] + p[..., 1, :] + p[..., 2, :]


def safe_normalize(a: Tensor, eps: float = 1e-20) -> Tensor:
    """Normalize with a floored squared length: zero vectors map to zero."""
    len2 = torch.clamp_min(sqr_length(a), eps)
    return a * torch.rsqrt(len2)[..., None]


def madd(a, b, c):
    """Multiply-add ``a * b + c``, the reference's named helper (two float
    ops, as the JAX package computes it; not a fused multiply-add)."""
    return a * b + c


def lerp(x, a, b):
    """(1-x)*a + x*b."""
    return (1.0 - x) * a + x * b


def safe_divide(a, b):
    """a/b with 0 where b == 0.  The divisor is replaced by 1 there before
    dividing, so neither branch (nor its backward) produces inf or NaN."""
    b = torch.as_tensor(b)
    zero = b == 0.0
    return torch.where(zero, 0.0, a / torch.where(zero, 1.0, b))


def safe_sqrt(x: Tensor, floor: float = 1e-20) -> Tensor:
    """sqrt clamped away from 0 (keeps the reference's values and a finite
    backward)."""
    return torch.sqrt(torch.clamp_min(x, floor))


def is_normalized(a: Tensor, eps: float = 1e-3) -> Tensor:
    """Whether the squared length is within ``eps`` of 1."""
    return torch.abs(sqr_length(a) - 1.0) < eps


def reflect_local(wo: Tensor) -> Tensor:
    """Mirror reflection in the local y-up frame."""
    return wo * torch.tensor([-1.0, 1.0, -1.0], dtype=wo.dtype, device=wo.device)


def reflect(wo: Tensor, n: Tensor) -> Tensor:
    """Mirror reflection about a normal."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n
