"""Quaternions as [..., 4] tensors (layout ``[r, i, j, k]``).

Counterpart of ``simplepath_tpu/core/quaternion.py``: pure functions over
``[..., 4]`` float32 tensors, batched and differentiable, with the
reference's conventions (component-wise lerp, not slerp; the four-case
trace construction from a basis, replicated branchlessly).
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = [
    "quat", "quat_identity", "quat_rotate_axis_angle", "quat_yaw_pitch_roll",
    "quat_from_basis", "quat_mul", "quat_conj", "quat_abs", "quat_rcp",
    "quat_normalize", "quat_dot", "quat_lerp", "quat_apply",
]


def _f32(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def quat(r, i, j, k) -> Tensor:
    return torch.stack(torch.broadcast_tensors(_f32(r), _f32(i), _f32(j),
                                               _f32(k)), dim=-1)


def quat_identity() -> Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0])


def quat_rotate_axis_angle(axis, angle) -> Tensor:
    """Rotation of ``angle`` radians about ``axis``."""
    axis = _f32(axis)
    u = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = 0.5 * _f32(angle)
    s = torch.sin(half)[..., None]
    return torch.cat([torch.cos(half)[..., None], s * u], dim=-1)


def quat_yaw_pitch_roll(yaw, pitch, roll) -> Tensor:
    """Euler-angle constructor, the reference's convention."""
    yaw, pitch, roll = _f32(yaw), _f32(pitch), _f32(roll)
    cya, sya = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cpi, spi = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cro, sro = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    return quat(cro * cya * cpi + sro * sya * spi,
                cro * cya * spi + sro * sya * cpi,
                cro * sya * cpi - sro * cya * spi,
                sro * cya * cpi - cro * sya * spi)


def quat_from_basis(vx, vy, vz) -> Tensor:
    """Quaternion from three orthonormal column vectors: all four cases of
    the reference's trace construction are computed and its branch order is
    replicated with nested selects."""
    vx, vy, vz = _f32(vx), _f32(vy), _f32(vz)
    xx, yy, zz = vx[..., 0], vy[..., 1], vz[..., 2]

    def mk(t, a, b, c):
        s = 0.5 / torch.sqrt(torch.clamp_min(t, 1e-30))
        return t * s, a * s, b * s, c * s

    t0 = 1.0 + xx + yy + zz                               # trace >= 0
    r0, i0, j0, k0 = mk(torch.clamp_min(t0, 1e-30), vy[..., 2] - vz[..., 1],
                        vz[..., 0] - vx[..., 2], vx[..., 1] - vy[..., 0])
    t1 = (1.0 + xx) - (yy + zz)                           # xx largest
    i1, r1, j1, k1 = mk(torch.clamp_min(t1, 1e-30), vy[..., 2] - vz[..., 1],
                        vx[..., 1] + vy[..., 0], vz[..., 0] + vx[..., 2])
    t2 = (1.0 + yy) - (zz + xx)                           # yy largest
    j2, r2, i2, k2 = mk(torch.clamp_min(t2, 1e-30), vz[..., 0] - vx[..., 2],
                        vx[..., 1] + vy[..., 0], vy[..., 2] + vz[..., 1])
    t3 = (1.0 + zz) - (xx + yy)                           # zz largest
    k3, r3, i3, j3 = mk(torch.clamp_min(t3, 1e-30), vx[..., 1] - vy[..., 0],
                        vz[..., 0] + vx[..., 2], vy[..., 2] + vz[..., 1])
    q0 = torch.stack([r0, i0, j0, k0], dim=-1)
    q1 = torch.stack([r1, i1, j1, k1], dim=-1)
    q2 = torch.stack([r2, i2, j2, k2], dim=-1)
    q3 = torch.stack([r3, i3, j3, k3], dim=-1)
    c0 = (xx + yy + zz >= 0.0)[..., None]
    c1 = (xx >= torch.maximum(yy, zz))[..., None]
    c2 = (yy >= zz)[..., None]
    return torch.where(c0, q0, torch.where(c1, q1, torch.where(c2, q2, q3)))


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product."""
    ar, ai, aj, ak = a.unbind(-1)
    br, bi, bj, bk = b.unbind(-1)
    return torch.stack([ar * br - ai * bi - aj * bj - ak * bk,
                        ar * bi + ai * br + aj * bk - ak * bj,
                        ar * bj - ai * bk + aj * br + ak * bi,
                        ar * bk + ai * bj - aj * bi + ak * br], dim=-1)


def quat_conj(a: Tensor) -> Tensor:
    return a * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=a.dtype,
                            device=a.device)


def quat_abs(a: Tensor) -> Tensor:
    return torch.linalg.vector_norm(a, dim=-1)


def quat_rcp(a: Tensor) -> Tensor:
    return quat_conj(a) / (a * a).sum(dim=-1, keepdim=True)


def quat_normalize(a: Tensor) -> Tensor:
    return a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)


def quat_dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(dim=-1)


def quat_lerp(q0: Tensor, q1: Tensor, factor) -> Tensor:
    """Component-wise lerp, matching the reference (NOT slerp)."""
    f = _f32(factor).to(q0.device)[..., None]
    return q0 + (q1 - q0) * f


def quat_apply(a: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) ``v`` by quaternion(s) ``a``: ``a * (0,v) * conj(a)``."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return quat_mul(quat_mul(a, qv), quat_conj(a))[..., 1:]
