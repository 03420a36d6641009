"""Sampling warp functions in the local y-up frame, batched.

Counterpart of ``simplepath_tpu/core/sampling.py``: the local frame is
right-handed y-up, so the primary hemisphere axis is +y.  ``u`` is
``[..., 2]``.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from .vec import safe_sqrt, vec3

PI = math.pi
TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi

__all__ = ["sample_to_uniform_sphere", "uniform_sphere_pdf",
           "sample_to_uniform_hemisphere", "uniform_hemisphere_pdf",
           "sample_to_concentric_disk", "sample_to_cosine_hemisphere",
           "cosine_hemisphere_pdf", "sample_to_uniform_cone", "uniform_cone_pdf",
           "spherical_direction", "spherical_theta", "spherical_phi"]


def sample_to_uniform_sphere(u: Tensor) -> Tensor:
    """Uniform direction on S² (z is the polar axis in the reference's
    formula even though the frame is y-up — reproduced)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = TWO_PI * u[..., 1]
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def uniform_sphere_pdf() -> float:
    return 1.0 / (4.0 * PI)


def sample_to_uniform_hemisphere(u: Tensor) -> Tensor:
    """Uniform over the y>0 hemisphere."""
    y = u[..., 0]
    r = safe_sqrt(1.0 - y * y)
    phi = TWO_PI * u[..., 1]
    return vec3(r * torch.cos(phi), y, r * torch.sin(phi))


def uniform_hemisphere_pdf() -> float:
    return 1.0 / (2.0 * PI)


def sample_to_concentric_disk(u: Tensor) -> Tensor:
    """Shirley–Chiu concentric disk map, branchless."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    one = torch.ones_like(ox)
    safe_ox = torch.where(ox == 0.0, one, ox)
    safe_oy = torch.where(oy == 0.0, one, oy)
    theta = torch.where(use_x,
                        (PI / 4.0) * (oy / safe_ox),
                        (PI / 2.0) - (PI / 4.0) * (ox / safe_oy))
    degenerate = (ox == 0.0) & (oy == 0.0)
    r = torch.where(degenerate, torch.zeros_like(r), r)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_to_cosine_hemisphere(u: Tensor) -> Tensor:
    """Cosine-weighted hemisphere via the concentric disk."""
    d = sample_to_concentric_disk(u)
    y = safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return vec3(d[..., 0], y, d[..., 1])


def cosine_hemisphere_pdf(cos_theta: Tensor) -> Tensor:
    return cos_theta * INV_PI


def sample_to_uniform_cone(u: Tensor, cos_theta_max) -> Tensor:
    """Uniform in a cone of half-angle acos(cos_theta_max) around +y."""
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = u[..., 1] * TWO_PI
    return vec3(torch.cos(phi) * sin_theta, cos_theta, torch.sin(phi) * sin_theta)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (TWO_PI * (1.0 - cos_theta_max))


def spherical_direction(sin_theta: Tensor, cos_theta: Tensor, phi: Tensor) -> Tensor:
    """y-up spherical direction: the polar axis is +y, phi runs from +x
    toward +z."""
    return vec3(sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi))


def spherical_theta(v: Tensor) -> Tensor:
    """Polar angle from the +y axis."""
    return torch.arccos(torch.clamp(v[..., 1], -0.9999999, 0.9999999))


def spherical_phi(v: Tensor) -> Tensor:
    """Azimuth in [0, 2π) around +y, from +x toward +z."""
    p = torch.atan2(v[..., 2], v[..., 0])
    return torch.where(p < 0.0, p + TWO_PI, p)
