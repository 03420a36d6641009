"""Primitive intersection tests over ray batches × SoA primitive tables.

Counterpart of ``simplepath_tpu/render/intersect.py``, with the ray batch
written out: each function tests N rays against P primitives at once and
returns ``[N, P]`` results; the closest-hit reduction is an argmin by the
caller.

Conventions:
 * a "hit" is (t, valid); shading data (point, normal, material) is computed
   by the caller from the winning primitive only;
 * valid iff t_min <= t <= t_max, with the reference's boundary senses.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from ..core.vec import dot, matvec3, normalize
from ..scene.types import PlaneArrays, SphereArrays, TriangleArrays

__all__ = ["intersect_spheres", "sphere_normal", "intersect_planes",
           "plane_normal", "intersect_triangles", "triangle_normal",
           "sphere_quadratic", "RAY_EPSILON", "INF_DISTANCE"]

RAY_EPSILON = 1e-3          # self-intersection offset
INF_DISTANCE = math.inf     # "no limit" ray distance


def sphere_quadratic(w2o_l: Tensor, w2o_t: Tensor, ro: Tensor, rd: Tensor):
    """Unit-sphere quadratic in object space → (b, disc, two_a).  The
    transform tables broadcast against the rays."""
    o = matvec3(w2o_l, ro) + w2o_t
    d = matvec3(w2o_l, rd)
    a = dot(d, d)
    b = 2.0 * dot(d, o)
    c = dot(o, o) - 1.0
    return b, b * b - 4.0 * a * c, 2.0 * a


def intersect_spheres(sph: SphereArrays, ro: Tensor, rd: Tensor,
                      t_min: Tensor, t_max: Tensor) -> tuple[Tensor, Tensor]:
    """N rays vs all S unit spheres in object space.

    ro, rd: [N,3]; t_min, t_max: [N]; returns (t [N,S], valid [N,S]).
    """
    b, disc, two_a = sphere_quadratic(sph.w2o_l, sph.w2o_t, ro[:, None, :],
                                      rd[:, None, :])
    has = disc > 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = (-b - sq) / two_a
    t1 = (-b + sq) / two_a
    t = torch.where(t0 < t_min[:, None], t1, t0)
    valid = has & (t >= t_min[:, None]) & (t <= t_max[:, None])
    return t, valid


def sphere_normal(sph: SphereArrays, idx: Tensor, ro: Tensor, rd: Tensor,
                  t: Tensor) -> Tensor:
    """World normal at hit t for sphere ``idx[n]`` of ray n.

    Reference quirk: the object-space normal is transformed by the
    object→world LINEAR matrix (not inverse transpose) then normalized.
    """
    w2o_l = sph.w2o_l[idx]
    o = matvec3(w2o_l, ro) + sph.w2o_t[idx]
    d = matvec3(w2o_l, rd)
    n_obj = o + t[:, None] * d  # radius 1
    n_world = matvec3(sph.o2w_l[idx], n_obj)
    len2 = torch.clamp_min(dot(n_world, n_world), 1e-12)
    return n_world * torch.rsqrt(len2)[:, None]


def intersect_planes(pl: PlaneArrays, ro: Tensor, rd: Tensor,
                     t_min: Tensor, t_max: Tensor) -> tuple[Tensor, Tensor]:
    """N rays vs all P y=0 planes in object space → (t [N,P], valid)."""
    row = pl.w2o_l[:, 1, :]                                   # [P,3]
    oy = dot(row, ro[:, None, :]) + pl.w2o_t[:, 1]
    dy = dot(row, rd[:, None, :])
    parallel = dy == 0.0
    t = -oy / torch.where(parallel, torch.ones_like(dy), dy)
    valid = (~parallel) & (t >= t_min[:, None]) & (t <= t_max[:, None])
    return t, valid


def plane_normal(pl: PlaneArrays, idx: Tensor) -> Tensor:
    """World normal: o2w linear applied to (0,1,0), i.e. column 1.
    NB the reference does NOT normalize this (quirk kept)."""
    return pl.o2w_l[idx][:, :, 1]


def intersect_triangles(v0: Tensor, v1: Tensor, v2: Tensor, ro: Tensor,
                        rd: Tensor, t_min: Tensor, t_max: Tensor
                        ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Shirley-style barycentric test, N rays × T triangles.

    v0/v1/v2: [T,3] (or [N,1,3] for one triangle per ray); ro, rd: [N,3];
    returns (t, beta, gamma, valid), each [N,T].  Boundary senses match the
    reference exactly (beta<=0, beta>=1 reject...).
    """
    A = v0[..., 0] - v1[..., 0]
    B = v0[..., 1] - v1[..., 1]
    C = v0[..., 2] - v1[..., 2]
    D = v0[..., 0] - v2[..., 0]
    E = v0[..., 1] - v2[..., 1]
    F = v0[..., 2] - v2[..., 2]
    G, H, I = rd[:, 0:1], rd[:, 1:2], rd[:, 2:3]
    J = v0[..., 0] - ro[:, 0:1]
    K = v0[..., 1] - ro[:, 1:2]
    L = v0[..., 2] - ro[:, 2:3]

    EIHF = E * I - H * F
    GFDI = G * F - D * I
    DHEG = D * H - E * G
    denom = A * EIHF + B * GFDI + C * DHEG
    safe_denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)

    beta = (J * EIHF + K * GFDI + L * DHEG) / safe_denom
    AKJB = A * K - J * B
    JCAL = J * C - A * L
    BLKC = B * L - K * C
    gamma = (I * AKJB + H * JCAL + G * BLKC) / safe_denom
    t = -(F * AKJB + E * JCAL + D * BLKC) / safe_denom

    valid = ((denom != 0.0)
             & (beta > 0.0) & (beta < 1.0)
             & (gamma > 0.0) & (beta + gamma < 1.0)
             & (t >= t_min[:, None]) & (t <= t_max[:, None]))
    return t, beta, gamma, valid


def triangle_normal(tri: TriangleArrays, idx: Tensor, beta: Tensor,
                    gamma: Tensor) -> Tensor:
    """Barycentric-interpolated shading normal of triangle ``idx[n]``."""
    alpha = 1.0 - beta - gamma
    n = (alpha[:, None] * tri.gather_row("n0", idx)
         + beta[:, None] * tri.gather_row("n1", idx)
         + gamma[:, None] * tri.gather_row("n2", idx))
    return normalize(n)
