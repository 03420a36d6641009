"""Light sampling, pdf, radiance and light-ray intersection, batched.

Counterpart of ``simplepath_tpu/render/lights.py``: sphere lights, the
constant environment light and the image-based one.  Every function takes
the whole wavefront: ``p``, ``n``, ``ro``, ``rd`` are ``[N,3]``, ``u`` is
``[N,2]``.

Sphere light sampling reproduces the reference's scheme exactly:
cosine-hemisphere POINT sampling toward the observer with the uniform-CONE
pdf — an intentional reproduction of the reference's (slightly inconsistent)
math so images match.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..core.distribution import (Distribution1D, Distribution2D, pdf_2d,
                                 sample_continuous_2d)
from ..core.onb import onb_from_v, onb_to_world
from ..core.sampling import (PI, TWO_PI, sample_to_cosine_hemisphere,
                             sample_to_uniform_sphere, spherical_phi,
                             spherical_theta, uniform_sphere_pdf)
from ..core.vec import dot, length, matvec3, normalize, sqr_length, vec3
from ..scene.types import ENV_CONST, EnvLightArrays, SphereLightArrays
from .intersect import INF_DISTANCE, RAY_EPSILON, sphere_quadratic

__all__ = ["LightSample", "sphere_light_sample", "sphere_light_pdf",
           "sphere_light_intersect", "sphere_light_intersect_p",
           "env_light_sample", "env_light_pdf", "env_light_radiance",
           "get_ray_offset", "get_ray_offset_nd"]


class LightSample(NamedTuple):
    L: Tensor            # [N,3] radiance
    pdf: Tensor          # [N]
    wi: Tensor           # [N,3] world direction toward light
    t_min: Tensor        # [N] shadow-ray start (offset)
    t_max: Tensor        # [N] shadow-ray end (light distance - offset)


def get_ray_offset(cos_d: Tensor) -> Tensor:
    """Self-intersection offset ε/|cosθ|."""
    zero = cos_d == 0.0
    q = RAY_EPSILON / torch.where(zero, torch.ones_like(cos_d), cos_d)
    return torch.where(zero, torch.full_like(q, RAY_EPSILON), q)


def get_ray_offset_nd(n: Tensor, d: Tensor) -> Tensor:
    """Offset from a normal/direction pair."""
    return get_ray_offset(torch.abs(dot(n, d)))


# ------------------------------------------------------------ sphere light

def _sphere_shape_sample(lights: SphereLightArrays, li: int, observer_world: Tensor,
                         u: Tensor) -> tuple[Tensor, Tensor]:
    """Sphere::sample(observer, u) → (point, normal), world space."""
    o2w_l = lights.o2w_l[li]
    obs = matvec3(lights.w2o_l[li], observer_world) + lights.w2o_t[li]
    inside = sqr_length(obs) <= 1.0

    # outside: cosine hemisphere toward the observer; inside: uniform sphere
    onb = onb_from_v(obs)  # v axis = to_observer
    s_cos = onb_to_world(onb, sample_to_cosine_hemisphere(u))
    s_uni = sample_to_uniform_sphere(u)

    local_sample = torch.where(inside[:, None], s_uni, s_cos)
    point = matvec3(o2w_l, local_sample) + lights.o2w_t[li]
    normal = normalize(matvec3(o2w_l, local_sample))  # reference: o2w on the normal
    return point, normal


def _sphere_shape_pdf(lights: SphereLightArrays, li: int, observer_world: Tensor) -> Tensor:
    """Solid-angle cone pdf."""
    obs = matvec3(lights.w2o_l[li], observer_world) + lights.w2o_t[li]
    sqr_dist = sqr_length(obs)
    inside = sqr_dist <= 1.0

    sin2_1_5_deg = 0.00068523
    sin2_theta_max = 1.0 / torch.clamp_min(sqr_dist, 1.0)
    cos_theta_max = torch.sqrt(torch.clamp_min(1.0 - sin2_theta_max, 1e-20))
    one_minus = torch.where(sin2_theta_max < sin2_1_5_deg,
                            sin2_theta_max / 2.0,
                            1.0 - cos_theta_max)
    pdf_cone = 1.0 / (TWO_PI * torch.clamp_min(one_minus, 1e-20))
    return torch.where(inside, torch.full_like(pdf_cone, uniform_sphere_pdf()),
                       pdf_cone)


def sphere_light_sample(lights: SphereLightArrays, li: int, p: Tensor, n: Tensor,
                        u: Tensor) -> LightSample:
    """ObjectLight::sample_impl + Light::sample."""
    sampled_point, sampled_normal = _sphere_shape_sample(lights, li, p, u)
    to_sample = sampled_point - p
    wi = normalize(to_sample)
    pdf = _sphere_shape_pdf(lights, li, p)
    distance = length(to_sample) - get_ray_offset_nd(sampled_normal, -wi)
    t_min = get_ray_offset_nd(n, wi)
    return LightSample(L=lights.radiance[li].expand(p.shape), pdf=pdf, wi=wi,
                       t_min=t_min, t_max=distance)


def sphere_light_pdf(lights: SphereLightArrays, li: int, p: Tensor, wi: Tensor) -> Tensor:
    return _sphere_shape_pdf(lights, li, p)


def sphere_light_intersect(lights: SphereLightArrays, li: int, ro: Tensor, rd: Tensor,
                           t_min: Tensor, t_max: Tensor) -> tuple[Tensor, Tensor]:
    """Sphere intersect for light rays → (t [N], valid [N])."""
    b, disc, two_a = sphere_quadratic(lights.w2o_l[li], lights.w2o_t[li], ro, rd)
    has = disc > 0.0
    sq = torch.sqrt(torch.where(has, torch.clamp_min(disc, 1e-12),
                                torch.ones_like(disc)))
    t0 = (-b - sq) / two_a
    t1 = (-b + sq) / two_a
    t = torch.where(t0 < t_min, t1, t0)
    valid = has & (t >= t_min) & (t <= t_max)
    return t, valid


def sphere_light_intersect_p(lights: SphereLightArrays, li: int, ro: Tensor, rd: Tensor,
                             t_min: Tensor, t_max: Tensor) -> Tensor:
    return sphere_light_intersect(lights, li, ro, rd, t_min, t_max)[1]


# ------------------------------------------------------------ env lights

def _env_distribution(env: EnvLightArrays) -> Distribution2D:
    marg = Distribution1D(env.cdf_marg_f, env.cdf_marg, env.cdf_marg_int, 0.0, 1.0)
    return Distribution2D(env.cdf_cond_f, env.cdf_cond, env.cdf_cond_int, marg)


def _ibl_lookup(env: EnvLightArrays, s: Tensor, t: Tensor) -> Tensor:
    """Nearest-neighbor texel fetch, wrapping horizontally and clamping
    vertically; ``torch.round`` rounds half to even, as ``jnp.round``."""
    s = torch.remainder(1.0 + torch.remainder(s, 1.0), 1.0)     # wrap
    t = torch.clamp(t, 0.0, 0.99999994)                         # clamp
    h, w = env.image.shape[0], env.image.shape[1]
    x = torch.clamp_max(torch.round(s * w).to(torch.int64), w - 1)
    y = torch.clamp_max(torch.round(t * h).to(torch.int64), h - 1)
    return env.image[y, x]


def _ibl_solid_angle_pdf(map_pdf: Tensor, sin_theta: Tensor) -> Tensor:
    """Map-space pdf → solid-angle pdf, 0 at the poles."""
    pole = sin_theta == 0.0
    return torch.where(pole, 0.0, map_pdf / (
        2.0 * PI * PI * torch.where(pole, 1.0, sin_theta)))


def env_light_sample(env: EnvLightArrays, env_kind: int, u: Tensor) -> LightSample:
    """Constant light: a uniform direction on the sphere.  Image-based
    light: a direction drawn from the luminance table (marginal row, then
    conditional column), radiance from the nearest texel."""
    n = u.shape[0]
    full = lambda v: torch.full((n,), v, dtype=torch.float32, device=u.device)
    if env_kind == ENV_CONST:
        wi = sample_to_uniform_sphere(u)
        return LightSample(L=env.radiance.expand(n, 3),
                           pdf=full(uniform_sphere_pdf()), wi=wi,
                           t_min=full(RAY_EPSILON), t_max=full(INF_DISTANCE))
    st, map_pdf = sample_continuous_2d(_env_distribution(env), u)
    theta = st[:, 1] * PI
    phi = st[:, 0] * TWO_PI
    ct, stheta = torch.cos(theta), torch.sin(theta)
    wi = matvec3(env.l2w, vec3(stheta * torch.cos(phi), ct, stheta * torch.sin(phi)))
    empty = map_pdf == 0.0
    pdf = torch.where(empty, 0.0, _ibl_solid_angle_pdf(map_pdf, stheta))
    L = torch.where(empty[:, None], 0.0, _ibl_lookup(env, st[:, 0], st[:, 1]))
    return LightSample(L=L, pdf=pdf, wi=wi, t_min=full(RAY_EPSILON),
                       t_max=full(INF_DISTANCE))


def env_light_pdf(env: EnvLightArrays, env_kind: int, wi: Tensor) -> Tensor:
    """Solid-angle pdf of drawing ``wi`` ([..., 3]) from the light."""
    if env_kind == ENV_CONST:
        return torch.full(wi.shape[:-1], uniform_sphere_pdf(),
                          dtype=torch.float32, device=wi.device)
    w = matvec3(env.w2l, wi)
    theta = spherical_theta(w)
    phi = spherical_phi(w)
    # Reference quirk: the v coordinate handed to the 2D pdf is theta * π
    # (not theta / π); kept as it is.
    map_pdf = pdf_2d(_env_distribution(env),
                     torch.stack([phi / TWO_PI, theta * PI], dim=-1))
    return _ibl_solid_angle_pdf(map_pdf, torch.sin(theta))


def env_light_radiance(env: EnvLightArrays, env_kind: int, rd: Tensor) -> Tensor:
    """Radiance seen by a ray that escapes to infinity."""
    if env_kind == ENV_CONST:
        return env.radiance.expand(rd.shape)
    w = normalize(matvec3(env.w2l, rd))
    return _ibl_lookup(env, spherical_phi(w) / TWO_PI, spherical_theta(w) / PI)
