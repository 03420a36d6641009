"""Branchless material system: sample / eval / pdf in the local y-up frame.

Counterpart of ``simplepath_tpu/render/materials.py``, batched over leading
dimensions.  The scene DSL's material algebra is closed:

    base     = lambertian | glossy(beckmann microfacet + lambertian, MIS)
    material = base | clearcoat(base)

so one flat parameter record covers every material, and virtual dispatch
becomes masked arithmetic.  Both lobes of the one-sample MIS are always
evaluated; a lambertian-only material simply carries selection weight 0 on
the microfacet lobe, which reproduces the single-lobe fast path exactly.

As in the JAX package, lobe-selection weights use a precomputed
directional-albedo table for the microfacet lobe instead of the C++
reference's 16-sample Monte-Carlo rho estimate per hit (the one-sample MIS
estimator is unbiased for ANY selection weights).  ``render_rays`` builds
it from the scene's materials on every call, as the JAX package does
(``render.film.with_rho_table``), and carries it in ``MaterialArrays``.

RNG contract: ``sample`` consumes exactly (u_layer, u_lobe, u2[2]) —
clearcoat layer select, MIS lobe select, and the lobe's own 2D sample.
``eval``/``pdf`` consume nothing.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor

from ..core import smath
from ..core.color import relative_luminance
from ..core.sampling import (PI, sample_to_uniform_hemisphere,
                             uniform_hemisphere_pdf)
from ..core.smath import (abs_cos_theta, balance_heuristic, cos_phi, cos_theta,
                          erfinv, fresnel_dielectric, same_hemisphere, sin_phi)
from ..core.vec import dot, normalize, reflect, reflect_local, safe_normalize
from ..scene.types import MAT_GLOSSY, MAT_LAMBERTIAN, MaterialArrays

__all__ = [
    "PROP_NONE", "PROP_DIFFUSE", "PROP_GLOSSY", "PROP_SPECULAR",
    "PROP_REFLECTIVE",
    "MatSample", "HitMaterial",
    "roughness_to_alpha", "beckmann_d", "beckmann_lambda", "beckmann_g1",
    "beckmann_g", "beckmann_sample_wh", "microfacet_pdf",
    "build_rho_tables", "gather_material",
    "material_sample", "material_eval", "material_pdf",
]

# BSDFProperties bitflags
PROP_NONE = 0
PROP_DIFFUSE = 1
PROP_GLOSSY = 2
PROP_SPECULAR = 4
PROP_REFLECTIVE = 8

# 64 cos-bins x 512 QMC samples (the JAX package's table size)
RHO_TABLE_SIZE = 64
RHO_TABLE_SAMPLES = 512

_LAMBERTIAN_PDF = uniform_hemisphere_pdf()


class MatSample(NamedTuple):
    color: Tensor      # [...,3]
    wi: Tensor         # [...,3] local
    pdf: Tensor        # [...]
    properties: Tensor  # [...] int32


class HitMaterial(NamedTuple):
    """Per-hit gathered material parameters ([N] / [N,3] / [N,K])."""
    base_type: Tensor
    albedo: Tensor
    roughness: Tensor
    ior: Tensor
    has_clearcoat: Tensor
    cc_ior: Tensor
    cc_color: Tensor
    rho_table: Tensor  # [N, RHO_TABLE_SIZE] microfacet directional albedo


# ------------------------------------------------------------- Beckmann

def roughness_to_alpha(roughness: Tensor) -> Tensor:
    """PBRT polynomial fit."""
    r = torch.clamp_min(roughness, 1e-3)
    x = torch.log(r)
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)


def beckmann_d(wh: Tensor, alpha: Tensor) -> Tensor:
    """Isotropic Beckmann NDF.  Masked lanes get SAFE INPUTS (t2=0, c4=1),
    not just a masked output, as in the JAX package — the values are the
    same: for c4 ≤ 1e-12 D underflows to exactly 0 anyway."""
    t2 = smath.tan2_theta(wh)
    c4 = smath.cos2_theta(wh) ** 2
    ok = torch.isfinite(t2) & (t2 < 1e30) & (c4 > 1e-12)
    t2s = torch.where(ok, t2, 0.0)
    c4s = torch.where(ok, c4, 1.0)
    a2 = alpha * alpha
    d = torch.exp(-t2s / a2) / (PI * a2 * c4s)
    return torch.where(ok, d, 0.0)


def beckmann_lambda(w: Tensor, alpha: Tensor) -> Tensor:
    """Masking-shadowing lambda (rational fit)."""
    abs_tan = torch.abs(smath.tan_theta(w))
    a = 1.0 / (alpha * torch.clamp_min(abs_tan, 1e-12))
    lam = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    return torch.where((a >= 1.6) | ~torch.isfinite(abs_tan) | (abs_tan < 1e-18),
                       0.0, lam)


def beckmann_g1(w: Tensor, alpha: Tensor) -> Tensor:
    return 1.0 / (1.0 + beckmann_lambda(w, alpha))


def beckmann_g(wo: Tensor, wi: Tensor, alpha: Tensor) -> Tensor:
    return 1.0 / (1.0 + beckmann_lambda(wo, alpha) + beckmann_lambda(wi, alpha))


def microfacet_pdf(wo: Tensor, wh: Tensor, alpha: Tensor) -> Tensor:
    """Visible-area pdf (sample_visible_area=true)."""
    return (beckmann_d(wh, alpha) * beckmann_g1(wo, alpha)
            * torch.abs(dot(wo, wh)) / torch.clamp_min(abs_cos_theta(wo), 1e-12))


def _beckmann_sample11(cos_theta_i: Tensor, u1: Tensor, u2: Tensor
                       ) -> tuple[Tensor, Tensor]:
    """Slope-space visible-normal sampling, branchless.  Runs the full
    9-iteration Newton/bisection (no early break; converged lanes freeze)."""
    # normal-incidence special case
    r_ni = torch.sqrt(-torch.log(torch.clamp_min(1.0 - u1, 1e-20)))
    phi_ni = 2.0 * PI * u2
    slope_x_ni = r_ni * torch.cos(phi_ni)
    slope_y_ni = r_ni * torch.sin(phi_ni)

    cti = torch.clamp_max(cos_theta_i, 0.9999)  # keep the general path finite
    sin_theta_i = torch.sqrt(torch.clamp_min(1.0 - cti * cti, 1e-20))
    tan_theta_i = sin_theta_i / cti
    cot_theta_i = 1.0 / torch.clamp_min(tan_theta_i, 1e-12)

    c = torch.erf(cot_theta_i)
    sample_x = torch.clamp_min(u1, 1e-6)

    theta_i = torch.acos(torch.clamp(cti, -0.9999999, 0.9999999))
    fit = 1.0 + theta_i * (-0.876 + theta_i * (0.4265 - 0.0594 * theta_i))
    b = c - (1.0 + c) * torch.pow(torch.clamp_min(1.0 - sample_x, 1e-20), fit)
    a = torch.full_like(b, -1.0)
    c = c.expand(b.shape)

    sqrt_pi_inv = 1.0 / math.sqrt(PI)
    normalization = 1.0 / (1.0 + c + sqrt_pi_inv * tan_theta_i
                           * torch.exp(-cot_theta_i * cot_theta_i))

    for _ in range(9):
        bad = ~((b >= a) & (b <= c))
        b = torch.where(bad, 0.5 * (a + c), b)
        inv_erf = erfinv(b)
        value = (normalization
                 * (1.0 + b + sqrt_pi_inv * tan_theta_i * torch.exp(-inv_erf * inv_erf))
                 - sample_x)
        derivative = normalization * (1.0 - inv_erf * tan_theta_i)
        converged = torch.abs(value) < 1e-5
        c_new = torch.where(value > 0, b, c)
        a_new = torch.where(value > 0, a, b)
        tiny = torch.where(derivative < 0, -1e-20, 1e-20)
        b_new = b - value / torch.where(torch.abs(derivative) < 1e-20, tiny,
                                        derivative)
        # freeze once converged (the reference breaks out of the loop)
        a = torch.where(converged, a, a_new)
        b = torch.where(converged, b, b_new)
        c = torch.where(converged, c, c_new)

    slope_x_gen = erfinv(torch.clamp(b, -0.999999, 0.999999))
    slope_y_gen = erfinv(torch.clamp(2.0 * torch.clamp_min(u2, 1e-6) - 1.0,
                                     -0.999999, 0.999999))

    ni = cos_theta_i > 0.9999
    return (torch.where(ni, slope_x_ni, slope_x_gen),
            torch.where(ni, slope_y_ni, slope_y_gen))


def _beckmann_sample(wi: Tensor, alpha: Tensor, u1: Tensor, u2: Tensor) -> Tensor:
    """Stretch / sample / rotate / unstretch."""
    wi_str = normalize(torch.stack(torch.broadcast_tensors(
        alpha * wi[..., 0], wi[..., 1], alpha * wi[..., 2]), dim=-1))
    slope_x, slope_y = _beckmann_sample11(cos_theta(wi_str), u1, u2)
    cp = cos_phi(wi_str)
    sp = sin_phi(wi_str)
    tmp = cp * slope_x - sp * slope_y
    slope_y = sp * slope_x + cp * slope_y
    slope_x = tmp
    slope_x = alpha * slope_x
    slope_y = alpha * slope_y
    return normalize(torch.stack([-slope_x, torch.ones_like(slope_x), -slope_y],
                                 dim=-1))


def beckmann_sample_wh(wo: Tensor, alpha: Tensor, u1: Tensor, u2: Tensor) -> Tensor:
    """Visible-area wh sampling with hemisphere flip."""
    flip = (cos_theta(wo) < 0.0)[..., None]
    wo_f = torch.where(flip, -wo, wo)
    wh = _beckmann_sample(wo_f, alpha, u1, u2)
    return torch.where(flip, -wh, wh)


# ------------------------------------------------------------- rho tables

def build_rho_tables(materials: MaterialArrays) -> Tensor:
    """Directional albedo (luminance) of the microfacet lobe per material,
    tabulated over cos_theta_o → ``[M, RHO_TABLE_SIZE]``.

    A QMC estimate on a grid, evaluated as one ``[S,K,M]`` batch.  The
    microfacet reflectance R is white, so luminance(rho) is scalar.
    """
    dev = materials.roughness.device
    K, S = RHO_TABLE_SIZE, RHO_TABLE_SAMPLES
    alpha = roughness_to_alpha(materials.roughness)[None, None, :]     # [1,1,M]
    ior = materials.ior[None, None, :]
    cos_grid = (torch.arange(K, dtype=torch.float32, device=dev) + 0.5) / K
    # R2 quasirandom points (the additive recurrence of the pixel sampler)
    g = 1.32471795724474602596
    n = torch.arange(S, dtype=torch.float32, device=dev) + 1.0
    u1 = torch.remainder(n / g, 1.0)[:, None, None]                    # [S,1,1]
    u2 = torch.remainder(n / (g * g), 1.0)[:, None, None]

    sin_grid = torch.sqrt(torch.clamp_min(1.0 - cos_grid ** 2, 0.0))
    wo = torch.stack([sin_grid, cos_grid, torch.zeros_like(cos_grid)],
                     dim=-1)[None, :, None, :]                         # [1,K,1,3]

    wh = beckmann_sample_wh(wo, alpha, u1, u2)                         # [S,K,M,3]
    d = dot(wo, wh)
    wi = reflect(wo, wh)
    pdf = microfacet_pdf(wo, wh, alpha) / (4.0 * torch.clamp_min(d, 1e-12))
    ok = (d >= 0.0) & same_hemisphere(wo, wi) & (pdf > 0.0)
    f = _torrance_sparrow(wo, wi, alpha, ior)
    contrib = f * abs_cos_theta(wi) / torch.clamp_min(pdf, 1e-12)
    vals = torch.where(ok, contrib, 0.0)                               # [S,K,M]
    return vals.mean(dim=0).T.contiguous()                             # [M,K]


def _torrance_sparrow(wo: Tensor, wi: Tensor, alpha: Tensor, ior) -> Tensor:
    aco = abs_cos_theta(wo)
    aci = abs_cos_theta(wi)
    wh = wo + wi
    wh_len2 = dot(wh, wh)
    ok = (aco > 0.0) & (aci > 0.0) & (wh_len2 > 0.0)
    wh = wh * torch.rsqrt(torch.clamp_min(wh_len2, 1e-20))[..., None]
    f = fresnel_dielectric(dot(wi, wh), 1.0, ior)
    val = (beckmann_d(wh, alpha) * beckmann_g(wo, wi, alpha) * f
           / torch.clamp_min(4.0 * aci * aco, 1e-12))
    return torch.where(ok, val, 0.0)


# ------------------------------------------------------------- lobes

def _lambertian_sample(albedo: Tensor, u2: Tensor) -> tuple[Tensor, Tensor]:
    """Uniform-hemisphere lambertian sample — reference quirk kept (NOT
    cosine-weighted).  Returns (color, wi); the pdf is ``_LAMBERTIAN_PDF``."""
    return albedo / PI, sample_to_uniform_hemisphere(u2)


def _microfacet_sample(wo: Tensor, alpha: Tensor, ior: Tensor, u2: Tensor
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """MicrofacetReflection::sample_impl → (scalar color, wi, pdf)."""
    wh = beckmann_sample_wh(wo, alpha, u2[..., 0], u2[..., 1])
    d = dot(wo, wh)
    wi = reflect(wo, wh)
    pdf = microfacet_pdf(wo, wh, alpha) / torch.clamp_min(4.0 * d, 1e-12)
    ok = (cos_theta(wo) != 0.0) & (d >= 0.0) & same_hemisphere(wo, wi)
    color = _torrance_sparrow(wo, wi, alpha, ior)
    return torch.where(ok, color, 0.0), wi, torch.where(ok, pdf, 0.0)


def _microfacet_pdf_wi(wo: Tensor, wi: Tensor, alpha: Tensor) -> Tensor:
    """MicrofacetReflection::pdf_impl.  wi ≈ -wo makes wo+wi a zero vector;
    safe_normalize keeps wh finite there (the pdf is masked to 0 by
    same_hemisphere anyway)."""
    sh = same_hemisphere(wo, wi)
    wh = safe_normalize(wo + wi)
    pdf = microfacet_pdf(wo, wh, alpha) / torch.clamp_min(4.0 * dot(wo, wh), 1e-12)
    return torch.where(sh, pdf, 0.0)


# ------------------------------------------------------------- material API

def gather_material(materials: MaterialArrays, mid: Tensor) -> HitMaterial:
    """Per-hit material rows (the rho table rides in ``materials``)."""
    if materials.rho_table is None:
        raise ValueError("materials carry no rho table: render through "
                         "render_rays, or build it with "
                         "render.film.with_rho_table")
    return HitMaterial(
        base_type=materials.base_type[mid],
        albedo=materials.albedo[mid],
        roughness=materials.roughness[mid],
        ior=materials.ior[mid],
        has_clearcoat=materials.has_clearcoat[mid],
        cc_ior=materials.cc_ior[mid],
        cc_color=materials.cc_color[mid],
        rho_table=materials.rho_table[mid],
    )


def _selection_weights(m: HitMaterial, wo: Tensor) -> tuple[Tensor, Tensor]:
    """One-sample MIS lobe weights (w_mf, w_lam), normalized.  Lambertian
    rho = albedo; microfacet rho from the precomputed table.  For base_type
    lambertian, w_mf = 0."""
    K = RHO_TABLE_SIZE
    c = torch.clamp(abs_cos_theta(wo) * K - 0.5, 0.0, K - 1.0)
    i0 = torch.floor(c).to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, K - 1)
    frac = c - i0.to(c.dtype)
    table = m.rho_table.expand(i0.shape + (K,))
    r0 = table.gather(-1, i0[..., None])[..., 0]
    r1 = table.gather(-1, i1[..., None])[..., 0]
    rho_mf = (1.0 - frac) * r0 + frac * r1
    w_mf = torch.where(m.base_type == MAT_GLOSSY, rho_mf, 0.0)
    w_lam = relative_luminance(m.albedo)
    total = w_mf + w_lam
    safe = torch.where(total == 0.0, 1.0, total)
    return w_mf / safe, w_lam / safe


def _mis_mix(mf_p: Tensor, lam_p: Tensor, mf_v: Tensor, lam_v: Tensor) -> Tensor:
    """Balance-heuristic mix of the two lobes' values (mf_v scalar → RGB)."""
    inner = mf_p + lam_p
    w_mf_mis = torch.where(mf_p > 0.0, balance_heuristic(mf_p, inner), 0.0)
    w_lam_mis = torch.where(lam_p > 0.0, balance_heuristic(lam_p, inner), 0.0)
    return (w_mf_mis * mf_v)[..., None] + w_lam_mis[..., None] * lam_v


def _base_sample(m: HitMaterial, wo: Tensor, u_lobe: Tensor, u2: Tensor) -> MatSample:
    """OneSampleMaterial::sample_impl for lobes (microfacet, lambertian).
    The microfacet lobe's reflectance R is white, so its color is a scalar
    broadcast to RGB."""
    alpha = roughness_to_alpha(m.roughness)
    w_mf, w_lam = _selection_weights(m, wo)

    mf_color_s, mf_wi, mf_pdf = _microfacet_sample(wo, alpha, m.ior, u2)
    lam_color, lam_wi = _lambertian_sample(m.albedo, u2)
    lam_pdf = torch.full_like(mf_pdf, _LAMBERTIAN_PDF)

    pick_mf = u_lobe < w_mf  # CDF select, lobe order (mf, lam)
    wi = torch.where(pick_mf[..., None], mf_wi, lam_wi)
    sel_pdf = torch.where(pick_mf, mf_pdf, lam_pdf)
    sel_color = torch.where(pick_mf[..., None], mf_color_s[..., None], lam_color)
    degenerate = (sel_pdf == 0.0) | (sel_color == 0.0).all(dim=-1)

    # per-lobe (value, pdf*weight) at the chosen wi; the selected lobe reuses
    # its own sample result, the other is cross-evaluated
    mf_v = torch.where(pick_mf, mf_color_s, _torrance_sparrow(wo, wi, alpha, m.ior))
    mf_p = torch.where(pick_mf, mf_pdf, _microfacet_pdf_wi(wo, wi, alpha)) * w_mf
    lam_v = m.albedo / PI  # independent of wi
    lam_p = _LAMBERTIAN_PDF * w_lam

    color = _mis_mix(mf_p, lam_p, mf_v, lam_v)
    pdf = mf_p + lam_p

    # single-lobe fast path (lambertian-only): raw lobe sample passthrough
    single = m.base_type == MAT_LAMBERTIAN
    color = torch.where(single[..., None], lam_color, color)
    pdf = torch.where(single, lam_pdf, pdf)
    wi = torch.where(single[..., None], lam_wi, wi)

    props = torch.where(pick_mf & ~single,
                        PROP_GLOSSY | PROP_REFLECTIVE,
                        PROP_DIFFUSE | PROP_REFLECTIVE).to(torch.int32)
    dead = degenerate & ~single
    pdf = torch.where(dead, 0.0, pdf)
    color = torch.where(dead[..., None], 0.0, color)
    return MatSample(color=color, wi=wi, pdf=pdf, properties=props)


def _base_eval(m: HitMaterial, wo: Tensor, wi: Tensor) -> Tensor:
    """OneSampleMaterial::eval_impl."""
    alpha = roughness_to_alpha(m.roughness)
    w_mf, w_lam = _selection_weights(m, wo)
    mf_p = _microfacet_pdf_wi(wo, wi, alpha) * w_mf
    lam_p = _LAMBERTIAN_PDF * w_lam
    mf_v = _torrance_sparrow(wo, wi, alpha, m.ior)
    lam_v = m.albedo / PI
    result = _mis_mix(mf_p, lam_p, mf_v, lam_v)
    single = m.base_type == MAT_LAMBERTIAN
    return torch.where(single[..., None], lam_v, result)


def _base_pdf(m: HitMaterial, wo: Tensor, wi: Tensor) -> Tensor:
    """OneSampleMaterial::pdf_impl."""
    alpha = roughness_to_alpha(m.roughness)
    w_mf, w_lam = _selection_weights(m, wo)
    pdf = w_mf * _microfacet_pdf_wi(wo, wi, alpha) + w_lam * _LAMBERTIAN_PDF
    single = m.base_type == MAT_LAMBERTIAN
    return torch.where(single, _LAMBERTIAN_PDF, pdf)


def _clearcoat_fresnel(m: HitMaterial, wo: Tensor) -> Tensor:
    f = fresnel_dielectric(cos_theta(wo), 1.0, m.cc_ior)
    return torch.where(m.has_clearcoat == 1, f, 0.0)


def material_sample(m: HitMaterial, wo: Tensor, u_layer: Tensor, u_lobe: Tensor,
                    u2: Tensor) -> MatSample:
    """Full material sample incl. the clearcoat layer."""
    f = _clearcoat_fresnel(m, wo)
    pick_spec = u_layer < f

    spec_wi = reflect_local(wo)
    spec_color = (f[..., None] * m.cc_color
                  / torch.clamp_min(abs_cos_theta(spec_wi), 1e-12)[..., None])

    base = _base_sample(m, wo, u_lobe, u2)
    base_pdf = (1.0 - f) * base.pdf
    base_color = (1.0 - f[..., None] * m.cc_color) * base.color
    base_pdf = torch.where(base.pdf == 0.0, 0.0, base_pdf)

    color = torch.where(pick_spec[..., None], spec_color, base_color)
    wi = torch.where(pick_spec[..., None], spec_wi, base.wi)
    pdf = torch.where(pick_spec, f, base_pdf)
    props = torch.where(pick_spec, PROP_SPECULAR | PROP_REFLECTIVE,
                        base.properties).to(torch.int32)
    return MatSample(color=color, wi=wi, pdf=pdf, properties=props)


def material_eval(m: HitMaterial, wo: Tensor, wi: Tensor) -> Tensor:
    """(1-f) * base_eval."""
    return (1.0 - _clearcoat_fresnel(m, wo))[..., None] * _base_eval(m, wo, wi)


def material_pdf(m: HitMaterial, wo: Tensor, wi: Tensor) -> Tensor:
    """(1-f) * base_pdf."""
    return (1.0 - _clearcoat_fresnel(m, wo)) * _base_pdf(m, wo, wi)
