"""Random numbers, vector math, sampling, materials and lights, batched.

Frozen copies, at commit d1155b91, of the port's ``core/rng.py``,
``core/vec.py``, ``core/sampling.py``, ``core/smath.py``, ``core/onb.py``,
``core/color.py``, ``render/materials.py`` and the sphere-light and
constant-environment parts of ``render/lights.py``; the arithmetic is
unchanged, so equal inputs give equal bits on one device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor

PI = math.pi
TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
RAY_EPSILON = 1e-3
INF_DISTANCE = math.inf

# ------------------------------------------------------------------ rng

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def r_sequence_alpha(dimension: int) -> list[float]:
    x = 2.0
    for _ in range(10):
        x = (1.0 + x) ** (1.0 / (dimension + 1.0))
    return [math.modf((1.0 / x) ** (i + 1.0))[0] for i in range(dimension)]


_ALPHA_2D = r_sequence_alpha(2)


def pixel_jitter(x: Tensor, y: Tensor, sample_index: Tensor) -> Tensor:
    """The sample's 2D R-sequence point of the pixel's stream, in [0,1)²."""
    seed = ((x.to(torch.int64) << 16) & _M32) | (y.to(torch.int64) & _M32)
    seed = seed ^ 0x6184FAF4
    alpha = torch.tensor(_ALPHA_2D, dtype=torch.float32, device=seed.device)
    fseed = seed.to(torch.float32) / 3.4028235e38
    vals = fseed[..., None] + alpha * (sample_index.to(torch.float32)[..., None] + 1.0)
    return torch.remainder(vals, 1.0)


def prng_key(seed: int, device=None) -> Tensor:
    """A 64-bit seed split into two 32-bit words (``jax.random.PRNGKey``)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64,
                        device=device)


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(key: Tensor, data) -> Tensor:
    if isinstance(data, Tensor):
        lo = data.to(torch.int64) & _M32
    else:
        lo = torch.tensor(int(data) & _M32, dtype=torch.int64, device=key.device)
    hi = torch.zeros_like(lo)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], hi, lo)
    return torch.stack([o0, o1], dim=-1)


def uniform_sites(key: Tensor, sites) -> Tensor:
    """Two uniforms for each draw site → ``[len(sites), ..., 2]``."""
    s = torch.tensor([int(x) & _M32 for x in sites], dtype=torch.int64,
                     device=key.device)
    s = s.reshape((-1,) + (1,) * (key.dim() - 1))
    k = fold_in(key[None], s)
    lo = torch.arange(2, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(k[..., 0:1], k[..., 1:2], torch.zeros_like(lo), lo)
    fb = ((((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32))
    return fb.view(torch.float32) - 1.0


# ------------------------------------------------------------------ vectors

def vec3(x, y, z):
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def sqr_length(a):
    return dot(a, a)


def length(a):
    return torch.sqrt(sqr_length(a))


def normalize(a):
    return a / length(a)[..., None]


def matvec3(m, v):
    p = m * v[..., None, :]
    return p[..., 0] + p[..., 1] + p[..., 2]


def vecmat3(v, m):
    p = v[..., :, None] * m
    return p[..., 0, :] + p[..., 1, :] + p[..., 2, :]


def safe_normalize(a, eps: float = 1e-20):
    len2 = torch.clamp_min(sqr_length(a), eps)
    return a * torch.rsqrt(len2)[..., None]


def safe_sqrt(x, floor: float = 1e-20):
    return torch.sqrt(torch.clamp_min(x, floor))


def reflect_local(wo):
    return wo * torch.tensor([-1.0, 1.0, -1.0], dtype=wo.dtype, device=wo.device)


def reflect(wo, n):
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def relative_luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def look_at(eye, point, up):
    """Camera-to-world (linear with columns u, v, z; origin eye)."""
    z = normalize(point - eye)
    u = normalize(cross(up, z))
    v = normalize(cross(z, u))
    return torch.stack([u, v, z], dim=-1), eye


# ------------------------------------------------------------------ sampling

def sample_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = TWO_PI * u[..., 1]
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def uniform_sphere_pdf() -> float:
    return 1.0 / (4.0 * PI)


def sample_to_uniform_hemisphere(u):
    y = u[..., 0]
    r = safe_sqrt(1.0 - y * y)
    phi = TWO_PI * u[..., 1]
    return vec3(r * torch.cos(phi), y, r * torch.sin(phi))


_LAMBERTIAN_PDF = 1.0 / (2.0 * PI)


def sample_to_concentric_disk(u):
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


def sample_to_cosine_hemisphere(u):
    d = sample_to_concentric_disk(u)
    y = safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return vec3(d[..., 0], y, d[..., 1])


# ------------------------------------------------------------------ smath

def _div0(num, den):
    zero = den == 0.0
    q = num / torch.where(zero, torch.ones_like(den), den)
    return torch.where(zero, torch.zeros_like(q), q)


def balance_heuristic(p, inner_product):
    return _div0(p, inner_product)


def balance_heuristic_counts(nf, f_pdf, ng, g_pdf):
    return _div0(nf * f_pdf, nf * f_pdf + ng * g_pdf)


_ERFINV_BIG = (3.03697567e-10, 2.93243101e-8, 1.22150334e-6, 2.84108955e-5,
               3.93552968e-4, 3.02698812e-3, 4.83185798e-3, -2.64646143e-1,
               8.40016484e-1)
_ERFINV_SMALL = (5.43877832e-9, 1.43285448e-7, 1.22774793e-6, 1.12963626e-7,
                 -5.61530760e-5, -1.47697632e-4, 2.31468678e-3, 1.15392581e-2,
                 -2.32015476e-1, 8.86226892e-1)


def _poly(coeffs, t):
    p = torch.full_like(t, coeffs[0])
    for c in coeffs[1:]:
        p = p * t + c
    return p


def erfinv(a):
    a = a.to(torch.float32)
    t = torch.log(torch.clamp_min(a * (0.0 - a) + 1.0, 1e-38))
    p = torch.where(torch.abs(t) > 6.125, _poly(_ERFINV_BIG, t),
                    _poly(_ERFINV_SMALL, t))
    return a * p


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    cti = torch.clamp(cos_theta_i, -1.0, 1.0)
    eta_i = torch.as_tensor(eta_i, dtype=cti.dtype, device=cti.device)
    eta_t = torch.as_tensor(eta_t, dtype=cti.dtype, device=cti.device)
    entering = cti > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    cti = torch.abs(cti)
    sin_i = torch.sqrt(torch.clamp_min(1.0 - cti * cti, 1e-20))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ctt = torch.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 1e-20))
    r_parl = (et * cti - ei * ctt) / (et * cti + ei * ctt)
    r_perp = (ei * cti - et * ctt) / (ei * cti + et * ctt)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, torch.ones_like(f), f)


def cos_theta(w):
    return w[..., 1]


def abs_cos_theta(w):
    return torch.abs(w[..., 1])


def cos2_theta(w):
    return w[..., 1] * w[..., 1]


def sin2_theta(w):
    return torch.clamp_min(1.0 - cos2_theta(w), 0.0)


def sin_theta(w):
    return torch.sqrt(torch.clamp_min(sin2_theta(w), 1e-20))


def tan_theta(w):
    ct = cos_theta(w)
    floor = torch.where(ct < 0, torch.full_like(ct, -1e-18),
                        torch.full_like(ct, 1e-18))
    safe = torch.where(torch.abs(ct) < 1e-18, floor, ct)
    return sin_theta(w) / safe


def tan2_theta(w):
    c2 = torch.clamp_min(cos2_theta(w), 1e-18)
    return sin2_theta(w) / c2


def _phi_component(w, comp: int):
    st = sin_theta(w)
    zero = st == 0.0
    q = torch.clamp(w[..., comp] / torch.where(zero, torch.ones_like(st), st),
                    -1.0, 1.0)
    return torch.where(zero, torch.ones_like(q), q)


def cos_phi(w):
    return _phi_component(w, 0)


def sin_phi(w):
    return _phi_component(w, 2)


def same_hemisphere(a, b):
    return a[..., 1] * b[..., 1] > 0.0


# ------------------------------------------------------------------ onb

def onb_from_v(n):
    """Rows (u, v, w) with the normal as v."""
    v = normalize(n)
    nx, ny, nz = v[..., 0], v[..., 1], v[..., 2]
    sign = torch.copysign(torch.ones_like(nz), nz)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    w = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    u = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return torch.stack([u, v, w], dim=-2)


def onb_to_world(onb, a):
    return vecmat3(a, onb)


def onb_to_local(onb, a):
    return matvec3(onb, a)


# ------------------------------------------------------------------ materials

MAT_LAMBERTIAN = 0
MAT_GLOSSY = 1
RHO_TABLE_SIZE = 64
RHO_TABLE_SAMPLES = 512


class MatSample(NamedTuple):
    color: Tensor
    wi: Tensor
    pdf: Tensor


class HitMaterial(NamedTuple):
    base_type: Tensor
    albedo: Tensor
    roughness: Tensor
    ior: Tensor
    has_clearcoat: Tensor
    cc_ior: Tensor
    cc_color: Tensor
    rho_table: Tensor


def roughness_to_alpha(roughness):
    r = torch.clamp_min(roughness, 1e-3)
    x = torch.log(r)
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)


def beckmann_d(wh, alpha):
    t2 = tan2_theta(wh)
    c4 = cos2_theta(wh) ** 2
    ok = torch.isfinite(t2) & (t2 < 1e30) & (c4 > 1e-12)
    t2s = torch.where(ok, t2, 0.0)
    c4s = torch.where(ok, c4, 1.0)
    a2 = alpha * alpha
    d = torch.exp(-t2s / a2) / (PI * a2 * c4s)
    return torch.where(ok, d, 0.0)


def beckmann_lambda(w, alpha):
    abs_tan = torch.abs(tan_theta(w))
    a = 1.0 / (alpha * torch.clamp_min(abs_tan, 1e-12))
    lam = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    return torch.where((a >= 1.6) | ~torch.isfinite(abs_tan) | (abs_tan < 1e-18),
                       0.0, lam)


def beckmann_g1(w, alpha):
    return 1.0 / (1.0 + beckmann_lambda(w, alpha))


def beckmann_g(wo, wi, alpha):
    return 1.0 / (1.0 + beckmann_lambda(wo, alpha) + beckmann_lambda(wi, alpha))


def microfacet_pdf(wo, wh, alpha):
    return (beckmann_d(wh, alpha) * beckmann_g1(wo, alpha)
            * torch.abs(dot(wo, wh)) / torch.clamp_min(abs_cos_theta(wo), 1e-12))


def _beckmann_sample11(cos_theta_i, u1, u2):
    r_ni = torch.sqrt(-torch.log(torch.clamp_min(1.0 - u1, 1e-20)))
    phi_ni = 2.0 * PI * u2
    slope_x_ni = r_ni * torch.cos(phi_ni)
    slope_y_ni = r_ni * torch.sin(phi_ni)

    cti = torch.clamp_max(cos_theta_i, 0.9999)
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
        a = torch.where(converged, a, a_new)
        b = torch.where(converged, b, b_new)
        c = torch.where(converged, c, c_new)

    slope_x_gen = erfinv(torch.clamp(b, -0.999999, 0.999999))
    slope_y_gen = erfinv(torch.clamp(2.0 * torch.clamp_min(u2, 1e-6) - 1.0,
                                     -0.999999, 0.999999))
    ni = cos_theta_i > 0.9999
    return (torch.where(ni, slope_x_ni, slope_x_gen),
            torch.where(ni, slope_y_ni, slope_y_gen))


def _beckmann_sample(wi, alpha, u1, u2):
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


def beckmann_sample_wh(wo, alpha, u1, u2):
    flip = (cos_theta(wo) < 0.0)[..., None]
    wo_f = torch.where(flip, -wo, wo)
    wh = _beckmann_sample(wo_f, alpha, u1, u2)
    return torch.where(flip, -wh, wh)


def build_rho_tables(roughness: Tensor, ior: Tensor) -> Tensor:
    """Directional albedo of the microfacet lobe per material → [M, 64]."""
    dev = roughness.device
    K, S = RHO_TABLE_SIZE, RHO_TABLE_SAMPLES
    alpha = roughness_to_alpha(roughness)[None, None, :]
    ior = ior[None, None, :]
    cos_grid = (torch.arange(K, dtype=torch.float32, device=dev) + 0.5) / K
    g = 1.32471795724474602596
    n = torch.arange(S, dtype=torch.float32, device=dev) + 1.0
    u1 = torch.remainder(n / g, 1.0)[:, None, None]
    u2 = torch.remainder(n / (g * g), 1.0)[:, None, None]
    sin_grid = torch.sqrt(torch.clamp_min(1.0 - cos_grid ** 2, 0.0))
    wo = torch.stack([sin_grid, cos_grid, torch.zeros_like(cos_grid)],
                     dim=-1)[None, :, None, :]
    wh = beckmann_sample_wh(wo, alpha, u1, u2)
    d = dot(wo, wh)
    wi = reflect(wo, wh)
    pdf = microfacet_pdf(wo, wh, alpha) / (4.0 * torch.clamp_min(d, 1e-12))
    ok = (d >= 0.0) & same_hemisphere(wo, wi) & (pdf > 0.0)
    f = _torrance_sparrow(wo, wi, alpha, ior)
    contrib = f * abs_cos_theta(wi) / torch.clamp_min(pdf, 1e-12)
    vals = torch.where(ok, contrib, 0.0)
    return vals.mean(dim=0).T.contiguous()


def _torrance_sparrow(wo, wi, alpha, ior):
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


def _microfacet_sample(wo, alpha, ior, u2):
    wh = beckmann_sample_wh(wo, alpha, u2[..., 0], u2[..., 1])
    d = dot(wo, wh)
    wi = reflect(wo, wh)
    pdf = microfacet_pdf(wo, wh, alpha) / torch.clamp_min(4.0 * d, 1e-12)
    ok = (cos_theta(wo) != 0.0) & (d >= 0.0) & same_hemisphere(wo, wi)
    color = _torrance_sparrow(wo, wi, alpha, ior)
    return torch.where(ok, color, 0.0), wi, torch.where(ok, pdf, 0.0)


def _microfacet_pdf_wi(wo, wi, alpha):
    sh = same_hemisphere(wo, wi)
    wh = safe_normalize(wo + wi)
    pdf = microfacet_pdf(wo, wh, alpha) / torch.clamp_min(4.0 * dot(wo, wh), 1e-12)
    return torch.where(sh, pdf, 0.0)


def gather_material(mats, mid: Tensor) -> HitMaterial:
    return HitMaterial(base_type=mats.base_type[mid], albedo=mats.albedo[mid],
                       roughness=mats.roughness[mid], ior=mats.ior[mid],
                       has_clearcoat=mats.has_clearcoat[mid],
                       cc_ior=mats.cc_ior[mid], cc_color=mats.cc_color[mid],
                       rho_table=mats.rho_table[mid])


def _selection_weights(m: HitMaterial, wo):
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


def _mis_mix(mf_p, lam_p, mf_v, lam_v):
    inner = mf_p + lam_p
    w_mf_mis = torch.where(mf_p > 0.0, balance_heuristic(mf_p, inner), 0.0)
    w_lam_mis = torch.where(lam_p > 0.0, balance_heuristic(lam_p, inner), 0.0)
    return (w_mf_mis * mf_v)[..., None] + w_lam_mis[..., None] * lam_v


def _base_sample(m: HitMaterial, wo, u_lobe, u2) -> MatSample:
    alpha = roughness_to_alpha(m.roughness)
    w_mf, w_lam = _selection_weights(m, wo)
    mf_color_s, mf_wi, mf_pdf = _microfacet_sample(wo, alpha, m.ior, u2)
    lam_color, lam_wi = m.albedo / PI, sample_to_uniform_hemisphere(u2)
    lam_pdf = torch.full_like(mf_pdf, _LAMBERTIAN_PDF)

    pick_mf = u_lobe < w_mf
    wi = torch.where(pick_mf[..., None], mf_wi, lam_wi)
    sel_pdf = torch.where(pick_mf, mf_pdf, lam_pdf)
    sel_color = torch.where(pick_mf[..., None], mf_color_s[..., None], lam_color)
    degenerate = (sel_pdf == 0.0) | (sel_color == 0.0).all(dim=-1)

    mf_v = torch.where(pick_mf, mf_color_s, _torrance_sparrow(wo, wi, alpha, m.ior))
    mf_p = torch.where(pick_mf, mf_pdf, _microfacet_pdf_wi(wo, wi, alpha)) * w_mf
    lam_v = m.albedo / PI
    lam_p = _LAMBERTIAN_PDF * w_lam

    color = _mis_mix(mf_p, lam_p, mf_v, lam_v)
    pdf = mf_p + lam_p

    single = m.base_type == MAT_LAMBERTIAN
    color = torch.where(single[..., None], lam_color, color)
    pdf = torch.where(single, lam_pdf, pdf)
    wi = torch.where(single[..., None], lam_wi, wi)

    dead = degenerate & ~single
    pdf = torch.where(dead, 0.0, pdf)
    color = torch.where(dead[..., None], 0.0, color)
    return MatSample(color=color, wi=wi, pdf=pdf)


def _base_eval(m: HitMaterial, wo, wi):
    alpha = roughness_to_alpha(m.roughness)
    w_mf, w_lam = _selection_weights(m, wo)
    mf_p = _microfacet_pdf_wi(wo, wi, alpha) * w_mf
    lam_p = _LAMBERTIAN_PDF * w_lam
    mf_v = _torrance_sparrow(wo, wi, alpha, m.ior)
    lam_v = m.albedo / PI
    result = _mis_mix(mf_p, lam_p, mf_v, lam_v)
    single = m.base_type == MAT_LAMBERTIAN
    return torch.where(single[..., None], lam_v, result)


def _base_pdf(m: HitMaterial, wo, wi):
    alpha = roughness_to_alpha(m.roughness)
    w_mf, w_lam = _selection_weights(m, wo)
    pdf = w_mf * _microfacet_pdf_wi(wo, wi, alpha) + w_lam * _LAMBERTIAN_PDF
    single = m.base_type == MAT_LAMBERTIAN
    return torch.where(single, _LAMBERTIAN_PDF, pdf)


def _clearcoat_fresnel(m: HitMaterial, wo):
    f = fresnel_dielectric(cos_theta(wo), 1.0, m.cc_ior)
    return torch.where(m.has_clearcoat == 1, f, 0.0)


def material_sample(m: HitMaterial, wo, u_layer, u_lobe, u2) -> MatSample:
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
    return MatSample(color=color, wi=wi, pdf=pdf)


def material_eval(m: HitMaterial, wo, wi):
    return (1.0 - _clearcoat_fresnel(m, wo))[..., None] * _base_eval(m, wo, wi)


def material_pdf(m: HitMaterial, wo, wi):
    return (1.0 - _clearcoat_fresnel(m, wo)) * _base_pdf(m, wo, wi)


# ------------------------------------------------------------------ lights

class LightSample(NamedTuple):
    L: Tensor
    pdf: Tensor
    wi: Tensor
    t_min: Tensor
    t_max: Tensor


def get_ray_offset(cos_d):
    zero = cos_d == 0.0
    q = RAY_EPSILON / torch.where(zero, torch.ones_like(cos_d), cos_d)
    return torch.where(zero, torch.full_like(q, RAY_EPSILON), q)


def get_ray_offset_nd(n, d):
    return get_ray_offset(torch.abs(dot(n, d)))


def sphere_quadratic(w2o_l, w2o_t, ro, rd):
    o = matvec3(w2o_l, ro) + w2o_t
    d = matvec3(w2o_l, rd)
    a = dot(d, d)
    b = 2.0 * dot(d, o)
    c = dot(o, o) - 1.0
    return b, b * b - 4.0 * a * c, 2.0 * a


def sphere_light_sample(lights, li: int, p, n, u) -> LightSample:
    o2w_l = lights.o2w_l[li]
    obs = matvec3(lights.w2o_l[li], p) + lights.w2o_t[li]
    inside = sqr_length(obs) <= 1.0
    onb = onb_from_v(obs)
    s_cos = onb_to_world(onb, sample_to_cosine_hemisphere(u))
    s_uni = sample_to_uniform_sphere(u)
    local_sample = torch.where(inside[:, None], s_uni, s_cos)
    point = matvec3(o2w_l, local_sample) + lights.o2w_t[li]
    normal = normalize(matvec3(o2w_l, local_sample))
    to_sample = point - p
    wi = normalize(to_sample)
    pdf = sphere_light_pdf(lights, li, p)
    distance = length(to_sample) - get_ray_offset_nd(normal, -wi)
    t_min = get_ray_offset_nd(n, wi)
    return LightSample(L=lights.radiance[li].expand(p.shape), pdf=pdf, wi=wi,
                       t_min=t_min, t_max=distance)


def sphere_light_pdf(lights, li: int, p):
    obs = matvec3(lights.w2o_l[li], p) + lights.w2o_t[li]
    sqr_dist = sqr_length(obs)
    inside = sqr_dist <= 1.0
    sin2_1_5_deg = 0.00068523
    sin2_theta_max = 1.0 / torch.clamp_min(sqr_dist, 1.0)
    cos_theta_max = torch.sqrt(torch.clamp_min(1.0 - sin2_theta_max, 1e-20))
    one_minus = torch.where(sin2_theta_max < sin2_1_5_deg,
                            sin2_theta_max / 2.0, 1.0 - cos_theta_max)
    pdf_cone = 1.0 / (TWO_PI * torch.clamp_min(one_minus, 1e-20))
    return torch.where(inside, torch.full_like(pdf_cone, uniform_sphere_pdf()),
                       pdf_cone)


def sphere_light_intersect(lights, li: int, ro, rd, t_min, t_max):
    b, disc, two_a = sphere_quadratic(lights.w2o_l[li], lights.w2o_t[li], ro, rd)
    has = disc > 0.0
    sq = torch.sqrt(torch.where(has, torch.clamp_min(disc, 1e-12),
                                torch.ones_like(disc)))
    t0 = (-b - sq) / two_a
    t1 = (-b + sq) / two_a
    t = torch.where(t0 < t_min, t1, t0)
    valid = has & (t >= t_min) & (t <= t_max)
    return t, valid


def env_light_sample(radiance, u) -> LightSample:
    """The constant environment light: a uniform direction on the sphere."""
    n = u.shape[0]
    full = lambda v: torch.full((n,), v, dtype=torch.float32, device=u.device)
    return LightSample(L=radiance.expand(n, 3), pdf=full(uniform_sphere_pdf()),
                       wi=sample_to_uniform_sphere(u), t_min=full(RAY_EPSILON),
                       t_max=full(INF_DISTANCE))
