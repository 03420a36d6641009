"""Scalar math helpers: balance heuristic, erfinv, fresnel, local trig.

Counterpart of ``simplepath_tpu/core/smath.py``; everything is branchless and
batched over leading dimensions.
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["balance_heuristic", "balance_heuristic_counts", "erfinv",
           "fresnel_dielectric", "cos_theta", "abs_cos_theta", "cos2_theta",
           "sin2_theta", "sin_theta", "tan_theta", "tan2_theta", "cos_phi",
           "sin_phi", "same_hemisphere"]


def _div0(num: Tensor, den: Tensor) -> Tensor:
    """num/den with 0 where den == 0."""
    zero = den == 0.0
    q = num / torch.where(zero, torch.ones_like(den), den)
    return torch.where(zero, torch.zeros_like(q), q)


def balance_heuristic(p: Tensor, inner_product: Tensor) -> Tensor:
    """One-sample balance heuristic w = p / Σp."""
    return _div0(p, inner_product)


def balance_heuristic_counts(nf, f_pdf: Tensor, ng, g_pdf: Tensor) -> Tensor:
    """(nf·f)/(nf·f+ng·g)."""
    denom = nf * f_pdf + ng * g_pdf
    return _div0(nf * f_pdf, denom)


_ERFINV_BIG = (3.03697567e-10, 2.93243101e-8, 1.22150334e-6, 2.84108955e-5,
               3.93552968e-4, 3.02698812e-3, 4.83185798e-3, -2.64646143e-1,
               8.40016484e-1)
_ERFINV_SMALL = (5.43877832e-9, 1.43285448e-7, 1.22774793e-6, 1.12963626e-7,
                 -5.61530760e-5, -1.47697632e-4, 2.31468678e-3, 1.15392581e-2,
                 -2.32015476e-1, 8.86226892e-1)


def _poly(coeffs, t: Tensor) -> Tensor:
    p = torch.full_like(t, coeffs[0])
    for c in coeffs[1:]:
        p = p * t + c
    return p


def erfinv(a: Tensor) -> Tensor:
    """The repo's own polynomial inverse error function (not
    ``torch.erfinv``: the values must match the JAX package's)."""
    a = a.to(torch.float32)
    t = torch.log(torch.clamp_min(a * (0.0 - a) + 1.0, 1e-38))
    p = torch.where(torch.abs(t) > 6.125, _poly(_ERFINV_BIG, t),
                    _poly(_ERFINV_SMALL, t))
    return a * p


def fresnel_dielectric(cos_theta_i: Tensor, eta_i, eta_t) -> Tensor:
    """Unpolarized dielectric Fresnel, branchless; swaps IORs when cos < 0.
    ``eta_i``/``eta_t`` are floats or tensors broadcastable to the batch."""
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


# ---- local-frame trig (y-up) ----

def cos_theta(w: Tensor) -> Tensor:
    return w[..., 1]


def abs_cos_theta(w: Tensor) -> Tensor:
    return torch.abs(w[..., 1])


def cos2_theta(w: Tensor) -> Tensor:
    return w[..., 1] * w[..., 1]


def sin2_theta(w: Tensor) -> Tensor:
    return torch.clamp_min(1.0 - cos2_theta(w), 0.0)


def sin_theta(w: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp_min(sin2_theta(w), 1e-20))


def tan_theta(w: Tensor) -> Tensor:
    # |cos| floored at 1e-18 (sign kept), as in the JAX package
    ct = cos_theta(w)
    floor = torch.where(ct < 0, torch.full_like(ct, -1e-18),
                        torch.full_like(ct, 1e-18))
    safe = torch.where(torch.abs(ct) < 1e-18, floor, ct)
    return sin_theta(w) / safe


def tan2_theta(w: Tensor) -> Tensor:
    c2 = torch.clamp_min(cos2_theta(w), 1e-18)
    return sin2_theta(w) / c2


def _phi_component(w: Tensor, comp: int) -> Tensor:
    st = sin_theta(w)
    zero = st == 0.0
    q = torch.clamp(w[..., comp] / torch.where(zero, torch.ones_like(st), st),
                    -1.0, 1.0)
    return torch.where(zero, torch.ones_like(q), q)


def cos_phi(w: Tensor) -> Tensor:
    return _phi_component(w, 0)


def sin_phi(w: Tensor) -> Tensor:
    return _phi_component(w, 2)


def same_hemisphere(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 1] * b[..., 1] > 0.0
