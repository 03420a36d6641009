"""Piecewise-constant 1D/2D distributions via cumsum + binary search.

Counterpart of ``simplepath_tpu/core/distribution.py``: the CDF build is a
prefix sum, sampling a branchless binary search over whole batches (one
gather a step).  Used for importance sampling image-based
environment lights.

IMPORTANT reference quirk, reproduced bit for bit (as in the JAX package):
Distribution1D's CDF normalization writes its results LEFT-SHIFTED by one, so
the effective CDF stored is ``[c1/I, c2/I, ..., cn/I, I]`` — the last entry
keeps the UNNORMALIZED integral.  Consequences:

* the upper-bound search lands on the correct PBRT-style bin index;
* the intra-bin remainder ``du = u - cdf[offset]`` is NEGATIVE (relative to
  the bin's end), divided by the NEXT segment's width — or kept raw when
  that segment has zero width;
* sampled positions can dip slightly below the bin start (even below 0 for
  the first bin).

The zero-integral fallback writes ``[0, 1/n, ..., 1]`` (no shift).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

__all__ = ["Distribution1D", "build_distribution_1d", "sample_continuous_1d",
           "sample_discrete_1d", "discrete_pdf_1d", "invert_1d",
           "Distribution2D", "build_distribution_2d", "sample_continuous_2d",
           "pdf_2d"]


class Distribution1D(NamedTuple):
    function: Tensor   # [n] |f|
    cdf: Tensor        # [n+1] the reference's effective (shifted) CDF
    integral: Tensor   # scalar: unnormalized total
    dmin: float
    dmax: float


def _lerp(t, a, b):
    return (1.0 - t) * a + t * b


def _effective_cdf(f: Tensor, dmin: float, dmax: float) -> tuple[Tensor, Tensor]:
    """Build the reference's shifted CDF over the last axis; returns
    (cdf [..., n+1], integral [...])."""
    n = f.shape[-1]
    steps = f * ((dmax - dmin) / n)
    raw = torch.cumsum(steps, dim=-1)                 # c1..cn
    integral = raw[..., -1]
    safe = torch.where(integral == 0.0, torch.ones_like(integral), integral)
    shifted = torch.cat([raw / safe[..., None], integral[..., None]], dim=-1)
    uniform = torch.arange(n + 1, dtype=f.dtype, device=f.device) / n
    cdf = torch.where(integral[..., None] == 0.0, uniform, shifted)
    return cdf, integral


def build_distribution_1d(f: Tensor, dmin: float = 0.0,
                          dmax: float = 1.0) -> Distribution1D:
    f = torch.abs(f)
    cdf, integral = _effective_cdf(f, dmin, dmax)
    return Distribution1D(f, cdf, integral, dmin, dmax)


def _take(a: Tensor, i: Tensor, row: Tensor | None) -> Tensor:
    """a[i] of a single 1-D table, or a[row, i] of a 2-D one (one row per
    element: a gather, the [N, n] rows are never copied)."""
    return a[i] if row is None else a[row, i]


def _rowwise_upper_bound(table: Tensor, row: Tensor | None, u: Tensor,
                         m: int) -> Tensor:
    """upper_bound over table[..., :m] (of row ``row`` per element, or of
    the single 1-D table): index of the first entry > u.  Branchless binary
    search of bit_length(m) steps, one gather each."""
    lo = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    hi = torch.full(u.shape, m, dtype=torch.int64, device=u.device)
    last = table.shape[-1] - 1
    for _ in range(int(m).bit_length()):
        mid = (lo + hi) // 2
        vals = _take(table, torch.clamp(mid, 0, last), row)
        go_right = (vals <= u) & (mid < m)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def _sample_from(function: Tensor, cdf: Tensor, integral: Tensor, u: Tensor,
                 dmin: float, dmax: float, row: Tensor | None = None
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """Shared 1D sampling on a single table, or on row ``row[k]`` of 2-D
    tables for element k of u.

    function: [n] or [nv, n], cdf: [n+1] or [nv, n+1], integral: scalar or
    [N] (already per element).  Returns (x, pdf, offset) with the
    reference's exact semantics."""
    n = function.shape[-1]
    offset = torch.clamp(_rowwise_upper_bound(cdf, row, u, n), 0, n - 1)
    c0 = _take(cdf, offset, row)
    c1 = _take(cdf, offset + 1, row)
    du = u - c0
    seg = c1 - c0
    du = torch.where(seg > 0, du / torch.where(seg > 0, seg, 1.0), du)
    f_off = _take(function, offset, row)
    pdf = torch.where(integral > 0,
                      f_off / torch.where(integral > 0, integral, 1.0), 0.0)
    x = _lerp((offset.to(u.dtype) + du) / n, dmin, dmax)
    return x, pdf, offset


def sample_continuous_1d(d: Distribution1D, u: Tensor
                         ) -> tuple[Tensor, Tensor, Tensor]:
    """→ (x, pdf, offset)."""
    return _sample_from(d.function, d.cdf, d.integral, u, d.dmin, d.dmax)


def sample_discrete_1d(d: Distribution1D, u: Tensor
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """→ (offset, pdf, u_remapped).  pdf is the DISCRETE probability
    f[offset] / (integral · n); the remap divides by the raw segment width
    with no zero guard, as the reference does (IEEE semantics kept)."""
    n = d.function.shape[-1]
    offset = torch.clamp(_rowwise_upper_bound(d.cdf, None, u, n), 0, n - 1)
    f_off = d.function[offset]
    pdf = torch.where(d.integral > 0,
                      f_off / torch.where(d.integral > 0, d.integral, 1.0) / n,
                      0.0)
    u_remapped = (u - d.cdf[offset]) / (d.cdf[offset + 1] - d.cdf[offset])
    return offset, pdf, u_remapped


def discrete_pdf_1d(d: Distribution1D, index: Tensor) -> Tensor:
    """f[i] / (integral · n), a raw division like the reference's."""
    n = d.function.shape[-1]
    return d.function[index] / (d.integral * n)


def invert_1d(d: Distribution1D, x: Tensor) -> tuple[Tensor, Tensor]:
    """→ (value, valid).  The reference returns nothing outside [min, max];
    ``valid`` carries that flag and ``value`` is the in-range result.
    Inputs are clamped first so the integer cast is always in range."""
    n = d.function.shape[-1]
    valid = (x >= d.dmin) & (x <= d.dmax)
    xc = torch.clamp(x, d.dmin, d.dmax)
    c = (xc - d.dmin) / (d.dmax - d.dmin) * n
    offset = torch.clamp(c.to(torch.int32), 0, n - 1).to(torch.int64)
    delta = c - offset.to(c.dtype)
    return _lerp(delta, d.cdf[offset], d.cdf[offset + 1]), valid


class Distribution2D(NamedTuple):
    conditional_f: Tensor     # [nv, nu]
    conditional_cdf: Tensor   # [nv, nu+1] effective CDFs per row
    conditional_int: Tensor   # [nv] unnormalized row integrals (= sum/nu)
    marginal: Distribution1D


def build_distribution_2d(func: Tensor) -> Distribution2D:
    """func: [nv, nu] — rows are conditionals, the marginal runs over the
    row integrals."""
    f = torch.abs(func)
    ccdf, cint = _effective_cdf(f, 0.0, 1.0)
    return Distribution2D(f, ccdf, cint, build_distribution_1d(cint))


def sample_continuous_2d(d: Distribution2D, u: Tensor) -> tuple[Tensor, Tensor]:
    """u: [N, 2] → ((s, t) [N, 2], pdf [N]): the marginal row first, then
    that row's conditional — two dependent binary searches."""
    d1, pdf1, v_idx = sample_continuous_1d(d.marginal, u[..., 1])
    d0, pdf0, _ = _sample_from(d.conditional_f, d.conditional_cdf,
                               d.conditional_int[v_idx], u[..., 0], 0.0, 1.0,
                               row=v_idx)
    return torch.stack([d0, d1], dim=-1), pdf0 * pdf1


def pdf_2d(d: Distribution2D, p: Tensor) -> Tensor:
    """pdf at continuous (s, t).  The integer casts clamp to the table (the
    reference's cast of a negative float is undefined; the JAX package
    chose the clamp)."""
    nv, nu = d.conditional_f.shape
    iu = torch.clamp((p[..., 0] * nu).to(torch.int32), 0, nu - 1).to(torch.int64)
    iv = torch.clamp((p[..., 1] * nv).to(torch.int32), 0, nv - 1).to(torch.int64)
    mint = d.marginal.integral
    return torch.where(mint > 0,
                       d.conditional_f[iv, iu] / torch.where(mint > 0, mint, 1.0),
                       0.0)
