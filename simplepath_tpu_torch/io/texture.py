"""Texture sampling: nearest-neighbor and bilinear with remap policies.

Counterpart of ``simplepath_tpu/io/texture.py``: the five remap policies
(none/clamp/black/repeat/wrap) are string-selected functions, and the
samplers read ``[H, W, C]`` tensors at batched (s, t) coordinates, one
gather for all texel fetches.

Faithfulness notes (as in the JAX package):

* ``sample_bilinear`` reproduces the reference verbatim, including its
  quirk: the corner weights are ``u_upper - u_lower`` = ceil(u) - floor(u),
  which is 1 for every non-integer u (and 0 at integers) — so the
  "bilinear" filter returns the floor-corner texel almost everywhere.
  ``sample_bilinear_true`` is the textbook filter.
* ``black`` cannot return a sentinel color from a remap of a scalar
  coordinate; out-of-range coordinates get texel weight 0 through an
  explicit in-range mask.
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["remap", "sample_nearest_neighbor", "sample_bilinear",
           "sample_bilinear_true"]

_MAX_LT_ONE = 0.99999994  # largest float32 < 1


def remap(f: Tensor, policy: str) -> tuple[Tensor, Tensor]:
    """Apply a remap policy to coordinate(s) ``f`` → (coord, in_range_mask).

    ``none`` passes through; ``clamp`` clips to [0, 1); ``black`` zeroes
    contributions outside [0, 1); ``repeat`` is ``abs(fmod(f, 1))`` (mirrors
    negatives about 0, as in the reference); ``wrap`` is the true positive
    modulus."""
    f = torch.as_tensor(f, dtype=torch.float32)
    ok = torch.ones(f.shape, dtype=torch.bool, device=f.device)
    if policy == "none":
        out = f
    elif policy == "clamp":
        out = torch.clamp(f, 0.0, _MAX_LT_ONE)
    elif policy == "black":
        ok = (f >= 0.0) & (f < 1.0)
        out = torch.where(ok, f, 0.0)
    elif policy == "repeat":
        out = torch.abs(torch.fmod(f, 1.0))
    elif policy == "wrap":
        out = torch.remainder(1.0 + torch.fmod(f, 1.0), 1.0)
    else:
        raise ValueError(f"Unknown remap policy: {policy}")
    return out, ok


def _remap_st(s, t, remap_horizontal, remap_vertical):
    if remap_vertical is None:
        remap_vertical = remap_horizontal
    s, ok_s = remap(s, remap_horizontal)
    t, ok_t = remap(t, remap_vertical)
    return s, t, (ok_s & ok_t)[..., None]


def _index(x: Tensor, size: int) -> Tensor:
    """float → int32 index (truncating, as the JAX cast), clipped above."""
    return torch.clamp_max(x.to(torch.int32), size - 1).to(torch.int64)


def sample_nearest_neighbor(img: Tensor, s: Tensor, t: Tensor,
                            remap_horizontal: str = "none",
                            remap_vertical: str | None = None) -> Tensor:
    """Nearest texel: round(s·W), round(t·H) (half to even), clamped to the
    last texel.  img is [H, W, C]; s/t broadcast to any batch shape."""
    s, t, ok = _remap_st(s, t, remap_horizontal, remap_vertical)
    h, w = img.shape[0], img.shape[1]
    x = _index(torch.round(s * w), w)
    y = _index(torch.round(t * h), h)
    return torch.where(ok, img[y, x], 0.0)


def sample_bilinear(img: Tensor, s: Tensor, t: Tensor,
                    remap_horizontal: str = "none",
                    remap_vertical: str | None = None) -> Tensor:
    """The reference's 'bilinear', including its degenerate ceil-floor
    weights — see the module docstring."""
    s, t, ok = _remap_st(s, t, remap_horizontal, remap_vertical)
    h, w = img.shape[0], img.shape[1]
    u = s * w
    v = t * h
    u_lower, u_upper = torch.floor(u), torch.ceil(u)
    v_lower, v_upper = torch.floor(v), torch.ceil(v)
    u_bias = (u_upper - u_lower)[..., None]
    v_bias = (v_upper - v_lower)[..., None]
    x0, x1 = _index(u_lower, w), _index(u_upper, w)
    y0, y1 = _index(v_lower, h), _index(v_upper, h)
    c0, c1 = img[y0, x0], img[y0, x1]
    c2, c3 = img[y1, x0], img[y1, x1]
    out = v_bias * (u_bias * c0 + (1.0 - u_bias) * c1) \
        + (1.0 - v_bias) * (u_bias * c2 + (1.0 - u_bias) * c3)
    return torch.where(ok, out, 0.0)


def sample_bilinear_true(img: Tensor, s: Tensor, t: Tensor,
                         remap_horizontal: str = "none",
                         remap_vertical: str | None = None) -> Tensor:
    """Textbook bilinear filter (texel centers at half-integers)."""
    s, t, ok = _remap_st(s, t, remap_horizontal, remap_vertical)
    h, w = img.shape[0], img.shape[1]
    u = s * w - 0.5
    v = t * h - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    iu, iv = u0.to(torch.int32), v0.to(torch.int32)
    x0 = torch.clamp(iu, 0, w - 1).to(torch.int64)
    x1 = torch.clamp(iu + 1, 0, w - 1).to(torch.int64)
    y0 = torch.clamp(iv, 0, h - 1).to(torch.int64)
    y1 = torch.clamp(iv + 1, 0, h - 1).to(torch.int64)
    c0, c1 = img[y0, x0], img[y0, x1]
    c2, c3 = img[y1, x0], img[y1, x1]
    out = (1.0 - fv) * ((1.0 - fu) * c0 + fu * c1) \
        + fv * ((1.0 - fu) * c2 + fu * c3)
    return torch.where(ok, out, 0.0)
