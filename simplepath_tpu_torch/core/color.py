"""Color utilities: luminance, sRGB encode, HSV→RGB.

Counterpart of ``simplepath_tpu/core/color.py``.  Colors are ``[..., 3]``.
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["relative_luminance", "rgb_to_srgb", "hsv_to_rgb"]

_LUMA_WEIGHTS = (0.2126, 0.7152, 0.0722)  # Rec.709


def relative_luminance(c: Tensor) -> Tensor:
    return (_LUMA_WEIGHTS[0] * c[..., 0]
            + _LUMA_WEIGHTS[1] * c[..., 1]
            + _LUMA_WEIGHTS[2] * c[..., 2])


def rgb_to_srgb(c: Tensor) -> Tensor:
    """Linear → sRGB transfer: linear below the 0.0031308 knee, the 1/2.4
    power above it (on a floored value, so the unused branch stays finite)."""
    return torch.where(c <= 0.0031308,
                       12.92 * c,
                       1.055 * torch.pow(torch.clamp_min(c, 1e-12), 1.0 / 2.4) - 0.055)


def hsv_to_rgb(h: Tensor, s: Tensor, v: Tensor) -> Tensor:
    """HSV → RGB (the reference's active branch), h, s, v in [0, 1].

    Reference quirk, kept: the offset ``m = v - c`` is computed but never
    added, so the result is the raw (c, x, 0) permutation of the sector."""
    c = v * s
    hprime = torch.floor(h * 6.0)
    x = c * (1.0 - torch.abs(torch.remainder(hprime, 2.0) - 1.0))
    zero = torch.zeros_like(c)
    cases = torch.stack([
        torch.stack([c, x, zero], dim=-1),
        torch.stack([x, c, zero], dim=-1),
        torch.stack([zero, c, x], dim=-1),
        torch.stack([zero, x, c], dim=-1),
        torch.stack([x, zero, c], dim=-1),
        torch.stack([c, zero, x], dim=-1),
    ])                                                   # [6, ..., 3]
    idx = torch.remainder(hprime.to(torch.int64), 6)
    return torch.gather(cases, 0, idx[None, ..., None].expand(1, *c.shape, 3))[0]
