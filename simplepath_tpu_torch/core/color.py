"""Color utilities: luminance.

Counterpart of ``simplepath_tpu/core/color.py`` (the sRGB transfer and the
HSV helper belong to later slices: image output beyond PFM and the
mandelbrot integrator).  Colors are ``[..., 3]``.
"""

from __future__ import annotations

from torch import Tensor

__all__ = ["relative_luminance"]

_LUMA_WEIGHTS = (0.2126, 0.7152, 0.0722)  # Rec.709


def relative_luminance(c: Tensor) -> Tensor:
    return (_LUMA_WEIGHTS[0] * c[..., 0]
            + _LUMA_WEIGHTS[1] * c[..., 1]
            + _LUMA_WEIGHTS[2] * c[..., 2])
