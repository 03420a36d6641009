"""Morton (Z-order) encode/decode, 32- and 64-bit.

Counterpart of ``simplepath_tpu/core/morton.py``: the reference's
bit-interleave ladders.  The 32-bit functions take and return int64 tensors
(torch has no uint32 arithmetic) holding the unsigned values; the 64-bit
ones are host-side numpy over uint64, as in the JAX package.  Not on the
render path (the film is a flat ray batch): tooling for tile orders and ray
sorting experiments.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

__all__ = ["morton_encode32", "morton_decode32", "morton_encode64",
           "morton_decode64"]


def _u32(a) -> Tensor:
    return torch.as_tensor(np.asarray(a, np.int64) if not torch.is_tensor(a)
                           else a).to(torch.int64) & 0xFFFFFFFF


def _part1by1_32(a: Tensor) -> Tensor:
    """Spread the low 16 bits over the even bits of a 32-bit code."""
    a = a & 0x0000FFFF
    a = (a | (a << 8)) & 0x00FF00FF
    a = (a | (a << 4)) & 0x0F0F0F0F
    a = (a | (a << 2)) & 0x33333333
    a = (a | (a << 1)) & 0x55555555
    return a


def _compact1by1_32(a: Tensor) -> Tensor:
    """Extract the even bits of a 32-bit code into the low 16."""
    a = a & 0x55555555
    a = (a | (a >> 1)) & 0x33333333
    a = (a | (a >> 2)) & 0x0F0F0F0F
    a = (a | (a >> 4)) & 0x00FF00FF
    a = (a | (a >> 8)) & 0x0000FFFF
    return a


def morton_encode32(x, y) -> Tensor:
    """Interleave two 16-bit coordinates into one 32-bit code (int64)."""
    return _part1by1_32(_u32(x)) | (_part1by1_32(_u32(y)) << 1)


def morton_decode32(d) -> tuple[Tensor, Tensor]:
    """Inverse of :func:`morton_encode32` → (x, y)."""
    d = _u32(d)
    return _compact1by1_32(d), _compact1by1_32(d >> 1)


def _part1by1_64(a):
    """Spread the low 32 bits over the even bits of a uint64."""
    a = np.asarray(a, np.uint64) & np.uint64(0x00000000FFFFFFFF)
    a = (a | (a << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    a = (a | (a << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    a = (a | (a << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    a = (a | (a << np.uint64(2))) & np.uint64(0x3333333333333333)
    a = (a | (a << np.uint64(1))) & np.uint64(0x5555555555555555)
    return a


def _compact1by1_64(a):
    """Extract the even bits of a uint64 into the low 32."""
    a = np.asarray(a, np.uint64) & np.uint64(0x5555555555555555)
    a = (a | (a >> np.uint64(1))) & np.uint64(0x3333333333333333)
    a = (a | (a >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    a = (a | (a >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    a = (a | (a >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    a = (a | (a >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return a


def morton_encode64(x, y) -> np.ndarray:
    """Interleave two 32-bit coordinates into one uint64 code (numpy)."""
    return _part1by1_64(x) | (_part1by1_64(y) << np.uint64(1))


def morton_decode64(d) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`morton_encode64` → (x, y)."""
    d = np.asarray(d, np.uint64)
    return _compact1by1_64(d), _compact1by1_64(d >> np.uint64(1))
