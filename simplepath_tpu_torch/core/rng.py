"""Stateless, counter-based random sampling, bit-exact with the JAX package.

Counterpart of ``simplepath_tpu/core/rng.py``.  Two samplers:

* the additive-recurrence R-sequence keyed by a pixel seed, used for pixel
  jitter — a closed form of ``(seed, n)``;
* threefry2x32 keyed by ``(pixel, sample, bounce, draw-site)`` for all
  integrator decisions.  The JAX package draws these with ``jax.random``
  (threefry2x32, ``jax_threefry_partitionable=True``); here the same hash is
  written in torch so that both packages produce the SAME uniforms from the
  same key — renders are then comparable per pixel, not just statistically.

Keys are ``[..., 2]`` int64 tensors whose entries hold 32-bit words (torch
has thin uint32 support, so words live in int64 and are masked after every
add/rotate).

What is reproduced of ``jax.random``:

* ``PRNGKey(seed)``      = ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``fold_in(key, i)``    = ``threefry(key, counter=(0, i))`` — both output
  words form the new key;
* ``uniform(key, shape)``: element ``j`` of the flattened shape hashes the
  64-bit counter ``j`` as (hi, lo) = ``(0, j)``; its 32 random bits are
  ``out_hi ^ out_lo``; the float is ``bitcast(bits >> 9 | 0x3F800000) - 1``.

Draw-site discipline: every distinct place in the integrator that consumes a
uniform gets a distinct static site id, so lanes never correlate.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

__all__ = ["r_sequence_alpha", "r_sequence", "pixel_jitter", "prng_key",
           "threefry2x32", "fold_in", "random_bits", "uniform", "site_key",
           "uniform_1d", "uniform_2d", "uniform_sites"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def r_sequence_alpha(dimension: int) -> list[float]:
    """Generalized-golden-ratio alphas: phi_d solves x^(d+1) = x + 1; alphas
    are frac(phi^-i)."""
    x = 2.0
    for _ in range(10):
        x = (1.0 + x) ** (1.0 / (dimension + 1.0))
    return [math.modf((1.0 / x) ** (i + 1.0))[0] for i in range(dimension)]


_ALPHA_1D = r_sequence_alpha(1)
_ALPHA_2D = r_sequence_alpha(2)


def r_sequence(seed: Tensor, n: Tensor, dimension: int = 2) -> Tensor:
    """R-sequence sample n for an integer (32-bit unsigned) seed.

    Matches the reference exactly, including the quirk that the seed is
    normalized by float32 max, which makes ``fseed`` ~1e-29 — effectively
    zero — so the sequence is the same for every seed.
    """
    alpha = torch.tensor(_ALPHA_2D if dimension == 2 else _ALPHA_1D,
                         dtype=torch.float32, device=seed.device)
    fseed = seed.to(torch.float32) / 3.4028235e38
    vals = fseed[..., None] + alpha * (n.to(torch.float32)[..., None] + 1.0)
    return torch.remainder(vals, 1.0)


def pixel_jitter(x: Tensor, y: Tensor, sample_index: Tensor) -> Tensor:
    """Per-pixel jitter: the ``sample_index``-th 2D R-sequence point of the
    stream seeded by ``x<<16|y`` (2D stream), in [0,1)²."""
    seed = ((x.to(torch.int64) << 16) & _M32) | (y.to(torch.int64) & _M32)
    seed = seed ^ 0x6184FAF4  # 2D stream seed
    return r_sequence(seed, sample_index, 2)


# ------------------------------------------------------------- threefry

def prng_key(seed: int, device=None) -> Tensor:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed split into two words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64,
                        device=device)


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: Tensor, k1: Tensor, x0: Tensor, x1: Tensor
                 ) -> tuple[Tensor, Tensor]:
    """The Threefry-2x32 block function (20 rounds) on int64-held 32-bit
    words; all arguments broadcast against each other."""
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
    """``jax.random.fold_in``: ``data`` (int or integer tensor broadcastable
    to ``key.shape[:-1]``) is taken modulo 2^32, as JAX's uint32 cast does."""
    if isinstance(data, Tensor):
        lo = data.to(torch.int64) & _M32
    else:
        lo = torch.tensor(int(data) & _M32, dtype=torch.int64,
                          device=key.device)
    hi = torch.zeros_like(lo)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], hi, lo)
    return torch.stack([o0, o1], dim=-1)


def random_bits(key: Tensor, count: int) -> Tensor:
    """32 random bits for each of ``count`` elements → ``[..., count]``
    int64 (partitionable layout: element j hashes counter (0, j))."""
    lo = torch.arange(count, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(lo),
                          lo)
    return b0 ^ b1


def _bits_to_unit_float(bits: Tensor) -> Tensor:
    """23 mantissa bits under exponent 0 → [1,2), minus 1."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(key: Tensor, shape: tuple = ()) -> Tensor:
    """``jax.random.uniform(key, shape)`` for ``shape`` () or (n,), batched
    over the key's leading dims."""
    if len(shape) > 1:
        raise NotImplementedError("uniform: shape must be () or (n,)")
    u = _bits_to_unit_float(random_bits(key, shape[0] if shape else 1))
    return u if shape else u[..., 0]


def site_key(key: Tensor, site: int) -> Tensor:
    """Derive the key for a static draw site."""
    return fold_in(key, site)


def uniform_1d(key: Tensor, site: int) -> Tensor:
    return uniform(site_key(key, site), ())


def uniform_2d(key: Tensor, site: int) -> Tensor:
    return uniform(site_key(key, site), (2,))


def uniform_sites(key: Tensor, sites) -> Tensor:
    """Two uniforms for each draw site in ``sites`` in ONE hash pass →
    ``[len(sites), ..., 2]``.  Row ``s`` equals ``uniform_2d(key, sites[s])``
    and its element 0 equals ``uniform_1d(key, sites[s])`` (a scalar draw
    hashes counter 0, the first of a 2-vector draw's two counters), so this
    is the same stream as per-site calls, in far fewer launches."""
    s = torch.tensor([int(x) & _M32 for x in sites], dtype=torch.int64,
                     device=key.device)
    s = s.reshape((-1,) + (1,) * (key.dim() - 1))
    return uniform(fold_in(key[None], s), (2,))
