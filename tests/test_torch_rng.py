"""The port's counter-based RNG (simplepath_tpu_torch.core.rng) against
``jax.random`` and the JAX package's R-sequence: BIT-equal, which is what
makes every later render comparison per pixel instead of statistical."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simplepath_tpu.core import rng as J
from simplepath_tpu_torch.core import rng as R

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)


def _words(seed, shape):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(words):
    return torch.from_numpy(words.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 + 7, 2 ** 40 + 3])
def test_prng_key_matches_jax(seed):
    if seed >= 2 ** 32:
        # without x64 JAX takes the seed modulo 2^32; the port keeps the
        # full 64 bits — compare the low word only
        assert int(R.prng_key(seed)[1]) == seed & 0xFFFFFFFF
        return
    np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(seed)),
                                  R.prng_key(seed).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_in_bits_equal(seed):
    keys = _words(seed, (257, 2))
    data = _words(seed + 100, (257,))
    data[:4] = [0, 1, 2 ** 32 - 1, 2 ** 31]
    ref = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(data))
    out = R.fold_in(_t(keys), _t(data))
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64), out.numpy())


@pytest.mark.parametrize("site", [0, 3, 16, 27, 2 ** 31 - 1])
def test_fold_in_python_int_site(site):
    keys = _words(5, (33, 2))
    ref = jax.vmap(lambda k: jax.random.fold_in(k, site))(jnp.asarray(keys))
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  R.fold_in(_t(keys), site).numpy())


@pytest.mark.parametrize("shape", [(), (2,)])
def test_uniform_bits_equal(shape):
    keys = _words(9, (513, 2))
    ref = jax.vmap(lambda k: jax.random.uniform(k, shape))(jnp.asarray(keys))
    out = R.uniform(_t(keys), shape)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    assert float(out.min()) >= 0.0 and float(out.max()) < 1.0


@pytest.mark.parametrize("site", [0, 1, 2, 3, 16, 24])
def test_site_draws_equal_jax_package(site):
    keys = _words(11, (129, 2))
    jk = jnp.asarray(keys)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: J.uniform_1d(k, site))(jk)),
        R.uniform_1d(_t(keys), site).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: J.uniform_2d(k, site))(jk)),
        R.uniform_2d(_t(keys), site).numpy())


def test_uniform_sites_is_the_per_site_stream():
    keys = _t(_words(13, (65, 2)))
    sites = (0, 1, 2, 3, 16, 17, 18, 19)
    u = R.uniform_sites(keys, sites)
    assert u.shape == (len(sites), 65, 2)
    for i, s in enumerate(sites):
        assert torch.equal(u[i], R.uniform_2d(keys, s))
        assert torch.equal(u[i, :, 0], R.uniform_1d(keys, s))


def test_render_key_chain_equal():
    """key → fold_in(pixel) → fold_in(sample) → fold_in(depth) → site draw,
    the chain film.py and the integrator walk."""
    rs = np.random.RandomState(3)
    lin = rs.randint(0, 1024 * 1024, 64).astype(np.uint32)
    key = jax.random.PRNGKey(42)

    def chain(i):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(key, i), 5), 2)
        return J.uniform_2d(k, 16)
    ref = jax.vmap(chain)(jnp.asarray(lin))
    tk = R.fold_in(R.prng_key(42).expand(64, 2), _t(lin))
    out = R.uniform_2d(R.fold_in(R.fold_in(tk, 5), 2), 16)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


@pytest.mark.parametrize("dimension", [1, 2])
def test_r_sequence_equal(dimension):
    rs = np.random.RandomState(4)
    seed = _words(4, (200,))
    n = rs.randint(0, 4096, 200).astype(np.int32)
    ref = J.r_sequence(jnp.asarray(seed), jnp.asarray(n), dimension)
    out = R.r_sequence(_t(seed), torch.from_numpy(n), dimension)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    assert R.r_sequence_alpha(dimension) == J.r_sequence_alpha(dimension)


def test_pixel_jitter_equal():
    rs = np.random.RandomState(6)
    x = rs.randint(0, 2048, 500).astype(np.int32)
    y = rs.randint(0, 2048, 500).astype(np.int32)
    s = rs.randint(0, 256, 500).astype(np.int32)
    ref = J.pixel_jitter(jnp.asarray(x), jnp.asarray(y), jnp.asarray(s))
    out = R.pixel_jitter(torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(s))
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
