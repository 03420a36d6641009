"""The brute-force integrator family (multi-bounce, no next-event
estimation) against the JAX package, per pixel (rtol 1e-3 / atol 1e-4 on at
least 98 % of the pixels, means within 0.5 %, as ``test_torch_render.py``),
and the adaptive-RR integrator with its per-pixel statistics threaded over
20 samples.

Adaptive RR only acts once a pixel's depth bucket holds RR_MIN_SAMPLES (16)
observations, so a render below 17 spp compares plain
``brute_force_iterative``.  The test renders ``g_bfiterrr`` with the
integrator overridden and Russian roulette from depth 0 (so that pixels on
geometry fill bucket 0 on every sample) at 20 spp, and shows RR firing: some
bucket reaches 16, and the image differs from the same render with RR gated
off.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import simplepath_tpu as J
import simplepath_tpu_torch as T
from simplepath_tpu.core.rng import pixel_jitter as j_pixel_jitter
from simplepath_tpu.render import integrators as JI
from simplepath_tpu.render.camera import generate_ray as j_generate_ray
from simplepath_tpu.render.materials import build_rho_tables as j_build_rho
from simplepath_tpu_torch.convert import scene_from_numpy
from simplepath_tpu_torch.core.rng import fold_in, pixel_jitter, prng_key
from simplepath_tpu_torch.render import integrators as TI
from simplepath_tpu_torch.render.camera import generate_ray
from simplepath_tpu_torch.render.film import with_rho_table

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
DYNAMIC = "brute_force_iterative_dynamic_rr"


def scene_path(name):
    return os.path.join(HERE, "scenes", name + ".sp")


def jax_scene_arrays(js) -> dict:
    out = {}
    for g in dataclasses.fields(js):
        group = getattr(js, g.name)
        if g.name == "static" or group is None:
            continue
        for f in dataclasses.fields(group):
            out[f"{g.name}.{f.name}"] = np.asarray(getattr(group, f.name))
    return out


def convert(js):
    return scene_from_numpy(dataclasses.asdict(js.static), jax_scene_arrays(js),
                            device="cpu")


def assert_per_pixel(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all() and out.mean() > 0
    close = np.isclose(out, ref, rtol=1e-3, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.98, f"{(~close).sum()} of {len(out)} pixels differ"
    assert abs(out.mean() - ref.mean()) <= 0.005 * ref.mean()


@pytest.mark.parametrize("name, integrator", [
    ("g_bf", "brute_force"), ("g_bfiter", "brute_force_iterative"),
    ("g_bfiterrr", "brute_force_iterative_rr")])
def test_brute_force_family_matches_jax_per_pixel(name, integrator):
    js = J.load_scene(scene_path(name))
    assert js.static.integrator == integrator
    ts = convert(js)
    n = 64
    xs = (np.arange(n) * 3) % js.static.width
    ys = (np.arange(n) * 7) % js.static.height
    ref = np.asarray(J.render_rays(js, jnp.asarray(xs, jnp.int32),
                                   jnp.asarray(ys, jnp.int32), spp=2,
                                   key=jax.random.PRNGKey(0)))
    out = T.render_rays(ts, torch.from_numpy(xs), torch.from_numpy(ys), 2,
                        prng_key(0), device="cpu").numpy()
    assert_per_pixel(out, ref)


SPP = 20


@pytest.fixture(scope="module")
def dynamic_scenes():
    js = J.load_scene(scene_path("g_bfiterrr"), cli_integrator=DYNAMIC)
    js = dataclasses.replace(js, static=dataclasses.replace(
        js.static, russian_roulette_depth=0))
    rs = np.random.RandomState(0)
    xs, ys = rs.randint(0, 48, 16), rs.randint(24, 48, 16)
    # the integrators are called directly here: their caller builds the rho
    # table, as the JAX integrators' caller passes it
    return js, with_rho_table(convert(js)), xs, ys


def jax_dynamic_samples(js, xs, ys, seed):
    """The JAX integrator stepped sample by sample, its statistics threaded
    as its film threads them → (per-sample L [SPP, N, 3], (mean, count))."""
    rho = j_build_rho(js.materials)
    xs, ys = jnp.asarray(xs, jnp.int32), jnp.asarray(ys, jnp.int32)
    lin = ys.astype(jnp.uint32) * jnp.uint32(js.static.width) + xs.astype(jnp.uint32)
    pix_keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(lin)

    @jax.jit
    def one(s, stats):
        jit = j_pixel_jitter(xs, ys, jnp.full_like(xs, s))
        px = xs.astype(jnp.float32) + jit[:, 0]
        py = ys.astype(jnp.float32) + jit[:, 1]
        ro, rd = j_generate_ray(js.camera, px, py)
        keys = jax.vmap(lambda k: jax.random.fold_in(k, s))(pix_keys)
        return JI.integrate_brute_force_iterative_dynamic_rr(
            js, rho, ro, rd, keys, jnp.stack([px, py], -1), stats)

    nd = js.static.max_depth - js.static.russian_roulette_depth
    stats = (jnp.zeros((len(xs), nd), jnp.float32),
             jnp.zeros((len(xs), nd), jnp.int32))
    Ls = []
    for s in range(SPP):
        L, stats = one(s, stats)
        Ls.append(np.asarray(L))
    return np.stack(Ls), tuple(np.asarray(x) for x in stats)


def test_dynamic_rr_matches_jax_and_fires(dynamic_scenes, monkeypatch):
    js, ts, xs, ys = dynamic_scenes
    ref_L, (ref_mean, ref_count) = jax_dynamic_samples(js, xs, ys, seed=2)

    # the port's integrator stepped the same way: its stats equal JAX's
    txs, tys = torch.from_numpy(xs), torch.from_numpy(ys)
    nd = TI.dynamic_rr_buckets(ts)
    stats = (torch.zeros((16, nd)), torch.zeros((16, nd), dtype=torch.int32))
    pix_keys = fold_in(prng_key(2).expand(16, 2), tys * ts.static.width + txs)
    for s in range(SPP):
        jit = pixel_jitter(txs, tys, torch.full_like(txs, s))
        pc = torch.stack([txs + jit[:, 0], tys + jit[:, 1]], -1).to(torch.float32)
        ro, rd = generate_ray(ts.camera, pc[:, 0], pc[:, 1])
        L, stats = TI.integrate_brute_force_iterative_dynamic_rr(
            ts, ro, rd, fold_in(pix_keys, s), pcoords=pc, stats=stats)
        np.testing.assert_allclose(L.numpy(), ref_L[s], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(stats[1].numpy(), ref_count)
    np.testing.assert_allclose(stats[0].numpy(), ref_mean, rtol=1e-4, atol=1e-6)
    assert ref_count.max() >= TI.RR_MIN_SAMPLES            # RR could fire

    # the film threads the same statistics: its mean equals the JAX samples'
    film = T.render_rays(ts, txs, tys, SPP, prng_key(2), device="cpu")
    assert_per_pixel(film.numpy(), ref_L.mean(axis=0))

    # and RR did fire: gated off, the same render differs
    monkeypatch.setattr(TI, "RR_MIN_SAMPLES", 10 ** 9)
    gated = T.render_rays(ts, txs, tys, SPP, prng_key(2), device="cpu")
    assert int((film != gated).any(dim=1).sum()) >= 4


def test_dynamic_rr_without_stats_is_one_plain_sample(dynamic_scenes):
    """With no statistics RR never fires: the same sample as
    brute_force_iterative except for the signed cosine, which only flips
    the sign of a throughput term on back-facing bounces."""
    _, ts, xs, ys = dynamic_scenes
    txs, tys = torch.from_numpy(xs).float() + 0.5, torch.from_numpy(ys).float() + 0.5
    ro, rd = generate_ray(ts.camera, txs, tys)
    keys = fold_in(prng_key(1).expand(16, 2), torch.arange(16))
    L = TI.integrate_brute_force_iterative_dynamic_rr(ts, ro, rd, keys)
    nd = TI.dynamic_rr_buckets(ts)
    L2, (mean, count) = TI.integrate_brute_force_iterative_dynamic_rr(
        ts, ro, rd, keys, stats=(torch.zeros((16, nd)),
                                 torch.zeros((16, nd), dtype=torch.int32)))
    assert torch.equal(L, L2)
    assert int(count.max()) >= 1 and float(mean.max()) > 0
