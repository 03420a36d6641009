"""The integrators with non-MIS next-event estimation — direct lighting
(with sphere lights, a constant and an image-based environment light) and
Whitted — and the Mandelbrot film test against the JAX package: a scene built by the JAX
package, carried over with ``convert.scene_from_numpy``, rendered by both
from the same key.

The RNG streams are bit-equal, so the comparison is per pixel: rtol 1e-3 /
atol 1e-4 on at least 98 % of 64 seeded pixels at 2 spp and the means within
0.5 % (as ``test_torch_render.py``).  Mandelbrot is chaotic in float32 (one
ulp of difference can change a pixel's escape count), so it is held on 256
pixels at the same per-pixel tolerance over at least 98 % of them.
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
from simplepath_tpu_torch.convert import scene_from_numpy
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.render import integrators as TI
from simplepath_tpu_torch.scene.types import INTEGRATORS

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)


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


def render_both(name, xs, ys, spp, seed):
    js = J.load_scene(scene_path(name))
    ts = scene_from_numpy(dataclasses.asdict(js.static), jax_scene_arrays(js),
                          device="cpu")
    ref = np.asarray(J.render_rays(js, jnp.asarray(xs, jnp.int32),
                                   jnp.asarray(ys, jnp.int32), spp=spp,
                                   key=jax.random.PRNGKey(seed)))
    out = T.render_rays(ts, torch.from_numpy(xs), torch.from_numpy(ys), spp,
                        prng_key(seed), device="cpu").numpy()
    return js, out, ref


@pytest.mark.parametrize("name", ["g_direct", "g_direct_env", "g_mesh_stl",
                                  "g_ibl", "g_whitted"])
def test_nee_integrators_match_jax_per_pixel(name):
    n = 64
    xs, ys = (np.arange(n) * 3) % 64, (np.arange(n) * 7) % 64
    js, out, ref = render_both(name, xs, ys, 2, 0)
    assert js.static.integrator in ("direct_lighting", "whitted")
    assert out.shape == ref.shape == (n, 3)
    assert np.isfinite(out).all() and out.mean() > 0
    close = np.isclose(out, ref, rtol=1e-3, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.98, f"{(~close).sum()} of {n} pixels differ"
    assert abs(out.mean() - ref.mean()) <= 0.005 * ref.mean()


def test_mandelbrot_matches_jax_on_most_pixels():
    rs = np.random.RandomState(4)
    xs, ys = rs.randint(0, 64, 256), rs.randint(0, 64, 256)
    js, out, ref = render_both("g_mandel", xs, ys, 1, 0)
    assert js.static.integrator == "mandelbrot"
    close = np.isclose(out, ref, rtol=1e-3, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.98, f"{(~close).sum()} of 256 pixels differ"
    assert out.max() > 0 and (out.sum(axis=1) == 0).any()   # inside and out


def test_mandelbrot_needs_film_coordinates():
    ts = T.load_scene(scene_path("g_mandel"), device="cpu")
    z = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="pcoords"):
        TI.integrate_mandelbrot(ts, z, z, torch.zeros((4, 2), dtype=torch.int64))


@pytest.mark.parametrize("name", INTEGRATORS)
def test_make_integrator_knows_every_name(name):
    fn = TI.make_integrator(name)
    assert fn is TI.INTEGRATOR_FNS[name] and callable(fn)
