"""Renders with the image-based environment light, per pixel against the
JAX package: the flagship integrator on ``g_ibl_rrnee`` and on
``g_combo_ibl`` (IBL plus a sphere light, glossy and clearcoat materials).
The golden IBL scenes concentrate radiance in a 3x2-texel sun, so the test
is per pixel under the same keys, not statistical: rtol 1e-3 / atol 1e-4 on
at least 98 % of 64 pixels at 2 spp and the means within 0.5 %, as
``test_torch_render.py``.  (``g_ibl``, direct lighting, is in
``test_torch_integrators.py``.)
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
from simplepath_tpu_torch.scene.types import ENV_IBL

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)


def jax_scene_arrays(js) -> dict:
    out = {}
    for g in dataclasses.fields(js):
        group = getattr(js, g.name)
        if g.name == "static" or group is None:
            continue
        for f in dataclasses.fields(group):
            out[f"{g.name}.{f.name}"] = np.asarray(getattr(group, f.name))
    return out


@pytest.mark.parametrize("name", ["g_ibl_rrnee", "g_combo_ibl"])
def test_ibl_render_matches_jax_per_pixel(name):
    js = J.load_scene(os.path.join(HERE, "scenes", name + ".sp"))
    assert js.static.env_kind == ENV_IBL
    ts = scene_from_numpy(dataclasses.asdict(js.static), jax_scene_arrays(js),
                          device="cpu")
    n = 64
    xs = (np.arange(n) * 3) % js.static.width
    ys = (np.arange(n) * 7) % js.static.height
    ref = np.asarray(J.render_rays(js, jnp.asarray(xs, jnp.int32),
                                   jnp.asarray(ys, jnp.int32), spp=2,
                                   key=jax.random.PRNGKey(0)))
    out = T.render_rays(ts, torch.from_numpy(xs), torch.from_numpy(ys), 2,
                        prng_key(0), device="cpu").numpy()
    assert np.isfinite(out).all() and out.mean() > 0
    close = np.isclose(out, ref, rtol=1e-3, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.98, f"{(~close).sum()} of {n} pixels differ"
    assert abs(out.mean() - ref.mean()) <= 0.005 * ref.mean()
