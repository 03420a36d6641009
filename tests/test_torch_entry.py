"""The port's one-device entry point (``simplepath_tpu_torch/entry.py``)
against the JAX package's ``__graft_entry__.py``:

* the port keeps its own copy of the tiny scene, equal to the JAX one;
* ``entry(device="cpu")``'s frame — the flagship at 1 spp over the 32x32
  frame, spheres, a plane and an 80-face icosphere — against the JAX
  ``entry()``'s ``fn`` on the same scene and key, per pixel at
  test_torch_render.py's tolerance (rtol 1e-3 / atol 1e-4 on >= 98 % of
  pixels, the mean within 0.5 %): through the port's own scene, and through
  the JAX scene carried over with ``convert.scene_from_numpy``.
"""

import dataclasses

import jax
import numpy as np
import torch

import __graft_entry__ as G
from simplepath_tpu_torch import entry as E
from simplepath_tpu_torch.convert import scene_from_numpy

torch.set_num_threads(1)


def jax_scene_arrays(js) -> dict:
    out = {}
    for g in dataclasses.fields(js):
        group = getattr(js, g.name)
        if g.name == "static" or group is None:
            continue
        for f in dataclasses.fields(group):
            out[f"{g.name}.{f.name}"] = np.asarray(getattr(group, f.name))
    return out


def test_tiny_scene_is_the_jax_entry_scene():
    assert E._TINY_SCENE == G._TINY_SCENE


def test_entry_frame_matches_the_jax_entry_per_pixel():
    fn_j, args_j = G.entry()
    ref = np.asarray(jax.jit(fn_j)(*args_j))
    js = args_j[0]
    fn, (scene, xs, ys, key) = E.entry(device="cpu")
    assert scene.static.num_triangles == js.static.num_triangles == 80
    assert scene.static.has_bvh and js.static.has_bvh
    carried = scene_from_numpy(dataclasses.asdict(js.static),
                               jax_scene_arrays(js), device="cpu")
    for name, s in (("own scene", scene), ("carried scene", carried)):
        out = fn(s, xs, ys, key).numpy()
        assert out.shape == ref.shape == (32 * 32, 3)
        assert np.isfinite(out).all() and out.mean() > 0
        close = np.isclose(out, ref, rtol=1e-3, atol=1e-4).all(axis=1)
        assert close.mean() >= 0.98, \
            f"{name}: {(~close).sum()} of 1024 pixels differ"
        assert abs(out.mean() - ref.mean()) <= 0.005 * ref.mean(), name
