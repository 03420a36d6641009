"""Every other scene of the repo through both packages' ``load_scene``: the
twelve tests/scenes/g_*.sp that tests/test_torch_scene.py does not hold,
the headline scene and the bench (327,680 triangles, both packages' C++
builders).  Static config equal, every array equal in dtype, shape and
value, the BVH record table byte-identical.

One tolerance, on the image-based light's CDF fields only: the port
accumulates them with ``torch.cumsum``, which adds in another order than
XLA's ``cumsum`` (a chosen departure, in CHANGES.md), so they differ in
the last bits (at most 1.8e-7 on these scenes); atol 2e-7 there, exact
everywhere else.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import simplepath_tpu as J
import simplepath_tpu_torch as T

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_scene import SCENES, jax_scene_arrays  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G_SCENES = ["g_bf", "g_bfiter", "g_bfiterrr", "g_combo_ibl", "g_direct",
            "g_direct_env", "g_ibl", "g_ibl_rrnee", "g_mandel", "g_mesh_stl",
            "g_rrnee", "g_whitted"]
PATHS = ([os.path.join("tests", "scenes", n + ".sp") for n in G_SCENES]
         + [os.path.join("scenes", "headline_parity.sp"),
            os.path.join("scenes", "bunny_bench.sp")])
CDF_FIELDS = {"env.cdf_cond", "env.cdf_cond_int", "env.cdf_marg",
              "env.cdf_marg_f", "env.cdf_marg_int"}
CDF_ATOL = 2e-7
IBL_SCENES = {"g_combo_ibl", "g_ibl", "g_ibl_rrnee"}   # the only ones with the tolerance


def _name(path):
    return os.path.basename(path)[:-3]


def test_the_scenes_are_every_other_scene_of_the_repo():
    on_disk = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "tests", "scenes"))
                     if f.startswith("g_") and f.endswith(".sp"))
    assert sorted(G_SCENES + SCENES) == on_disk
    assert not set(G_SCENES) & set(SCENES)


@pytest.fixture(scope="module", params=PATHS, ids=[_name(p) for p in PATHS])
def pair(request):
    path = os.path.join(ROOT, request.param)
    return _name(path), J.load_scene(path), T.load_scene(path, device="cpu")


def test_static_config_equal(pair):
    _, js, ts = pair
    assert dataclasses.asdict(js.static) == dataclasses.asdict(ts.static)


def test_every_array_equal(pair):
    name, js, ts = pair
    arrays = jax_scene_arrays(js)
    assert arrays
    if name in IBL_SCENES:
        assert CDF_FIELDS <= set(arrays)
    for path, ref in arrays.items():
        group, field = path.split(".")
        out = getattr(getattr(ts, group), field).numpy()
        assert out.dtype == ref.dtype, path
        assert out.shape == ref.shape, path
        if name in IBL_SCENES and path in CDF_FIELDS:
            np.testing.assert_allclose(out, ref, rtol=0, atol=CDF_ATOL, err_msg=path)
        else:
            np.testing.assert_array_equal(out, ref, err_msg=path)


def test_bvh_records_byte_identical(pair):
    _, js, ts = pair
    if not js.static.has_bvh:
        assert ts.bvh is None
        return
    assert np.asarray(js.bvh.records).tobytes() == ts.bvh.records.numpy().tobytes()
