"""Renders through the BVH forest (``parallel/geom_shard.py``) on one
process, held against the port's own replicated (one BVH) render, which
equals the JAX package's per pixel (test_torch_render.py), at the JAX
package's gates (tests/test_geom_shard.py):

* ``tests/scenes/g_blob.sp`` as a forest of 2 and of 4: max abs diff < 1e-4
  (:31);
* the lucy-class terrain reduced to ``io.meshgen.displaced_grid(160)``
  (50,562 triangles) with lucy_bench's camera, glossy clearcoat, plane and
  environment light, as a forest of 4: under 1 % of pixels off by more than
  1e-3 (closest-hit ties between different triangles of the regular grid
  break by visit order in one BVH and by shard order in the forest), the
  mean within 1 % (:70).
"""

import os

import numpy as np
import pytest
import torch

from simplepath_tpu_torch import build_scene, load_scene, parse_sp
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.io.meshgen import displaced_grid, write_ply
from simplepath_tpu_torch.parallel import (make_geom_mesh,
                                           render_image_geom_sharded,
                                           render_image_sharded,
                                           shard_scene_geometry)
from simplepath_tpu_torch.render import cuda_traverse as ct

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
BLOB = os.path.join(HERE, "scenes", "g_blob.sp")

TERRAIN = """version: 1
scene_parameters {
    output_file_name: "t.pfm"
    width: 40
    height: 28
    max_depth: 4
    russian_roulette_depth: 2
    integrator: iterative_rrnee
}
perspective_camera {
    origin: 0.0 900.0 -2300.0
    look_at: 0.0 0.0 0.0
    fov: 45
}
material_glossy {
    name: "base"
    diffuse: 0.7 0.7 0.7
    ior: 1.3
    roughness: 0.75
}
material_glossy {
    name: "plane"
    diffuse: 0.4 0.1 0.1
    ior: 1.8
    roughness: 0.01
}
material_clearcoat {
    name: "coat"
    base: "base"
    ior: 1.5
    color: 1.0 1.0 1.0
}
mesh {
    file: "terrain.ply"
    material: "coat"
}
plane {
    material: "plane"
    translate: 0.0 -400.0 0.0
}
environment_light {
    radiance: 1.0 1.0 1.3
}
"""


@pytest.fixture(scope="module")
def replicated():
    return render_image_sharded(load_scene(BLOB, device="cpu"), 2,
                                prng_key(11), device="cpu").numpy()


@pytest.mark.parametrize("d", [2, 4])
def test_forest_render_equals_replicated(d, replicated):
    key, ref = prng_key(11), replicated
    scene = shard_scene_geometry(load_scene(BLOB, use_bvh=False, device="cpu"),
                                 make_geom_mesh(d))
    assert scene.bvh.records.shape[0] == d
    ct.reset_launch_counts()
    out = render_image_geom_sharded(scene, 2, key, device="cpu").numpy()
    assert ct.launch_counts == {"closest": 0, "anyhit": 0}  # CPU: plain
    assert np.isfinite(out).all() and out.mean() > 0
    assert np.abs(out - ref).max() < 1e-4, np.abs(out - ref).max()


def test_lucy_class_terrain_forest(tmp_path):
    v, f = displaced_grid(160)
    write_ply(str(tmp_path / "terrain.ply"), v, f)
    key = prng_key(3)
    ps = parse_sp(TERRAIN, base_dir=str(tmp_path))
    ref = render_image_sharded(build_scene(ps, device="cpu"), 1, key,
                               device="cpu").numpy()
    scene = shard_scene_geometry(build_scene(ps, use_bvh=False, device="cpu"),
                                 make_geom_mesh(4))
    assert scene.static.num_triangles == 2 * 159 ** 2
    out = render_image_geom_sharded(scene, 1, key, device="cpu").numpy()
    assert np.isfinite(out).all() and out.max() > 0
    off = (np.abs(out - ref).max(axis=2) > 1e-3).mean()
    assert off < 0.01, f"{off:.2%} of pixels differ"
    assert abs(out.mean() - ref.mean()) < 0.01 * ref.mean()
