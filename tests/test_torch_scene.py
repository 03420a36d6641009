"""The port's scene front door against the JAX package's: every array of
``load_scene`` equal, the BVH record table byte-identical (both packages run
the numpy builder below NATIVE_MIN_TRIS), and the conversion of a JAX-built
scene (``convert.scene_from_numpy``) equal to the port's own build."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import simplepath_tpu as J
import simplepath_tpu_torch as T
from simplepath_tpu.render.materials import build_rho_tables as j_build_rho
from simplepath_tpu_torch.convert import scene_from_numpy
from simplepath_tpu_torch.render.film import with_rho_table
from simplepath_tpu_torch.scene import bvh as tbvh

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
SCENES = ["g_blob", "g_mesh_ply", "g_glossy"]


def scene_path(name):
    return os.path.join(HERE, "scenes", name + ".sp")


def jax_scene_arrays(js) -> dict:
    """The JAX scene's arrays as numpy, keyed by "<group>.<field>"."""
    out = {}
    for g in dataclasses.fields(js):
        group = getattr(js, g.name)
        if g.name == "static" or group is None:
            continue
        for f in dataclasses.fields(group):
            out[f"{g.name}.{f.name}"] = np.asarray(getattr(group, f.name))
    return out


@pytest.fixture(scope="module", params=SCENES)
def pair(request):
    path = scene_path(request.param)
    return J.load_scene(path), T.load_scene(path, device="cpu")


def test_static_config_equal(pair):
    js, ts = pair
    assert dataclasses.asdict(js.static) == dataclasses.asdict(ts.static)


def test_every_array_equal(pair):
    js, ts = pair
    arrays = jax_scene_arrays(js)
    assert arrays
    for path, ref in arrays.items():
        group, field = path.split(".")
        out = getattr(getattr(ts, group), field).numpy()
        assert out.dtype == ref.dtype, path
        assert out.shape == ref.shape, path
        np.testing.assert_array_equal(out, ref, err_msg=path)


def test_bvh_records_byte_identical(pair):
    js, ts = pair
    if not js.static.has_bvh:
        assert ts.bvh is None
        return
    assert np.asarray(js.bvh.records).tobytes() == ts.bvh.records.numpy().tobytes()


def test_rho_table_built_once_matches_jax(pair):
    """The scene carries no table (render_rays builds it from the materials
    on every call, as the JAX package does); the one built from its
    materials equals JAX's."""
    js, ts = pair
    assert ts.materials.rho_table is None
    ref = np.asarray(j_build_rho(js.materials))
    np.testing.assert_allclose(with_rho_table(ts).materials.rho_table.numpy(),
                               ref, rtol=1e-5, atol=1e-7)


def test_converted_scene_equals_own_build(pair):
    js, ts = pair
    cs = scene_from_numpy(dataclasses.asdict(js.static), jax_scene_arrays(js),
                          device="cpu")
    assert cs.static == ts.static
    for g in dataclasses.fields(ts):
        a, b = getattr(ts, g.name), getattr(cs, g.name)
        if g.name == "static" or a is None:
            assert g.name == "static" or b is None
            continue
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            # the rho table is None in both: render_rays builds it
            assert (x is None and y is None) or torch.equal(x, y), \
                f"{g.name}.{f.name}"


def test_scene_to_moves_every_tensor():
    ts = with_rho_table(T.load_scene(scene_path("g_mesh_ply"), device="cpu"))
    moved = ts.to("cpu")
    assert moved.static is ts.static and moved.device == torch.device("cpu")
    assert torch.equal(moved.triangles.v0, ts.triangles.v0)
    assert torch.equal(moved.materials.rho_table, ts.materials.rho_table)


def _synthetic_mesh(n_side=110, seed=0):
    """A bumpy height-field of 2*(n_side-1)^2 (≥ 20k) triangles."""
    rs = np.random.RandomState(seed)
    g = np.linspace(-1, 1, n_side, dtype=np.float32)
    x, z = np.meshgrid(g, g, indexing="ij")
    y = (0.1 * rs.rand(n_side, n_side)).astype(np.float32)
    p = np.stack([x, y, z], -1)
    a, b, c, d = p[:-1, :-1], p[1:, :-1], p[:-1, 1:], p[1:, 1:]
    v0 = np.concatenate([a.reshape(-1, 3), b.reshape(-1, 3)])
    v1 = np.concatenate([b.reshape(-1, 3), d.reshape(-1, 3)])
    v2 = np.concatenate([c.reshape(-1, 3), c.reshape(-1, 3)])
    return v0, v1, v2


def _check_tree(nodes, order, lo, hi):
    """Every triangle in exactly one leaf, leaves within LEAF_SIZE, child
    boxes bound their triangles, the depth fits the traversal stack."""
    n = lo.shape[0]
    assert sorted(order.tolist()) == list(range(n))
    meta, box = nodes["child_meta"], nodes["child_box"]
    counts = meta[:, :, 2]
    leaf = counts > 0
    assert counts[leaf].sum() == n and counts.max() <= tbvh.LEAF_SIZE
    lo_o, hi_o = lo[order], hi[order]
    for node, w in zip(*np.nonzero(leaf)):
        first, cnt = meta[node, w, 1], meta[node, w, 2]
        assert (box[node, w, :3] <= lo_o[first:first + cnt].min(0) + 1e-6).all()
        assert (box[node, w, 3:] >= hi_o[first:first + cnt].max(0) - 1e-6).all()
    depth = tbvh.tree_depth(meta)
    assert depth * (tbvh.WIDTH - 1) + 1 <= tbvh._stack_limit()


def test_native_and_numpy_builders_give_valid_trees():
    from simplepath_tpu_torch import native
    v0, v1, v2 = _synthetic_mesh()
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    assert lo.shape[0] >= tbvh.NATIVE_MIN_TRIS
    nodes_np, order_np = tbvh.build_bvh_wide(lo, hi)
    _check_tree(nodes_np, order_np, lo, hi)
    if native.get_lib() is None:
        pytest.skip("no C++ compiler: the numpy builder is the only path")
    nodes_nat, order_nat = native.native_build_bvh_wide(
        lo, hi, tbvh.LEAF_SIZE, tbvh.WIDTH)
    _check_tree(nodes_nat, order_nat, lo, hi)
    # the port's library is built from its own source into its build dir
    assert os.path.dirname(native._SO_PATH) == native.BUILD_DIR
    assert "simplepath_tpu_torch" in native._SO_PATH
    # build_nodes dispatches to it above the threshold and says so
    tbvh.build_nodes(lo, hi)
    assert tbvh.LAST_BUILDER == "native"
    rec = tbvh.pack_records(nodes_nat, v0[order_nat], v1[order_nat], v2[order_nat])
    assert rec.shape[1] == tbvh.RECORD_WIDTH and rec.dtype == np.float32
