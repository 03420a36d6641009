"""The lucy-class stress scene's path, at a small size on the CPU: the
scene's own text (scenes/lucy_bench.sp) with its film cut to 27x40 (its
aspect at 1/50) over a displaced_grid(41) terrain (3,200 triangles) written
as terrain_28m.ply, rendered by both packages from the same key per pixel
(test_torch_render.py's tolerance) with 512-pixel chunks, so that the last
chunk is padded; the statistics the lucy tools print against the JAX
tools' formulas; the mesh tool's grid rule and bytes; and chip_smoke.py's
ray sets, which the lucy phase builds from lucy's scene, unchanged on the
bench.  One JAX render compile.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import simplepath_tpu as J
import simplepath_tpu_torch as T
from simplepath_tpu.io import meshgen as jax_meshgen
from simplepath_tpu.parallel.mesh import make_ray_mesh as jax_ray_mesh
from simplepath_tpu.parallel.mesh import render_image_sharded as jax_render
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.io.meshgen import (displaced_grid, grid_side,
                                             grid_triangles, write_ply,
                                             write_terrain)
from simplepath_tpu_torch.parallel.geom_shard import (make_geom_mesh,
                                                      shard_scene_geometry)
from simplepath_tpu_torch.parallel.mesh import render_image_sharded
from simplepath_tpu_torch.scene import bvh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
import torch_lucy_geom_bench as geom_tool  # noqa: E402

torch.set_num_threads(1)

LUCY = os.path.join(ROOT, "scenes", "lucy_bench.sp")
GRID = 41                       # 2 * 40^2 = 3,200 triangles
FILM = (27, 40)                 # 1350x2000 at 1/50
CHUNK = 512                     # 1,080 pixels: three chunks, the last padded


def small_lucy_text() -> str:
    with open(LUCY) as f:
        text = f.read()
    return (text.replace("width: 1350", f"width: {FILM[0]}")
            .replace("height: 2000", f"height: {FILM[1]}"))


@pytest.fixture(scope="module")
def lucy_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("lucy")
    write_ply(str(out / cs.LUCY_MESH), *displaced_grid(GRID))
    return str(out)


@pytest.fixture(scope="module")
def scenes(lucy_dir):
    text = small_lucy_text()
    js = J.build_scene(J.parse_sp(text, base_dir=lucy_dir))
    ts = T.build_scene(T.parse_sp(text, base_dir=lucy_dir), device="cpu")
    return js, ts


def test_scene_is_lucy_cut_in_film_and_triangles(scenes):
    js, ts = scenes
    st = ts.static
    assert (st.width, st.height) == FILM
    assert st.num_triangles == js.static.num_triangles == 2 * (GRID - 1) ** 2
    assert (st.max_depth, st.integrator) == (10, "iterative_rrnee")
    assert np.asarray(js.bvh.records).tobytes() == ts.bvh.records.numpy().tobytes()


def test_padded_chunks_match_jax_per_pixel(scenes):
    """render_image_sharded in 512-pixel chunks (the last one padded with
    pixel (0, 0)) against the JAX package's on one device, same chunk and
    key: rtol 1e-3 / atol 1e-4 on at least 98 % of the pixels, means within
    0.5 % (test_torch_render.py)."""
    js, ts = scenes
    n = FILM[0] * FILM[1]
    assert n % CHUNK and n > CHUNK
    ref = np.asarray(jax_render(js, 1, jax.random.PRNGKey(0),
                                mesh=jax_ray_mesh(jax.devices()[:1]),
                                chunk_rays=CHUNK))
    out = render_image_sharded(ts, 1, prng_key(0), chunk_rays=CHUNK,
                               device="cpu").numpy()
    assert out.shape == ref.shape == (FILM[1], FILM[0], 3)
    assert np.isfinite(out).all() and out.mean() > 0
    close = np.isclose(out, ref, rtol=1e-3, atol=1e-4).all(axis=2)
    assert close.mean() >= 0.98, f"{(~close).sum()} of {n} pixels differ"
    assert abs(out.mean() - ref.mean()) <= 0.005 * ref.mean()


def test_table_stats_equal_the_jax_tools_formula(scenes):
    """bvh.table_stats (what tools/torch_lucy_bench.py prints) against
    tools/lucy_bench.py:36-41 on the JAX package's records of the scene."""
    js, ts = scenes
    rec = np.asarray(js.bvh.records)
    M = rec.shape[0]
    counts = np.asarray(rec[:, 110])
    leaf_rows = counts > 0
    stats = bvh.table_stats(ts.bvh.records.numpy())
    assert stats["rows"] == M
    assert stats["bytes"] == M * 512
    assert stats["leaves"] == int(leaf_rows.sum())
    assert stats["mean_leaf_occupancy"] == float(counts[leaf_rows].mean())
    assert stats["used_rows"] == int((rec != 0).any(axis=1).sum()) == M


def test_table_depth_is_tree_depth(scenes):
    """The depth read off the table equals bvh.tree_depth of the nodes the
    table was packed from (the mesh has no transform: its triangles are the
    PLY's), and the stack slots follow pack_records' rule."""
    _, ts = scenes
    v, f = displaced_grid(GRID)
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    nodes, order = bvh.build_nodes(lo, hi)
    packed = bvh.pack_records(nodes, v0[order], v1[order], v2[order])
    assert packed.tobytes() == ts.bvh.records.numpy().tobytes()
    stats = bvh.table_stats(packed)
    depth = bvh.tree_depth(nodes["child_meta"])
    assert stats["depth"] == depth >= 2
    assert stats["stack_needed"] == depth * (bvh.WIDTH - 1) + 1
    assert stats["internal_rows"] == nodes["child_box"].shape[0]


def test_forest_stats_equal_the_jax_tools_formula(scenes):
    """The forest tool's per-shard statistics against
    tools/lucy_geom_bench.py:66-71 applied to the port's forest records."""
    _, ts = scenes
    forest = shard_scene_geometry(ts, make_geom_mesh(4))
    rec = forest.bvh.records.numpy()
    D = rec.shape[0]
    occs, rows = [], []
    for d in range(D):
        counts = rec[d, :, 110]
        leaf = counts > 0
        rows.append(int((rec[d] != 0).any(axis=1).sum()))
        occs.append(float(counts[leaf].mean()))
    stats = geom_tool.shard_stats(forest.bvh.records)
    assert stats["padded_rows"] == rec.shape[1]
    assert stats["used_rows"] == rows
    assert stats["mean_leaf_occupancy"] == occs


def test_grid_rule_at_the_default():
    """tools/make_lucy_scene.py's rule, ``int((tris / 2.0) ** 0.5) + 2``:
    14,440,000 is a perfect square, so the default rounds up to a 3802
    grid, 28,895,202 triangles (displaced_grid(3801) would give exactly
    28,880,000)."""
    tris = cs.LUCY_TRIS
    assert tris == 28_880_000
    assert grid_side(tris) == int((tris / 2.0) ** 0.5) + 2 == 3802
    assert grid_triangles(tris) == 28_895_202 >= tris
    assert 2 * (3801 - 1) ** 2 == tris


def test_mesh_bytes_equal_the_jax_packages(tmp_path):
    n = grid_side(20_000)
    assert n == int((20_000 / 2.0) ** 0.5) + 2 == 102
    path = str(tmp_path / "port" / cs.LUCY_MESH)
    assert write_terrain(path, 20_000, log=lambda _: None) == path
    jax_path = str(tmp_path / "jax.ply")
    jax_meshgen.write_ply(jax_path, *jax_meshgen.displaced_grid(n))
    with open(path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()


def test_scene_text_check(tmp_path):
    assert cs.check_scene_text(LUCY) == open(LUCY).read()
    cut = tmp_path / "cut.sp"
    cut.write_text(small_lucy_text())
    with pytest.raises(ValueError, match="width: 1350"):
        cs.check_scene_text(str(cut))


def test_middle_run_is_the_benchs_rows_480_to_543():
    assert cs.middle_run(1024, 1024) == (480 * 1024, 544 * 1024)
    start, stop = cs.middle_run(1350, 2000)
    assert stop - start == 65536 and start + stop == 1350 * 2000
    assert cs.middle_run(*FILM) == (0, FILM[0] * FILM[1])


@pytest.fixture(scope="module")
def bench():
    return T.load_scene(cs.SCENE, device="cpu")


def incoherent_rays_before_reach(scene, n: int = 65499, seed: int = 7):
    """chip_smoke.incoherent_rays as it was before it took ``reach``."""
    from simplepath_tpu_torch.render.traverse import scene_intersect_batch
    ro, rd, t_min, t_max = cs.primary_rays(scene)
    hit = scene_intersect_batch(scene, ro, rd, t_min, t_max)
    points = (ro + hit.t[:, None] * rd)[hit.valid].cpu().numpy()
    rs = np.random.RandomState(seed)
    origin = points[rs.randint(0, points.shape[0], n)].astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    direction = d / np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(n, 1e-3, np.float32)
    t_max = np.where(rs.rand(n) < 0.5, np.inf,
                     0.5 + 4.0 * rs.rand(n)).astype(np.float32)
    t_max[rs.rand(n) < 0.1] = -np.inf
    return origin, direction, t_min, t_max


def test_benchs_incoherent_rays_are_unchanged(bench):
    before = incoherent_rays_before_reach(bench)
    now = cs.incoherent_rays(bench)
    for a, b in zip(now, before):
        assert a.numpy().tobytes() == b.tobytes()


def test_reach_scales_the_finite_rays_only(scenes):
    """On the small lucy scene: ``reach`` multiplies each finite t_max (in
    float64, then rounded) and changes nothing else."""
    _, ts = scenes
    one = [a.numpy() for a in cs.incoherent_rays(ts, n=4099)]
    far = [a.numpy() for a in cs.incoherent_rays(ts, n=4099, reach=8.0)]
    for a, b in zip(one[:3], far[:3]):
        assert a.tobytes() == b.tobytes()
    finite = np.isfinite(one[3])
    assert 0 < finite.sum() < finite.size
    assert np.array_equal(np.isfinite(far[3]), finite)
    np.testing.assert_array_equal(far[3][~finite], one[3][~finite])
    np.testing.assert_array_equal(
        far[3][finite], (one[3][finite].astype(np.float64) * 8.0).astype(np.float32))


def test_lucy_reach_is_its_size_over_the_benchs(scenes, bench):
    _, ts = scenes
    reach = cs.reach_of(ts, bench)
    assert reach == cs.scene_extent(ts) / cs.scene_extent(bench)
    assert cs.reach_of(bench, bench) == 1.0
    assert 100 < reach < 10_000         # +-1000 units against a blob of a few


def test_bounce_rays_stand_in_for_a_bounce_never_reached(scenes, monkeypatch):
    """A chunk whose paths end before bounce 5 (depth cut to 4 here) fails
    the bench's ray sets, and with ``stand_in`` gives bounce 3, the deepest
    reached, named so."""
    import dataclasses
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    _, ts = scenes
    shallow = dataclasses.replace(ts, static=dataclasses.replace(
        ts.static, max_depth=4))
    with pytest.raises(AssertionError, match="were not all reached"):
        cs.bounce_rays(shallow)
    sets, calls = cs.bounce_rays(shallow, stand_in=True)
    assert calls == {"closest": 4, "anyhit": 4}
    for kernel in ("closest", "anyhit"):
        assert list(sets[kernel]) == ["bounce0", "bounce2", "bounce3_deepest"]
    # a pixel's closest-hit ray; with an environment light, the shadow rays
    # of both NEE strategies (the light's and the material's sample) in one
    # any-hit launch
    assert sets["closest"]["bounce0"][0].shape == (FILM[0] * FILM[1], 3)
    assert sets["anyhit"]["bounce0"][0].shape == (2 * FILM[0] * FILM[1], 3)


def test_the_topology_part_runs_at_w16_through_the_plain_versions(
        scenes, lucy_dir, tmp_path):
    """tools/torch_lucy_bench.py --topologies w16_k12 on the CPU over the
    cut lucy scene, in a subprocess (the topology is read at import): both
    wrappers held to their plain versions on 65,536 primary rays, the rows
    they visit and their bound counted, no device time; the 1-spp frame
    within 1e-4 of the default topology's, rendered here."""
    import json
    import subprocess

    scene = os.path.join(lucy_dir, "lucy_bench.sp")
    with open(scene, "w") as f:
        f.write(small_lucy_text())
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "SIMPLEPATH_BVH_WIDTH",
                        "SIMPLEPATH_BVH_LEAF")}
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_lucy_bench.py"),
         "--topologies", "w16_k12", "--platform", "cpu", "--scene", scene,
         "--out", str(tmp_path)], env=dict(env, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(proc.stdout.splitlines()[0])
    assert (res["topology"], res["width"], res["leaf_size"]) == ("w16_k12",
                                                                 16, 12)
    assert res["triangles"] == 2 * (GRID - 1) ** 2 and res["ok"]
    assert [k["kernel"] for k in res["kernels"]] == ["closest", "anyhit"]
    for k in res["kernels"]:
        assert k["n"] == 65536 and k["max_abs_err"] == 0.0
        assert not any(v for key, v in k.items() if key.endswith("_mismatches"))
        assert k["rows_visited"] > 0 and k["bound_ms"] > 0
        assert k["kernel_ms"] is None and k["plain_ms"] is None
    from simplepath_tpu_torch.io.pfm import read_pfm
    img = read_pfm(str(tmp_path / "w16_k12.pfm"))
    default = render_image_sharded(scenes[1], 1, prng_key(0),
                                   device="cpu").numpy()
    assert img.shape == default.shape and np.isfinite(img).all()
    assert np.abs(img - default).max() <= 1e-4


def test_the_topology_parts_trace_and_brute_force(scenes):
    """tools/torch_lucy_bench.py's tools for a frame that departs from the
    default topology's: a traced pixel's radiance is the frame's, bit for
    bit; the first call whose answer differs between two traces is found,
    with the ray both asked; every triangle against a ray in float64 finds
    the hit the traversal found."""
    import copy

    import torch_lucy_bench as lb

    ts = scenes[1]
    frame = render_image_sharded(ts, 1, prng_key(0), device="cpu").numpy()
    xs, ys = torch.tensor([3, 13, 20, 26]), torch.tensor([5, 20, 30, 39])
    radiance, calls = lb.trace_pixels(ts, xs, ys)
    assert radiance.tobytes() == frame[ys, xs].tobytes()
    kinds = [k for k, _ in calls]
    assert {"closest", "anyhit"} <= set(kinds) and kinds[0] == "closest"
    first = calls[0][1]
    assert first["t"].shape == (4,) and first["key"].shape == (4, 9)

    a = (radiance, kinds, [c for _, c in calls])
    b = copy.deepcopy(a)
    b[2][0]["t"][1] += 1.0
    traces = {"w8_k12": a, "other": b}
    assert lb.first_divergence(traces, 0) is None
    d = lb.first_divergence(traces, 1)
    assert (d["call"], d["kind"], d["bounce"], d["rays_equal"]) == \
        (0, "closest", 0, True)
    assert d["answers"]["other"]["t"] == d["answers"]["w8_k12"]["t"] + 1.0

    nearest = lb.brute_force(ts, {k: first[k] for k in ("ro", "rd", "t_min",
                                                        "t_max")})
    hits = np.isfinite(first["t"])
    assert hits.any()
    for i in range(4):
        if not hits[i]:
            assert nearest[i] == []
            continue
        t, key = nearest[i][0]
        assert abs(t - first["t"][i]) <= 1e-4 * first["t"][i]
        assert key == first["key"][i].tolist()
