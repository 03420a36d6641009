"""The golden tier's port, on the CPU: chip_smoke.py's gate math against
the JAX side's (tests/test_golden_parity.py, tools/calibrate_floors.py,
tools/headline_calibrate.py, loaded by path) on seeded random images; every
gate failing on a golden scaled by 1.1; the golden phase's own
render-and-gate function on g_mandel, and the phase failing on a failed gate
or on a mesh golden that launched no kernel; the headline tool's checkpointed
passes resuming to the uninterrupted film; and tools/torch_make_goldens.py's
scene texts and assets byte-equal to tests/scenes/ and to the JAX tool's.
No JAX render compile: the JAX side contributes its numpy math and strings.
"""

import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
import torch_headline_calibrate as headline_tool  # noqa: E402
import torch_make_goldens as make_tool  # noqa: E402
from simplepath_tpu_torch.io.pfm import read_pfm  # noqa: E402

torch.set_num_threads(1)


def load_by_path(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_side():
    return {"parity": load_by_path("_jax_golden_parity",
                                   "tests/test_golden_parity.py"),
            "floors": load_by_path("_jax_calibrate_floors",
                                   "tools/calibrate_floors.py"),
            "headline": load_by_path("_jax_headline_calibrate",
                                     "tools/headline_calibrate.py"),
            "goldens": load_by_path("_jax_make_goldens", "tools/make_goldens.py")}


def image_pair(seed: int, shape=(48, 64, 3)) -> tuple:
    """A heavy-tailed 'reference' and a noisy estimate of it (a few
    fireflies each, so the firefly exclusion has work)."""
    rng = np.random.default_rng(seed)
    ref = rng.lognormal(-1.5, 1.0, shape).astype(np.float32)
    ours = (ref * rng.lognormal(0.0, 0.3, shape)).astype(np.float32)
    ours.reshape(-1)[rng.integers(0, ours.size, 5)] *= 200
    return ref, ours


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box3_and_rel_err_equal_the_golden_tests(jax_side, seed):
    jg = jax_side["parity"]
    ref, ours = image_pair(seed)
    np.testing.assert_allclose(cs.box3(ours), jg.box3(ours), rtol=1e-6)
    np.testing.assert_allclose(cs.rel_err(ref, ours), jg._rel_err(ref, ours),
                               rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blurred_gates_equal_test_golden(jax_side, seed):
    """blurred_gates' metrics against test_golden's lines, computed with
    its box3: the blurred images' error floored at 5 % of the UNblurred
    golden's mean."""
    jg = jax_side["parity"]
    ref, ours = image_pair(seed)
    mean_ref = float(ref.mean())
    bref, bours = jg.box3(ref), jg.box3(ours)
    scale = np.maximum(bref.mean(axis=2), 0.05 * max(mean_ref, 1e-3))
    p90 = float(np.percentile(np.abs(bref - bours).mean(axis=2) / scale, 90))
    gates = cs.blurred_gates(ref, ours, "iterative_rrnee")
    np.testing.assert_allclose(gates["blur_p90"][0], p90, rtol=1e-6)
    np.testing.assert_allclose(
        gates["rel_mean"][0], abs(float(ours.mean()) - mean_ref) / mean_ref,
        rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matched_metrics_equal_calibrate_floors(jax_side, seed):
    ref, ours = image_pair(seed)
    want = jax_side["floors"].floor_metrics(ref, ours)
    got = cs.matched_metrics(ref, ours)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_headline_metrics_equal_headline_calibrate(jax_side, seed):
    ref, ours = image_pair(seed)
    want = jax_side["headline"].metrics(ref, ours, "row")
    got = cs.headline_metrics(ref, ours, "row")
    assert got.keys() == want.keys()
    assert (got["label"], got["n_excluded"]) == (want["label"], want["n_excluded"])
    assert got["n_excluded"] > 0
    for k in want:
        if k not in ("label", "n_excluded"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def golden(name: str) -> np.ndarray:
    return read_pfm(os.path.join(cs.GOLDEN, name + ".pfm"))


def floor_of(name: str) -> dict:
    return cs.golden_json("matched_floors.json")[name]


def headline_floor() -> dict:
    return next(c for c in cs.golden_json("headline_cache/calibration.json")
                if c["label"].startswith("ours_vs_ours"))


def gates_of(tier: str, ref, ours) -> dict:
    if tier == "blurred":
        return cs.blurred_gates(ref, ours, "direct_lighting")
    if tier == "matched":
        return cs.matched_gates(ref, ours, floor_of("g_direct"))
    return cs.headline_gates(cs.headline_metrics(ref, ours, "k3"),
                             headline_floor())


@pytest.mark.parametrize("tier", ["blurred", "matched", "headline"])
def test_a_golden_scaled_by_1_1_fails_the_mean_gate_alone(tier):
    ref = golden("g_headline" if tier == "headline" else "g_direct")
    assert cs.failed_gates(gates_of(tier, ref, ref)) == []
    gates = gates_of(tier, ref, ref * np.float32(1.1))
    assert [k for k, (_, _, ok) in gates.items() if not ok] == ["rel_mean"]
    assert len(cs.failed_gates(gates)) == 1


@pytest.mark.parametrize("tier,metric", [("matched", "p90"),
                                         ("matched", "p99"),
                                         ("headline", "p50"),
                                         ("headline", "p99"),
                                         ("headline", "blur_p99")])
def test_the_error_percentile_gates_fail(tier, metric):
    """A golden whose pixels are 0, or 20x the golden's one time in 20
    (the mean kept in expectation), fails each error percentile."""
    ref = golden("g_headline" if tier == "headline" else "g_direct")
    rng = np.random.default_rng(3)
    fireflies = rng.choice([0.0, 20.0], (*ref.shape[:2], 1), p=[0.95, 0.05])
    gates = gates_of(tier, ref, ref * fireflies.astype(np.float32))
    assert not gates[metric][2], gates[metric]


def test_mandelbrot_gate_fails_off_by_a_shade():
    ref = golden("g_mandel")
    assert cs.blurred_gates(ref, ref, "mandelbrot")["close_share"][2]
    assert not cs.blurred_gates(ref, ref + np.float32(3e-3),
                                "mandelbrot")["close_share"][2]


def test_golden_plan_covers_every_golden_but_the_headline():
    plan = {name: (spp, floor) for name, spp, floor in cs.golden_plan()}
    manifest = cs.golden_json("manifest.json")
    assert len(plan) == 15 and "g_headline" not in plan
    floors = cs.golden_json("matched_floors.json")
    assert {n for n, (_, f) in plan.items() if f is not None} == set(floors)
    for name, (spp, floor) in plan.items():
        if floor is not None or name == "g_mandel":
            assert spp == manifest[name]["spp"]
        else:                       # the IBL scenes: test_golden's 128 spp
            assert "ibl" in name and spp == 128
    assert set(cs.MESH_GOLDENS) < set(plan)


def test_golden_scene_passes_g_mandel_on_the_cpu():
    res = cs.golden_scene("g_mandel", 1, None, device="cpu")
    assert res["failed"] == [], res
    assert res["gates"]["close_share"][0] > 0.99
    assert (res["spp"], res["integrator"]) == (1, "mandelbrot")
    assert res["launches"]["closest"] == res["launches"]["anyhit"] == 0


def test_phase_golden_fails_on_a_failed_gate(monkeypatch):
    """An impossible matched floor (p90, p99 under 0) fails the phase after
    the scene's line; a real one passes."""
    impossible = {"rel_mean": 1.0, "p90": 0.0, "p99": 0.0}
    monkeypatch.setattr(cs, "golden_plan",
                        lambda: [("g_mandel", 1, impossible)])
    with pytest.raises(AssertionError, match="golden gates failed"):
        cs.phase_golden(device="cpu")
    monkeypatch.setattr(cs, "golden_plan", lambda: [("g_mandel", 1, None)])
    assert cs.phase_golden(device="cpu") == {
        "golden": {"closest": 0, "anyhit": 0}}


def test_phase_golden_fails_on_a_mesh_golden_without_launches(monkeypatch):
    """On the CPU the wrappers run the plain versions and count nothing:
    exactly what the phase refuses for a mesh golden."""
    monkeypatch.setattr(cs, "golden_plan", lambda: [("g_mesh_stl", 1, None)])
    with pytest.raises(AssertionError, match="launches both kernels"):
        cs.phase_golden(device="cpu")


def test_headline_passes_resume_to_the_uninterrupted_film(tmp_path, monkeypatch):
    """The headline tool's passes on a small golden: a run cut after its
    first pass resumes from the checkpoint to the uninterrupted film bit for
    bit, which is the one-call render within float32 rounding."""
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel import mesh

    scene = sp.load_scene(os.path.join(cs.GOLDEN_SCENES, "g_direct.sp"),
                          device="cpu")
    whole, _ = headline_tool.render_full(scene, 4, 3, str(tmp_path / "a.npz"),
                                         step=2)
    real = mesh.render_image_sharded
    calls = []

    def dying(*a, **kw):
        calls.append(kw["spp_offset"])
        if len(calls) == 2:
            raise KeyboardInterrupt("cut after the first pass")
        return real(*a, **kw)

    ckpt = str(tmp_path / "b.npz")
    monkeypatch.setattr(mesh, "render_image_sharded", dying)
    with pytest.raises(KeyboardInterrupt):
        headline_tool.render_full(scene, 4, 3, ckpt, step=2)
    monkeypatch.setattr(mesh, "render_image_sharded", real)
    assert int(np.load(ckpt)["s0"]) == 2
    resumed, seconds = headline_tool.render_full(scene, 4, 3, ckpt, step=2)
    assert len(seconds) == 1
    assert resumed.tobytes() == whole.tobytes()
    once = real(scene, 4, prng_key(3), device="cpu").numpy()
    np.testing.assert_allclose(whole, once, rtol=1e-5, atol=1e-7)


def test_make_goldens_check_is_byte_equal(tmp_path, jax_side, monkeypatch):
    """--check passes: every file written equals tests/scenes/; each scene
    text is the JAX tool's string and each asset the JAX tool's bytes."""
    out = tmp_path / "port"
    assert make_tool.main(["--out", str(out), "--check"]) == 0
    jm = jax_side["goldens"]
    scenes = jm.all_scenes()
    assert set(scenes) == set(make_tool.all_scenes())
    for name, (integ, body, _, size, max_depth) in scenes.items():
        with open(out / (name + ".sp")) as f:
            assert f.read() == jm.scene_text(name, integ, body, w=size,
                                             h=size, max_depth=max_depth)
    jax_out = tmp_path / "jax"
    jax_out.mkdir()
    monkeypatch.setattr(jm, "SCENES", str(jax_out))   # where it writes
    jm.make_assets()
    for name in make_tool.ASSETS:
        assert (jax_out / name).read_bytes() == (out / name).read_bytes()


def test_make_goldens_check_finds_a_changed_byte(tmp_path):
    out, committed = tmp_path / "out", tmp_path / "committed"
    out.mkdir()
    files = make_tool.write_scenes(str(out))
    shutil.copytree(out, committed)
    assert make_tool.differing(str(out), files, str(committed)) == []
    with open(committed / "g_bf.sp", "a") as f:
        f.write(" ")
    os.remove(committed / "g_mandel.sp")
    assert make_tool.differing(str(out), files, str(committed)) == [
        "g_bf.sp", "g_mandel.sp"]
