"""The port's CLI, progressive and checkpointed render, and host helpers:

* ``python -m simplepath_tpu_torch.cli`` with ``--platform cpu`` writes a
  PFM for every test scene, prints ``--stats``, reads a scene from stdin,
  writes a ``--profile`` trace, and fails without CUDA by default;
* a progressive render cut after a checkpoint and resumed equals the
  uninterrupted one bit for bit;
* checkpoints written by either package load in the other;
* ``RunningStats`` and ``Stopwatch`` equal the JAX package's.
"""

import glob
import io
import os

import numpy as np
import pytest
import torch

from simplepath_tpu import utils as JU
from simplepath_tpu_torch import cli
from simplepath_tpu_torch import utils as TU
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.io.pfm import read_pfm
from simplepath_tpu_torch.parallel import mesh
from simplepath_tpu_torch.render.film import render_image_progressive
from simplepath_tpu_torch.scene.build import build_scene, load_scene
from simplepath_tpu_torch.scene.parser import parse_sp

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
SCENES = sorted(os.path.basename(p)[:-3]
                for p in glob.glob(os.path.join(HERE, "scenes", "g_*.sp")))

TINY = """version: 1
scene_parameters {
    output_file_name: "tiny.pfm"
    width: 12
    height: 8
    max_depth: 3
    russian_roulette_depth: 1
    integrator: iterative_rrnee
}
perspective_camera {
    origin: 0.0 1.0 4.0
    look_at: 0.0 0.5 0.0
    fov: 45
}
material_lambertian {
    name: "white"
    diffuse: 0.7 0.7 0.7
}
sphere {
    material: "white"
    translate: 0.0 1.0 0.0
}
plane {
    material: "white"
}
sphere_light {
    translate: 0.0 4.0 0.0
    radiance: 10.0 10.0 10.0
}
environment_light {
    radiance: 0.5 0.5 0.5
}
"""


def test_every_test_scene_is_listed():
    assert len(SCENES) == 15


@pytest.mark.parametrize("name", SCENES)
def test_cli_writes_a_pfm_for_every_test_scene(name, tmp_path, capsys):
    out = tmp_path / f"{name}.pfm"
    rc = cli.main([os.path.join(HERE, "scenes", name + ".sp"), "--platform",
                   "cpu", "--output", str(out), "--threads", "4"])
    assert rc == 0
    img = read_pfm(str(out))
    scene = load_scene(os.path.join(HERE, "scenes", name + ".sp"), device="cpu")
    assert img.shape == (scene.static.height, scene.static.width, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    printed = capsys.readouterr().out
    assert f"Wrote {out}" in printed and "Elapsed time: 00:00:" in printed


def test_cli_stats_stdin_and_output_next_to_cwd(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.stdin", io.StringIO(TINY))
    assert cli.main(["-", "--platform", "cpu", "--samples", "2", "--stats",
                     "--integrator", "direct_lighting"]) == 0
    printed = capsys.readouterr().out
    assert "parse:" in printed and "primary rays/s:" in printed
    img = read_pfm(str(tmp_path / "tiny.pfm"))
    assert img.shape == (8, 12, 3) and img.mean() > 0


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    scene = tmp_path / "tiny.sp"
    scene.write_text(TINY)
    prof = tmp_path / "prof"
    assert cli.main([str(scene), "--platform", "cpu", "--profile",
                     str(prof)]) == 0
    assert (prof / "trace.json").stat().st_size > 0
    assert "Profiler trace written" in capsys.readouterr().out


def test_cli_progressive_checkpoint_resumes_to_the_same_film(tmp_path, capsys):
    scene = tmp_path / "tiny.sp"
    scene.write_text(TINY)
    ck = tmp_path / "ck.npz"
    args = [str(scene), "--platform", "cpu", "--samples", "4", "--spp-chunk",
            "2", "--checkpoint", str(ck)]
    assert cli.main(args + ["--output", str(tmp_path / "a.pfm")]) == 0
    film, done, meta = TU.load_checkpoint(str(ck))
    assert done == 4 and meta == {"spp_target": 4}
    # a finished checkpoint: the second run renders nothing and writes the
    # same image
    assert cli.main(args + ["--output", str(tmp_path / "b.pfm"),
                            "--no-progress"]) == 0
    assert (tmp_path / "a.pfm").read_bytes() == (tmp_path / "b.pfm").read_bytes()


def test_cli_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    scene = tmp_path / "tiny.sp"
    scene.write_text(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(scene)])
    with pytest.raises(RuntimeError, match="CUDA"):
        render_image_progressive(build_scene(parse_sp(TINY), device="cpu"), 1,
                                 prng_key(0))


def test_cli_geom_shards_names_the_later_slice(tmp_path, capsys):
    """--geom-shards builds a forest (parallel/geom_shard.py): a scene with
    fewer triangles than shards (TINY has none) is a usage error."""
    scene = tmp_path / "tiny.sp"
    scene.write_text(TINY)
    with pytest.raises(SystemExit):
        cli.main([str(scene), "--platform", "cpu", "--geom-shards", "2"])
    assert "at least one triangle per shard" in capsys.readouterr().err


def test_cli_test_flag_runs_the_port_tests(monkeypatch):
    seen = {}
    monkeypatch.setattr("pytest.main", lambda a: seen.setdefault("args", a) and 0)
    cli.main(["--test"])
    files = [os.path.basename(a) for a in seen["args"] if a.endswith(".py")]
    assert "test_torch_cli.py" in files
    assert all(f.startswith("test_torch_") for f in files)


def test_progressive_render_resumed_after_a_cut_equals_uninterrupted(
        tmp_path, monkeypatch):
    scene = build_scene(parse_sp(TINY), device="cpu")
    key = prng_key(7)
    whole = render_image_progressive(scene, 6, key, chunk=2, device="cpu")
    ck = str(tmp_path / "ck.npz")

    # the second pass dies: the checkpoint holds the first pass only
    real = mesh.render_image_sharded
    calls = []

    def dying(*a, **kw):
        calls.append(kw["spp_offset"])
        if len(calls) == 2:
            raise KeyboardInterrupt("cut")
        return real(*a, **kw)

    monkeypatch.setattr(mesh, "render_image_sharded", dying)
    with pytest.raises(KeyboardInterrupt):
        render_image_progressive(scene, 6, key, chunk=2, checkpoint_path=ck,
                                 checkpoint_every=2, device="cpu")
    monkeypatch.setattr(mesh, "render_image_sharded", real)
    assert calls == [0, 2] and TU.load_checkpoint(ck)[1] == 2

    resumed = render_image_progressive(scene, 6, key, chunk=2, checkpoint_path=ck,
                                       checkpoint_every=2, device="cpu")
    assert torch.equal(resumed, whole)
    assert TU.load_checkpoint(ck)[1] == 6
    # a checkpoint for another sample count is ignored, not resumed
    other = render_image_progressive(scene, 4, key, chunk=2, checkpoint_path=ck,
                                     device="cpu")
    assert torch.equal(other, render_image_progressive(scene, 4, key, chunk=2,
                                                       device="cpu"))


def test_checkpoints_load_across_packages(tmp_path):
    film = np.random.RandomState(0).rand(5, 7, 3).astype(np.float32)
    TU.save_checkpoint(str(tmp_path / "t.npz"), film, 12, {"spp_target": 32})
    JU.save_checkpoint(str(tmp_path / "j.npz"), film, 12, {"spp_target": 32})
    for path in ("t.npz", "j.npz"):
        for load in (TU.load_checkpoint, JU.load_checkpoint):
            f, done, meta = load(str(tmp_path / path))
            assert f.tobytes() == film.tobytes() and f.dtype == np.float32
            assert done == 12 and meta == {"spp_target": 32}
    assert TU.load_checkpoint(str(tmp_path / "missing.npz")) is None


def test_running_stats_and_stopwatch_match_jax():
    xs = np.random.RandomState(1).randn(20, 4)
    t, j = TU.RunningStats(), JU.RunningStats()
    assert t.variance() == j.variance() == 0.0
    for x in xs:
        t.push(x)
        j.push(x)
    np.testing.assert_array_equal(t.mean(), j.mean())
    np.testing.assert_array_equal(t.variance(), j.variance())
    np.testing.assert_allclose(t.variance(), xs.var(axis=0, ddof=1), rtol=1e-12)
    assert t.size() == j.size() == 20
    for e in (0.0, 3725.456, 59.999, 86400.5):
        ts, js = TU.Stopwatch(), JU.Stopwatch()
        ts.elapsed = js.elapsed = e
        assert str(ts) == str(js)
    sw = TU.Stopwatch()
    assert sw.stop() >= 0.0 and str(sw).startswith("00:00:00.")


def test_progress_bar_draws_to_its_stream():
    buf = io.StringIO()
    bar = TU.ProgressBar(8, "spp", width=8, stream=buf, min_interval=0.0)
    bar.update(4)
    bar.draw()
    bar.finish()
    text = buf.getvalue()
    assert " 50% |****----| 4/8 spp" in text and "100% |********| 8/8 spp" in text
