"""A run of a cell on the CPU, at the tiny configuration of ``conftest.py``:
the result line, the metrics found by name, the modules a run loads, and
``correct`` coming out false when the timed path is broken underneath."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, run, run_ranks, run_train

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _references() -> list[str]:
    """Every reference package a configuration of BENCHMARK.json names, and
    the default."""
    from harness import check
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        configs = json.load(f)["configs"]
    names = {check.DEFAULT_REFERENCE}
    for cf in configs:
        with open(os.path.join(os.path.dirname(BENCH), cf["file"])) as f:
            names.add(json.load(f).get("reference", check.DEFAULT_REFERENCE))
    return sorted(names)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(tiny_bench, trace, capsys):
    from harness import bench
    out = run(trace)
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    assert bench.emit(out) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = set(line) - {"check", "pixels_compared"}
    assert keys == (KEYS | {"breakdown"} if trace else KEYS)
    assert list(line)[-1] == "check"
    assert line["check"]["pixels_off_share"]["value"] == 0.0
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "load_s" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"setup_s", "paths_per_s", "peak_mem_gb"}


def test_new_cell_config_and_metric_are_new_files(tiny_bench, own_config):
    """The tiny cell, its configuration and a per-layer metric come in as
    new files and one list entry each, with no harness file edited; so does
    a configuration that names its own reference package and a generated
    file, with a cell on it."""
    here = tiny_bench / "benchmark"
    own = own_config()
    (here / "metrics" / "passes_profiled.tiny.py").write_text(
        "def read(r):\n    return float(r['paths_profiled'])\n")
    bench = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "passes_profiled.tiny", "unit": "paths",
                               "better": "higher", "source": "program_counter",
                               "layer": "bounce loop", "moves": "paths_per_s",
                               "workloads": ["tiny.render", own]})
    (tiny_bench / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell in ("tiny.render", own):
        out = run(trace=1, cell=cell)
        assert out["correct"] is True, out["check"]
        assert out["metrics"]["passes_profiled.tiny"]["value"] == 24 * 16


@pytest.mark.parametrize("reference", _references())
def test_no_jax_after_a_rehearsal_and_reference_imports_no_program(tmp_path, reference):
    """In fresh processes: a CPU rehearsal of a cell loads no module named
    jax, jaxlib, flax or simplepath_tpu (names compared whole), and the
    reference package, every module of it, loads nothing of the program."""
    code = f"""
import sys, time, pathlib
sys.path[:0] = [{os.path.join(BENCH, 'tests')!r}]
import conftest
from harness import bench, spec
class MP:
    def setattr(self, o, n, v): setattr(o, n, v)
conftest.tiny_bench.__wrapped__(pathlib.Path({str(tmp_path)!r}), MP())
args = bench.parse(["--workload", "tiny.render", "--seed", "7", "--seconds", "0.5"])
bench.run_cell(args, spec.cell("tiny.render"), time.time(), device="cpu")
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    mods = eval(subprocess.run([sys.executable, "-c", code], check=True,
                               capture_output=True, text=True).stdout.splitlines()[-1])
    assert "simplepath_tpu_torch" in mods
    assert not {"jax", "jaxlib", "flax", "simplepath_tpu"} & set(mods)
    code = f"""
import importlib, os, sys
sys.path[:0] = [{BENCH!r}]
for f in sorted(os.listdir(os.path.join({BENCH!r}, {reference!r}))):
    if f.endswith(".py"):
        importlib.import_module({reference!r} + "." + f[:-3])
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    mods = eval(subprocess.run([sys.executable, "-c", code], check=True,
                               capture_output=True, text=True).stdout.splitlines()[-1])
    assert not {"simplepath_tpu_torch", "simplepath_tpu", "jax"} & set(mods)


def _zero_rows(img, keep):
    flat = img.reshape(-1, 3).clone()
    flat[keep(flat.shape[0])] = 0.0
    return flat.reshape(img.shape)


FAULTS = {
    # half of the frame left out
    "half_the_batch": lambda f: lambda scene, spp, key, **k: _zero_rows(
        f(scene, spp, key, **k), lambda n: slice(n // 2, None)),
    # every pass returns the same frame, whatever its key
    "state_unchanged": lambda f: lambda scene, spp, key, **k: f(
        scene, spp, torch.zeros_like(key), **k),
    # the other ranks' blocks of the frame never arrive (three of four)
    "exchange_left_out": lambda f: lambda scene, spp, key, **k: _zero_rows(
        f(scene, spp, key, **k), lambda n: slice(n // 4, None)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_correct_is_false_under_a_fault(tiny_bench, monkeypatch, fault):
    from simplepath_tpu_torch.parallel import mesh
    monkeypatch.setattr(mesh, "render_image_sharded",
                        FAULTS[fault](mesh.render_image_sharded))
    out = run()
    assert out["correct"] is False, out["check"]


def test_correct_is_false_with_a_radiance_altered(tiny_bench, monkeypatch):
    """Every path's radiance altered by 1e-3 where the integrator makes it."""
    from simplepath_tpu_torch.render import integrators
    fn = integrators.INTEGRATOR_FNS["iterative_rrnee"]
    monkeypatch.setitem(integrators.INTEGRATOR_FNS, "iterative_rrnee",
                        lambda *a, **k: fn(*a, **k) * 1.001)
    out = run()
    assert out["correct"] is False, out["check"]


def _control(cell: str, seed: int, device, passes: int) -> tuple[float, float]:
    """(the reference's reading against itself, the control's) on the cell's
    pixel plan: the control is the reference with its radiance state in
    bfloat16."""
    from harness import bench, check, spec
    c = spec.cell(cell)
    cfg, chk = c["config_spec"], c["check"]
    _, mesh_dir = bench.prepare(cfg)
    w, h = cfg["film"]
    plan = check.sample_plan(seed, w * h, chk["pixels_per_pass"], device)
    spp = c["traffic_spec"]["spp"]
    ref = check.reference_pixels(cfg, mesh_dir, spp, seed, plan,
                                 passes, device)
    ctl = check.reference_pixels(cfg, mesh_dir, spp, seed, plan,
                                 passes, device, state_dtype=torch.bfloat16)
    return (check.compare(ref, ref, chk["rel"], chk["abs"])["pixels_off_share"],
            check.compare(ctl, ref, chk["rel"], chk["abs"])["pixels_off_share"])


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3, 2 ** 40 + 5])
def test_control_fails_the_limit(tiny_bench, seed):
    from harness import spec
    same, ctl = _control("tiny.render", seed, "cpu", 3)
    limit = spec.cell("tiny.render")["check"]["limits"]["pixels_off_share"]
    assert same == 0.0 and ctl > limit


@pytest.mark.parametrize("cell", ["bunny.render", "bunny.render_cli", "lucy.render"])
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 7, 2 ** 41 + 9])
def test_control_fails_at_the_cells_size(gpu, cell, seed):
    """On the card, at the cell's own size and pixel plan (a dozen passes)."""
    from harness import spec
    same, ctl = _control(cell, seed, gpu, 12)
    limit = spec.cell(cell)["check"]["limits"]["pixels_off_share"]
    print(f"control {cell} seed {seed}: {ctl!r} against the limit {limit!r}")
    assert same == 0.0 and ctl > 3 * limit


@pytest.mark.parametrize("trace", [0, 1])
def test_train_cell(tiny_bench, trace):
    out = run_train(trace)
    assert out["correct"] is True, out["check"]
    assert list(out)[-1] == "check"
    assert set(out["check"]) == {"loss_gap", "grad_norm_gap", "change_norm_gap",
                                 "pixels_off_share"}
    if trace:
        assert {"load_s", "forward_share.train"} <= set(out["metrics"])
    else:
        assert set(out["metrics"]) == {"setup_s", "train_step_s", "peak_mem_gb"}


TRAIN_FAULTS = {
    # the step hands back the parameters it was given
    "state_unchanged": lambda step: lambda params, *a: (params, step(params, *a)[1]),
    # the step sees half of the batch, its mean taken over that half
    "half_the_batch": lambda step: lambda params, target, xs, ys, key: step(
        params, target[: xs.shape[0] // 2], xs[: xs.shape[0] // 2],
        ys[: ys.shape[0] // 2], key),
}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_correct_is_false_under_a_fault(tiny_bench, monkeypatch, fault):
    from simplepath_tpu_torch.diff import grad
    make = grad.make_train_step
    monkeypatch.setattr(grad, "make_train_step",
                        lambda *a, **k: TRAIN_FAULTS[fault](make(*a, **k)))
    out = run_train()
    assert out["correct"] is False, out["check"]


def _train_control(cell: str, seed: int, device) -> tuple[dict, dict]:
    """The reference against itself, and the control (the reference with
    its radiance state in bfloat16, as the render cells' control) against
    the reference, on the cell's first steps."""
    from harness import bench, check, spec
    c = spec.cell(cell)
    cfg, t, chk = c["config_spec"], c["traffic_spec"], c["check"]
    _, mesh_dir = bench.prepare(cfg)
    w, h = cfg["film"]
    target = check.train_target(seed, w * h, device)
    pixels = check.sample_plan(seed, w * h, chk["pixels"], device)[0]
    steps = chk["checked_steps"]
    args = (cfg, mesh_dir, t["spp"], seed, target, steps, t["lr"], device)
    ref = check.reference_train(*args, pixels=pixels)
    ctl = check.reference_train(*args, state_dtype=torch.bfloat16, pixels=pixels)
    as_program = lambda r: dict(losses=r["losses"], pixels=r["pixels"], albedo=[
        r["albedo0"] - t["lr"] * r["grad0"]] + [r["albedo"]] * (steps - 1))
    return (check.compare_train(as_program(ref), ref, t["lr"], chk),
            check.compare_train(as_program(ctl), ref, t["lr"], chk))


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3, 2 ** 40 + 5])
def test_train_control_fails_the_limits(tiny_bench, seed):
    from harness import spec
    same, ctl = _train_control("tiny.train", seed, "cpu")
    limits = spec.cell("tiny.train")["check"]["limits"]
    assert all(v < 1e-5 for v in same.values()), same

    assert any(ctl[k] > v for k, v in limits.items()), ctl


@pytest.mark.parametrize("seed", [101, 2 ** 31 + 7, 2 ** 41 + 9])
def test_train_control_fails_at_the_cells_size(gpu, seed):
    from harness import spec
    same, ctl = _train_control("bunny.train", seed, gpu)
    limits = spec.cell("bunny.train")["check"]["limits"]
    print(f"train control seed {seed}: {ctl!r} (the reference itself {same!r}) "
          f"against {limits!r}")
    assert any(ctl[k] > 3 * v for k, v in limits.items())


def test_train_first_step_pixels_at_the_cells_size(gpu):
    """The first step's own forward radiance of the sampled pixels against
    the reference's, and the control's, on the card at the cell's size:
    a dozen seeds of the program in one process (its scene and step built
    once), the control on three of them."""
    from harness import bench, check, spec
    from simplepath_tpu_torch import load_scene
    from simplepath_tpu_torch.diff import grad
    c = spec.cell("bunny.train")
    cfg, t, chk = c["config_spec"], c["traffic_spec"], c["check"]
    path, mesh_dir = bench.prepare(cfg)
    scene = load_scene(path, device=gpu)
    w, h = scene.static.width, scene.static.height
    lin = torch.arange(w * h, device=gpu)
    step = grad.make_train_step(scene, t["spp"], lr=t["lr"], device=gpu,
                                leaves=tuple(t["leaves"]))
    limit = chk["limits"]["pixels_off_share"]
    sound, control = [], []
    for i, seed in enumerate(2 ** 35 + 1000 * k + 17 for k in range(12)):
        pixels = check.sample_plan(seed, w * h, chk["pixels"], gpu)[0]
        target = check.train_target(seed, w * h, gpu)
        key = check.frame_keys(seed, 1, gpu)[0]
        with check.FirstRender(grad, pixels) as first:
            step(grad.get_params(scene), target, lin % w, lin // w, key)
        read = lambda dt: check.reference_pixels(
            cfg, mesh_dir, t["spp"], seed, pixels[None], 1, gpu, dt)
        ref = read(None)
        sound.append(check.compare(first.kept, ref, chk["rel"], chk["abs"])[
            "pixels_off_share"])
        if i < 3:
            control.append(check.compare(read(torch.bfloat16), ref, chk["rel"],
                                         chk["abs"])["pixels_off_share"])
    print(f"train first-step pixels: sound {sound!r}; control {control!r}; "
          f"limit {limit!r}")
    assert max(sound) <= limit < min(control)


@pytest.mark.parametrize("seed", [103, 2 ** 31 + 11, 2 ** 42 + 13])
def test_train_half_the_batch_at_the_cells_size(gpu, monkeypatch, seed):
    """The half-of-the-batch fault planted in the step, on the card at the
    cell's own size (a state left unchanged reads 1 and needs no run)."""
    from harness import bench, spec
    from simplepath_tpu_torch.diff import grad
    make = grad.make_train_step
    monkeypatch.setattr(grad, "make_train_step", lambda *a, **k: TRAIN_FAULTS[
        "half_the_batch"](make(*a, **k)))
    args = bench.parse(["--workload", "bunny.train", "--seed", str(seed),
                        "--seconds", "1", "--trace", "0"])
    out = bench.run_train_cell(args, spec.cell("bunny.train"), time.time(), gpu)
    print(f"train half the batch seed {seed}: {out['check']!r}")
    assert out["correct"] is False


@pytest.mark.parametrize("planted", [None, 0, 1])
def test_ranks_refuse_a_forbidden_module_on_any_rank(tiny_bench, planted):
    """Two ranks of a cell over gloo on the CPU, each a process of its own
    as under torchrun: rank 0 writes the result only where no rank holds a
    module of JAX or the JAX package once the window has closed (one is
    planted in the rank ``planted``)."""
    plant = (f"if {planted!r} == int(sys.argv[1]):\n"
             "    sys.modules['jax'] = types.ModuleType('jax')\n")
    codes, ends, result = run_ranks(tiny_bench, 0, plant)
    if planted is None:
        assert codes == [0, 0], ends
        out = json.loads(result.read_text())
        assert out["correct"] is True and out["device"]["count"] == 2, out
    else:
        assert codes[0] == 5 and not result.exists(), (codes, ends)
        assert f"rank {planted}: ['jax']" in ends[0][1]
