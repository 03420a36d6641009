"""The benchmark's CPU tests: ``python -m pytest benchmark/tests``.

They import the harness as ``benchmark/run.py`` does (``benchmark/`` and the
root of the checkout on ``sys.path``).  Tests that need a GPU decide so in
the ``gpu`` fixture and skip on a machine without one.
"""

import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

# A configuration small enough for the CPU: one displaced icosphere of 320
# triangles, a plane, a sphere light and a constant environment light.
TINY_SCENE = """version: 1
scene_parameters {
    output_file_name: "tiny.pfm"
    width: 24
    height: 16
    max_depth: 10
    russian_roulette_depth: 3
    integrator: iterative_rrnee
}
perspective_camera {
    origin: 0.0 2.0 5.0
    look_at: 0.0 1.0 0.0
    fov: 45
}
material_glossy {
    name: "glossy_base"
    diffuse: 0.8 0.2 0.8
    ior: 1.8
    roughness: 0.25
}
material_lambertian {
    name: "lambert"
    diffuse: 0.1 0.8 0.8
}
material_clearcoat {
    name: "coat"
    base: "glossy_base"
    ior: 1.3
    color: 1.0 0.9 0.9
}
mesh {
    file: "blob.ply"
    translate: 0.5 1.0 0.0
    scale: 0.9 0.9 0.9
    material: "coat"
}
mesh {
    file: "blob.ply"
    translate: -1.0 1.0 0.0
    scale: 0.6 0.6 0.6
    material: "lambert"
}
plane {
    material: "glossy_base"
}
sphere_light {
    translate: 0.0 4.0 0.0
    scale: 0.5 0.5 0.5
    radiance: 10.0 10.0 10.0
}
environment_light {
    radiance: 0.3 0.3 0.4
}
"""


def tiny_config() -> dict:
    return {"name": "tiny", "source": "benchmark/tests/conftest.py",
            "precision": "float32", "reduced": [], "film": [24, 16],
            "scene_file": "tiny.sp", "scene_text": TINY_SCENE,
            "meshes": {"blob.ply": {"generator": "displaced_blob",
                                    "args": {"subdivisions": 2},
                                    "ply_bytes": 6277}}}


SEED = 2 ** 33 + 12345


def run(trace=0, seed=SEED, seconds=1.0, cell="tiny.render"):
    """A run of a render cell in this process, on the CPU → its result."""
    import time

    from harness import bench, spec
    args = bench.parse(["--workload", cell, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)])
    return bench.run_cell(args, spec.cell(cell), time.time(), device="cpu")


def run_train(trace=0, seed=SEED, seconds=0.5):
    """A run of ``tiny.train`` in this process, on the CPU → its result."""
    import time

    from harness import bench, spec
    args = bench.parse(["--workload", "tiny.train", "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)])
    return bench.run_train_cell(args, spec.cell("tiny.train"), time.time(), device="cpu")


def run_ranks(tiny_bench, trace: int, prelude: str = ""):
    """``tiny.ranks2``'s two ranks over gloo on the CPU, each a process of
    its own as under torchrun, each running ``prelude`` (Python, with
    ``sys``, ``types``, ``bench`` and ``spec`` imported) before its run →
    (exit codes, (stdout, stderr) of each, the result file rank 0 writes)."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    result = tiny_bench / "result.json"
    code = f"""
import sys, time, types
sys.path[:0] = [{os.path.join(BENCH, 'tests')!r}]
import conftest
from harness import bench, spec
spec.HERE, spec.ROOT = {str(tiny_bench / 'benchmark')!r}, {str(tiny_bench)!r}
spec.WORK = {str(tiny_bench / 'benchmark' / 'work')!r}
{prelude}
args = bench.parse(["--workload", "tiny.ranks2", "--seed", "{SEED}", "--seconds", "0.5",
                    "--trace", "{trace}", "--rank-worker", "--started", repr(time.time()),
                    "--result", {str(result)!r}])
sys.exit(bench.rank_worker(args, spec.cell("tiny.ranks2"), device="cpu"))
"""
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2")
        procs.append(subprocess.Popen([sys.executable, "-c", code, str(rank)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    ends = [p.communicate(timeout=240) for p in procs]
    return [p.returncode for p in procs], ends, result


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """A copy of the benchmark's data in ``tmp_path`` with the tiny
    configuration and cells ``tiny.render``, ``tiny.ranks2`` (two ranks over
    gloo) and ``tiny.train`` on it, and the harness pointed at the copy."""
    import json

    from harness import spec

    here = tmp_path / "benchmark"
    for sub in ("cells", "configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), here / sub)
    (here / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    cells = [{"name": "tiny.render", "config": "tiny", "traffic": "frames_1spp",
              "chips": 1, "why": "the CPU tests' render cell",
              "trace": {"roofline_calls": [0]},
              "check": {"pixels_per_pass": 64, "rel": 1e-4, "abs": 1e-6,
                        "limits": {"pixels_off_share": 0.01}}}]
    cells.append(dict(cells[0], name="tiny.ranks2", traffic="frames_1spp_ranks",
                      chips=2, why="the CPU tests' cell over two ranks"))
    train = json.load(open(os.path.join(BENCH, "cells", "bunny.train.json")))
    cells.append(dict(train, name="tiny.train", config="tiny",
                      why="the CPU tests' train cell"))
    bench = json.load(open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")))
    for cell in cells:
        (here / "cells" / f"{cell['name']}.json").write_text(json.dumps(cell))
        bench["workloads"].append({k: cell[k] for k in
                                   ("name", "config", "traffic", "chips", "why")})
    # the tiny cells report what bunny's report
    for m in bench["end_to_end"] + bench["per_layer"]:
        for big, tiny in (("bunny.render", "tiny.render"), ("bunny.train", "tiny.train"),
                          ("lucy.ranks4", "tiny.ranks2")):
            if big in m.get("workloads", []):
                m["workloads"].append(tiny)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", str(here))
    monkeypatch.setattr(spec, "ROOT", str(tmp_path))
    monkeypatch.setattr(spec, "WORK", str(here / "work"))
    return tmp_path


# A generator of the kind a configuration names under "files", as a new
# file of the benchmark would hold it: a displaced icosphere as PLY.
BLOB_GENERATOR = """from harness import meshgen


def write(path, subdivisions, seed):
    v, f = meshgen.displaced_blob(subdivisions, seed=seed)
    meshgen.write_ply(path, v, f)
"""
BLOB_BYTES = 1715
# appended to a copy of plainref's render.py: every radiance off by 1e-3
RADIANCE_ALTERED = """

_render_pixels = render_pixels


def render_pixels(*args, **kwargs):
    return _render_pixels(*args, **kwargs) + 1e-3
"""


@pytest.fixture
def own_config(tiny_bench, monkeypatch):
    """Adds to the tiny benchmark, as new files and list entries only, a
    configuration that names its own reference (a copy of ``plainref``,
    its radiance altered by 1e-3 where asked) and a generated file (its
    second mesh, written by a generator of the copy's ``generators/``), and
    a render cell on it → a function(altered=False) that returns the
    cell's name."""
    import json
    import uuid

    here = tiny_bench / "benchmark"
    monkeypatch.syspath_prepend(str(here))
    (here / "generators").mkdir(exist_ok=True)
    (here / "generators" / "blob_ply.py").write_text(BLOB_GENERATOR)
    made = []

    def make(altered: bool = False) -> str:
        ref = f"tinyref_{uuid.uuid4().hex[:8]}"
        made.append(ref)
        shutil.copytree(os.path.join(BENCH, "plainref"), here / ref)
        if altered:
            with open(here / ref / "render.py", "a") as f:
                f.write(RADIANCE_ALTERED)
        name = f"tiny_{ref}"
        first = TINY_SCENE.index('file: "blob.ply"') + 1
        cfg = dict(tiny_config(), name=name, reference=ref,
                   scene_text=TINY_SCENE[:first] + TINY_SCENE[first:].replace(
                       'file: "blob.ply"', 'file: "blob_gen.ply"'),
                   files={"blob_gen.ply": {"generator": "blob_ply",
                                           "args": {"subdivisions": 1, "seed": 3},
                                           "bytes": BLOB_BYTES}})
        (here / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        cell = json.loads((here / "cells" / "tiny.render.json").read_text())
        cell.update(name=f"{name}.render", config=name)
        (here / "cells" / f"{name}.render.json").write_text(json.dumps(cell))
        bench = json.loads((tiny_bench / "BENCHMARK.json").read_text())
        bench["configs"].append({"name": name, "source": "benchmark/tests/conftest.py",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": [], "why": "the CPU tests' own reference"})
        bench["workloads"].append({k: cell[k] for k in
                                   ("name", "config", "traffic", "chips", "why")})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "tiny.render" in m.get("workloads", []):
                m["workloads"].append(cell["name"])
        (tiny_bench / "BENCHMARK.json").write_text(json.dumps(bench))
        return cell["name"]

    yield make
    for m in [m for m in sys.modules if m.split(".")[0] in made]:
        del sys.modules[m]


@pytest.fixture
def gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
