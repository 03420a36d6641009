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


@pytest.fixture
def gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
