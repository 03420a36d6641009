"""The benchmark's data against its contract: names, units, cells,
configurations, metrics and their readers, and the frozen mesh generator."""

import json
import os
import re

import pytest

from conftest import BENCH

ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(path):
    with open(path) as f:
        return json.load(f)


BENCH_JSON = load(os.path.join(ROOT, "BENCHMARK.json"))


def test_frozen_blob_is_the_repo_bench_mesh(tmp_path):
    from harness import meshgen
    spec = load(os.path.join(BENCH, "configs", "bunny.json"))["meshes"]["bench_blob.ply"]
    out = meshgen.write_mesh(spec, str(tmp_path / "bench_blob.ply"))
    with open(out, "rb") as a, open(os.path.join(ROOT, "scenes", "bench_blob.ply"), "rb") as b:
        assert a.read() == b.read()


def test_lucy_mesh_size_is_the_terrain_grid():
    spec = load(os.path.join(BENCH, "configs", "lucy.json"))["meshes"]["terrain_28m.ply"]
    n = spec["args"]["n"]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n * n}\nproperty float x\nproperty float y\n"
              f"property float z\nelement face {2 * (n - 1) ** 2}\n"
              "property list uchar int vertex_indices\nend_header\n")
    assert 2 * (n - 1) ** 2 == 28_895_202
    assert spec["ply_bytes"] == len(header) + 12 * n * n + 13 * 2 * (n - 1) ** 2


def test_top_level_keys():
    assert set(BENCH_JSON) == {"command", "paths", "run_seconds", "configs",
                               "workloads", "end_to_end", "per_layer"}
    assert BENCH_JSON["paths"] == ["benchmark"]
    assert BENCH_JSON["command"] == ["python3", "benchmark/run.py"]


@pytest.mark.parametrize("w", BENCH_JSON["workloads"], ids=lambda w: w["name"])
def test_cell_file_matches_and_names_a_config(w):
    c = load(os.path.join(BENCH, "cells", f"{w['name']}.json"))
    for k in ("name", "config", "traffic", "chips", "why"):
        assert c[k] == w[k], k
    assert os.path.exists(os.path.join(BENCH, "configs", f"{w['config']}.json"))
    assert os.path.exists(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
    assert w["config"] in {cf["name"] for cf in BENCH_JSON["configs"]}
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_config_files_and_reduced_keys():
    for cf in BENCH_JSON["configs"]:
        assert cf["file"] == f"benchmark/configs/{cf['name']}.json"
        data = load(os.path.join(ROOT, cf["file"]))
        assert data["reduced"] == cf["reduced"]
        for k in cf["reduced"]:
            assert k in data["assumed"], k
        assert cf["name"] in {w["config"] for w in BENCH_JSON["workloads"]}
        # the reference and the generators a configuration names are the benchmark's own
        assert os.path.isdir(os.path.join(BENCH, data.get("reference", "plainref")))
        for entry in data.get("files", {}).values():
            assert os.path.exists(os.path.join(BENCH, "generators", f"{entry['generator']}.py"))


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH_JSON[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH_JSON["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in BENCH_JSON["workloads"]}) \
        == len(BENCH_JSON["workloads"])


def test_metrics_name_layer_moves_and_reader():
    from harness import spec
    e2e = {m["name"]: m for m in BENCH_JSON["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH_JSON["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH_JSON["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["layer"] and "\n" not in m["layer"]
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))
        for w in m.get("workloads", []):
            reported = e2e[m["moves"]].get("workloads", [w])
            assert w in reported, (m["name"], w)
    for w in BENCH_JSON["workloads"]:
        reported = [m for m in spec.per_layer(BENCH_JSON, w["name"])]
        assert reported, w["name"]
        assert len(spec.end_to_end(BENCH_JSON, w["name"])) >= 2


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in BENCH_JSON["workloads"])
    assert four <= max(1, len(BENCH_JSON["workloads"]) // 4)
