"""The benchmark's data: cells, configurations, traffic mixes and the
per-layer metrics' readers, each found by its name.

A cell is ``cells/<name>.json``, its configuration ``configs/<config>.json``,
its traffic ``traffic/<traffic>.json``; a per-layer metric is read by
``metrics/<name>.py`` (a ``read(readings)`` function that returns a number,
or None where its cell has nothing for it to read).  Which metrics a cell
reports comes from ``BENCHMARK.json`` at the root of the checkout.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
WORK = os.path.join(HERE, "work")


def _load(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The cell with its configuration and traffic filled in."""
    c = _load("cells", name)
    c["config_spec"] = _load("configs", c["config"])
    c["traffic_spec"] = _load("traffic", c["traffic"])
    return c


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, name: str) -> bool:
    return name in metric.get("workloads", [name])


def end_to_end(bench: dict, name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if _reports(m, name)]


def per_layer(bench: dict, name: str) -> list[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list that move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, name)}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
