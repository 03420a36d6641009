"""The traced run's profiler window and what is read from it.

The arithmetic follows ``tools/torch_profile_render.py`` (device-busy time
from the profiler's kernels, the traversal's share of it) and
``chip_smoke.py::cuda_launches`` (launches are the profiler's device
events) at commit d1155b91, with busy time taken as the union of the
device's kernel and copy intervals, so that nothing is counted twice.  The
profiler's trace is written as Chrome trace JSON into the benchmark's work
directory, read back and removed.
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CLOSEST = "traverse_kernel<false"
ANYHIT = "traverse_kernel<true"
TOP = 10
NAME_CHARS = 160


@contextlib.contextmanager
def profiled(host_ops: bool):
    """Profile the block: the device's kernels and copies, and with
    ``host_ops`` the host's ops too, with the block marked as the window.
    Recording every host op slows the host's launches (on the bunny frame a
    pass took 4.6 s against 2.9 s), so the numbers of the device come from
    a pass profiled without them, and only the names of the idle stretches
    from a pass profiled with them."""
    acts = [torch.profiler.ProfilerActivity.CPU] if host_ops else []
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    acts = acts or [torch.profiler.ProfilerActivity.CPU]    # the CPU tests
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()


def events(prof, path: str) -> list:
    """The profile's complete events, through a Chrome trace at ``path``."""
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            ev = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in ev if e.get("ph") == "X"]


def _union(iv: list) -> list:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _device(ev: list) -> list:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in ev if e.get("cat") in DEVICE_CATS)


def device_readings(ev: list, window_s: float) -> dict:
    """Readings of a pass profiled for the device alone, which ``window_s``
    seconds of the host's clock bracket (times in seconds)."""
    dev = _device(ev)
    busy = _union([[s, e] for s, e, _ in dev])
    return dict(
        window_s=window_s,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        launches=len(dev),
        closest_s=[(e - s) * 1e-6 for s, e, n in dev if CLOSEST in n],
        anyhit_s=[(e - s) * 1e-6 for s, e, n in dev if ANYHIT in n],
        nccl_s=sum(e - s for s, e, n in dev if "nccl" in n.lower()) * 1e-6)


def breakdown(ev: list) -> dict:
    """The device operations that took most time, and the idle stretches by
    the host op around them, of a pass profiled with the host's ops."""
    win = [e for e in ev if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the profile holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [d for d in _device(ev) if w0 <= d[0] < w1]
    busy = _union([[max(s, w0), min(e, w1)] for s, e, _ in dev])
    by_name: dict = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    # the host op around each idle stretch: the innermost CPU op open at
    # its start (ops nest on the one host thread that renders)
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in ev if e.get("cat") == "cpu_op")
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps: dict = {}
    stack: list = []
    j = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        while j < len(ops) and ops[j][0] <= g0:
            while stack and stack[-1][1] <= ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        if g1 > g0:
            name = stack[-1][2] if stack else "host outside any op"
            gaps[name] = gaps.get(name, 0.0) + (g1 - g0)
    top = lambda d: [[n[:NAME_CHARS], v * 1e-6] for n, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return dict(device_ops=top(by_name), idle_gaps=top(gaps))


class CallSampler:
    """Wraps the program's two traversal entry points (module attributes,
    which ``render/traverse.py`` calls through) while installed: counts the
    calls of each kind and keeps the inputs of the calls whose index is in
    ``keep``, for the work count after the window."""

    def __init__(self, module, keep):
        self.module = module
        self.keep = set(keep)
        self.calls = {"closest": 0, "anyhit": 0}
        self.kept = []
        self._orig = {}

    def _wrap(self, kind):
        fn = self._orig[kind]

        def call(records, ro, rd, t_min, t_max):
            i = self.calls[kind]
            if ro.shape[0] > 0:
                self.calls[kind] = i + 1
                if i in self.keep:
                    self.kept.append((kind, i, records, ro, rd, t_min, t_max))
            return fn(records, ro, rd, t_min, t_max)
        return call

    def __enter__(self):
        for kind in self.calls:
            self._orig[kind] = getattr(self.module, kind)
            setattr(self.module, kind, self._wrap(kind))
        return self

    def __exit__(self, *exc):
        for kind, fn in self._orig.items():
            setattr(self.module, kind, fn)
