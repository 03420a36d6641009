"""A traced run hands the program's own spans and counters
(``simplepath_tpu_torch.tracing``) to the per-layer metrics: set-up's
record, one window pass's (step's), and over several ranks every rank's;
the metrics that read them and the two beside them that read the host's
time; a program without ``tracing`` run as before; and the profiled passes
under the keys of a run without the traced pass."""

import json
import sys

import pytest

from conftest import SEED, run, run_ranks, run_train

# the per-layer metrics that read the program's spans and counters
SPAN_METRICS = {"live_lane_share.render", "rank_skew.ranks", "backward_share.train",
                "first_use_s"}
# and those beside them that read the host's time: in the profiler's trace
# of the pass profiled for the device, and on the harness's clock
HOST_METRICS = {"host_us_per_launch.render", "before_load_s"}
NEW_KEYS = {"trace", "setup_trace", "ranks_trace"}

# On the CPU the profiler traces no device operation: the host's ops of the
# pass profiled for the device stand in for its launches, so that
# ``host_us_per_launch.render`` has a count to divide by.
HOST_OPS = ("cpu_op",)


@pytest.fixture
def kept(monkeypatch):
    """The readings that a run in this process hands to the metrics' readers,
    with the host's ops standing in for the launches."""
    from harness import bench, trace
    monkeypatch.setattr(trace, "DEVICE_CATS", trace.DEVICE_CATS + HOST_OPS)
    box = {}
    finish = bench.finish

    def keep(args, c, numbers, attempted, e2e, readings, *rest):
        box["readings"] = readings
        return finish(args, c, numbers, attempted, e2e, readings, *rest)
    monkeypatch.setattr(bench, "finish", keep)
    return box


def listed(cell: str) -> set:
    """The span and host metrics that the tiny benchmark's BENCHMARK.json
    lists for ``cell``."""
    from harness import spec
    return ({m["name"] for m in spec.per_layer(spec.benchmark(), cell)}
            & (SPAN_METRICS | HOST_METRICS))


def assert_read(out: dict, names: set) -> None:
    for name in names:
        assert isinstance(out["metrics"][name]["value"], float), (name, out["metrics"])


def test_traced_render_records_the_programs_spans(tiny_bench, kept):
    out = run(trace=1)
    assert out["correct"] is True, out["check"]
    r = kept["readings"]
    setup, trace = r["setup_trace"]["spans"], r["trace"]["spans"]
    assert {"load", "load.parse", "frame", "bounce", "wait.alive"} <= set(setup)
    assert setup["frame"]["count"] == 1
    assert {"frame", "wait.frame", "bounce", "wait.alive", "nee"} <= set(trace)
    assert trace["frame"]["count"] == 1 and "load" not in trace
    counters = r["trace"]["counters"]
    assert counters["bounce.lanes"] >= counters["bounce.live"] > 0
    assert "ranks_trace" not in r
    assert listed("tiny.render") == {"host_us_per_launch.render", "live_lane_share.render",
                                     "first_use_s", "before_load_s"}
    assert_read(out, listed("tiny.render"))


def test_traced_train_records_the_programs_spans(tiny_bench, kept):
    from harness import spec
    out = run_train(trace=1)
    assert out["correct"] is True, out["check"]
    r = kept["readings"]
    setup, trace = r["setup_trace"]["spans"], r["trace"]["spans"]
    assert setup["train.step"]["count"] == spec.cell("tiny.train")["check"]["checked_steps"]
    assert "load" in setup
    assert trace["train.step"]["count"] == 1
    assert {"train.forward", "train.backward", "train.update", "bounce"} <= set(trace)
    assert listed("tiny.train") == {"backward_share.train", "first_use_s", "before_load_s"}
    assert_read(out, listed("tiny.train"))


def test_traced_ranks_hand_on_every_ranks_spans(tiny_bench):
    kept = tiny_bench / "readings.json"
    prelude = f"""
import json
from harness import trace
trace.DEVICE_CATS = trace.DEVICE_CATS + {HOST_OPS!r}
_finish = bench.finish
def _keep(args, c, numbers, attempted, e2e, readings, *rest):
    with open({str(kept)!r}, "w") as f:
        json.dump(readings, f)
    return _finish(args, c, numbers, attempted, e2e, readings, *rest)
bench.finish = _keep
"""
    codes, ends, result = run_ranks(tiny_bench, 1, prelude)
    assert codes == [0, 0], ends
    out = json.loads(result.read_text())
    assert out["correct"] is True, out["check"]
    r = json.loads(kept.read_text())
    assert len(r["ranks_trace"]) == 2
    for t in r["ranks_trace"]:
        assert {"frame", "rank_render", "wait.rank", "gather", "wait.gather"} <= set(t["spans"])
    assert r["ranks_trace"][0] == r["trace"]
    assert {"rank_render", "gather"} <= set(r["setup_trace"]["spans"])
    assert listed("tiny.ranks2") == (SPAN_METRICS | HOST_METRICS) - {"backward_share.train"}
    assert_read(out, listed("tiny.ranks2"))


def test_no_new_keys_without_the_programs_tracing(tiny_bench, kept, monkeypatch):
    """A program that has no ``tracing`` module: the traced run passes and
    hands the metrics none of the program's spans."""
    import simplepath_tpu_torch.tracing  # noqa: F401  the program's own imports stay whole
    monkeypatch.setitem(sys.modules, "simplepath_tpu_torch.tracing", None)
    out = run(trace=1)
    assert out["correct"] is True, out["check"]
    assert not NEW_KEYS & set(kept["readings"])
    assert not SPAN_METRICS & set(out["metrics"])
    assert {"launches_per_mpath.render"} | HOST_METRICS <= set(out["metrics"])


def test_host_time_a_launch_leaves_out_the_blocking_calls():
    """``blocked_s`` is the union of the host's synchronises and copies in
    the profiler's trace, and ``host_us_per_launch.render`` takes it off the
    pass's wall: launches and other calls into CUDA stay host time."""
    from harness import spec, trace

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [ev("cuda_runtime", "cudaLaunchKernel", 0.0, 4.0),
              ev("kernel", "k", 2.0, 30.0),
              ev("cuda_runtime", "cudaMemcpyAsync", 10.0, 15.0),
              ev("cuda_runtime", "cudaStreamSynchronize", 20.0, 12.0),
              ev("cuda_driver", "cuLaunchKernel", 40.0, 3.0),
              ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 30.0, 2.0),
              ev("cuda_runtime", "cudaDeviceSynchronize", 50.0, 5.0)]
    r = trace.device_readings(events, 100e-6)
    assert r["blocked_s"] == pytest.approx(27e-6)
    assert r["launches"] == 2
    assert spec.reader("host_us_per_launch.render")(r) == pytest.approx((100 - 27) / 2)


def _key_index(keys, key) -> int:
    import torch
    return next(i for i in range(keys.shape[0]) if torch.equal(keys[i], key))


def test_profiled_passes_keep_their_keys(tiny_bench, monkeypatch):
    """A traced render run renders the unprofiled pass and the two profiled
    ones under keys 0, 1 and 2, as a run without the traced pass does, the
    traced pass under key 3 before them, and the window on from
    key 4; the reference is compared over all of them."""
    import torch

    from harness import bench, check
    from simplepath_tpu_torch import tracing
    from simplepath_tpu_torch.parallel import mesh
    seen = []
    render = mesh.render_image_sharded

    def spy(scene, spp, key, **kw):
        seen.append((key.clone(), tracing.enabled(), torch._C._autograd._profiler_enabled()))
        return render(scene, spp, key, **kw)
    monkeypatch.setattr(mesh, "render_image_sharded", spy)
    out = run(trace=1)
    assert out["correct"] is True, out["check"]
    keys = check.frame_keys(SEED, check.MAX_PASSES, "cpu")
    window = [(_key_index(keys, k), traced, profiled) for k, traced, profiled in seen[1:]]
    assert window[:4] == [(bench.TRACED_PASS, True, False), (0, False, False),
                          (1, False, True), (2, False, True)]
    assert [i for i, _, _ in window[4:]] == list(range(4, len(window)))
    assert out["attempted"] == len(window)


def test_profiled_train_steps_keep_their_keys_and_parameters(tiny_bench, monkeypatch):
    """A traced train run gives the unprofiled step and the two profiled ones
    the keys and parameters of a run without the traced step: the
    traced step takes the next key and the same parameters as the
    unprofiled one, and its own are dropped."""
    import torch

    from harness import bench, check, spec
    from simplepath_tpu_torch import tracing
    from simplepath_tpu_torch.diff import grad
    seen = []
    make = grad.make_train_step

    def spy_make(*a, **kw):
        step = make(*a, **kw)

        def spy(params, target, xs, ys, key):
            seen.append((key.clone(), params["mat_albedo"], tracing.enabled(),
                         torch._C._autograd._profiler_enabled()))
            return step(params, target, xs, ys, key)
        return spy
    monkeypatch.setattr(grad, "make_train_step", spy_make)
    out = run_train(trace=1)
    assert out["correct"] is True, out["check"]
    checked = spec.cell("tiny.train")["check"]["checked_steps"]
    keys = check.frame_keys(SEED, check.MAX_PASSES, "cpu")
    window = seen[checked:]
    assert [(_key_index(keys, k), traced, profiled) for k, _, traced, profiled in window[:4]] == [
        (checked + bench.TRACED_PASS, True, False), (checked, False, False),
        (checked + 1, False, True), (checked + 2, False, True)]
    assert window[0][1] is window[1][1]
