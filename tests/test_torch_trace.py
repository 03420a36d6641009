"""The port's tracing (``simplepath_tpu_torch/tracing.py``) on the CPU:

* off, nothing is recorded, and a frame renders bit-equal with it on and off;
* spans nest, on one thread and across threads, and each span's self time
  and its children's times add up to its own;
* the bounce loop's ``bounce.live`` and ``bounce.lanes`` equal a direct count
  of the alive masks;
* under ``torch.profiler`` the ``sp.*`` annotations nest as the record does
  and hold the aten ops issued inside them;
* the kernel wrappers' ``launch_counts`` are the registry's groups, and a
  kernel library's first use is a ``library`` span;
* a train step's recomputed bounces open their spans inside
  ``train.backward``.
"""

import json
import threading
import time

import pytest
import torch

from simplepath_tpu_torch import tracing
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.diff.grad import get_params, make_train_step
from simplepath_tpu_torch.parallel.mesh import render_image_sharded
from simplepath_tpu_torch.render import cuda_probes, cuda_traverse, integrators
from simplepath_tpu_torch.scene.build import load_scene

torch.set_num_threads(1)

TINY = """version: 1
scene_parameters {
    output_file_name: "tiny.pfm"
    width: 8
    height: 6
    max_depth: 4
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


@pytest.fixture(scope="module")
def scene():
    return load_scene(TINY, device="cpu")


def frame(scene, chunk_rays=16):
    return render_image_sharded(scene, 1, prng_key(3), chunk_rays=chunk_rays,
                                device="cpu")


def _by_id(rec):
    return {s.id: s for s in rec.closed()}


def _ancestors(span, by_id):
    while span.parent is not None:
        span = by_id[span.parent]
        yield span


def test_off_records_nothing_and_the_frame_is_bit_equal(scene):
    assert not tracing.enabled()
    assert tracing.span("frame") is tracing.span("bounce", depth=1)
    with tracing.recording() as idle:
        pass
    off = frame(scene)
    assert idle.spans == [] and idle.counters == {} and not tracing.enabled()
    with tracing.recording() as rec:
        on = frame(scene)
    assert torch.equal(off, on)
    s = rec.summary()
    assert s["frames"] == 1 and s["orphans"] == 0
    assert s["spans"]["frame"]["count"] == 1
    assert s["spans"]["chunk"]["count"] == 3
    assert {"wait.frame", "wait.alive", "bounce", "rho_table", "rng", "nee",
            "closest_hit", "light_hits", "shading",
            "material_sample"} <= set(s["spans"])
    # every span of the pass shares the frame's index, its request id
    assert {sp.frame for sp in rec.closed()} == {0}


def test_spans_nest_and_self_times_add_up():
    with tracing.recording() as rec:
        with tracing.span("outer") as outer:
            with tracing.span("a"):
                time.sleep(0.002)
            with tracing.span("b", k=1) as b:
                b.set(more=2)
                with tracing.span("c"):
                    time.sleep(0.002)

            def worker():
                with tracing.span("elsewhere"):
                    time.sleep(0.001)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    by_name = {s.name: s for s in rec.closed()}
    assert by_name["b"].attrs == {"k": 1, "more": 2}
    assert by_name["c"].parent == by_name["b"].id
    # a thread with no span open takes the innermost open span elsewhere
    assert by_name["elsewhere"].parent == outer.id
    assert by_name["elsewhere"].thread != outer.thread
    s = rec.summary()
    assert s["orphans"] == 0
    rows = s["spans"]
    for parent, kids in (("outer", ("a", "b", "elsewhere")), ("b", ("c",))):
        assert rows[parent]["self_s"] + sum(rows[k]["total_s"] for k in kids) \
            == pytest.approx(rows[parent]["total_s"], abs=1e-9)
    assert rows["a"]["self_s"] == rows["a"]["total_s"]


def test_bounce_counters_equal_the_alive_masks(scene, monkeypatch):
    loop = integrators._bounce_loop
    masks = []

    def counted(scene, state, step, max_depth):
        def step_seen(depth, st):
            masks.append(st[-1].clone())
            return step(depth, st)
        return loop(scene, state, step_seen, max_depth)

    monkeypatch.setattr(integrators, "_bounce_loop", counted)
    with tracing.recording() as rec:
        frame(scene)
    c = rec.summary()["counters"]
    assert len(masks) == rec.summary()["spans"]["bounce"]["count"] > 3
    assert c["bounce.live"] == sum(int(m.sum()) for m in masks)
    assert c["bounce.lanes"] == sum(m.numel() for m in masks)
    assert 0 < c["bounce.live"] < c["bounce.lanes"]


def test_profiler_annotations_nest_as_the_record(scene, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.recording() as rec:
            frame(scene, chunk_rays=None)       # one chunk
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X"]
    iv = lambda e: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
    ann = lambda name: [iv(e) for e in ev if e.get("cat") == "user_annotation"
                        and e["name"] == "sp." + name]
    ops = [iv(e) for e in ev if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    (f0, f1), = ann("frame")
    bounces = ann("bounce")
    rows = rec.summary()["spans"]
    assert len(bounces) == rows["bounce"]["count"]
    assert len(ann("chunk")) == rows["chunk"]["count"] == 1
    for b0, b1 in bounces:
        assert f0 <= b0 < b1 <= f1
        assert any(b0 <= o0 and o1 <= b1 for o0, o1 in ops)
    inside = [o1 for o0, o1 in ops if f0 <= o0 < f1]
    assert inside and max(inside) <= f1


def test_launch_counts_are_registry_groups():
    assert tracing._groups["launches.traverse"] is cuda_traverse.launch_counts
    assert tracing._groups["launches.probes"] is cuda_probes.launch_counts
    with tracing.recording() as rec:
        cuda_traverse.launch_counts["closest"] += 2
    cuda_traverse.launch_counts["closest"] -= 2
    assert rec.summary()["counters"]["launches.traverse.closest"] == 2


def test_library_span_and_build_counter(monkeypatch):
    from simplepath_tpu_torch import native
    monkeypatch.setattr(native, "_lib_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    with tracing.recording() as rec:
        lib = native.get_lib()
    lib_span, = rec.closed()
    assert lib_span.name == "library" and lib_span.attrs["lib"] == "native"
    assert rec.summary()["counters"].get("library.builds", 0) == int(
        lib_span.attrs["built"])
    assert lib is native.get_lib()


def test_recomputed_bounces_fall_inside_backward(scene):
    lin = torch.arange(12)
    xs, ys = lin % 8, lin // 8
    step = make_train_step(scene, 1, lr=0.05, device="cpu",
                           leaves=("mat_albedo",))
    with tracing.recording() as rec:
        step(get_params(scene), torch.full((12, 3), 0.5), xs, ys, prng_key(1))
    by_id = _by_id(rec)
    spans = list(by_id.values())
    back, = [s for s in spans if s.name == "train.backward"]
    recomputed = [s for s in spans if back.start <= s.start < back.end
                  and s is not back and s.name != "wait.backward"]
    assert {"rng", "closest_hit", "nee"} <= {s.name for s in recomputed}
    assert all(back in _ancestors(s, by_id) for s in recomputed)
    assert rec.summary()["orphans"] == 0
    assert {"train.step", "train.forward", "wait.forward", "train.update",
            "bounce"} <= set(rec.summary()["spans"])
