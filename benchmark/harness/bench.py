"""One run of one cell: set-up, the measured window, the trace readings and
the check against the plain reference; prints the result line.

Set-up writes the configuration's meshes and scene file into the work
directory (once per checkout), loads the scene through the program, and
renders one warm pass of the cell's own shape.  The window then renders
passes back to back, each under a key folded from the seed and the pass
index, until ``--seconds`` have passed, and ends with a synchronise.  A
cell over several GPUs is started as users start one, under ``torchrun``
(``python -m torch.distributed.run --standalone``); its rank 0 writes the
result, which the starting process prints.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "simplepath_tpu")
# a traffic mix's ``chunk_rays``: the whole frame (each rank's block of it)
# as one wavefront; null is the program's default chunk, as the CLI renders
WHOLE_FRAME = "frame"
BYTES_PER_GB = 1e9
# the whole of a run over several GPUs, the ranks' first-run builds included
RANKS_TIMEOUT_S = 1150


def log(started: float, what: str) -> None:
    print(f"[{time.time() - started:8.2f} s] {what}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Refused(Exception):
    """A run that may print no result: JAX or the JAX package was loaded."""

    def __init__(self, held: dict):
        super().__init__("modules of JAX or the JAX package are loaded: " + "; ".join(
            f"rank {r}: {mods}" for r, mods in sorted(held.items())))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the starting process for the ranks of a cell over several GPUs
    ap.add_argument("--rank-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--started", type=float, help=argparse.SUPPRESS)
    ap.add_argument("--result", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(spec.WORK, "cache", sub)


def prepare(cfg: dict) -> tuple[str, str]:
    """The configuration's meshes and scene file in its work directory →
    (scene path, mesh directory)."""
    from . import meshgen

    d = os.path.join(spec.WORK, cfg["name"])
    os.makedirs(d, exist_ok=True)
    for fname, mesh in cfg["meshes"].items():
        meshgen.write_mesh(mesh, os.path.join(d, fname))
    path = os.path.join(d, cfg["scene_file"])
    if not os.path.exists(path) or open(path).read() != cfg["scene_text"]:
        with open(path + ".tmp", "w") as f:
            f.write(cfg["scene_text"])
        os.replace(path + ".tmp", path)
    return path, d


def run_cell(args, c: dict, started: float, device=None) -> dict | None:
    """Set-up, window, trace and check in this process (a rank of a cell
    over several GPUs, or the one process of a one-GPU cell) → the result
    (rank 0) or None.  ``device`` None is the cell's GPU; the CPU tests
    pass the CPU, where nothing is timed on a device."""
    import torch
    import torch.distributed as dist

    from . import check, trace as tr
    from simplepath_tpu_torch import load_scene
    from simplepath_tpu_torch.render import cuda_traverse

    cfg, traffic = c["config_spec"], c["traffic_spec"]
    world = c["chips"]
    if world > 1:
        from simplepath_tpu_torch.parallel import multihost
        device = multihost.init_distributed(device=device)
        rank = dist.get_rank()
        gloo = dist.new_group(backend="gloo")
        first = multihost.rank_zero_first(gloo, multihost.DEFAULT_TIMEOUT)
    else:
        import contextlib
        device = torch.device("cuda", 0) if device is None else torch.device(device)
        rank, first = 0, contextlib.nullcontext()
    on_gpu = device.type == "cuda"
    if on_gpu:
        torch.cuda.set_device(device)

    def sync():
        if on_gpu:
            torch.cuda.synchronize(device)

    def peak_bytes():
        return torch.cuda.max_memory_allocated(device) if on_gpu else 0
    spp = traffic["spp"]

    with first:
        path, mesh_dir = prepare(cfg)
        t0 = time.time()
        scene = load_scene(path, device=device)
        sync()
        load_s = time.time() - t0
    log(started, f"scene loaded in {load_s:.2f} s")
    w, h = scene.static.width, scene.static.height
    chunk = w * h // world if traffic["chunk_rays"] == WHOLE_FRAME else traffic["chunk_rays"]
    if world > 1:
        render_frame = lambda key: multihost.render_image_multihost(
            scene, spp, key, chunk_rays=chunk, device=device)
    else:
        from simplepath_tpu_torch.parallel.mesh import render_image_sharded
        render_frame = lambda key: render_image_sharded(
            scene, spp, key, chunk_rays=chunk, device=device)
    chk = c["check"]
    plan = check.sample_plan(args.seed, w * h, chk["pixels_per_pass"], device)
    keys = check.frame_keys(args.seed, check.MAX_PASSES, device)
    render_frame(check.warm_key(device)).sum().item()
    sync()
    setup_peak = peak_bytes()
    if on_gpu:
        torch.cuda.reset_peak_memory_stats(device)
    if world > 1:
        dist.barrier()

    samples, passes = [], 0
    readings = bd = None

    ends = []

    def one_pass():
        nonlocal passes
        img = render_frame(keys[passes])
        samples.append(img.reshape(-1, 3)[plan[passes]])
        passes += 1
        ends.append(time.time())

    w0 = time.time()
    setup_s = w0 - started
    log(started, f"set-up done: {setup_s:.2f} s")
    if args.trace:
        # pass 0 unprofiled, for its wall; pass 1 profiled for the device's
        # numbers, pass 2 for the names of the host's ops
        sync()
        p0 = time.time()
        one_pass()
        sync()
        pass_s = time.time() - p0
        keep = c["trace"]["roofline_calls"] if rank == 0 else []
        with tr.profiled(host_ops=False) as prof:
            with tr.CallSampler(cuda_traverse, keep) as sampler:
                sync()
                p0 = time.time()
                one_pass()
                sync()
                p1 = time.time()
        readings = tr.device_readings(tr.events(prof, os.path.join(
            spec.WORK, f"trace.{c['name']}.{rank}.json")), p1 - p0)
        with tr.profiled(host_ops=True) as prof:
            one_pass()
        bd = tr.breakdown(tr.events(prof, os.path.join(
            spec.WORK, f"trace.{c['name']}.{rank}.json")))
        prof = None
    while True:
        stop = (time.time() - w0 >= args.seconds) or passes == check.MAX_PASSES
        if world > 1:
            flag = torch.tensor([int(stop)], device=device)
            dist.broadcast(flag, 0)
            stop = bool(flag.item())
        if stop:
            break
        one_pass()
    sync()
    w1 = time.time()
    peak = peak_bytes()
    log(started, f"window closed: {passes} passes in {w1 - w0:.2f} s; pass ends "
        f"{[round(t - w0, 3) for t in ends]}")

    if readings is not None:
        readings.update(load_s=load_s, ranks=world, pass_s=pass_s,
                        paths_profiled=w * h * spp / world)
        readings["traversal_calls"] = traversal_calls(sampler, readings)
        sampler = None
        log(started, "trace read")
    mine = dict(peak=max(peak, setup_peak), window_peak=peak, readings=readings,
                kind=torch.cuda.get_device_name(device) if on_gpu else "cpu",
                forbidden=forbidden_modules())
    everyone = [mine]
    if world > 1:
        everyone = [None] * world
        dist.all_gather_object(everyone, mine, group=gloo)
    program = torch.cat(samples).cpu() if rank == 0 else None
    del samples, scene, render_frame
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    if world > 1:
        dist.barrier(group=gloo)
        dist.destroy_process_group()
        if rank != 0:
            return None
    # every rank's modules once the window has closed (this one's again at
    # the end, in the process that writes or prints the result)
    held = {r: e["forbidden"] for r, e in enumerate(everyone) if e["forbidden"]}
    if held:
        raise Refused(held)

    ref = check.reference_pixels(cfg["scene_text"], mesh_dir, spp, args.seed,
                                 plan, passes, device)
    numbers = check.compare(program, ref, chk["rel"], chk["abs"])
    log(started, f"reference compared: {numbers}")
    e2e = dict(setup_s=setup_s, paths_per_s=passes * w * h * spp / (w1 - w0),
               peak_mem_gb=max(e["window_peak"] for e in everyone) / BYTES_PER_GB)
    device_info = {"platform": "gpu" if on_gpu else "cpu", "kind": mine["kind"],
                   "count": world, "memory_peak_bytes": max(e["peak"] for e in everyone)}
    return finish(args, c, numbers, passes, e2e, readings, bd, device_info,
                  [e["readings"] for e in everyone if e["readings"]])


def run_train_cell(args, c: dict, started: float, device=None) -> dict:
    """A train cell in this process: set-up builds the step and drives it
    through its first ``checked_steps`` steps (the steps the reference
    follows), keeping the first step's own forward radiance of a sample of
    pixels; the window runs the same step on, and the reference then
    follows the first steps from the configuration's own albedo."""
    import contextlib

    import torch

    from . import check, trace as tr
    from simplepath_tpu_torch import load_scene
    from simplepath_tpu_torch.diff import grad as grad_module
    from simplepath_tpu_torch.diff.grad import get_params, make_train_step, render_loss

    cfg, traffic = c["config_spec"], c["traffic_spec"]
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    on_gpu = device.type == "cuda"
    if on_gpu:
        torch.cuda.set_device(device)
    sync = torch.cuda.synchronize if on_gpu else (lambda *a: None)
    spp, leaves, lr = traffic["spp"], tuple(traffic["leaves"]), traffic["lr"]
    checked = c["check"]["checked_steps"]

    path, mesh_dir = prepare(cfg)
    t0 = time.time()
    scene = load_scene(path, device=device)
    sync()
    load_s = time.time() - t0
    log(started, f"scene loaded in {load_s:.2f} s")
    w, h = scene.static.width, scene.static.height
    lin = torch.arange(w * h, device=device)
    xs, ys = lin % w, lin // w
    target = check.train_target(args.seed, w * h, device)
    keys = check.frame_keys(args.seed, check.MAX_PASSES, device)
    pixels = check.sample_plan(args.seed, w * h, c["check"]["pixels"], device)[0]
    step = make_train_step(scene, spp, lr=lr, device=device, leaves=leaves)
    params = get_params(scene)
    states, losses = [], []
    with check.FirstRender(grad_module, pixels) as first:
        for t in range(checked):
            params, loss = step(params, target, xs, ys, keys[t])
            losses.append(float(loss))
            states.append(params["mat_albedo"].detach().clone())
    sync()
    setup_peak = torch.cuda.max_memory_allocated(device) if on_gpu else 0
    if on_gpu:
        torch.cuda.reset_peak_memory_stats(device)

    steps, readings, bd = 0, None, None
    w0 = time.time()
    setup_s = w0 - started
    log(started, f"set-up done: {setup_s:.2f} s (losses {losses})")

    def one_step():
        nonlocal params, steps
        params, _ = step(params, target, xs, ys, keys[checked + steps])
        steps += 1

    if args.trace:
        sync()
        p0 = time.time()
        one_step()
        sync()
        step_s = time.time() - p0
        p0 = time.time()
        with torch.no_grad():
            float(render_loss(scene, params, target, xs, ys, spp, keys[checked + steps],
                              device=device))
        sync()
        forward_s = time.time() - p0
        with tr.profiled(host_ops=False) as prof:
            one_step()
        readings = tr.device_readings(tr.events(prof, os.path.join(
            spec.WORK, f"trace.{c['name']}.json")), step_s)
        with tr.profiled(host_ops=True) as prof:
            one_step()
        bd = tr.breakdown(tr.events(prof, os.path.join(spec.WORK, f"trace.{c['name']}.json")))
        prof = None
        readings.update(load_s=load_s, ranks=1, pass_s=step_s, forward_s=forward_s)
    while time.time() - w0 < args.seconds and checked + steps < check.MAX_PASSES:
        one_step()
    sync()
    w1 = time.time()
    peak = torch.cuda.max_memory_allocated(device) if on_gpu else 0
    log(started, f"window closed: {steps} steps in {w1 - w0:.2f} s")
    kind = torch.cuda.get_device_name(device) if on_gpu else "cpu"
    del scene, step, params, xs, ys, lin
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()

    ref = check.reference_train(cfg["scene_text"], mesh_dir, spp, args.seed, target,
                                checked, lr, device, pixels=pixels)
    numbers = check.compare_train(dict(losses=losses, albedo=states, pixels=first.kept),
                                  ref, lr, c["check"])
    log(started, f"reference compared: {numbers}")
    e2e = dict(setup_s=setup_s, train_step_s=(w1 - w0) / max(steps, 1),
               peak_mem_gb=peak / BYTES_PER_GB)
    return finish(args, c, numbers, steps, e2e, readings, bd,
                  dict(platform="gpu" if on_gpu else "cpu", kind=kind, count=1,
                       memory_peak_bytes=max(peak, setup_peak)),
                  [readings] if readings else [])


def finish(args, c, numbers, attempted, e2e, readings, bd, device_info, rank_readings):
    """The result line of a run: its metrics found by name in BENCHMARK.json."""
    limits = c["check"]["limits"]
    bench = spec.benchmark()
    if args.trace:
        metrics = {}
        for m in spec.per_layer(bench, c["name"]):
            v = spec.reader(m["name"])(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        n = len(rank_readings)
        device_info["busy_s"] = sum(r["busy_s"] for r in rank_readings) / n
        device_info["window_s"] = sum(r["window_s"] for r in rank_readings) / n
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(bench, c["name"])}
    out = {"correct": all(numbers[k] <= v for k, v in limits.items()),
           "attempted": attempted, "failed": 0, "metrics": metrics,
           "device": device_info}
    if args.trace:
        out["breakdown"] = bd
    out["check"] = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    return out


def traversal_calls(sampler, readings: dict) -> list:
    """(bound s, device s) of the kept traversal calls, each matched by its
    order to its kernel in the profile; none where the counts disagree."""
    from simplepath_tpu_torch.scene import bvh

    from . import work

    times = {"closest": readings["closest_s"], "anyhit": readings["anyhit_s"]}
    if any(len(times[k]) < n for k, n in sampler.calls.items()):
        return []
    out = []
    for kind, i, records, ro, rd, t_min, t_max in sampler.kept:
        wk = work.call_work(records, ro, rd, t_min, t_max, kind == "anyhit",
                            bvh.WIDTH, bvh.LEAF_SIZE)
        out.append(dict(kind=kind, call=i, bound_s=wk["bound_s"],
                        device_s=times[kind][i], bound_by=wk["bound_by"],
                        rays=wk["rays"]))
    sampler.kept.clear()
    return out


def refuse(e: Refused) -> int:
    print(e, file=sys.stderr)
    return 5


def emit(out: dict) -> int:
    """Print the result line and the compared numbers; refuse a process
    that holds JAX or the JAX package."""
    bad = forbidden_modules()
    if bad:
        return refuse(Refused({0: bad}))
    print(json.dumps(out), flush=True)
    for k, v in out["check"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


def start_ranks(args, c: dict, started: float) -> int:
    """Start the cell's ranks under torchrun and print rank 0's result."""
    from simplepath_tpu_torch.parallel.launch import RanksFailed, run_processes

    d = os.path.join(spec.WORK, "ranks")
    os.makedirs(d, exist_ok=True)
    result = os.path.join(d, f"{c['name']}.result.json")
    if os.path.exists(result):
        os.remove(result)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={c['chips']}",
           os.path.join(spec.HERE, "run.py"), "--rank-worker",
           "--started", repr(started), "--result", result,
           "--workload", args.workload, "--seed", str(args.seed),
           "--seconds", repr(args.seconds), "--trace", str(args.trace)]
    try:
        logs = run_processes([cmd], None, d, RANKS_TIMEOUT_S, names=[c["name"]])
    except RanksFailed as e:
        print(e, file=sys.stderr)
        return 6
    print(logs[0][-4000:], file=sys.stderr)
    with open(result) as f:
        out = json.load(f)
    os.remove(result)
    return emit(out)


def main(argv=None, started: float | None = None) -> int:
    started = time.time() if started is None else started
    args = parse(argv)
    cache_env()
    c = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < c["chips"]:
        print(f"{c['name']} needs {c['chips']} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if c["chips"] > 1 and not args.rank_worker:
        return start_ranks(args, c, started)
    if c["traffic_spec"]["entry"] == "make_train_step":
        return emit(run_train_cell(args, c, started))
    if args.rank_worker:
        return rank_worker(args, c)
    try:
        return emit(run_cell(args, c, started))
    except Refused as e:
        return refuse(e)


def rank_worker(args, c: dict, device=None) -> int:
    """A rank of a cell over several GPUs: rank 0 writes the result for the
    starting process to print, unless a rank holds JAX or the JAX package."""
    try:
        out = run_cell(args, c, args.started, device)
    except Refused as e:
        return refuse(e)
    if out is not None:
        bad = forbidden_modules()
        if bad:
            return refuse(Refused({0: bad}))
        with open(args.result + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(args.result + ".tmp", args.result)
    return 0
