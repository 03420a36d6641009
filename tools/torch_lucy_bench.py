#!/usr/bin/env python3
"""The lucy-class stress scene end to end on the GPU: record-table
statistics and the full 1350x2000 frame — the port's counterpart of
tools/lucy_bench.py.

    python3 tools/torch_make_lucy_scene.py     # first: the 28.9M-triangle PLY
    python3 tools/torch_lucy_bench.py [--spp 4]

Loads scenes/lucy_bench.sp with ``load_scene`` on the card (cold: the BVH
built and cached in scenes/.spcache/; warm: served from there), prints the
record table's statistics (rows, bytes, leaves and their mean occupancy,
the tree depth and the stack slots it needs against the kernels'), then
renders the frame through ``render_image_sharded`` at --spp samples and
prints its seconds, camera paths/s, film mean, the launches of each
traversal kernel and the peak device memory, beside the card's name and
power limit.  Needs one CUDA device; imports nothing of JAX.

The BVH topologies on lucy's table, each in a process of its own (the
topology is read at import; the geometry cache is off, so each builds its
table cold):

    python3 tools/torch_lucy_bench.py --topologies w8_k12,w16_k12,w8_k24

The processes start together and build the traversal library anew at their
topology (ptxas's registers and spills of each kernel) and load the scene
side by side; then, one at a time on the card, each holds sp_closest and
sp_anyhit against their plain versions on 65,536 primary rays with 0
mismatches and times both (``chip_smoke.compare_case``: device ms by
``time_cuda``, plain ms, rows visited and the bound from
``traversal_work``), and renders the 1-spp frame through
``render_image_sharded`` into ``--out``/<topology>.pfm with each kernel's
launches.  Each other topology's frame is held to the first's: max abs
diff <= 1e-4.  Where frames differ, the TRACE_PIXELS pixels that differ
most are rendered again in every process with each kernel call kept, the
first call whose answer differs between the topologies is found, and its
ray is held against every triangle of the scene in float64 by the first
process.  One JSON line a topology, one for the traced pixels; exit 1 if
any process or check failed.  ``--platform cpu --scene S`` rehearses it on
the CPU through the plain versions (no times).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SCENE = os.path.join(ROOT, "scenes", "lucy_bench.sp")
TOPOLOGY_OUT = os.path.join(ROOT, "chip_smoke_out", "lucy_topology")
TOPOLOGY_TIMEOUT_S = 900
FRAME_TOL = 1e-4            # chip_smoke.py's topology phase on the bench
# ptxas's names of the two kernels (chip_smoke.ptxas_summary)
PTXAS_NAMES = {"closest": "traverse_kernel<0,0>", "anyhit": "traverse_kernel<1,0>"}
TRACE_PIXELS = 32           # of the pixels that differ, those traced
NEAREST = 3                 # hits of a brute-forced ray, nearest first
VERTEX_FIELDS = ("v0x", "v0y", "v0z", "v1x", "v1y", "v1z", "v2x", "v2y", "v2z")


def print_table(stats: dict) -> None:
    print(f"record rows {stats['rows']:,} ({stats['bytes'] / 1e9:.2f} GB); "
          f"leaf rows {stats['leaves']:,}; mean leaf occupancy "
          f"{stats['mean_leaf_occupancy']:.2f}/{stats['leaf_size']}; depth "
          f"{stats['depth']}, stack slots needed {stats['stack_needed']} of "
          f"{stats['kernel_stack']}", flush=True)


def wait_for(path: str, proc=None, timeout: float = TOPOLOGY_TIMEOUT_S) -> None:
    """Wait until ``path`` exists; raise if ``proc`` exits first or the
    time runs out."""
    t0 = time.time()
    while not os.path.exists(path):
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"the process exited ({proc.returncode}) "
                               f"before writing {os.path.basename(path)}")
        if time.time() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)


def touch(path: str) -> None:
    open(path, "w").close()


def publish(path: str, write) -> None:
    """``write(file)`` into a file of its own, then moved to ``path``: the
    other process reads ``path`` as soon as it exists."""
    with open(path + ".tmp", "wb") as f:
        write(f)
    os.replace(path + ".tmp", path)


def tri_keys(scene, idx: torch.Tensor) -> torch.Tensor:
    """The vertices of triangles ``idx`` ([N, 9]; zeros for -1): what names
    a triangle whatever order a topology's table keeps it in."""
    tr = scene.triangles
    i = idx.clamp(min=0).long()
    keys = torch.stack([getattr(tr, f)[i] for f in VERTEX_FIELDS], 1)
    return torch.where((idx >= 0)[:, None], keys, 0.0)


def trace_pixels(scene, xs, ys) -> tuple:
    """The pixels at 1 spp under the frame's key, with every call of the
    two wrappers kept: its rays and, for sp_closest, t and the hit
    triangle's vertices, for sp_anyhit the occlusion → (radiance, calls).
    Fewer rays than the coherence sort takes, so each call's rays stay in
    pixel order."""
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.render.film import render_rays

    calls = []
    originals = {name: getattr(ct, name) for name in ("closest", "anyhit")}

    def keeping(name):
        def wrapped(records, ro, rd, t_min, t_max):
            out = originals[name](records, ro, rd, t_min, t_max)
            kept = dict(ro=ro, rd=rd, t_min=t_min, t_max=t_max)
            if name == "closest":
                kept.update(t=out[0], key=tri_keys(
                    scene, torch.where(out[4], out[1], -1)))
            else:
                kept.update(occluded=out)
            calls.append((name, {k: v.cpu().numpy() for k, v in kept.items()}))
            return out
        return wrapped

    for name in originals:
        setattr(ct, name, keeping(name))
    try:
        radiance = render_rays(scene, xs, ys, 1, prng_key(0, scene.device),
                               device=scene.device)
    finally:
        for name, fn in originals.items():
            setattr(ct, name, fn)
    return radiance.cpu().numpy(), calls


def brute_force(scene, rays: dict) -> list:
    """Each ray against every triangle of the scene, in float64 and without
    a BVH, by the traversal's rule (barycentrics strictly inside, t in
    [t_min, t_max]) → for each ray the NEAREST nearest hits (t, the
    triangle's vertices)."""
    tr = scene.triangles
    v = [getattr(tr, f).double() for f in VERTEX_FIELDS]
    v0 = torch.stack(v[0:3], 1)
    e1, e2 = torch.stack(v[3:6], 1) - v0, torch.stack(v[6:9], 1) - v0
    out = []
    for i in range(rays["ro"].shape[0]):
        ro, rd = (torch.from_numpy(rays[k][i]).double().to(v0.device)
                  for k in ("ro", "rd"))
        p = torch.cross(rd.expand_as(e2), e2, dim=1)
        det = (e1 * p).sum(1)
        inv = 1.0 / torch.where(det == 0.0, 1.0, det)
        s = ro - v0
        b = (s * p).sum(1) * inv
        q = torch.cross(s, e1, dim=1)
        g = (rd * q).sum(1) * inv
        t = (e2 * q).sum(1) * inv
        ok = ((det != 0.0) & (b > 0) & (g > 0) & (b + g < 1)
              & (t >= float(rays["t_min"][i])) & (t <= float(rays["t_max"][i])))
        t = torch.where(ok, t, float("inf"))
        near = torch.topk(t, min(NEAREST, t.numel()), largest=False)
        out.append([(float(tt), [float(x) for x in torch.cat([v0[j], v0[j] + e1[j], v0[j] + e2[j]])])
                    for tt, j in zip(near.values, near.indices) if tt < float("inf")])
    return out


def topology_run(args) -> None:
    """One topology's process (module docstring), in step with the parent
    through files in ``--out``: it builds and loads, waits for its turn
    (``<topology>.go``), holds and times both kernels and renders the
    frame, then traces the pixels the parent names (``trace_pixels.npy``;
    ``no_trace``: none) and, with ``--brute-force``, answers the parent's
    rays against every triangle (``brute_rays.npz`` → ``brute.json``)."""
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.device import resolve_device
    from simplepath_tpu_torch.io.pfm import write_image
    from simplepath_tpu_torch.parallel.mesh import render_image_sharded
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.scene import bvh

    dev = resolve_device(args.platform)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    name = f"w{bvh.WIDTH}_k{bvh.LEAF_SIZE}"
    at = lambda f: os.path.join(args.out, f)
    res = dict(topology=name, width=bvh.WIDTH, leaf_size=bvh.LEAF_SIZE,
               device=str(dev))
    if cuda:
        t0 = time.time()
        ptxas = cs.ptxas_summary(ct._compile_source(
            ct.KERNEL_SOURCE, ct.library_path(), verbose=True).splitlines())
        ct._library()
        res.update(card=cs.nvidia_smi_line(), build_s=time.time() - t0,
                   ptxas={k: ptxas[v] for k, v in PTXAS_NAMES.items()})
    t0 = time.time()
    scene = sp.load_scene(args.scene, device=dev)
    sync()
    res.update(load_s=time.time() - t0, triangles=scene.static.num_triangles,
               host_peak_rss_bytes=cs.host_peak_rss(),
               **bvh.table_stats(scene.bvh.records.cpu().numpy()))
    touch(at(f"{name}.ready"))
    wait_for(at(f"{name}.go"))
    rays = cs.primary_rays(scene)
    res["kernels"] = [cs.compare_case(kernel, "primary", scene.bvh.records,
                                      rays) for kernel in ("closest", "anyhit")]
    del rays
    ct.reset_launch_counts()
    t0 = time.time()
    img = render_image_sharded(scene, 1, prng_key(0, dev), device=dev)
    img = img.cpu().numpy()             # waits for the device
    res.update(frame_s=time.time() - t0, launches=dict(ct.launch_counts),
               frame_mean=float(img.mean()))
    if cuda and min(res["launches"].values()) <= 0:
        raise AssertionError(f"the frame launched no kernel: {res['launches']}")
    write_image(at(f"{name}.pfm"), img)
    publish(at(f"{name}.json"), lambda f: f.write(json.dumps(res).encode()))

    while not os.path.exists(at("no_trace")):
        if os.path.exists(at("trace_pixels.npy")):
            xy = torch.from_numpy(np.load(at("trace_pixels.npy"))).to(dev)
            radiance, calls = trace_pixels(scene, xy[:, 0], xy[:, 1])
            publish(at(f"{name}_trace.npz"), lambda f: np.savez(
                f, radiance=radiance, kinds=np.array([k for k, _ in calls]),
                **{f"{i}_{k}": v for i, (_, c) in enumerate(calls)
                   for k, v in c.items()}))
            break
        time.sleep(0.05)
    touch(at(f"{name}.traced"))
    if args.brute_force:
        while not os.path.exists(at("no_brute")):
            if os.path.exists(at("brute_rays.npz")):
                with np.load(at("brute_rays.npz")) as z:
                    nearest = brute_force(scene, {k: z[k] for k in z.files})
                publish(at("brute.json"),
                        lambda f: f.write(json.dumps(nearest).encode()))
                break
            time.sleep(0.05)


def load_trace(path: str) -> tuple:
    with np.load(path) as z:
        kinds = list(z["kinds"])
        calls = [{k.split("_", 1)[1]: z[k] for k in z.files
                  if k.split("_", 1)[0] == str(i)} for i in range(len(kinds))]
        return z["radiance"], kinds, calls


def first_divergence(traces: dict, ray: int) -> dict | None:
    """The first call whose answer for ``ray`` differs between the
    topologies' traces (their rays still equal there) → what each answered,
    or None."""
    names = list(traces)
    kinds = [traces[n][1] for n in names]
    bounce = 0
    for c in range(min(len(k) for k in kinds)):
        kind = kinds[0][c]
        if any(k[c] != kind for k in kinds):
            return dict(call=c, kind="the topologies call the kernels in "
                        "another order")
        calls = [traces[n][2][c] for n in names]
        ray_in = {k: calls[0][k][ray] for k in ("ro", "rd", "t_min", "t_max")}
        fields = ("t", "key") if kind == "closest" else ("occluded",)
        answers = [tuple(np.asarray(x[f][ray]).tobytes() for f in fields)
                   for x in calls]
        if len(set(answers)) > 1:
            same_rays = all(np.array_equal(x[k][ray], v, equal_nan=True)
                            for x in calls for k, v in ray_in.items())
            return dict(call=c, kind=kind, bounce=bounce, rays_equal=same_rays,
                        ray={k: v.tolist() for k, v in ray_in.items()},
                        answers={n: {f: x[f][ray].tolist() for f in fields}
                                 for n, x in zip(names, calls)})
        bounce += kind == "closest"
    return None


def topologies(args) -> int:
    """Every topology of ``--topologies`` in a process of its own (started
    together, loading side by side; then on the card one at a time), each
    frame held to the first's; the pixels that differ traced in every
    topology, and the first ray whose answer differs held against every
    triangle."""
    from simplepath_tpu_torch.io.pfm import read_pfm

    names = args.topologies.split(",")
    unknown = [n for n in names if n not in cs.TOPOLOGIES]
    if unknown:
        raise SystemExit(f"unknown topologies {unknown}; known: "
                         f"{sorted(cs.TOPOLOGIES)}")
    if args.platform is None:
        print(f"card: {cs.nvidia_smi_line()}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    at = lambda f: os.path.join(args.out, f)
    # an earlier run's hand-offs would pass for this run's
    for f in [n + ext for n in names for ext in (".ready", ".go", ".json",
                                                 ".traced", "_trace.npz")] \
            + ["trace_pixels.npy", "no_trace", "brute_rays.npz", "brute.json",
               "no_brute"]:
        if os.path.exists(at(f)):
            os.remove(at(f))
    procs, logs = {}, {}
    for i, name in enumerate(names):
        cmd = [sys.executable, os.path.abspath(__file__), "--topology-run",
               "--scene", args.scene, "--out", args.out]
        if args.platform:
            cmd += ["--platform", args.platform]
        if i == 0:
            cmd.append("--brute-force")
        logs[name] = open(at(f"{name}.log"), "w")
        procs[name] = subprocess.Popen(
            cmd, env=dict(os.environ, SIMPLEPATH_CACHE="0",
                          **cs.TOPOLOGIES[name]),
            stdout=logs[name], stderr=subprocess.STDOUT)
    failed, frames, results = [], {}, {}
    try:
        for name in names:
            t0 = time.time()
            wait_for(at(f"{name}.ready"), procs[name])
            touch(at(f"{name}.go"))
            wait_for(at(f"{name}.json"), procs[name])
            with open(at(f"{name}.json")) as f:
                results[name] = json.load(f)
            frames[name] = torch.from_numpy(np.ascontiguousarray(
                read_pfm(at(f"{name}.pfm"))))
            held = cs.held_against(frames[name], frames[names[0]])
            results[name].update(
                ok=held["max_abs_diff"] <= FRAME_TOL, turn_s=time.time() - t0,
                frame_held_to=names[0], frame_max_abs_diff=held["max_abs_diff"],
                frame_against=held)
            if not results[name]["ok"]:
                failed.append(name)
            print(json.dumps(results[name]), flush=True)
        diff = torch.stack([(frames[n] - frames[names[0]]).abs().amax(dim=2)
                            for n in names]).amax(dim=0)
        order = torch.argsort(diff.reshape(-1), descending=True)
        order = order[:int((diff > FRAME_TOL).sum().clamp(max=TRACE_PIXELS))]
        w = diff.shape[1]
        if order.numel() == 0:
            touch(at("no_trace"))
        else:
            publish(at("trace_pixels.npy"), lambda f: np.save(
                f, torch.stack([order % w, order // w], 1).numpy()))
        for name in names:
            wait_for(at(f"{name}.traced"), procs[name])
        if order.numel():
            traces = {n: load_trace(at(f"{n}_trace.npz")) for n in names}
            pixels = []
            for r, lin in enumerate(order.tolist()):
                x, y = lin % w, lin // w
                pixels.append(dict(
                    x=x, y=y, frame={n: frames[n][y, x].tolist() for n in names},
                    traced={n: traces[n][0][r].tolist() for n in names},
                    diverges=first_divergence(traces, r)))
            rays = [p["diverges"]["ray"] for p in pixels
                    if p["diverges"] and "ray" in p["diverges"]]
            if rays:
                publish(at("brute_rays.npz"), lambda f: np.savez(
                    f, **{k: np.array([r[k] for r in rays], np.float32)
                          for k in ("ro", "rd", "t_min", "t_max")}))
                wait_for(at("brute.json"), procs[names[0]])
                with open(at("brute.json")) as f:
                    nearest = iter(json.load(f))
                for p in pixels:
                    if p["diverges"] and "ray" in p["diverges"]:
                        p["diverges"]["nearest_hits_float64"] = next(nearest)
            else:
                touch(at("no_brute"))
            print(json.dumps({"differing_pixels": int((diff > FRAME_TOL).sum()),
                              "traced": pixels}), flush=True)
        else:
            touch(at("no_brute"))
        for name, proc in procs.items():
            if proc.wait(timeout=TOPOLOGY_TIMEOUT_S) != 0:
                raise RuntimeError(f"{name}'s process exited {proc.returncode}")
    except Exception as e:                      # its log says the rest
        failed.append(f"{type(e).__name__}: {e}")
        for name, log in logs.items():
            log.flush()
            with open(at(f"{name}.log")) as f:
                print(f"--- {name}:\n{f.read()[-3000:]}", flush=True)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs.values():
            log.close()
    print(json.dumps({"lucy_topologies": {"ok": not failed, "failed": failed}}),
          flush=True)
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--topologies", default=None,
                    help="comma-separated topologies of chip_smoke.TOPOLOGIES "
                         "(e.g. w8_k12,w16_k12,w8_k24): the kernels and the "
                         "1-spp frame at each, in fresh processes")
    ap.add_argument("--scene", default=SCENE)
    ap.add_argument("--out", default=TOPOLOGY_OUT)
    ap.add_argument("--platform", default=None,
                    help="torch device (default: cuda); cpu rehearses the "
                         "topologies through the plain versions")
    ap.add_argument("--topology-run", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--brute-force", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.scene = os.path.abspath(args.scene)
    args.out = os.path.abspath(args.out)
    if args.platform is None and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.topology_run:
        topology_run(args)
        return 0
    if args.topologies:
        return topologies(args)
    import simplepath_tpu_torch as sp
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.parallel.mesh import render_image_sharded
    from simplepath_tpu_torch.render import cuda_traverse as ct
    from simplepath_tpu_torch.scene import bvh, cache

    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    t0 = time.time()
    scene = sp.load_scene(args.scene)
    torch.cuda.synchronize()
    load = "warm" if cache.LAST_HIT else "cold"
    print(f"load ({load}) {time.time() - t0:.1f}s; tris "
          f"{scene.static.num_triangles:,}; host peak "
          f"{cs.host_peak_rss() / 1e9:.1f} GB", flush=True)
    print_table(bvh.table_stats(scene.bvh.records.cpu().numpy()))

    st = scene.static
    torch.cuda.reset_peak_memory_stats()
    ct.reset_launch_counts()
    t0 = time.time()
    img = render_image_sharded(scene, args.spp, prng_key(0))
    torch.cuda.synchronize()
    render_s = time.time() - t0
    launches = dict(ct.launch_counts)
    paths = st.width * st.height * args.spp
    print(f"render {st.width}x{st.height} @ {args.spp}spp: {render_s:.2f}s "
          f"({paths / render_s / 1e3:.1f}k camera paths/s on one card); "
          f"mean {float(img.mean()):.5f}; launches {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0:
        raise AssertionError("the frame is not finite and positive")
    return 0


if __name__ == "__main__":
    sys.exit(main())
