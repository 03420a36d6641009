#!/usr/bin/env python3
"""The port's multi-GPU path on every GPU of one host: one rank a GPU, over
NCCL, through the port's entry points, each part held against the same job
on one GPU in the same run.

    python3 tools/torch_multichip.py                  # every part, every GPU
    python3 tools/torch_multichip.py --parts dryrun   # the short first check
    python3 tools/torch_multichip.py --world 4 --backend gloo --parts rays
                                                      # four ranks sharing GPUs
    python3 tools/torch_multichip.py --parts hosts    # two hosts of two GPUs

First it prints every GPU's name and power limit (nvidia-smi), the device
count, the torch, CUDA and NCCL versions, the host's memory and the NCCL_*
variables of the run (its own, and those the hosts part sets); then one
JSON line a part, in this order:

  dryrun  entry.dryrun_multichip(world): a train step over the ranks, the
          2 x (world/2) rays x geometry grid's render and its gradient,
          each against one process
  rays    the bench (scenes/bunny_bench.sp, 1024x1024, depth 10, flagship)
          at 4 spp through the CLI, rays over the ranks (torchrun), against
          the CLI on one GPU: rank 0's PFM equal to one GPU's bit for bit;
          frame seconds in turns (one GPU, ranks, ranks, one GPU)
  geom    the bench at 1 spp with --geom-shards 4 over the ranks (one shard
          a GPU at world 4): bit-equal to the one-process forest of 4, and
          within 1e-4 of the one-BVH frame; seconds in turns with the
          one-process forest
  grid    the 2 x (world/2) grid on the bench (ranks of this script under
          torchrun): render_image_geom_sharded at 1 spp within 1e-4 of the
          one-BVH frame, and one train_step_multihost over the grid held to
          the one-GPU step as tests/test_geom_shard.py:244 holds it (loss
          rtol 1e-4; the albedo's update rtol 0.05 / atol 1e-6)
  train   chip_smoke.py's 65,536-pixel albedo step over the ranks against
          one GPU: loss and albedo within rtol / atol 1e-5
  hosts   the ranks as two hosts that share no file system: two torchrun
          node groups (--nnodes 2, a static rendezvous on 127.0.0.1) of
          world/2 ranks, node 1 on the upper half of the GPUs, each node on
          its own copy of the scene and of the package (no cache, no build,
          no checkpoint in common), NCCL kept off its peer-to-peer and
          shared-memory transports so that it takes its network transport
          (HOSTS_NCCL_ENV; the transport NCCL reports is quoted); on the
          bench: rays at 1 spp, rank 0's PFM bit-equal to one GPU's, frame
          seconds in turns (one GPU, the nodes cold, the nodes warm, one
          GPU); --geom-shards 4 over the nodes, bit-equal to the
          one-process forest of 4; a 2-spp render in 1-spp passes cut after
          its first, resumed with the checkpoint on node 0 only, rank 0's
          PFM equal to the uncut render; each node's cold builds and each
          rank's load seconds
  lucy    scenes/lucy_bench.sp uncut (its PLY written by io/meshgen into
          the output directory) at 1 spp with --geom-shards 4 over the
          ranks, rank 0 building cold and the others loading warm, held to
          the one-BVH frame on one GPU at the lucy gate (< 1 % of pixels off
          by > 1e-3, means within 1 %); every GPU's peak memory

Every CLI run is a fresh process; the ranks start under ``torchrun
--standalone`` and run under ``parallel/launch.run_processes``, which ends
them all when one fails or the time limit passes.  A part that fails prints
its error and the run goes on to the next; the exit code is 1 if any part
failed.  The CUDA library is built once, before any rank starts.  Output
files go to --out (default chip_smoke_out/multichip/).  Imports nothing of
JAX.  ``--platform cpu --scene tests/scenes/g_blob.sp`` rehearses the flow
on the CPU over gloo; with ``--backend gloo`` every node of the hosts part
sees every GPU (on one card both share GPU 0, and NCCL's variables go
unread).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from simplepath_tpu_torch.parallel.launch import (package_env,  # noqa: E402
                                                  run_processes)

PARTS = ("dryrun", "rays", "geom", "grid", "train", "hosts", "lucy")
OUT = os.path.join(ROOT, "chip_smoke_out", "multichip")
RAYS_SPP = 4
GEOM_SHARDS = 4
CLI_TIMEOUT_S = 900
LUCY_TIMEOUT_S = 1500
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=3)
LOAD_TIMEOUT = datetime.timedelta(minutes=30)
HOSTS_NODES = 2
HOSTS_SPP = 2                   # the resumed render's, in 1-spp passes
# NCCL between the node groups of one machine as between hosts: neither
# peer-to-peer copies nor shared memory, so it takes its network transport
# (the loopback interface, both nodes being here); INFO prints the
# transport of each channel
HOSTS_NCCL_ENV = {"NCCL_P2P_DISABLE": "1", "NCCL_SHM_DISABLE": "1",
                  "NCCL_SOCKET_IFNAME": "lo", "NCCL_DEBUG": "INFO"}
# what a node's log says of each build it made or cache entry it read
BUILD_LINES = {"bvh_builds": "BVH builder:",
               "geometry_cache_writes": "geometry cache written",
               "geometry_cache_hits": "geometry cache hit",
               "traversal_library_builds": "traversal library built",
               "native_builder_builds": "native BVH builder built"}


def emit(part: str, **fields) -> None:
    print(json.dumps({"part": part, **fields}, default=str), flush=True)


def header() -> dict:
    """Every GPU's name and power limit, the versions and the host's
    memory."""
    gpus = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit,pci.bus_id",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    with open("/proc/meminfo") as f:
        mem = dict(line.split(":", 1) for line in f)
    info = dict(nvidia_smi=gpus, device_count=torch.cuda.device_count(),
                torch=torch.__version__, cuda=torch.version.cuda,
                nccl=".".join(map(str, torch.cuda.nccl.version())),
                host_mem_total=mem["MemTotal"].strip(),
                host_mem_available=mem["MemAvailable"].strip(),
                nccl_env={k: v for k, v in os.environ.items()
                          if k.startswith("NCCL_")},
                hosts_nccl_env=HOSTS_NCCL_ENV)
    for line in gpus:
        print(line, flush=True)
    emit("header", **info)
    return info


# ------------------------------------------------------------- the CLI

def run_cli(args, name: str, cli_args: list, world: int,
            timeout: float = CLI_TIMEOUT_S) -> dict:
    """The CLI as ``world`` ranks under torchrun (one process when world is
    1) → its readings: render and parse seconds (rank 0's), world,
    backend, and each rank's device and peak memory."""
    cmd = [sys.executable, "-m", "simplepath_tpu_torch.cli", *cli_args,
           "--stats", "--no-progress"]
    if args.platform:
        cmd += ["--platform", args.platform]
    if world > 1:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={world}", *cmd[1:]]
        if args.backend:
            cmd += ["--dist-backend", args.backend]
    t0 = time.time()
    out = run_processes([cmd], [package_env()], os.path.join(args.out, "logs"),
                        timeout, names=[name], cwd=ROOT)[0]
    res = dict(wall_s=time.time() - t0, **cli_stats(out, name, world),
               cache_writes=out.count("cache written"),
               cache_hits=out.count("cache hit"))
    return res


def cli_stats(out: str, name: str, world: int) -> dict:
    """What rank 0 of the CLI printed with ``--stats``: render and parse
    seconds, world, backend, and each rank's device, peak memory and
    seconds of its own load."""
    m = re.search(r"parse: ([0-9.]+)s\s+render: ([0-9.]+)s", out)
    w = re.search(r"world: (\d+)\s+backend: (\S+)", out)
    ranks = re.findall(r"rank (\d+): (.+?)  peak device memory: (\S+)"
                       r"(?: B)?  load: ([0-9.]+)s", out)
    res = dict(parse_s=float(m.group(1)), render_s=float(m.group(2)),
               world=int(w.group(1)), backend=w.group(2),
               devices=[name for _, name, _, _ in ranks],
               peak_device_bytes=[None if p == "n/a" else int(p)
                                  for _, _, p, _ in ranks],
               load_s=[float(s) for _, _, _, s in ranks])
    if res["world"] != world:
        raise AssertionError(f"{name}: the CLI ran as {res['world']} ranks, "
                             f"not {world}")
    return res


def read_frame(path: str) -> torch.Tensor:
    from simplepath_tpu_torch.io.pfm import read_pfm
    return torch.from_numpy(np.ascontiguousarray(read_pfm(path)))


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


class Refs:
    """One-GPU references computed once a run and shared by the parts."""

    def __init__(self, args):
        self.args = args
        self._one_bvh = None
        self._train = None

    def one_bvh_1spp(self) -> str:
        """The one-BVH 1-spp bench frame of the CLI on one GPU (path)."""
        if self._one_bvh is None:
            path = os.path.join(self.args.out, "one_bvh_1spp.pfm")
            res = run_cli(self.args, "one_bvh_1spp",
                          [self.args.scene, "--samples", "1", "--output",
                           path], 1)
            self._one_bvh = path
            emit("reference", frame="one_bvh_1spp", **res)
        return self._one_bvh

    def train(self):
        """chip_smoke.py's train setup on one GPU: the bench, its 65,536
        pixels, the target rendered at the true parameters (saved for the
        ranks), a flat 0.5 albedo, and one step (loss, new albedo, the
        step's seconds, first and second call)."""
        if self._train is None:
            from simplepath_tpu_torch import load_scene
            from simplepath_tpu_torch.core.rng import prng_key
            from simplepath_tpu_torch.diff import grad as G
            from simplepath_tpu_torch.render.film import render_rays

            dev = device_of(self.args)
            scene = load_scene(self.args.scene, device=dev)
            xs, ys = cs.bench_batch(scene)
            key = prng_key(7, dev)
            dscene = dataclasses.replace(scene, static=dataclasses.replace(
                scene.static, differentiable=True))
            with torch.no_grad():
                target = render_rays(dscene, xs, ys, cs.TRAIN_SPP, key,
                                     device=dev)
            torch.save(target.cpu(), os.path.join(self.args.out, "target.pt"))
            p0 = G.get_params(scene)
            p0 = dict(p0, mat_albedo=torch.full_like(p0["mat_albedo"], 0.5))
            step = G.make_train_step(scene, cs.TRAIN_SPP, lr=cs.TRAIN_LR,
                                     device=dev, leaves=cs.TRAIN_LEAVES)
            secs = []
            for _ in range(2):
                t0 = time.time()
                new, loss = step(p0, target, xs, ys, key)
                float(loss)
                secs.append(time.time() - t0)
            self._train = dict(loss=float(loss), step_s=secs,
                               p0=p0["mat_albedo"].cpu().numpy(),
                               albedo=new["mat_albedo"].cpu().numpy())
            del scene, dscene, target, step
            if dev.type == "cuda":
                torch.cuda.empty_cache()    # the ranks use this GPU next
        return self._train


def device_of(args):
    from simplepath_tpu_torch.device import resolve_device
    return resolve_device(args.platform)


# ------------------------------------------------------------- the parts

def part_dryrun(args, refs) -> dict:
    from simplepath_tpu_torch.entry import dryrun_multichip
    return dict(world=args.world,
                **dryrun_multichip(args.world, args.backend, args.platform))


def part_rays(args, refs) -> dict:
    """The bench at 4 spp, rays over the ranks, in turns with one GPU."""
    frames, turns = {}, []
    for i, world in enumerate((1, args.world, args.world, 1)):
        path = os.path.join(args.out, f"rays_{i}_w{world}.pfm")
        res = run_cli(args, f"rays_{i}_w{world}",
                      [args.scene, "--samples", str(RAYS_SPP), "--output",
                       path], world)
        turns.append(res)
        frames.setdefault(world, []).append(path)
    one, many = frames[1], frames[args.world]
    equal = all(same_bytes(one[0], p) for p in one[1:] + many)
    one_s = [t["render_s"] for t in turns if t["world"] == 1]
    many_s = [t["render_s"] for t in turns if t["world"] == args.world]
    out = dict(spp=RAYS_SPP, turns=turns, rank0_pfm_equals_one_gpu=equal,
               one_gpu_render_s=one_s, ranks_render_s=many_s,
               ratio=sum(many_s) / sum(one_s),
               image_mean=float(read_frame(one[0]).mean()))
    if not equal:
        raise AssertionError(f"rank 0's PFM differs from one GPU's: {out}")
    return out


def part_geom(args, refs) -> dict:
    """The bench's forest of 4 over the ranks against the one-process
    forest of 4 (in turns) and the one-BVH frame."""
    ref = refs.one_bvh_1spp()
    frames, turns = {}, []
    for i, world in enumerate((1, args.world, args.world, 1)):
        path = os.path.join(args.out, f"geom_{i}_w{world}.pfm")
        res = run_cli(args, f"geom_{i}_w{world}",
                      [args.scene, "--samples", "1", "--geom-shards",
                       str(GEOM_SHARDS), "--output", path], world)
        turns.append(res)
        frames.setdefault(world, []).append(path)
    one, many = frames[1], frames[args.world]
    equal = all(same_bytes(one[0], p) for p in one[1:] + many)
    held = cs.held_against(read_frame(many[0]), read_frame(ref))
    one_s = [t["render_s"] for t in turns if t["world"] == 1]
    many_s = [t["render_s"] for t in turns if t["world"] == args.world]
    out = dict(shards=GEOM_SHARDS, shards_a_rank=GEOM_SHARDS // args.world,
               turns=turns, rank0_pfm_equals_one_process_forest=equal,
               against_one_bvh=held, one_process_forest_render_s=one_s,
               ranks_render_s=many_s, ratio=sum(many_s) / sum(one_s))
    if not (equal and held["max_abs_diff"] < 1e-4):
        raise AssertionError(f"the forest over the ranks departs: {out}")
    return out


def rank_torchrun(args, job: str, timeout: float = CLI_TIMEOUT_S) -> list:
    """This script's rank job ``job`` on ``args.world`` ranks under
    torchrun → each rank's saved readings."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={args.world}", os.path.abspath(__file__),
           "--rank-job", job, "--out", args.out, "--scene", args.scene]
    if args.platform:
        cmd += ["--platform", args.platform]
    if args.backend:
        cmd += ["--backend", args.backend]
    run_processes([cmd], [package_env()], os.path.join(args.out, "logs"),
                  timeout, names=[job], cwd=ROOT)
    res = []
    for r in range(args.world):
        with open(os.path.join(args.out, f"{job}_rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def part_grid(args, refs) -> dict:
    """The 2 x (world/2) grid: its frame against the one-BVH frame, and
    its train step against one GPU's."""
    if args.world < 4 or args.world % 2:
        raise ValueError(f"the grid needs an even world >= 4, not {args.world}")
    ref = refs.one_bvh_1spp()
    one = refs.train()
    ranks = rank_torchrun(args, "grid")
    img = torch.from_numpy(np.load(os.path.join(args.out, "grid_img.npy")))
    held = cs.held_against(img, read_frame(ref))
    albedo = np.load(os.path.join(args.out, "grid_albedo.npy"))
    d_new, d_ref = albedo - one["p0"], one["albedo"] - one["p0"]
    loss = ranks[0]["loss"]
    out = dict(layout=[2, args.world // 2], ranks=ranks,
               against_one_bvh=held, loss=loss, one_gpu_loss=one["loss"],
               loss_rel_diff=abs(loss - one["loss"]) / abs(one["loss"]),
               update_max_abs=float(np.abs(d_new).max()),
               update_max_abs_diff=float(np.abs(d_new - d_ref).max()))
    ok = (held["max_abs_diff"] < 1e-4 and out["loss_rel_diff"] <= 1e-4
          and out["update_max_abs"] > 1e-7
          and np.allclose(d_new, d_ref, rtol=0.05, atol=1e-6))
    if not ok:
        raise AssertionError(f"the grid departs: {out}")
    return out


def part_train(args, refs) -> dict:
    """The 65,536-pixel albedo step over the ranks against one GPU."""
    one = refs.train()
    ranks = rank_torchrun(args, "train")
    albedo = np.load(os.path.join(args.out, "train_albedo.npy"))
    loss = ranks[0]["loss"]
    out = dict(ranks=ranks, loss=loss, one_gpu_loss=one["loss"],
               one_gpu_step_s=one["step_s"],
               loss_abs_diff=abs(loss - one["loss"]),
               albedo_max_abs_diff=float(np.abs(albedo - one["albedo"]).max()))
    if not (np.isclose(loss, one["loss"], rtol=1e-5, atol=1e-5)
            and np.allclose(albedo, one["albedo"], rtol=1e-5, atol=1e-5)):
        raise AssertionError(f"the step over the ranks departs: {out}")
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_node(args, d: str) -> str:
    """A host's own disk in ``d``: a copy of the scene file and of the
    files it names beside it, and of the package without its build → the
    scene's path there."""
    src = os.path.dirname(args.scene)
    shutil.copytree(os.path.join(ROOT, "simplepath_tpu_torch"),
                    os.path.join(d, "simplepath_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    with open(args.scene) as f:
        named = re.findall(r'"([^"]+)"', f.read())
    for name in [os.path.basename(args.scene), *named]:
        if os.path.isfile(os.path.join(src, name)):
            os.makedirs(os.path.dirname(os.path.join(d, name)), exist_ok=True)
            shutil.copy(os.path.join(src, name), os.path.join(d, name))
    return os.path.join(d, os.path.basename(args.scene))


def node_gpus(args, node: int, per: int) -> str | None:
    """CUDA_VISIBLE_DEVICES of a node: over NCCL its own ``per`` GPUs;
    None (every GPU it sees) over gloo, where its ranks share them, and on
    the CPU."""
    if args.platform is not None or args.backend == "gloo":
        return None
    return ",".join(str(g) for g in range(node * per, (node + 1) * per))


def nccl_transport(log: str) -> list:
    """The transport lines NCCL printed at INFO, once each, without the
    host and process that printed them."""
    lines = re.findall(r"NCCL INFO ((?:Channel \d+/\d+ : .*? via \S+)"
                       r"|(?:Using network \S+)|(?:NET/\S+ : .*))", log)
    return sorted(set(re.sub(r"\[\d+\]", "[.]", line) for line in lines))[:12]


def run_nodes(args, name: str, scenes: list, cli_args: list,
              checkpoint: bool = False) -> dict:
    """The CLI as HOSTS_NODES torchrun node groups of world / HOSTS_NODES
    ranks, node i on ``scenes[i]`` (its own copy, in its own directory,
    imported from there), its output ``<name>.pfm`` and, with
    ``checkpoint``, its checkpoint ``ck.npz`` in that directory → rank 0's
    readings, each node's builds, which nodes wrote the PFM (rank 0's
    alone, or this raises) and the NCCL transport."""
    per = args.world // HOSTS_NODES
    port = free_port()
    cmds, envs, dirs = [], [], [os.path.dirname(s) for s in scenes]
    for i, (scene, d) in enumerate(zip(scenes, dirs)):
        cmd = [sys.executable, "-m", "torch.distributed.run",
               f"--nnodes={HOSTS_NODES}", f"--node-rank={i}",
               f"--nproc-per-node={per}", "--master-addr=127.0.0.1",
               f"--master-port={port}", "-m", "simplepath_tpu_torch.cli",
               scene, *cli_args, "--output", os.path.join(d, f"{name}.pfm"),
               "--stats", "--no-progress"]
        if checkpoint:
            cmd += ["--checkpoint", os.path.join(d, "ck.npz")]
        if args.platform:
            cmd += ["--platform", args.platform]
        if args.backend:
            cmd += ["--dist-backend", args.backend]
        env = dict(os.environ, PYTHONPATH=d, **HOSTS_NCCL_ENV)
        gpus = node_gpus(args, i, per)
        if gpus is not None:
            env["CUDA_VISIBLE_DEVICES"] = gpus
        cmds.append(cmd)
        envs.append(env)
    t0 = time.time()
    # run from the nodes' parent: the checkout's package is not on the path
    logs = run_processes(cmds, envs, os.path.join(args.out, "logs"),
                         CLI_TIMEOUT_S, cwd=os.path.dirname(dirs[0]),
                         names=[f"{name}_node{i}" for i in range(len(cmds))])
    res = dict(wall_s=time.time() - t0,
               **cli_stats(logs[0], name, args.world),
               nodes=[{k: log.count(line) for k, line in BUILD_LINES.items()}
                      for log in logs],
               wrote=[os.path.exists(os.path.join(d, f"{name}.pfm"))
                      for d in dirs],
               nccl_transport=nccl_transport("\n".join(logs)))
    if res["wrote"] != [True] + [False] * (len(dirs) - 1):
        raise AssertionError(f"{name}: rank 0 alone writes the PFM, but the "
                             f"nodes wrote {res['wrote']}")
    return res


def part_hosts(args, refs) -> dict:
    """The ranks as two hosts that share no file system (module
    docstring): rays in turns with one GPU, the forest of 4, and a render
    resumed with the checkpoint on node 0 only."""
    from simplepath_tpu_torch.utils import load_checkpoint

    if args.world % HOSTS_NODES:
        raise ValueError(f"{args.world} ranks do not divide over "
                         f"{HOSTS_NODES} nodes")
    root = os.path.join(args.out, "hosts")
    shutil.rmtree(root, ignore_errors=True)
    scenes = [make_node(args, os.path.join(root, f"node{i}"))
              for i in range(HOSTS_NODES)]
    node0 = os.path.dirname(scenes[0])

    def one_gpu(name, cli_args):
        path = os.path.join(root, f"{name}.pfm")
        return run_cli(args, f"hosts_{name}",
                       [args.scene, *cli_args, "--output", path], 1), path

    # rays: the first run of the nodes finds both cold, the second warm
    turns, frames = [], []
    for i, where in enumerate(("one", "nodes", "nodes", "one")):
        if where == "one":
            res, path = one_gpu(f"rays_{i}_one", ["--samples", "1"])
        else:
            res = run_nodes(args, f"rays_{i}", scenes, ["--samples", "1"])
            path = os.path.join(node0, f"rays_{i}.pfm")
        turns.append(dict(res, where=where))
        frames.append(path)
    one_s = [t["render_s"] for t in turns if t["where"] == "one"]
    nodes_s = [t["render_s"] for t in turns if t["where"] == "nodes"]
    rays = dict(turns=turns, one_gpu_render_s=one_s, nodes_render_s=nodes_s,
                ratio=sum(nodes_s) / sum(one_s),
                rank0_pfm_equals_one_gpu=all(same_bytes(frames[0], p)
                                             for p in frames[1:]))

    forest = ["--samples", "1", "--geom-shards", str(GEOM_SHARDS)]
    one_forest, one_path = one_gpu("geom_one", forest)
    nodes_forest = run_nodes(args, "geom", scenes, forest)
    geom = dict(one_process_forest=one_forest, nodes=nodes_forest,
                shards_a_rank=GEOM_SHARDS // args.world,
                rank0_pfm_equals_one_process_forest=same_bytes(
                    one_path, os.path.join(node0, "geom.pfm")))

    passes = ["--samples", str(HOSTS_SPP), "--spp-chunk", "1"]
    uncut, uncut_path = one_gpu("uncut_one", passes)
    # the first 1-spp pass, in this process on one GPU
    dev = device_of(args)
    cs.cut_checkpoint(os.path.join(node0, "ck.npz"), args.scene, HOSTS_SPP,
                      1, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    resumed_run = run_nodes(args, "resumed", scenes, passes, checkpoint=True)
    resumed = dict(uncut_one_gpu=uncut, nodes=resumed_run,
                   rank0_pfm_equals_uncut=same_bytes(
                       uncut_path, os.path.join(node0, "resumed.pfm")),
                   checkpoint_samples_on_node0=load_checkpoint(
                       os.path.join(node0, "ck.npz"))[1],
                   checkpoint_written_on_node1=any(
                       os.path.exists(os.path.join(os.path.dirname(s),
                                                   "ck.npz"))
                       for s in scenes[1:]))

    out = dict(nodes=HOSTS_NODES, ranks_a_node=args.world // HOSTS_NODES,
               nccl_env=HOSTS_NCCL_ENV,
               nccl_transport=sorted({t for r in (turns[1], turns[2],
                                                  nodes_forest, resumed_run)
                                      for t in r["nccl_transport"]}),
               rays=rays, geom=geom, resumed=resumed)
    ok = (rays["rank0_pfm_equals_one_gpu"]
          and geom["rank0_pfm_equals_one_process_forest"]
          and resumed["rank0_pfm_equals_uncut"]
          and resumed["checkpoint_samples_on_node0"] == HOSTS_SPP
          and not resumed["checkpoint_written_on_node1"])
    if not ok:
        raise AssertionError(f"the ranks over two hosts depart: {out}")
    return out


def part_lucy(args, refs) -> dict:
    """Lucy uncut: its forest of 4 over the ranks (rank 0 cold), held to
    the one-BVH frame on one GPU at the lucy gate."""
    from simplepath_tpu_torch.io.meshgen import write_terrain

    d = os.path.join(args.out, "lucy")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        t0 = time.time()
        write_terrain(os.path.join(d, cs.LUCY_MESH), args.lucy_tris,
                      log=lambda _: None)
        write_s = time.time() - t0
        scene = os.path.join(d, "lucy_bench.sp")
        with open(scene, "w") as f:
            f.write(cs.check_scene_text())
        forest, one = os.path.join(d, "forest.pfm"), os.path.join(d, "one.pfm")
        ranks = run_cli(args, "lucy_forest",
                        [scene, "--samples", "1", "--geom-shards",
                         str(GEOM_SHARDS), "--output", forest], args.world,
                        LUCY_TIMEOUT_S)
        single = run_cli(args, "lucy_one_bvh",
                         [scene, "--samples", "1", "--output", one], 1,
                         LUCY_TIMEOUT_S)
        held = cs.held_against(read_frame(forest), read_frame(one))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out = dict(triangles_asked=args.lucy_tris, mesh_write_s=write_s,
               forest_over_ranks=ranks,
               one_bvh_one_gpu=single, against_one_bvh=held,
               gate_share_over_1e3=0.01, gate_mean_rel=0.01)
    if not (held["share_over_1e3"] < 0.01
            and abs(held["mean"] - held["ref_mean"]) < 0.01 * held["ref_mean"]):
        raise AssertionError(f"lucy's forest over the ranks misses the gate: "
                             f"{out}")
    return out


# ------------------------------------------------------------- the ranks

def rank_job(args) -> None:
    """One rank of the grid or train part (under torchrun): join the
    others, load the bench (rank 0 first, the others warm), run the job
    and save this rank's readings."""
    import torch.distributed as dist

    from simplepath_tpu_torch import load_scene
    from simplepath_tpu_torch.core.rng import prng_key
    from simplepath_tpu_torch.diff import grad as G
    from simplepath_tpu_torch.parallel import (init_distributed,
                                               make_geom_mesh,
                                               render_image_geom_sharded,
                                               shard_scene_geometry,
                                               train_step_multihost)
    from simplepath_tpu_torch.parallel.multihost import rank_zero_first

    job = args.rank_job
    dev = init_distributed(backend=args.backend, device=args.platform,
                           timeout=COLLECTIVE_TIMEOUT)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        coord = dist.new_group(backend="gloo", timeout=LOAD_TIMEOUT)
        cuda = dev.type == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        mesh = (make_geom_mesh(world // 2, 2, timeout=COLLECTIVE_TIMEOUT)
                if job == "grid" else None)
        with rank_zero_first(coord, LOAD_TIMEOUT):
            t0 = time.time()
            scene = load_scene(args.scene, use_bvh=False if mesh else None,
                               device=dev)
            if mesh:
                scene = shard_scene_geometry(
                    scene, mesh, cache_dir=os.path.dirname(
                        os.path.abspath(args.scene)))
            load_s = time.time() - t0
        res = dict(rank=rank, world=world, backend=str(dist.get_backend()),
                   device=str(dev), load_s=load_s)
        if cuda:
            props = torch.cuda.get_device_properties(dev)
            res.update(name=props.name, uuid=str(getattr(props, "uuid", "")))
        if mesh:
            sync()
            t0 = time.time()
            img = render_image_geom_sharded(scene, 1, prng_key(0, dev),
                                            device=dev)
            sync()
            res["render_s"] = time.time() - t0
            if rank == 0:
                np.save(os.path.join(args.out, "grid_img.npy"),
                        img.cpu().numpy())
            del img
        target = torch.load(os.path.join(args.out, "target.pt"))
        xs, ys = cs.bench_batch(scene)
        p0 = G.get_params(scene)
        params = dict(p0, mat_albedo=torch.full_like(p0["mat_albedo"], 0.5))
        steps = []
        for _ in range(1 if mesh else 2):
            sync()
            t0 = time.time()
            params, loss = train_step_multihost(
                scene, params, target, xs, ys, cs.TRAIN_SPP, prng_key(7, dev),
                lr=cs.TRAIN_LR, mesh=mesh.ray_mesh(dev) if mesh else None,
                leaves=cs.TRAIN_LEAVES, device=dev)
            sync()
            steps.append((time.time() - t0, loss))
            if len(steps) == 1 and rank == 0:
                np.save(os.path.join(args.out, f"{job}_albedo.npy"),
                        params["mat_albedo"].cpu().numpy())
        res.update(step_s=[s for s, _ in steps], loss=steps[0][1],
                   losses=[x for _, x in steps],
                   peak_device_bytes=(torch.cuda.max_memory_allocated(dev)
                                      if cuda else None))
        with open(os.path.join(args.out, f"{job}_rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def check_distinct(results: dict, args) -> None:
    """Over NCCL: every run of ``args.world`` ranks used that many distinct
    GPUs (the CLI's devices, the rank jobs' UUIDs)."""
    if args.platform is not None or args.backend == "gloo":
        return
    for part, res in results.items():
        runs = [t["devices"] for t in res.get("turns", [])
                if t["world"] == args.world]
        runs += [[r["uuid"] for r in res.get("ranks", [])]]
        if "forest_over_ranks" in res:
            runs.append(res["forest_over_ranks"]["devices"])
        for devices in runs:
            if devices and len(set(devices)) != args.world:
                raise AssertionError(f"{part}: {len(set(devices))} distinct "
                                     f"GPUs for {args.world} ranks: {devices}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated subset of " + ",".join(PARTS))
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every GPU)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on CUDA, gloo on the CPU")
    ap.add_argument("--platform", default=None,
                    help="torch device (default: cuda, one GPU a rank)")
    ap.add_argument("--scene", default=cs.SCENE,
                    help="the bench scene of the rays, geom, grid and train "
                         "parts")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--lucy-tris", type=int, default=cs.LUCY_TRIS,
                    help="lucy's triangles (default: uncut; fewer only to "
                         "rehearse the part)")
    ap.add_argument("--rank-job", choices=("grid", "train"), default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    # absolute: the hosts part runs its nodes from another directory
    args.scene, args.out = os.path.abspath(args.scene), os.path.abspath(args.out)
    if args.rank_job:
        rank_job(args)
        return 0
    parts = [p for p in args.parts.split(",") if p]
    unknown = set(parts) - set(PARTS)
    if unknown:
        ap.error(f"unknown parts {sorted(unknown)}")
    if args.platform is None and not torch.cuda.is_available():
        print("torch_multichip: no CUDA device; this tool runs on the GPUs "
              "(--platform cpu rehearses it on the CPU)", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    args.world = args.world or torch.cuda.device_count()
    if args.platform is None:
        header()
        from simplepath_tpu_torch.render import cuda_traverse
        cuda_traverse.build_library()   # once, before any rank starts
    refs, results, failed = Refs(args), {}, []
    started = time.time()
    for part in PARTS:
        if part not in parts:
            continue
        t0 = time.time()
        try:
            results[part] = globals()[f"part_{part}"](args, refs)
            emit(part, ok=True, seconds=time.time() - t0, **results[part])
        except Exception as e:                  # the next part still runs
            import traceback
            traceback.print_exc()
            failed.append(part)
            emit(part, ok=False, seconds=time.time() - t0,
                 error=f"{type(e).__name__}: {str(e)[-4000:]}")
    try:
        check_distinct(results, args)
    except AssertionError as e:
        failed.append("distinct_gpus")
        print(e, file=sys.stderr)
    print(json.dumps({"multichip": {"ok": not failed, "failed": failed,
                                    "world": args.world,
                                    "seconds": time.time() - started}}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
