"""Ranks on hosts that share no file system, on the CPU over gloo:

* two CLI ranks, each a host of one rank (``RANK`` 0 and 1, ``LOCAL_RANK``
  0, ``LOCAL_WORLD_SIZE`` 1), started by ``parallel/launch.run_processes``
  with a TCP rendezvous on 127.0.0.1, each in a directory of its own with
  its own copy of g_blob.sp and blob.ply and its own ``--checkpoint`` path;
  only rank 0's path holds the cut checkpoint.  Rank 0's PFM equals the
  one-process render byte for byte, and rank 1 writes no checkpoint;
* the start of rank 3 of 4 on the second of two hosts with two GPUs each
  (monkeypatched): GPU 1, NCCL, the topology from the environment;
* in one process, a progressive render, whole or cut and resumed, equals
  the render in one pass byte for byte.

tests/test_torch_hosts_part.py rehearses tools/torch_multichip.py's
``hosts`` part, the same over torchrun node groups.
"""

import os
import shutil
import socket
import sys

import torch
import torch.distributed as dist

from simplepath_tpu_torch import cli, load_scene
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.parallel import launch
from simplepath_tpu_torch.parallel import multihost
from simplepath_tpu_torch.parallel.mesh import render_image_sharded
from simplepath_tpu_torch.render.film import render_image_progressive
from simplepath_tpu_torch.utils import load_checkpoint

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_ranks import BLOB, cut_checkpoint  # noqa: E402

torch.set_num_threads(1)

PASSES = ["--samples", "2", "--spp-chunk", "1", "--no-progress"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_env(rank: int, world: int, port: int) -> dict:
    """What a launcher gives rank ``rank`` of ``world`` when every host
    runs one rank: LOCAL_RANK 0 of 1, the rendezvous on 127.0.0.1."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env = launch.package_env(dict(base, OMP_NUM_THREADS="1"))
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    return env


def test_a_render_resumed_on_two_hosts_equals_one_process(tmp_path):
    """Only rank 0's host holds the checkpoint; the other host's rank
    starts at rank 0's count all the same."""
    one = tmp_path / "one.pfm"
    assert cli.main([BLOB, *PASSES, "--platform", "cpu", "--output",
                     str(one)]) == 0
    hosts = [tmp_path / f"host{r}" for r in range(2)]
    for d in hosts:
        d.mkdir()
        for f in ("g_blob.sp", "blob.ply"):
            shutil.copy(os.path.join(HERE, "scenes", f), d)
    cut_checkpoint(hosts[0] / "ck.npz")
    port = free_port()
    cmds = [[sys.executable, "-m", "simplepath_tpu_torch.cli",
             str(d / "g_blob.sp"), *PASSES, "--checkpoint", str(d / "ck.npz"),
             "--output", str(d / "out.pfm"), "--platform", "cpu"]
            for d in hosts]
    failed = None
    try:
        logs = launch.run_processes(
            cmds, [host_env(r, 2, port) for r in range(2)],
            str(tmp_path / "logs"), timeout=90, names=["host0", "host1"],
            cwd=str(tmp_path))
    except launch.RanksFailed as e:
        failed = e
    assert (hosts[0] / "out.pfm").read_bytes() == one.read_bytes()
    assert failed is None, failed
    assert logs[0].count("Wrote ") == 1 and "Wrote " not in logs[1]
    assert not (hosts[1] / "out.pfm").exists()
    assert not (hosts[1] / "ck.npz").exists()      # rank 1 writes none
    assert load_checkpoint(str(hosts[0] / "ck.npz"))[1] == 2


def test_rank_three_on_the_second_host_takes_gpu_one_over_nccl(monkeypatch):
    monkeypatch.setattr(os, "environ", os.environ.copy())
    for k, v in dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="1",
                     LOCAL_WORLD_SIZE="2").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("TORCH_NCCL_ASYNC_ERROR_HANDLING", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    calls = {}
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.update(set_device=d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    assert multihost.env_topology() == (4, 3, 1, 2)
    assert multihost.rank_device(1, 2) == (torch.device("cuda", 1), "nccl")
    assert multihost.init_distributed() == torch.device("cuda", 1)
    assert calls == dict(set_device=torch.device("cuda", 1), backend="nccl",
                         init_method="env://", world_size=4, rank=3,
                         timeout=multihost.DEFAULT_TIMEOUT)
    assert os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] == "1"


def test_one_process_progressive_render_equals_one_pass(tmp_path):
    scene = load_scene(BLOB, device="cpu")
    whole = render_image_sharded(scene, 2, prng_key(0), device="cpu")
    passes = render_image_progressive(scene, 2, prng_key(0), chunk=1,
                                      device="cpu")
    cut_checkpoint(tmp_path / "ck.npz")
    resumed = render_image_progressive(
        scene, 2, prng_key(0), chunk=1,
        checkpoint_path=str(tmp_path / "ck.npz"), device="cpu")
    for img in (passes, resumed):
        assert img.numpy().tobytes() == whole.numpy().tobytes()
