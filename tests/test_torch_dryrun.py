"""The multi-process dry run (``entry.dryrun_multichip``) and the start of a
rank (``parallel/multihost.py``, ``parallel/launch.py``), on the CPU over
gloo, without JAX:

* ``dryrun_multichip(4, backend="gloo", device="cpu")``: four rank
  processes run the train step, the 2 x 2 rays x geometry render and its
  gradient, each part held against the same job in this process (loss rtol
  1e-4, the render within 1e-4, finite gradients within rtol 1e-5);
* no silent gloo: NCCL asked for without a GPU, on the CPU, or with more
  ranks on the host than GPUs raises, naming both counts, before any
  process group starts; named gloo lets ranks share GPUs;
* ``init_distributed`` takes the topology from the environment, as
  ``torchrun`` sets it;
* the supervisor ends every process, with what it started, once one fails
  or the time runs out, and names the failed ranks.
"""

import os
import sys
import time

import pytest
import torch
import torch.distributed as dist

from simplepath_tpu_torch.entry import dryrun_multichip
from simplepath_tpu_torch.parallel import launch
from simplepath_tpu_torch.parallel.multihost import (init_distributed,
                                                     rank_device)

torch.set_num_threads(1)


def test_dryrun_over_four_gloo_ranks_matches_one_process(capsys):
    res = dryrun_multichip(4, backend="gloo", device="cpu")
    printed = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in printed] == \
        ["dryrun_multichip(4)"] * 3
    assert all(" OK " in line for line in printed)
    train = res["train"]
    assert abs(train["loss"] - train["one_process_loss"]) \
        <= 1e-4 * train["one_process_loss"]
    assert train["max_abs_param_diff"] <= 1e-5
    assert res["grid_render"]["layout"] == [2, 2]
    assert res["grid_render"]["mean"] > 0
    assert res["grid_render"]["max_abs_diff"] <= 1e-4
    assert res["grid_grad"]["leaves"] == 12


def test_dryrun_batch_must_divide_over_the_ranks():
    with pytest.raises(ValueError, match="3 ranks do not divide"):
        dryrun_multichip(3, backend="gloo", device="cpu")


def test_nccl_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rank_device(0, 1, "nccl")
    with pytest.raises(RuntimeError, match="CUDA"):
        rank_device(0, 1, None)
    with pytest.raises(RuntimeError, match="NCCL runs on CUDA"):
        rank_device(0, 1, "nccl", "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(4)
    assert rank_device(0, 4, None, "cpu") == (torch.device("cpu"), "gloo")
    assert not dist.is_initialized()


def test_more_ranks_than_gpus_raises_for_nccl(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for backend in (None, "nccl"):
        with pytest.raises(RuntimeError,
                           match="4 ranks on this host and 2 GPU"):
            rank_device(3, 4, backend)
    with pytest.raises(RuntimeError, match="4 ranks on this host and 2 GPU"):
        dryrun_multichip(4)
    # one GPU a rank, GPU LOCAL_RANK; gloo shares them
    assert rank_device(1, 2, None) == (torch.device("cuda", 1), "nccl")
    assert rank_device(3, 4, "gloo") == (torch.device("cuda", 1), "gloo")
    assert not dist.is_initialized()


def test_init_distributed_reads_the_topology_from_the_environment(
        tmp_path, monkeypatch):
    for k, v in launch.rank_env(0, 1, {}).items():
        if k != "PYTHONPATH":
            monkeypatch.setenv(k, v)
    dev = init_distributed("file://" + str(tmp_path / "rendezvous"),
                           device="cpu")
    try:
        assert dev == torch.device("cpu")
        assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_rank_env_is_torchruns():
    env = launch.rank_env(2, 4, {"PYTHONPATH": "x"})
    assert {k: env[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                "LOCAL_WORLD_SIZE")} == \
        {"RANK": "2", "WORLD_SIZE": "4", "LOCAL_RANK": "2",
         "LOCAL_WORLD_SIZE": "4"}
    assert env["PYTHONPATH"] == launch.ROOT + os.pathsep + "x"


def test_a_failing_rank_ends_the_others_and_is_named(tmp_path):
    pid_file = tmp_path / "child.pid"
    waiter = ["sh", "-c", f"sleep 60 & echo $! > {pid_file}; wait"]
    failer = [sys.executable, "-c",
              "import time, sys; time.sleep(1); print('rank 1 says no'); "
              "sys.exit(3)"]
    t0 = time.time()
    with pytest.raises(launch.RanksFailed,
                       match=r"rank 1 failed \(rank 0 ended\)") as e:
        launch.run_processes([waiter, failer], None, str(tmp_path / "logs"),
                             timeout=60)
    assert time.time() - t0 < 20
    assert "rank 1 says no" in str(e.value) and "exit 3" in str(e.value)
    # the waiter's child went with it: gone, or a zombie left to be reaped
    stat = f"/proc/{int(pid_file.read_text())}/stat"
    time.sleep(0.2)
    assert not os.path.exists(stat) or open(stat).read().split()[2] == "Z"


def test_ranks_past_the_time_limit_are_ended(tmp_path):
    t0 = time.time()
    with pytest.raises(launch.RanksFailed, match="still running after 1 s"):
        launch.run_processes([["sleep", "60"]], None, str(tmp_path),
                             timeout=1, names=["slow"])
    assert time.time() - t0 < 10
    out = launch.run_processes([["echo", "fine"]], None, str(tmp_path),
                               timeout=30)
    assert out == ["fine\n"]
