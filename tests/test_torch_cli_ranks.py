"""The CLI as several ranks (``torchrun --standalone``, which picks a free
port, ``--platform cpu``, gloo) on tests/scenes/g_blob.sp, held to the
one-process CLI:

* plain (each rank renders its block of every chunk) and with
  ``--geom-shards 2`` (a forest shard a rank), rank 0's PFM equals the
  one-process CLI's byte for byte, and only rank 0 writes (one ``Wrote``);
* a progressive render cut after its first pass, resumed by two ranks from
  its checkpoint, equals the whole one-process render byte for byte, and
  the checkpoint rank 0 writes holds every sample;
* ``--geom-shards 3`` over 2 ranks stops with the CLI's usage error;
* a rank other than 0 resumes at the sample count rank 0 sends it and
  writes no checkpoint.

The three two-rank renders start together, under one supervisor
(``parallel/launch.run_processes``), to keep the file short.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from simplepath_tpu_torch import cli, load_scene
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.parallel import launch
from simplepath_tpu_torch.parallel.mesh import render_image_sharded
from simplepath_tpu_torch.render.film import render_image_progressive
from simplepath_tpu_torch.utils import load_checkpoint, save_checkpoint

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import BLOB, cut_checkpoint  # noqa: E402

torch.set_num_threads(1)

PASSES = [BLOB, "--samples", "2", "--spp-chunk", "1", "--no-progress"]


def torchrun(args, nproc=2):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={nproc}", "-m", "simplepath_tpu_torch.cli",
            *args, "--platform", "cpu"]


def env():
    base = {k: v for k, v in os.environ.items()
            if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return launch.package_env(dict(base, OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process CLI's PFMs, and the same renders by two ranks."""
    d = tmp_path_factory.mktemp("cli_ranks")
    one = {"plain": d / "one_plain.pfm", "forest": d / "one_forest.pfm",
           "passes": d / "one_passes.pfm"}
    for name, args in (("plain", [BLOB, "--samples", "2"]),
                       ("forest", [BLOB, "--samples", "2", "--geom-shards",
                                   "2"]),
                       ("passes", PASSES)):
        assert cli.main(args + ["--platform", "cpu", "--output",
                                str(one[name])]) == 0
    cut_checkpoint(str(d / "ck_cut.npz"))
    ranks = {"plain": [BLOB, "--samples", "2", "--stats"],
             "forest": [BLOB, "--samples", "2", "--geom-shards", "2"],
             "resumed": PASSES + ["--checkpoint", str(d / "ck_cut.npz")]}
    names = list(ranks)
    logs = launch.run_processes(
        [torchrun(ranks[n] + ["--output", str(d / f"ranks_{n}.pfm")])
         for n in names], [env()] * len(names), str(d / "logs"), timeout=150,
        names=names)
    return d, one, dict(zip(names, logs))


def test_two_ranks_render_equals_one_process(runs):
    d, one, logs = runs
    assert (d / "ranks_plain.pfm").read_bytes() == one["plain"].read_bytes()
    assert logs["plain"].count("Wrote ") == 1
    assert "world: 2  backend: gloo" in logs["plain"]
    assert logs["plain"].count("peak device memory") == 2


def test_two_ranks_forest_equals_one_process(runs):
    d, one, logs = runs
    assert (d / "ranks_forest.pfm").read_bytes() == one["forest"].read_bytes()
    assert logs["forest"].count("Wrote ") == 1


def test_two_ranks_resume_a_cut_render(runs):
    d, one, logs = runs
    assert (d / "ranks_resumed.pfm").read_bytes() == \
        one["passes"].read_bytes()
    assert logs["resumed"].count("Wrote ") == 1
    film, done, meta = load_checkpoint(str(d / "ck_cut.npz"))
    assert done == 2 and meta == {"spp_target": 2}


def test_shards_that_do_not_divide_over_the_ranks_stop(tmp_path):
    with pytest.raises(launch.RanksFailed) as e:
        launch.run_processes(
            [torchrun([BLOB, "--geom-shards", "3", "--output",
                       str(tmp_path / "x.pfm")])], [env()],
            str(tmp_path / "logs"), timeout=150, names=["three"])
    assert "3 shards do not divide over the 2 ranks" in str(e.value)
    assert not (tmp_path / "x.pfm").exists()


def test_dist_backend_needs_several_ranks(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        cli.main([BLOB, "--platform", "cpu", "--dist-backend", "gloo",
                  "--output", str(tmp_path / "x.pfm")])
    assert "needs several ranks" in capsys.readouterr().err


def test_only_rank_zero_writes_the_checkpoint(tmp_path, monkeypatch):
    """A rank other than 0 resumes at the count rank 0 sends it, reads no
    checkpoint of its own and writes none."""
    scene = load_scene(BLOB, device="cpu")
    ck = tmp_path / "ck.npz"
    film = np.full((48, 48, 3), 0.5, np.float32)
    save_checkpoint(str(ck), np.zeros_like(film), 0, {"spp_target": 2})
    before = ck.read_bytes()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    sent = []

    def from_rank_zero(objects, src):      # what rank 0 read from its disk
        sent.append(src)
        objects[:] = [film, 1]

    monkeypatch.setattr(dist, "broadcast_object_list", from_rank_zero)
    offsets = []

    def one_pass(*a, **kw):
        offsets.append(kw["spp_offset"])
        return render_image_sharded(*a, **kw)

    img = render_image_progressive(scene, 2, prng_key(0), chunk=1,
                                   checkpoint_path=str(ck),
                                   checkpoint_every=1, render_fn=one_pass,
                                   device="cpu")
    assert sent == [0]
    assert offsets == [1]                  # resumed at rank 0's count
    assert ck.read_bytes() == before       # and wrote nothing
    assert torch.isfinite(img).all()
