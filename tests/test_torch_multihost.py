"""Ray sharding over processes (``parallel/multihost.py``), two ranks over
gloo on the CPU, held against the port's own one-process render and train
step (which equal the JAX package's per pixel and per leaf:
test_torch_render.py, test_torch_grad.py):

* the two ranks' frames equal each other and the one-process frame exactly,
  whole and in chunks; two 1-spp passes at offsets 0 and 1 compose to the
  2-spp frame (tests/test_multihost.py:97, tests/test_sharding.py:118);
* the two-rank train step returns the same parameters on both ranks, and
  the one-process step's loss and parameters (rtol 1e-5 / atol 1e-5,
  tests/test_multihost.py:215); the ranks meet at the coordination
  barrier on the first step only;
* a barrier that times out raises, and a rank that fails ends the run at
  once (tests/torch_ranks.py);
* a rank's block of a pixel batch, the replicated scene, and the warm-up
  render on one process.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import BLOB, RanksFailed, run_ranks  # noqa: E402

from simplepath_tpu_torch import load_scene  # noqa: E402
from simplepath_tpu_torch.core.rng import prng_key  # noqa: E402
from simplepath_tpu_torch.convert import params_to_numpy  # noqa: E402
from simplepath_tpu_torch.diff.grad import get_params, make_train_step  # noqa: E402
from simplepath_tpu_torch.parallel import (RayMesh, make_ray_mesh,  # noqa: E402
                                           render_image_sharded,
                                           replicate_scene, shard_pixels,
                                           warmup_render)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def blob():
    return load_scene(BLOB, device="cpu")


def test_two_ranks_render_equals_one_process(blob, tmp_path):
    r0, r1 = run_ranks("ray", 2, tmp_path)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    one = render_image_sharded(blob, 2, prng_key(0), device="cpu").numpy()
    assert np.isfinite(one).all() and one.mean() > 0
    np.testing.assert_array_equal(r0["img"], one)
    np.testing.assert_array_equal(r0["chunked"], r0["pass0"])
    np.testing.assert_array_equal(
        r0["pass0"], render_image_sharded(blob, 1, prng_key(0),
                                          device="cpu").numpy())
    np.testing.assert_allclose((r0["pass0"] + r0["pass1"]) / 2, one,
                               atol=2e-6)


def test_two_ranks_train_step_equals_one_process(blob, tmp_path):
    r0, r1 = run_ranks("train", 2, tmp_path)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert int(r0["barriers"]) == 1

    g = torch.arange(2, 48, 4)
    ys, xs = torch.meshgrid(g, g, indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    target = torch.full((xs.numel(), 3), 0.25)
    step = make_train_step(blob, 1, device="cpu")
    params = get_params(blob)
    for i in (1, 2):
        params, loss = step(params, target, xs, ys, prng_key(4))
        np.testing.assert_allclose(float(r0[f"loss{i}"]), float(loss),
                                   rtol=1e-5)
        for k, v in params_to_numpy(params).items():
            np.testing.assert_allclose(r0[f"p{i}_{k}"], v, atol=1e-5,
                                       err_msg=f"step {i}: {k}")
    moved = np.abs(r0["p1_mat_albedo"] - blob.materials.albedo.numpy()).max()
    assert moved > 1e-6


def test_a_barrier_that_times_out_raises(tmp_path):
    r0, _ = run_ranks("barrier", 2, tmp_path)
    assert "monitoredBarrier" in str(r0["raised"]), r0["raised"]
    assert float(r0["waited_s"]) < 30


def test_a_failing_rank_ends_the_run_at_once(tmp_path):
    t0 = time.time()
    with pytest.raises(RanksFailed, match="rank 1 fails on purpose"):
        run_ranks("raise", 2, tmp_path)
    assert time.time() - t0 < 40


def test_shard_pixels_and_replicate_scene(blob):
    """A rank's block of a pixel batch padded to the world size, and the
    scene on the rank's device; one process is a world of one."""
    lone = make_ray_mesh(device="cpu")
    assert (lone.rank, lone.world, lone.group) == (0, 1, None)
    xs, ys = torch.arange(5), torch.arange(5) + 10
    blocks = [shard_pixels(RayMesh(r, 2, None, torch.device("cpu")), xs, ys)
              for r in (0, 1)]
    assert [b[2] for b in blocks] == [5, 5]
    assert torch.equal(torch.cat([b[0] for b in blocks]),
                       torch.tensor([0, 1, 2, 3, 4, 0]))
    assert torch.equal(torch.cat([b[1] for b in blocks]),
                       torch.tensor([10, 11, 12, 13, 14, 0]))
    assert replicate_scene(lone, blob).device == torch.device("cpu")
    assert warmup_render(blob, 1, lone) > 0
