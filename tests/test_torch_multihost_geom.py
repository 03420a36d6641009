"""Geometry sharding over processes (``parallel/geom_shard.py``), ranks over
gloo on the CPU, held against the port's own replicated render and train
step (which equal the JAX package's: test_torch_render.py,
test_torch_grad.py):

* 1-D, two ranks: a forest of 2 (a shard a rank) and of 4 (two a rank);
  both ranks' films are equal, and within 1e-4 of the replicated render
  (tests/test_multihost.py:316, tests/test_geom_shard.py:31);
* 2-D, four ranks as a 2 x 2 grid (rays x geom): the render, within 1e-4
  (tests/test_geom_shard.py:51), and one train step split over the ray
  blocks, against the replicated step as tests/test_geom_shard.py:244
  holds it.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import BLOB, run_ranks  # noqa: E402

from simplepath_tpu_torch import load_scene  # noqa: E402
from simplepath_tpu_torch.core.rng import prng_key  # noqa: E402
from simplepath_tpu_torch.diff.grad import get_params, make_train_step  # noqa: E402
from simplepath_tpu_torch.parallel import render_image_sharded  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def blob():
    return load_scene(BLOB, device="cpu")


@pytest.fixture(scope="module")
def replicated(blob):
    return render_image_sharded(blob, 2, prng_key(11), device="cpu").numpy()


def test_two_ranks_1d_forest_equals_replicated(replicated, tmp_path):
    r0, r1 = run_ranks("geom1d", 2, tmp_path)
    for d in ("d2", "d4"):
        np.testing.assert_array_equal(r0[d], r1[d], err_msg=d)
        diff = np.abs(r0[d] - replicated).max()
        assert diff < 1e-4, f"{d}: max diff {diff}"
    assert replicated.mean() > 0


def test_four_ranks_2d_grid_equals_replicated(blob, replicated, tmp_path):
    ranks = run_ranks("geom2d", 4, tmp_path)
    for r in ranks[1:]:
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    out = ranks[0]
    assert np.abs(out["img"] - replicated).max() < 1e-4

    g = torch.arange(2, 48, 4)
    ys, xs = torch.meshgrid(g, g, indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    p0 = get_params(blob)
    ref, ref_loss = make_train_step(blob, 2, device="cpu")(
        p0, torch.full((xs.numel(), 3), 0.25), xs, ys, prng_key(2))
    np.testing.assert_allclose(float(out["loss"]), float(ref_loss), rtol=1e-4)
    d_new = out["p_mat_albedo"] - p0["mat_albedo"].numpy()
    d_ref = (ref["mat_albedo"] - p0["mat_albedo"]).numpy()
    assert np.abs(d_new).max() > 1e-7, "no update"
    np.testing.assert_allclose(d_new, d_ref, rtol=0.05, atol=1e-6)
