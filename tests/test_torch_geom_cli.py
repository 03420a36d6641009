"""The CLI's ``--geom-shards`` and differentiation through the forest
(``parallel/geom_shard.py``), on one process:

* ``--geom-shards 2`` writes the forest render; with ``--spp-chunk`` and
  ``--checkpoint`` the passes compose to the one-shot forest render, and a
  render cut after its first pass and resumed by the CLI equals the whole
  one byte for byte (tests/test_geom_shard.py:138, :152); more shards than
  triangles is a usage error (:177);
* the albedo gradient through a forest of 4 equals the replicated
  gradient, and central differences (:185).
"""

import os

import numpy as np
import pytest
import torch

from simplepath_tpu_torch import cli, load_scene
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.diff.grad import (get_params, render_loss,
                                            render_loss_and_grad)
from simplepath_tpu_torch.io.pfm import read_pfm
from simplepath_tpu_torch.parallel.geom_shard import (
    make_geom_mesh, render_image_geom_sharded, shard_scene_geometry)
from simplepath_tpu_torch.render.film import render_image_progressive
from simplepath_tpu_torch.utils import load_checkpoint

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
BLOB = os.path.join(HERE, "scenes", "g_blob.sp")


def forest(d):
    return shard_scene_geometry(load_scene(BLOB, use_bvh=False, device="cpu"),
                                make_geom_mesh(d))


def test_cli_geom_shards(tmp_path):
    out = tmp_path / "blob.pfm"
    assert cli.main([BLOB, "--samples", "1", "--geom-shards", "2",
                     "--output", str(out), "--platform", "cpu"]) == 0
    img = read_pfm(str(out))
    assert img.shape == (48, 48, 3) and np.isfinite(img).all()
    one = render_image_geom_sharded(forest(2), 1, prng_key(0), device="cpu")
    np.testing.assert_array_equal(img, one.numpy())

    with pytest.raises(SystemExit):
        cli.main([BLOB, "--samples", "1", "--geom-shards", "5121",
                  "--output", str(tmp_path / "x.pfm"), "--platform", "cpu"])


def test_cli_geom_shards_checkpoint_cut_and_resumed(tmp_path):
    args = [BLOB, "--samples", "2", "--geom-shards", "2", "--spp-chunk", "1",
            "--platform", "cpu", "--no-progress"]
    whole, ck = tmp_path / "whole.pfm", tmp_path / "ck.npz"
    assert cli.main(args + ["--checkpoint", str(ck), "--output",
                            str(whole)]) == 0
    img = read_pfm(str(whole))
    one = render_image_geom_sharded(forest(2), 2, prng_key(0), device="cpu")
    np.testing.assert_allclose(img, one.numpy(), atol=2e-6)

    # the same progressive render through the forest, whose second pass
    # dies: its checkpoint keeps the first pass, and the CLI resumes it
    passes = []

    def dying(*a, **kw):
        passes.append(kw["spp_offset"])
        if len(passes) == 2:
            raise KeyboardInterrupt("cut")
        return render_image_geom_sharded(*a, **kw)

    cut, ck_cut = tmp_path / "cut.pfm", tmp_path / "ck_cut.npz"
    with pytest.raises(KeyboardInterrupt):
        render_image_progressive(forest(2), 2, prng_key(0), chunk=1,
                                 checkpoint_path=str(ck_cut),
                                 checkpoint_every=1, render_fn=dying,
                                 device="cpu")
    assert passes == [0, 1] and load_checkpoint(str(ck_cut))[1] == 1
    assert cli.main(args + ["--checkpoint", str(ck_cut), "--output",
                            str(cut)]) == 0
    assert cut.read_bytes() == whole.read_bytes()


def test_albedo_gradient_through_forest():
    scene = forest(4)
    rep = load_scene(BLOB, device="cpu")
    g = torch.arange(6, 48, 4)
    ys, xs = torch.meshgrid(g, g, indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    key = prng_key(2)
    target = torch.full((xs.numel(), 3), 0.25)
    params = get_params(scene)
    _, grads = render_loss_and_grad(scene, params, target, xs, ys, 2, key,
                                    device="cpu", leaves=("mat_albedo",))
    _, g_rep = render_loss_and_grad(rep, get_params(rep), target, xs, ys, 2,
                                    key, device="cpu", leaves=("mat_albedo",))
    assert torch.isfinite(grads["mat_albedo"]).all()
    g_ad, g_r = float(grads["mat_albedo"][1, 0]), float(g_rep["mat_albedo"][1, 0])
    assert abs(g_ad) > 1e-5, "the forest's albedo gradient is zero"
    assert abs(g_ad - g_r) < max(0.05 * abs(g_r), 1e-4), (g_ad, g_r)

    eps = 1e-3

    def loss(sign):
        p = dict(params)
        p["mat_albedo"] = params["mat_albedo"].clone()
        p["mat_albedo"][1, 0] += sign * eps
        with torch.no_grad():
            return float(render_loss(scene, p, target, xs, ys, 2, key,
                                     device="cpu"))
    g_fd = (loss(1) - loss(-1)) / (2 * eps)
    assert abs(g_ad - g_fd) < max(0.08 * max(abs(g_fd), abs(g_ad)), 2e-3), \
        (g_ad, g_fd)
