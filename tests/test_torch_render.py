"""The slice as a whole: a scene built by the JAX package, carried over with
``convert.scene_from_numpy``, rendered by both packages from the same key.

The RNG streams are bit-equal (test_torch_rng.py), so the comparison is per
pixel: rtol 1e-3 / atol 1e-4 on at least 98 % of the pixels and the image
mean within 0.5 %.  (Not 100 %: a lobe or layer choice ``u < w`` can flip on
a last-ulp difference of ``w`` between libm and XLA, which changes that
pixel's whole path.)
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import simplepath_tpu as J
import simplepath_tpu_torch as T
from simplepath_tpu_torch.convert import scene_from_numpy
from simplepath_tpu_torch.core.rng import prng_key
from simplepath_tpu_torch.parallel.mesh import render_image_sharded
from simplepath_tpu_torch.render import integrators as TI

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
ROOT = os.path.dirname(HERE)


def scene_path(name):
    return os.path.join(HERE, "scenes", name + ".sp")


def jax_scene_arrays(js) -> dict:
    out = {}
    for g in dataclasses.fields(js):
        group = getattr(js, g.name)
        if g.name == "static" or group is None:
            continue
        for f in dataclasses.fields(group):
            out[f"{g.name}.{f.name}"] = np.asarray(getattr(group, f.name))
    return out


def _pixels(static, n=64):
    xs = (np.arange(n) * 3) % static.width
    ys = (np.arange(n) * 7) % static.height
    return xs, ys


@pytest.mark.parametrize("name", ["g_blob", "g_mesh_ply", "g_glossy"])
def test_render_rays_matches_jax_per_pixel(name):
    js = J.load_scene(scene_path(name))
    ts = scene_from_numpy(dataclasses.asdict(js.static), jax_scene_arrays(js),
                          device="cpu")
    xs, ys = _pixels(js.static)
    ref = np.asarray(J.render_rays(js, jnp.asarray(xs, jnp.int32),
                                   jnp.asarray(ys, jnp.int32), spp=2,
                                   key=jax.random.PRNGKey(0)))
    out = T.render_rays(ts, torch.from_numpy(xs), torch.from_numpy(ys), 2,
                        prng_key(0), device="cpu").numpy()
    assert out.shape == ref.shape == (64, 3)
    assert np.isfinite(out).all() and out.mean() > 0
    close = np.isclose(out, ref, rtol=1e-3, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.98, f"{(~close).sum()} of 64 pixels differ"
    assert abs(out.mean() - ref.mean()) <= 0.005 * ref.mean()


def test_bench_scene_crop_matches_jax_per_pixel():
    """The main path's own scene (327,680 triangles; glossy, clearcoat; the
    C++ BVH builder where a compiler exists): both packages build the same
    record table, byte for byte, and 128 seeded pixels of the frame agree."""
    path = os.path.join(ROOT, "scenes", "bunny_bench.sp")
    js = J.load_scene(path)
    ts = T.load_scene(path, device="cpu")
    assert ts.static.num_triangles == 327680
    assert np.asarray(js.bvh.records).tobytes() == ts.bvh.records.numpy().tobytes()
    rs = np.random.RandomState(0)
    xs, ys = rs.randint(100, 924, 128), rs.randint(300, 1000, 128)
    ref = np.asarray(J.render_rays(js, jnp.asarray(xs, jnp.int32),
                                   jnp.asarray(ys, jnp.int32), spp=2,
                                   key=jax.random.PRNGKey(5)))
    out = T.render_rays(ts, torch.from_numpy(xs), torch.from_numpy(ys), 2,
                        prng_key(5), device="cpu").numpy()
    close = np.isclose(out, ref, rtol=1e-3, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.98, f"{(~close).sum()} of 128 pixels differ"
    assert out.mean() > 0
    assert abs(out.mean() - ref.mean()) <= 0.005 * ref.mean()


@pytest.fixture(scope="module")
def blob():
    return T.load_scene(scene_path("g_blob"), device="cpu")


def test_sort_on_and_off_are_bit_identical(blob):
    """The coherence sort is a pure permutation of per-lane state."""
    xs, ys = _pixels(blob.static, 200)
    args = (blob, torch.from_numpy(xs), torch.from_numpy(ys), 2, prng_key(1))
    plain = T.render_rays(*args, device="cpu", sort=False)
    sorted_ = T.render_rays(*args, device="cpu", sort=True)
    default = T.render_rays(*args, device="cpu")       # CPU tensors: no sort
    assert torch.equal(plain, sorted_)
    assert torch.equal(plain, default)
    assert float(plain.mean()) > 0


def test_sort_is_decided_by_device_and_size(blob):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not TI._use_coherence_sort(blob, 1 << 16, cpu)
    assert TI._use_coherence_sort(blob, TI.SORT_MIN_RAYS, cuda)
    assert not TI._use_coherence_sort(blob, TI.SORT_MIN_RAYS - 1, cuda)


def test_coherence_order_matches_jax(blob):
    from simplepath_tpu.render import integrators as JI
    rs = np.random.RandomState(2)
    n = 500
    p = (rs.rand(n, 3) * 3 - 1.5).astype(np.float32)
    rd = rs.randn(n, 3).astype(np.float32)
    alive = rs.rand(n) < 0.8
    lo, inv = TI._scene_sort_bounds(blob)
    ref = JI._coherence_order(jnp.asarray(alive), jnp.asarray(p), jnp.asarray(rd),
                              jnp.asarray(lo.numpy()), jnp.asarray(inv.numpy()))
    out = TI._coherence_order(torch.from_numpy(alive), torch.from_numpy(p),
                              torch.from_numpy(rd), lo, inv)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_chunked_frame_equals_one_batch(blob):
    """48x48 = 2304 pixels in chunks of 512 (the last one padded) against
    the whole frame as one batch: identical."""
    key = prng_key(2)
    whole = T.render_image(blob, 1, key, device="cpu")
    chunked = render_image_sharded(blob, 1, key, chunk_rays=512, device="cpu")
    assert whole.shape == (48, 48, 3)
    assert torch.equal(whole, chunked)
    one = render_image_sharded(blob, 1, key, device="cpu")   # n <= chunk branch
    assert torch.equal(whole, one)


def test_spp_offset_composes(blob):
    xs, ys = _pixels(blob.static)
    args = (blob, torch.from_numpy(xs), torch.from_numpy(ys))
    key = prng_key(3)
    full = T.render_rays(*args, 4, key, device="cpu")
    a = T.render_rays(*args, 2, key, spp_offset=0, device="cpu")
    b = T.render_rays(*args, 2, key, spp_offset=2, device="cpu")
    torch.testing.assert_close((a + b) / 2, full, rtol=1e-6, atol=1e-7)
    assert not torch.equal(a, b)


def test_unknown_integrator_raises():
    with pytest.raises(ValueError):
        TI.make_integrator("no_such_integrator")
    assert TI.make_integrator("iterative_rrnee") is TI.integrate_rrnee


def test_device_none_means_cuda_and_raises_without_one(blob):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    xs, ys = _pixels(blob.static, 4)
    key = prng_key(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.load_scene(scene_path("g_blob"))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.render_rays(blob, torch.from_numpy(xs), torch.from_numpy(ys), 1, key)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.render_image(blob, 1, key)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_image_sharded(blob, 1, key)
    with pytest.raises(RuntimeError, match="CUDA"):
        scene_from_numpy({}, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        T.resolve_device("cuda")


def test_float32_is_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _run_isolated(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_imports_neither_jax_nor_the_jax_package():
    out = _run_isolated(
        "import sys, pkgutil, importlib\n"
        "import simplepath_tpu_torch as sp\n"
        "for m in pkgutil.walk_packages(sp.__path__, 'simplepath_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'simplepath_tpu' or m.startswith('simplepath_tpu.')]\n"
        "print('BAD', bad)\n")
    assert "BAD []" in out


def test_chip_smoke_imports_no_jax_and_fails_without_a_gpu():
    out = _run_isolated(
        "import sys, importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'simplepath_tpu')]\n"
        "print('BAD', bad)\n")
    assert "BAD []" in out
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run in full")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
