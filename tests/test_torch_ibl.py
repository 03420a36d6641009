"""The image-based environment light against the JAX package: the
piecewise-constant distributions, the texture samplers, the light's
sample/pdf/radiance and the tables ``load_scene`` builds (the renders are in
``test_torch_ibl_render.py`` and, for direct lighting,
``test_torch_integrators.py``).

Tolerances: the distributions and samplers agree at 1e-6 (and equal the JAX
tests' probe values where those are checked exactly); the light's functions
at rtol 1e-5 / atol 1e-6 (a few directions pass through arccos/atan2, whose
last ulp differs between libm and XLA).  The scene's image and luminance table equal
the JAX package's byte for byte; its CDFs only at rtol 1e-6, because XLA's
``cumsum`` adds in another order than ``torch.cumsum`` (they differ in the
last bit).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import simplepath_tpu as J
import simplepath_tpu_torch as T
from simplepath_tpu.core import distribution as JD
from simplepath_tpu.io import texture as JX
from simplepath_tpu.render import lights as JL
from simplepath_tpu.scene import types as JT
from simplepath_tpu_torch.convert import scene_from_numpy
from simplepath_tpu_torch.core import distribution as TD
from simplepath_tpu_torch.io import texture as TX
from simplepath_tpu_torch.render import lights as TL
from simplepath_tpu_torch.scene import types as TT

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
IBL_SCENES = ["g_ibl", "g_ibl_rrnee", "g_combo_ibl"]
CDF_FIELDS = {"cdf_cond", "cdf_cond_int", "cdf_marg_f", "cdf_marg", "cdf_marg_int"}
RS = np.random.RandomState(11)


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


def close(out, ref, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol, atol=atol)


# ------------------------------------------------------------ distribution

F1 = np.array([1.0, 3.0, 0.0, 4.0], np.float32)
U1 = np.array([0.05, 0.1, 0.2, 0.3, 0.6, 0.9, 0.999], np.float32)


def test_1d_probe_values():
    """The reference probe values of TestDistributions, through the port."""
    d = TD.build_distribution_1d(torch.from_numpy(F1))
    x, pdf, off = TD.sample_continuous_1d(d, torch.from_numpy(U1))
    close(x, [-0.05, -0.016667, 0.175, 0.2, 0.65, 0.725, 0.74975], 0, 1e-5)
    close(pdf, [0.5, 0.5, 1.5, 1.5, 2.0, 2.0, 2.0], 0, 1e-6)
    np.testing.assert_array_equal(off.numpy(), [0, 0, 1, 1, 3, 3, 3])
    off, pdf, ur = TD.sample_discrete_1d(d, torch.from_numpy(U1))
    np.testing.assert_array_equal(off.numpy(), [0, 0, 1, 1, 3, 3, 3])
    close(pdf, [0.125, 0.125, 0.375, 0.375, 0.5, 0.5, 0.5], 0, 1e-6)
    close(ur.numpy()[[0, 1, 4, 5, 6]], [-0.2, -0.066667, -0.4, -0.1, -0.001], 0, 1e-5)
    assert np.all(np.isneginf(ur.numpy()[[2, 3]]))
    close(TD.discrete_pdf_1d(d, torch.arange(4)), [0.125, 0.375, 0.0, 0.5], 0, 1e-6)
    d2 = TD.build_distribution_1d(torch.tensor([2.0, 1.0]), -1.0, 3.0)
    off, pdf, ur = TD.sample_discrete_1d(d2, torch.tensor([0.2, 0.8]))
    np.testing.assert_array_equal(off.numpy(), [0, 1])
    close(pdf, [0.166667, 0.083333], 0, 1e-5)
    close(ur, [-1.4, -0.04], 0, 1e-5)


def test_2d_probe_values():
    d = TD.build_distribution_2d(torch.tensor([[1.0, 0.0], [0.0, 3.0]]))
    u = torch.tensor([[0.1, 0.1], [0.1, 0.6], [0.6, 0.1], [0.6, 0.6]])
    st, pdf = TD.sample_continuous_2d(d, u)
    close(st, [[-0.45, -0.1], [-0.4, 0.3], [-0.2, -0.1], [0.1, 0.3]], 0, 1e-5)
    close(pdf, [1.0, 3.0, 1.0, 3.0], 0, 1e-5)
    p = torch.tensor([[0.2, 0.2], [0.2, 0.8], [0.8, 0.2], [0.8, 0.8]])
    close(TD.pdf_2d(d, p), [1.0, 0.0, 0.0, 3.0], 0, 1e-6)


def t1d(jd) -> TD.Distribution1D:
    """The port's Distribution1D over the JAX-built tables: sampling is
    compared on equal tables (the builds differ in the cumsum's last bit,
    which the sampling's remainder ``du`` divides by a narrow segment)."""
    return TD.Distribution1D(*(torch.from_numpy(np.array(a)) for a in jd[:3]),
                             jd.dmin, jd.dmax)


@pytest.mark.parametrize("f", [F1, np.zeros(5, np.float32),
                               RS.rand(37).astype(np.float32) * (RS.rand(37) < 0.7)],
                         ids=["probe", "zero_integral", "random"])
def test_1d_matches_jax(f):
    u = np.concatenate([U1, RS.rand(300).astype(np.float32)])
    x = np.linspace(-0.2, 1.2, 57).astype(np.float32)
    jd = JD.build_distribution_1d(jnp.asarray(f))
    for a, b in zip(TD.build_distribution_1d(torch.from_numpy(f))[:3], jd[:3]):
        close(a, b)
    td = t1d(jd)
    if not f.any():   # the zero-integral fallback is not shifted
        close(td.cdf, np.arange(6) / 5)
    for a, b in zip(TD.sample_continuous_1d(td, torch.from_numpy(u)),
                    JD.sample_continuous_1d(jd, jnp.asarray(u))):
        close(a, b)
    for a, b in zip(TD.sample_discrete_1d(td, torch.from_numpy(u)),
                    JD.sample_discrete_1d(jd, jnp.asarray(u))):
        close(a, b)
    close(TD.discrete_pdf_1d(td, torch.arange(len(f))),
          JD.discrete_pdf_1d(jd, jnp.arange(len(f))))
    for a, b in zip(TD.invert_1d(td, torch.from_numpy(x)),
                    JD.invert_1d(jd, jnp.asarray(x))):
        close(a, b)


def test_2d_matches_jax():
    f = (RS.rand(9, 14) * (RS.rand(9, 14) < 0.8)).astype(np.float32)
    f[3] = 0.0                                      # a zero row
    u = RS.rand(500, 2).astype(np.float32)
    p = (RS.rand(500, 2) * 1.4 - 0.2).astype(np.float32)
    jd = JD.build_distribution_2d(jnp.asarray(f))
    built = TD.build_distribution_2d(torch.from_numpy(f))
    for a, b in zip(built[:3] + built.marginal[:3], jd[:3] + jd.marginal[:3]):
        close(a, b)
    td = TD.Distribution2D(*(torch.from_numpy(np.array(a)) for a in jd[:3]),
                           t1d(jd.marginal))
    for a, b in zip(TD.sample_continuous_2d(td, torch.from_numpy(u)),
                    JD.sample_continuous_2d(jd, jnp.asarray(u))):
        close(a, b)
    close(TD.pdf_2d(td, torch.from_numpy(p)), JD.pdf_2d(jd, jnp.asarray(p)))


# ------------------------------------------------------------ texture

def test_remap_probe_values():
    f = torch.tensor([-0.25, 0.0, 0.5, 1.0, 1.75])
    out, _ = TX.remap(f, "none")
    close(out, [-0.25, 0.0, 0.5, 1.0, 1.75])
    out, _ = TX.remap(f, "clamp")
    assert float(out[0]) == 0.0 and float(out[3]) < 1.0 and float(out[4]) < 1.0
    _, ok = TX.remap(f, "black")
    np.testing.assert_array_equal(ok.numpy(), [False, True, True, False, False])
    out, _ = TX.remap(f, "repeat")
    close(out, [0.25, 0.0, 0.5, 0.0, 0.75])
    out, _ = TX.remap(f, "wrap")
    close(out, [0.75, 0.0, 0.5, 0.0, 0.75])
    with pytest.raises(ValueError):
        TX.remap(f, "mirror")


@pytest.mark.parametrize("sampler", ["sample_nearest_neighbor",
                                     "sample_bilinear", "sample_bilinear_true"])
@pytest.mark.parametrize("policy", ["clamp", "black", "repeat", "wrap"])
def test_samplers_match_jax(sampler, policy):
    img = RS.rand(5, 7, 3).astype(np.float32)
    s = (RS.rand(200) * 1.6 - 0.3).astype(np.float32)
    t = (RS.rand(200) * 1.6 - 0.3).astype(np.float32)
    s[:4] = [0.0, 0.5, 1.0 / 7, 3.0 / 7]          # texel edges
    out = getattr(TX, sampler)(torch.from_numpy(img), torch.from_numpy(s),
                               torch.from_numpy(t), policy, "clamp")
    ref = getattr(JX, sampler)(jnp.asarray(img), jnp.asarray(s), jnp.asarray(t),
                               policy, "clamp")
    assert out.shape == (200, 3)
    close(out, ref)
    for a, b in zip(TX.remap(torch.from_numpy(s), policy),
                    JX.remap(jnp.asarray(s), policy)):
        close(a, b)


def test_samplers_take_scalar_coordinates():
    img = np.arange(18, dtype=np.float32).reshape(2, 3, 3)
    ti = torch.from_numpy(img)
    close(TX.sample_nearest_neighbor(ti, torch.tensor(0.4), torch.tensor(0.3)), img[1, 1])
    close(TX.sample_bilinear(ti, torch.tensor(0.55), torch.tensor(0.3)), img[0, 1])
    close(TX.sample_bilinear_true(ti, torch.tensor(1.0 / 3.0), torch.tensor(0.25)),
          0.5 * (img[0, 0] + img[0, 1]), 1e-5)


# ------------------------------------------------------------ the light

@pytest.fixture(scope="module")
def ibl():
    js = J.load_scene(scene_path("g_ibl"))
    ts = scene_from_numpy(dataclasses.asdict(js.static), jax_scene_arrays(js),
                          device="cpu")
    return js, ts


def _dirs(n):
    d = RS.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:3] = [[0, 1, 0], [0, -1, 0], [1, 0, 0]]     # the poles and the seam
    return d.astype(np.float32)


def test_ibl_sample_pdf_radiance_match_jax(ibl):
    js, ts = ibl
    u = RS.rand(800, 2).astype(np.float32)
    ref = jax.vmap(lambda x: JL.env_light_sample(js.env, JT.ENV_IBL, x))(jnp.asarray(u))
    out = TL.env_light_sample(ts.env, TT.ENV_IBL, torch.from_numpy(u))
    for o, r in zip(out, ref):
        close(o, r, 1e-5, 1e-6)
    assert float(out.pdf.max()) > 0 and float(out.L.max()) > 1.0   # the sun
    wi = _dirs(800)
    close(TL.env_light_pdf(ts.env, TT.ENV_IBL, torch.from_numpy(wi)),
          jax.vmap(lambda w: JL.env_light_pdf(js.env, JT.ENV_IBL, w))(jnp.asarray(wi)),
          1e-5, 1e-6)
    close(TL.env_light_radiance(ts.env, TT.ENV_IBL, torch.from_numpy(wi)),
          jax.vmap(lambda w: JL.env_light_radiance(js.env, JT.ENV_IBL, w))(
              jnp.asarray(wi)), 1e-5, 1e-6)
    # batched over lights as the integrators call it: [nl, N, 3]
    assert TL.env_light_pdf(ts.env, TT.ENV_IBL,
                            torch.from_numpy(wi).expand(2, 800, 3)).shape == (2, 800)


@pytest.mark.parametrize("name", IBL_SCENES)
def test_ibl_scene_loads_and_equals_jax(name):
    """``load_scene`` builds an IBL scene; every array equals the JAX
    package's byte for byte (the image and the sampled luminance table
    included), the CDFs at rtol 1e-6."""
    js = J.load_scene(scene_path(name))
    ts = T.load_scene(scene_path(name), device="cpu")
    assert ts.static.env_kind == TT.ENV_IBL
    assert dataclasses.asdict(js.static) == dataclasses.asdict(ts.static)
    for path, ref in jax_scene_arrays(js).items():
        group, field = path.split(".")
        out = getattr(getattr(ts, group), field).numpy()
        assert out.dtype == ref.dtype and out.shape == ref.shape, path
        if group == "env" and field in CDF_FIELDS:
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0, err_msg=path)
        else:
            assert out.tobytes() == ref.tobytes(), path
    h, w = ts.env.image.shape[:2]
    assert ts.env.cdf_cond.shape == (2 * h, 2 * w + 1)
    assert ts.env.cdf_marg.shape == (2 * h + 1,)


def test_scene_from_numpy_carries_the_env_group(ibl):
    js, ts = ibl
    assert ts.static.env_kind == TT.ENV_IBL
    for f in dataclasses.fields(js.env):
        assert getattr(ts.env, f.name).numpy().tobytes() == \
            np.asarray(getattr(js.env, f.name)).tobytes(), f.name
