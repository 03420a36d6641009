"""The port's materials and lights against the JAX package with the same
uniforms (rtol 1e-5; a few absolute 1e-6 where a value passes through
trigonometric functions of 2π·u)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simplepath_tpu.render import lights as JL, materials as JM
from simplepath_tpu.scene import types as JT
from simplepath_tpu_torch.render import lights as TL, materials as TM
from simplepath_tpu_torch.scene import types as TT

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)

N = 600
RS = np.random.RandomState(1)

# lambertian, glossy (rough, smooth, near-mirror), clearcoat over both
MATS = dict(
    base_type=np.array([0, 1, 1, 1, 0, 1], np.int32),
    albedo=np.array([[.1, .8, .8], [.8, .2, .2], [.8, .2, .8], [.6, .6, .6],
                     [.1, .2, .8], [.8, .2, .8]], np.float32),
    roughness=np.array([.5, .75, .25, .01, .5, .25], np.float32),
    ior=np.array([1.5, 1.8, 1.8, 1.8, 1.5, 1.8], np.float32),
    has_clearcoat=np.array([0, 0, 0, 0, 1, 1], np.int32),
    cc_ior=np.array([1.5, 1.5, 1.5, 1.5, 1.5, 1.3], np.float32),
    cc_color=np.array([[1, 1, 1]] * 4 + [[1, .8, .8], [1, 1, 1]], np.float32),
)


def _dirs(n, up=False):
    d = RS.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if up:
        d[:, 1] = np.abs(d[:, 1])
    return d.astype(np.float32)


WO = _dirs(N, up=True)
WO[:N // 8, 1] *= -1          # some below the surface
WI = _dirs(N)
MID = RS.randint(0, 6, N)
U_LAYER, U_LOBE = RS.rand(N).astype(np.float32), RS.rand(N).astype(np.float32)
U2 = RS.rand(N, 2).astype(np.float32)


@pytest.fixture(scope="module")
def mats():
    jm = JT.MaterialArrays(**{k: jnp.asarray(v) for k, v in MATS.items()})
    tm = TT.MaterialArrays(**{k: torch.from_numpy(v) for k, v in MATS.items()})
    rho_j = JM.build_rho_tables(jm)
    tm = TT.MaterialArrays(**{k: torch.from_numpy(v) for k, v in MATS.items()},
                           rho_table=TM.build_rho_tables(tm))
    hm_j = jax.vmap(lambda i: JM.gather_material(jm, rho_j, i))(jnp.asarray(MID))
    hm_t = TM.gather_material(tm, torch.from_numpy(MID))
    return jm, tm, rho_j, hm_j, hm_t


def close(out, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_build_rho_tables(mats):
    _, tm, rho_j, _, _ = mats
    assert tm.rho_table.shape == (6, TM.RHO_TABLE_SIZE)
    close(tm.rho_table, rho_j, atol=1e-7)


def test_gather_material_needs_a_rho_table():
    tm = TT.MaterialArrays(**{k: torch.from_numpy(v) for k, v in MATS.items()})
    with pytest.raises(ValueError, match="rho table"):
        TM.gather_material(tm, torch.zeros(3, dtype=torch.int64))


def test_material_sample(mats):
    """Same uniforms → same sample.  A lobe or layer pick ``u < w`` can flip
    on a last-ulp difference of w; such lanes (none expected at these seeds,
    at most a handful allowed) are excluded from the value comparison."""
    *_, hm_j, hm_t = mats
    ref = jax.vmap(JM.material_sample)(hm_j, jnp.asarray(WO), jnp.asarray(U_LAYER),
                                       jnp.asarray(U_LOBE), jnp.asarray(U2))
    out = TM.material_sample(hm_t, torch.from_numpy(WO), torch.from_numpy(U_LAYER),
                             torch.from_numpy(U_LOBE), torch.from_numpy(U2))
    same = out.properties.numpy() == np.asarray(ref.properties)
    assert same.mean() >= 0.99
    for o, r in ((out.color, ref.color), (out.wi, ref.wi), (out.pdf, ref.pdf)):
        # near-mirror lobes reach values of 1e3..1e5: relative tolerance only
        np.testing.assert_allclose(o.numpy()[same], np.asarray(r)[same],
                                   rtol=2e-4, atol=1e-5)


def test_material_eval_and_pdf(mats):
    *_, hm_j, hm_t = mats
    wo, wi = torch.from_numpy(WO), torch.from_numpy(WI)
    close(TM.material_eval(hm_t, wo, wi),
          jax.vmap(JM.material_eval)(hm_j, jnp.asarray(WO), jnp.asarray(WI)),
          rtol=1e-4)
    close(TM.material_pdf(hm_t, wo, wi),
          jax.vmap(JM.material_pdf)(hm_j, jnp.asarray(WO), jnp.asarray(WI)),
          rtol=1e-4)


def test_material_eval_broadcasts_over_lights(mats):
    """[nl,N,3] incoming directions against [N] materials, as NEE calls it."""
    *_, hm_t = mats
    wo = torch.from_numpy(WO)
    wi = torch.stack([torch.from_numpy(WI), torch.from_numpy(_dirs(N))])
    f = TM.material_eval(hm_t, wo, wi)
    assert f.shape == (2, N, 3)
    assert torch.equal(f[0], TM.material_eval(hm_t, wo, wi[0]))
    assert torch.equal(TM.material_pdf(hm_t, wo, wi)[1],
                       TM.material_pdf(hm_t, wo, wi[1]))


@pytest.mark.parametrize("fn", ["beckmann_d", "beckmann_lambda", "beckmann_g1"])
def test_beckmann_terms(fn):
    alpha = (0.05 + RS.rand(N)).astype(np.float32)
    ref = jax.vmap(getattr(JM, fn))(jnp.asarray(WI), jnp.asarray(alpha))
    close(getattr(TM, fn)(torch.from_numpy(WI), torch.from_numpy(alpha)), ref,
          rtol=1e-4, atol=1e-7)


def test_beckmann_sample_wh():
    alpha = (0.05 + RS.rand(N)).astype(np.float32)
    ref = jax.vmap(JM.beckmann_sample_wh)(jnp.asarray(WO), jnp.asarray(alpha),
                                          jnp.asarray(U2[:, 0]), jnp.asarray(U2[:, 1]))
    out = TM.beckmann_sample_wh(torch.from_numpy(WO), torch.from_numpy(alpha),
                                torch.from_numpy(U2[:, 0]), torch.from_numpy(U2[:, 1]))
    close(out, ref, rtol=2e-4, atol=2e-5)


# ------------------------------------------------------------------ lights

def _xform(scale, translate):
    l = np.diag(scale).astype(np.float32)
    t = np.asarray(translate, np.float32)
    il = np.linalg.inv(l).astype(np.float32)
    return l, t, il, (-il @ t).astype(np.float32)


LIGHTS = [_xform([.5, .5, .5], [0, 4, 0]), _xform([1, 2, 1], [3, 1, -2])]
P = (RS.randn(N, 3) * 2).astype(np.float32)
P[:5] = [0.1, 4.1, 0.0]      # inside light 0
NRM = _dirs(N)


@pytest.fixture(scope="module")
def sphere_lights():
    cols = [np.stack([x[k] for x in LIGHTS]) for k in range(4)]
    rad = np.array([[10, 10, 10], [1, 2, 3]], np.float32)
    names = ("o2w_l", "o2w_t", "w2o_l", "w2o_t")
    jl = JT.SphereLightArrays(**dict(zip(names, map(jnp.asarray, cols))),
                              radiance=jnp.asarray(rad))
    tl = TT.SphereLightArrays(**dict(zip(names, map(torch.from_numpy, cols))),
                              radiance=torch.from_numpy(rad))
    return jl, tl


@pytest.mark.parametrize("li", [0, 1])
def test_sphere_light_sample_and_pdf(sphere_lights, li):
    jl, tl = sphere_lights
    ref = jax.vmap(lambda p, n, u: JL.sphere_light_sample(jl, li, p, n, u))(
        jnp.asarray(P), jnp.asarray(NRM), jnp.asarray(U2))
    out = TL.sphere_light_sample(tl, li, torch.from_numpy(P),
                                 torch.from_numpy(NRM), torch.from_numpy(U2))
    for o, r in zip(out, ref):
        close(o, r, rtol=1e-4, atol=1e-5)
    # the cone pdf divides by 1 - cos_theta_max: the cancellation amplifies a
    # last-ulp difference of the square root, hence 1e-4
    close(TL.sphere_light_pdf(tl, li, torch.from_numpy(P), out.wi),
          jax.vmap(lambda p, w: JL.sphere_light_pdf(jl, li, p, w))(
              jnp.asarray(P), ref.wi), rtol=1e-4)


@pytest.mark.parametrize("li", [0, 1])
def test_sphere_light_intersect(sphere_lights, li):
    jl, tl = sphere_lights
    rd = _dirs(N)
    # aim half the rays at the light so that there are hits
    c = LIGHTS[li][1]
    aim = c - P
    rd[::2] = (aim / np.linalg.norm(aim, axis=1, keepdims=True))[::2]
    t_min = np.full(N, 1e-3, np.float32)
    t_max = np.where(RS.rand(N) < 0.2, -np.inf, np.inf).astype(np.float32)
    rt, rv = jax.vmap(lambda o, d, a, b: JL.sphere_light_intersect(jl, li, o, d, a, b))(
        jnp.asarray(P), jnp.asarray(rd), jnp.asarray(t_min), jnp.asarray(t_max))
    ot, ov = TL.sphere_light_intersect(tl, li, torch.from_numpy(P), torch.from_numpy(rd),
                                       torch.from_numpy(t_min), torch.from_numpy(t_max))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(rv))
    assert ov.any() and not ov[torch.from_numpy(t_max) < 0].any()
    v = ov.numpy()
    np.testing.assert_allclose(ot.numpy()[v], np.asarray(rt)[v], rtol=1e-4, atol=1e-5)


def _const_env():
    rad = np.array([0.6, 0.7, 0.8], np.float32)
    eye = np.eye(3, dtype=np.float32)
    z = lambda *s: np.zeros(s, np.float32)
    fields = dict(radiance=rad, image=z(1, 1, 3), l2w=eye, w2l=eye,
                  cdf_cond_f=z(1, 1), cdf_cond=z(1, 2), cdf_cond_int=z(1),
                  cdf_marg_f=z(1), cdf_marg=z(2), cdf_marg_int=z())
    return (JT.EnvLightArrays(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TT.EnvLightArrays(**{k: torch.from_numpy(np.array(v)) for k, v in fields.items()}))


def test_constant_env_light():
    je, te = _const_env()
    ref = jax.vmap(lambda u: JL.env_light_sample(je, JT.ENV_CONST, u))(jnp.asarray(U2))
    out = TL.env_light_sample(te, TT.ENV_CONST, torch.from_numpy(U2))
    for o, r in zip(out, ref):
        close(o, r, atol=1e-6)
    wi = torch.from_numpy(WI)
    close(TL.env_light_pdf(te, TT.ENV_CONST, wi),
          jax.vmap(lambda w: JL.env_light_pdf(je, JT.ENV_CONST, w))(jnp.asarray(WI)))
    close(TL.env_light_radiance(te, TT.ENV_CONST, wi),
          jax.vmap(lambda w: JL.env_light_radiance(je, JT.ENV_CONST, w))(jnp.asarray(WI)))


def test_ray_offset():
    c = np.concatenate([[0.0], RS.rand(50)]).astype(np.float32)
    close(TL.get_ray_offset(torch.from_numpy(c)), JL.get_ray_offset(jnp.asarray(c)))
