"""The port's ``core/`` math against the JAX package, function by function,
on seeded inputs.  Tolerances: rtol 1e-6 for plain arithmetic, 1e-5 where a
transcendental function is involved (libm and XLA differ in the last ulps).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simplepath_tpu.core import (color as Jc, onb as Jo, sampling as Js,
                                 smath as Jm, transform as Jt, vec as Jv)
from simplepath_tpu_torch.core import (color as Tc, onb as To, sampling as Ts,
                                       smath as Tm, transform as Tt, vec as Tv)

# many small tensor ops: one intra-op thread is as fast, and the test
# workers that run side by side do not fight over the cores
torch.set_num_threads(1)

N = 512
_RS = np.random.RandomState(0)
A3 = _RS.randn(N, 3).astype(np.float32)
B3 = _RS.randn(N, 3).astype(np.float32)
UNIT = (A3 / np.linalg.norm(A3, axis=1, keepdims=True)).astype(np.float32)
UNIT[:3] = [[0, 0, 1], [0, 0, -1], [0, 1, 0]]
U2 = _RS.rand(N, 2).astype(np.float32)
U2[:4] = [[0, 0], [0.5, 0.5], [0.999999, 0.25], [0.25, 0.999999]]
S = _RS.rand(N).astype(np.float32)
M33 = _RS.randn(N, 3, 3).astype(np.float32)
COS = np.concatenate([np.linspace(-1, 1, N - 2), [0.0, 1e-9]]).astype(np.float32)
# divisors with exact zeros (safe_divide gives 0 there)
DIV = np.where(S < 0.2, 0.0, B3[:, 0]).astype(np.float32)
# squared lengths 1 + d, d on both sides of is_normalized's eps (1e-3) and
# well clear of it
NEAR_UNIT = (UNIT * np.sqrt(1.0 + np.resize(
    np.float32([-2e-3, -9e-4, -5e-4, 0.0, 5e-4, 9e-4, 2e-3, 0.5]), N))[:, None]
    ).astype(np.float32)
# linear colours through 0, the sRGB knee at 0.0031308 and above 1
LINEAR = np.concatenate([
    [0.0, 0.0031308, np.nextafter(np.float32(0.0031308), np.float32(1)),
     1e-5, 1.0, 1.5], np.linspace(0.0, 4.0, 3 * N - 6)]).astype(
    np.float32).reshape(N, 3)
THETA = (U2[:, 0] * np.pi).astype(np.float32)
PHI = (U2[:, 1] * 2.0 * np.pi).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def j(x):
    return jnp.asarray(x)


def check(ref, out, rtol, atol=1e-7):
    ref = jax.tree_util.tree_leaves(ref)
    out = list(out) if isinstance(out, (tuple, list)) else [out]
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        o = o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
        np.testing.assert_allclose(o, np.asarray(r), rtol=rtol, atol=atol)


# (name, jax fn, torch fn, inputs, rtol)
CASES = [
    ("vec.dot", Jv.dot, Tv.dot, (A3, B3), 1e-6),
    ("vec.cross", Jv.cross, Tv.cross, (A3, B3), 1e-6),
    ("vec.length", Jv.length, Tv.length, (A3,), 1e-6),
    ("vec.normalize", Jv.normalize, Tv.normalize, (A3,), 1e-6),
    ("vec.safe_normalize", Jv.safe_normalize, Tv.safe_normalize,
     (np.concatenate([A3[:8], np.zeros((2, 3), np.float32)]),), 1e-6),
    ("vec.matvec3", Jv.matvec3, Tv.matvec3, (M33, A3), 1e-6),
    ("vec.vecmat3", Jv.vecmat3, Tv.vecmat3, (A3, M33), 1e-6),
    ("vec.safe_sqrt", Jv.safe_sqrt, Tv.safe_sqrt, (A3[:, 0],), 1e-6),
    ("vec.reflect", Jv.reflect, Tv.reflect, (A3, UNIT), 1e-6),
    ("vec.reflect_local", Jv.reflect_local, Tv.reflect_local, (A3,), 1e-6),
    ("vec.madd", Jv.madd, Tv.madd, (A3, B3, UNIT), 1e-6),
    ("vec.lerp", Jv.lerp, Tv.lerp, (S[:, None], A3, B3), 1e-6),
    ("vec.safe_divide", Jv.safe_divide, Tv.safe_divide, (A3[:, 0], DIV), 1e-6),
    ("vec.is_normalized", Jv.is_normalized, Tv.is_normalized, (NEAR_UNIT,), 0),
    ("onb.onb_create", Jo.onb_create, To.onb_create, (UNIT,), 1e-6),
    ("onb.onb_from_v", Jo.onb_from_v, To.onb_from_v, (A3,), 1e-6),
    ("smath.balance_heuristic", Jm.balance_heuristic, Tm.balance_heuristic,
     (S, np.where(S < 0.1, 0, S + 0.5).astype(np.float32)), 1e-6),
    ("smath.erfinv", Jm.erfinv, Tm.erfinv,
     (np.clip(COS, -0.999999, 0.999999),), 1e-5),
    ("smath.sin_theta", Jm.sin_theta, Tm.sin_theta, (UNIT,), 1e-6),
    ("smath.tan_theta", Jm.tan_theta, Tm.tan_theta, (UNIT,), 1e-5),
    ("smath.tan2_theta", Jm.tan2_theta, Tm.tan2_theta, (UNIT,), 1e-5),
    ("smath.cos_phi", Jm.cos_phi, Tm.cos_phi, (UNIT,), 1e-5),
    ("smath.sin_phi", Jm.sin_phi, Tm.sin_phi, (UNIT,), 1e-5),
    ("smath.same_hemisphere", Jm.same_hemisphere, Tm.same_hemisphere,
     (A3, B3), 0),
    ("sampling.uniform_sphere", Js.sample_to_uniform_sphere,
     Ts.sample_to_uniform_sphere, (U2,), 1e-5),
    ("sampling.uniform_hemisphere", Js.sample_to_uniform_hemisphere,
     Ts.sample_to_uniform_hemisphere, (U2,), 1e-5),
    ("sampling.concentric_disk", Js.sample_to_concentric_disk,
     Ts.sample_to_concentric_disk, (U2,), 1e-5),
    ("sampling.cosine_hemisphere", Js.sample_to_cosine_hemisphere,
     Ts.sample_to_cosine_hemisphere, (U2,), 1e-5),
    ("sampling.cosine_hemisphere_pdf", Js.cosine_hemisphere_pdf,
     Ts.cosine_hemisphere_pdf, (COS,), 1e-5),
    ("sampling.uniform_cone", Js.sample_to_uniform_cone,
     Ts.sample_to_uniform_cone, (U2, np.float32(0.8)), 1e-5),
    ("sampling.uniform_cone_pdf", Js.uniform_cone_pdf, Ts.uniform_cone_pdf,
     (COS[:-3],), 1e-5),
    ("sampling.spherical_direction", Js.spherical_direction,
     Ts.spherical_direction, (np.sin(THETA), np.cos(THETA), PHI), 1e-5),
    ("color.relative_luminance", Jc.relative_luminance, Tc.relative_luminance,
     (np.abs(A3),), 1e-6),
    ("color.rgb_to_srgb", Jc.rgb_to_srgb, Tc.rgb_to_srgb, (LINEAR,), 1e-6),
]


@pytest.mark.parametrize("name,jfn,tfn,args,rtol", CASES,
                         ids=[c[0] for c in CASES])
def test_core_function_matches_jax(name, jfn, tfn, args, rtol):
    # trig of 2π·u near u=1 leaves absolute errors of a few 1e-7 on values
    # near zero, so sampling functions get that much absolute slack
    atol = 1e-6 if name.startswith(("sampling", "smath.cos_phi", "smath.sin_phi",
                                    "onb")) else 1e-7
    check(jfn(*map(j, args)), tfn(*map(t, args)), rtol, atol)


def test_safe_divide_backward_matches_jax():
    """Where b == 0 both the value and the gradients are 0: the divisor is
    replaced before dividing, so no inf or NaN reaches either backward."""
    a, b = A3[:, 0], DIV
    ja, jb = jax.grad(lambda x, y: Jv.safe_divide(x, y).sum(), argnums=(0, 1))(j(a), j(b))
    ta, tb = t(a).requires_grad_(True), t(b).requires_grad_(True)
    Tv.safe_divide(ta, tb).sum().backward()
    assert (DIV == 0).any()
    assert torch.isfinite(ta.grad).all() and torch.isfinite(tb.grad).all()
    check((ja, jb), (ta.grad, tb.grad), 1e-6)


def test_onb_round_trip_and_frames():
    onb_j = Jo.onb_from_v(j(A3))
    onb_t = To.onb_from_v(t(A3))
    check(jax.vmap(Jo.onb_to_local)(onb_j, j(B3)), To.onb_to_local(onb_t, t(B3)),
          1e-5, 1e-6)
    check(jax.vmap(Jo.onb_to_world)(onb_j, j(B3)), To.onb_to_world(onb_t, t(B3)),
          1e-5, 1e-6)
    back = To.onb_to_world(onb_t, To.onb_to_local(onb_t, t(B3)))
    np.testing.assert_allclose(back.numpy(), B3, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("eta_t", [1.3, 1.5, 1.8])
def test_fresnel_dielectric_matches_jax(eta_t):
    check(Jm.fresnel_dielectric(j(COS), 1.0, eta_t),
          Tm.fresnel_dielectric(t(COS), 1.0, eta_t), 1e-5, 1e-7)
    # per-lane IOR tensors, as the material code passes them
    ior = (1.2 + S).astype(np.float32)
    check(Jm.fresnel_dielectric(j(COS), 1.0, j(ior)),
          Tm.fresnel_dielectric(t(COS), 1.0, t(ior)), 1e-5, 1e-7)


def test_balance_heuristic_counts_matches_jax():
    f = S
    g = np.where(S < 0.3, 0, 1 - S).astype(np.float32)
    f = np.where(S > 0.9, 0, f).astype(np.float32)
    check(Jm.balance_heuristic_counts(1, j(f), 1, j(g)),
          Tm.balance_heuristic_counts(1, t(f), 1, t(g)), 1e-6)


def test_transform_algebra_matches_jax():
    ja = Jt.affine_compose(Jt.affine_translate([1, 2, 3]),
                           Jt.affine_compose(Jt.affine_rotate([1, 1, 0], 33.0),
                                             Jt.affine_scale([0.5, 2, 1.5])))
    ta = Tt.affine_compose(Tt.affine_translate([1, 2, 3]),
                           Tt.affine_compose(Tt.affine_rotate([1, 1, 0], 33.0),
                                             Tt.affine_scale([0.5, 2, 1.5])))
    check(ja, ta, 1e-6)
    check(Jt.affine_inverse(ja), Tt.affine_inverse(ta), 1e-5, 1e-6)
    check(Jt.apply_point(ja, j(A3)), Tt.apply_point(ta, t(A3)), 1e-5, 1e-6)
    check(Jt.apply_normal(ja, j(A3)), Tt.apply_normal(ta, t(A3)), 1e-5, 1e-6)
    jt = Jt.transform_compose(Jt.Transform(ja, Jt.affine_inverse(ja)),
                              Jt.transform_identity())
    tt = Tt.transform_compose(Tt.Transform(ta, Tt.affine_inverse(ta)),
                              Tt.transform_identity())
    check(jt, [tt.fwd.linear, tt.fwd.t, tt.inv.linear, tt.inv.t], 1e-5, 1e-6)


def test_look_at_matches_jax():
    args = ([0.0, 2.0, 5.0], [-0.25, 1.0, 0.0], [0.0, 1.0, 0.0])
    check(Jt.look_at(*args), Tt.look_at(*args), 1e-6)
