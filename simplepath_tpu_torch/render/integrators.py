"""Light-transport integrators over batched ray wavefronts.

Counterpart of ``simplepath_tpu/render/integrators.py``: all eight
integrators of the scene DSL.  Each bounce is a ``step(depth, state) ->
state`` function over the whole wavefront with an ``alive`` mask, driven by
:func:`_bounce_loop`, which exits as soon as every lane has terminated (one
host sync per bounce).  With ``scene.static.differentiable`` every bounce
runs under ``torch.utils.checkpoint``, so reverse mode keeps only the
per-bounce state.  An integrator maps (scene, ro[N,3],
rd[N,3], keys[N,2], *, pcoords=[N,2] film coordinates) -> L[N,3]; the
adaptive-RR one also threads its per-pixel statistics (``stats=``).

Faithfully reproduced reference quirks (as in the JAX package):

* The NEE integrator adds UNWEIGHTED light radiance when the path ray hits a
  light on top of the MIS NEE estimate.
* ``estimate_direct_mis`` RETURNS EARLY when the light-sample strategy is
  invalid or occluded, dropping the BSDF strategy for that sample.
* The BSDF-strategy occlusion test runs with t_max = ∞ and counts lights as
  occluders.  Consequence — used as an EXACT optimization: a BSDF ray that
  hits a sphere light is always self-blocked, so the strategy can only ever
  contribute ENVIRONMENT radiance.  With no env light it is identically zero
  and is skipped; with one, the closest-light search collapses into the
  occlusion test already being done.
* ``brute_force`` (the recursive flavor) uses the signed cosine and a fresh
  t_min = ε each bounce.
* Whitted's specular recursion does not attenuate by the specular sample.

RNG: every uniform draw has a static site id; per-depth keys are
``fold_in(key, depth)`` so lanes and bounces decorrelate (direct lighting,
one bounce, draws on the keys themselves).  The streams are bit-equal to
the JAX package's (core/rng.py).
"""

from __future__ import annotations

import os

import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from ..core.color import hsv_to_rgb, relative_luminance
from ..core.onb import onb_from_v, onb_to_local, onb_to_world
from ..core.rng import fold_in, uniform_sites
from ..core.smath import balance_heuristic_counts
from ..core.vec import dot
from ..scene.types import ENV_NONE, Scene
from .intersect import INF_DISTANCE, RAY_EPSILON
from .lights import (LightSample, env_light_pdf, env_light_radiance,
                     env_light_sample, get_ray_offset, get_ray_offset_nd,
                     sphere_light_pdf, sphere_light_sample)
from .materials import (PROP_SPECULAR, HitMaterial, MatSample, gather_material,
                        material_eval, material_pdf, material_sample)
from .traverse import (hit_shading, scene_intersect_batch,
                       scene_intersect_lights, scene_intersect_p_batch)

__all__ = ["make_integrator", "INTEGRATOR_FNS", "integrate_direct_lighting",
           "integrate_rrnee", "integrate_brute_force",
           "integrate_brute_force_iterative",
           "integrate_brute_force_iterative_rr",
           "integrate_brute_force_iterative_dynamic_rr", "integrate_whitted",
           "integrate_mandelbrot"]

# Draw-site ids (stable across the codebase, equal to the JAX package's)
SITE_MAT_LAYER = 0
SITE_MAT_LOBE = 1
SITE_MAT_2D = 2
SITE_RR = 3
SITE_LIGHT_BASE = 16          # per light l: base + 8*l + {0: light 2D, 1-3: NEE material}

# wavefronts smaller than this are not worth sorting
SORT_MIN_RAYS = 4096

RR_CUTOFF = 0.1               # fixed Russian roulette: luminance threshold
RR_MIN_SAMPLES = 16           # adaptive RR: observations before a bucket acts
MANDELBROT_ITERATIONS = 4096
# the Mandelbrot loop asks the device whether a lane is still active this
# often (a host sync); finished lanes never change, so the image is the same
MANDELBROT_CHECK_EVERY = 64


def _light_sites(light_index: int) -> tuple[int, int, int, int]:
    b = SITE_LIGHT_BASE + 8 * light_index
    return b, b + 1, b + 2, b + 3


def _num_lights(scene: Scene) -> int:
    return scene.static.num_sphere_lights + (1 if scene.static.env_kind != ENV_NONE else 0)


def _light_sample(scene: Scene, light_index: int, p, n, u) -> LightSample:
    """Unified light.sample over the static light list: sphere lights first,
    then the environment light."""
    if light_index < scene.static.num_sphere_lights:
        return sphere_light_sample(scene.sphere_lights, light_index, p, n, u)
    ls = env_light_sample(scene.env, scene.static.env_kind, u)
    # InfiniteLight: shadow ray t_min from the observer normal
    return ls._replace(t_min=get_ray_offset_nd(n, ls.wi))


def _light_pdf(scene: Scene, light_index: int, p, wi):
    if light_index < scene.static.num_sphere_lights:
        return sphere_light_pdf(scene.sphere_lights, light_index, p, wi)
    return env_light_pdf(scene.env, scene.static.env_kind, wi)


def _stack_tuples(items):
    """Stack a list of NamedTuples of tensors field by field → [nl, ...]."""
    return type(items[0])(*(torch.stack(xs) for xs in zip(*items)))


def _light_samples_all(scene: Scene, p, nrm, u_light):
    """Draw the light-sampling-strategy sample for EVERY light over the whole
    wavefront → LightSample of [nl, N, ...] plus ls_ok [nl, N].
    ``u_light[li]`` is light li's [N,2] uniforms (its own draw site, as in
    the reference's for_each_light loop)."""
    ls = _stack_tuples([_light_sample(scene, li, p, nrm, u_light[li])
                        for li in range(_num_lights(scene))])
    ls_ok = (ls.pdf > 0.0) & (ls.L != 0.0).any(dim=-1)
    return ls, ls_ok


def _estimate_direct_mis_all(scene: Scene, p, nrm, wo_world, onb,
                             m: HitMaterial, keys, enabled) -> Tensor:
    """estimate_direct_mis, batched over the whole wavefront AND summed over
    all lights.

    Shadow rays for every lane and every light are assembled into ONE flat
    [nl*N] batch (with an env light: both strategies, [2*nl*N]) and traversed
    by one any-hit launch (:func:`traverse.scene_intersect_p_batch`).  Lanes
    whose contribution is masked (``enabled`` false, or an invalid light
    sample) carry a collapsed interval (t_max = -inf) so the kernel culls
    them on the first visit; their masked results are identical either way.

    Reference semantics kept:
    * early-return when the light strategy is invalid or occluded → the BSDF
      strategy is gated on ``ls_ok & ~occluded``;
    * the BSDF-strategy occlusion runs with t_max = ∞ and counts lights as
      blockers, so it only ever delivers ENVIRONMENT radiance — with no env
      light it is identically zero and skipped (module docstring).
    """
    n = p.shape[0]
    nl = _num_lights(scene)
    if nl == 0:
        return torch.zeros((n, 3), dtype=torch.float32, device=p.device)
    neg_inf = -INF_DISTANCE
    has_env = scene.static.env_kind != ENV_NONE

    # every light's draw sites in one hash pass: [nl, 4, N, 2]
    sites = [s for li in range(nl) for s in _light_sites(li)]
    u_all = uniform_sites(keys, sites).reshape(nl, 4, n, 2)

    ls, ls_ok = _light_samples_all(scene, p, nrm, u_all[:, 0])   # [nl, N, ...]

    ro_flat = p[None].expand(nl, n, 3).reshape(-1, 3)
    live1 = enabled[None] & ls_ok
    wo_local = onb_to_local(onb, wo_world)                       # [N,3]
    wi_local = onb_to_local(onb[None], ls.wi)                    # [nl,N,3]

    if has_env:
        # BSDF-sampling strategy: its material samples don't depend on the
        # light-strategy occlusion result, so BOTH strategies' shadow rays go
        # through ONE fused any-hit launch of 2·nl·N rays.  The reference
        # gates strategy 2 on the light sample being unoccluded (early
        # return); that gate moves into strat2_ok after the fact — lanes it
        # disables traverse uselessly but contribute nothing, so images are
        # identical while the launch count per bounce halves.
        ms = _stack_tuples([
            material_sample(m, wo_local, u_all[li, 1, :, 0], u_all[li, 2, :, 0],
                            u_all[li, 3])
            for li in range(nl)])
        ms_ok = (ms.pdf > 0.0) & (ms.color != 0.0).any(dim=-1)    # [nl,N]
        wi2 = onb_to_world(onb[None], ms.wi)
        cos2 = torch.abs(dot(wi2, nrm[None]))
        mat_t_min = get_ray_offset(cos2)
        live2 = enabled[None] & ls_ok & ms_ok

        ro_all = torch.cat([ro_flat, ro_flat])
        rd_all = torch.cat([ls.wi.reshape(-1, 3), wi2.reshape(-1, 3)])
        tmn_all = torch.cat([ls.t_min.reshape(-1), mat_t_min.reshape(-1)])
        tmx_all = torch.cat([
            torch.where(live1, ls.t_max, neg_inf).reshape(-1),
            torch.where(live2, INF_DISTANCE, neg_inf).reshape(-1)])
        occ_all = scene_intersect_p_batch(scene, ro_all, rd_all, tmn_all, tmx_all)
        occluded = occ_all[:nl * n].reshape(nl, n)
        blocked = occ_all[nl * n:].reshape(nl, n)
    else:
        occluded = scene_intersect_p_batch(
            scene, ro_flat, ls.wi.reshape(-1, 3), ls.t_min.reshape(-1),
            torch.where(live1, ls.t_max, neg_inf).reshape(-1)).reshape(nl, n)

    f = material_eval(m, wo_local, wi_local)              # [nl,N,3]
    bsdf_pdf = material_pdf(m, wo_local, wi_local)        # [nl,N]
    w1 = balance_heuristic_counts(1, ls.pdf, 1, bsdf_pdf)
    cos1 = torch.abs(dot(ls.wi, nrm[None]))
    strat1 = f * ls.L * (cos1 * w1 / torch.where(ls.pdf > 0, ls.pdf, 1.0))[..., None]
    strat1_ok = ls_ok & ~occluded & (f != 0.0).any(dim=-1) & (bsdf_pdf > 0.0)
    total = torch.where(strat1_ok[..., None], strat1, 0.0).sum(0)

    if not has_env:
        return total

    strat2_enabled = ls_ok & ~occluded
    light_pdf2 = torch.stack([_light_pdf(scene, li, p, wi2[li])
                              for li in range(nl)])                   # [nl,N]
    w2 = balance_heuristic_counts(1, ms.pdf, 1, light_pdf2)
    env_L = env_light_radiance(scene.env, scene.static.env_kind, wi2)
    strat2 = ms.color * env_L * (cos2 * w2 / torch.where(ms.pdf > 0, ms.pdf, 1.0))[..., None]
    strat2_ok = strat2_enabled & ms_ok & (light_pdf2 > 0.0) & ~blocked
    return total + torch.where(strat2_ok[..., None], strat2, 0.0).sum(0)


def _estimate_direct_all(scene: Scene, p, nrm, wo_world, onb, m: HitMaterial,
                         keys, enabled) -> Tensor:
    """estimate_direct without MIS, batched over the wavefront and summed
    over all lights; every light's shadow rays go through one flat any-hit
    launch of nl·N rays (masked lanes with a collapsed interval), as in
    :func:`_estimate_direct_mis_all`."""
    n = p.shape[0]
    nl = _num_lights(scene)
    if nl == 0:
        return torch.zeros((n, 3), dtype=torch.float32, device=p.device)
    u_light = uniform_sites(keys, [_light_sites(li)[0] for li in range(nl)])
    ls, ls_ok = _light_samples_all(scene, p, nrm, u_light)      # [nl, N, ...]
    wo_local = onb_to_local(onb, wo_world)
    f = material_eval(m, wo_local, onb_to_local(onb[None], ls.wi))  # [nl,N,3]

    live = enabled[None] & ls_ok
    occluded = scene_intersect_p_batch(
        scene, p[None].expand(nl, n, 3).reshape(-1, 3), ls.wi.reshape(-1, 3),
        ls.t_min.reshape(-1),
        torch.where(live, ls.t_max, -INF_DISTANCE).reshape(-1)).reshape(nl, n)
    cos1 = torch.abs(dot(ls.wi, nrm[None]))
    contrib = f * ls.L * (cos1 / torch.where(ls.pdf > 0, ls.pdf, 1.0))[..., None]
    ok = ls_ok & (f != 0.0).any(dim=-1) & ~occluded
    return torch.where(ok[..., None], contrib, 0.0).sum(0)


def _sample_batch(scene: Scene, mid, wo_local, u_mat) -> tuple[HitMaterial, MatSample]:
    """Gather each lane's material and draw its bounce sample; ``u_mat`` is
    the [3, N, 2] uniforms of the sites (layer, lobe, 2D)."""
    m = gather_material(scene.materials, mid)
    return m, material_sample(m, wo_local, u_mat[0, :, 0], u_mat[1, :, 0], u_mat[2])


# ------------------------------------------------------- coherence sort

def _part1by2(x: Tensor) -> Tensor:
    """Spread the low 10 bits of x so there are two zero bits between each."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


# Origin-cell quantization of the coherence-sort key (read once at import),
# clamped so the key fits 32 bits (3 octant bits + 3*bits Morton)
_SORT_BITS = min(9, max(1, int(os.environ.get("SIMPLEPATH_SORT_BITS", "7"))))


def _coherence_order(alive, p, rd, lo, inv_extent) -> Tensor:
    """Permutation that groups rays into coherent warps for the next bounce.

    Key = (direction octant, Morton code of the quantized origin cell); dead
    lanes sort last so whole warps go dead together and their
    (collapsed-interval) traversals exit on the first stack pop.  The sort is
    a pure permutation of independent per-lane computations, so the rendered
    image is bit-identical with or without it — it exists purely to keep a
    warp's rays on neighbouring BVH rows.  The argsort is stable (as
    ``jnp.argsort`` is), so ties preserve scanline/pixel order.
    """
    bits = _SORT_BITS
    top = float((1 << bits) - 1)
    oct_ = ((rd[:, 0] < 0).to(torch.int64) * 4
            + (rd[:, 1] < 0).to(torch.int64) * 2
            + (rd[:, 2] < 0).to(torch.int64))
    q = torch.clamp((p - lo) * inv_extent * top, 0.0, top).to(torch.int64)
    m = ((_part1by2(q[:, 0]) << 2) | (_part1by2(q[:, 1]) << 1)
         | _part1by2(q[:, 2]))
    key = (oct_ << (3 * bits)) | m
    key = torch.where(alive, key, 0xFFFFFFFF)
    return torch.argsort(key, stable=True)


def _scene_sort_bounds(scene: Scene) -> tuple[Tensor, Tensor]:
    """(lo, 1/extent) of the triangle soup, for the coherence-sort key."""
    tri = scene.triangles
    lo = torch.stack([torch.minimum(torch.minimum(
        getattr(tri, "v0" + ax).min(), getattr(tri, "v1" + ax).min()),
        getattr(tri, "v2" + ax).min()) for ax in "xyz"])
    hi = torch.stack([torch.maximum(torch.maximum(
        getattr(tri, "v0" + ax).max(), getattr(tri, "v1" + ax).max()),
        getattr(tri, "v2" + ax).max()) for ax in "xyz"])
    return lo, 1.0 / torch.clamp_min(hi - lo, 1e-6)


def _use_coherence_sort(scene: Scene, n_rays: int, device: torch.device) -> bool:
    """Sorting only pays where divergence costs: on CUDA tensors, on a
    triangle BVH, for wavefronts of at least SORT_MIN_RAYS rays; never in
    differentiable mode (as in the JAX package)."""
    return (device.type == "cuda" and not scene.static.differentiable
            and scene.static.has_bvh and scene.static.num_triangles > 0
            and n_rays >= SORT_MIN_RAYS)


def _bounce_loop(scene: Scene, state: tuple, step, max_depth: int) -> tuple:
    """Drive ``step(depth, state) -> state`` for up to ``max_depth``
    bounces; the state's last element is the alive mask, and the loop stops
    once no lane is alive (one host sync per bounce).

    With ``scene.static.differentiable`` each bounce runs under
    ``torch.utils.checkpoint``: reverse mode then keeps only the per-bounce
    state (a few [N]-vectors) and recomputes one bounce at a time, O(1)
    activation memory in depth (the JAX package's ``jax.checkpoint`` in its
    fixed-trip ``fori_loop``).  The recompute is exact: every draw comes from
    threefry keys, none from torch's RNG.  After every lane has died, the
    JAX package's fixed-trip bounces change nothing, so stopping early gives
    the same values and gradients."""
    for depth in range(max_depth):
        if not bool(state[-1].any()):       # one host sync per bounce
            break
        if scene.static.differentiable:
            state = checkpoint(step, depth, state, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            state = step(depth, state)
    return state


# ------------------------------------------------------------- integrators

def integrate_rrnee(scene: Scene, ro: Tensor, rd: Tensor, keys: Tensor, *,
                    pcoords: Tensor | None = None,
                    sort: bool | None = None) -> Tensor:
    """IntegratorIterativeRRNEE — the flagship.

    ``keys`` is the [N,2] per-(pixel, sample) threefry keys.  ``sort``
    overrides the coherence-sort decision (None = by device and batch size);
    the image is identical either way.  Only this integrator sorts, as in the
    JAX package.
    """
    n_rays = ro.shape[0]
    dev = ro.device
    max_depth = scene.static.max_depth
    rr_depth = scene.static.russian_roulette_depth
    if sort is None:
        sort = _use_coherence_sort(scene, n_rays, dev)
    if sort:
        if scene.static.num_triangles == 0:
            raise ValueError("the coherence sort needs a triangle soup")
        sort_lo, sort_inv = _scene_sort_bounds(scene)

    neg = -INF_DISTANCE

    def step(depth: int, state: tuple) -> tuple:
        orig, ro, rd, t_min, throughput, L, alive = state
        dkeys = fold_in(keys[orig], depth)
        # sites 0..3 (material layer, lobe, 2D; Russian roulette): one pass
        u_mat = uniform_sites(dkeys, (SITE_MAT_LAYER, SITE_MAT_LOBE,
                                      SITE_MAT_2D, SITE_RR))

        # dead lanes carry a collapsed interval: every intersector, kernel
        # and plain, rejects them without special-casing
        lhit, ldist, lL = scene_intersect_lights(
            scene, ro, rd, t_min, torch.where(alive, INF_DISTANCE, neg))
        t_max = torch.where(lhit, ldist, INF_DISTANCE)
        hit = scene_intersect_batch(scene, ro, rd, t_min,
                                    torch.where(alive, t_max, neg))

        p, nrm, mid = hit_shading(scene, hit, ro, rd)
        onb = onb_from_v(nrm)
        wo = -rd
        wo_local = onb_to_local(onb, wo)
        m, ms = _sample_batch(scene, mid, wo_local, u_mat)
        ms_ok = (ms.pdf > 0.0) & (ms.color != 0.0).any(dim=-1)

        # NEE over all lights: the whole wavefront's shadow rays traverse in
        # one batched any-hit query; masked lanes collapse their intervals
        nee_mask = alive & hit.valid & ms_ok
        nee = _estimate_direct_mis_all(scene, p, nrm, wo, onb, m, dkeys, nee_mask)
        L = L + torch.where(nee_mask[:, None], throughput * nee, 0.0)

        # throughput update
        wi = onb_to_world(onb, ms.wi)
        cosine = torch.abs(dot(wi, nrm))
        contrib = cosine[:, None] * ms.color / torch.where(ms.pdf > 0, ms.pdf, 1.0)[:, None]
        new_throughput = throughput * contrib

        # Russian roulette
        lum = relative_luminance(new_throughput)
        rr_active = (lum < RR_CUTOFF) if depth >= rr_depth else torch.zeros_like(alive)
        q = torch.clamp_min(lum / RR_CUTOFF, 0.05)
        rr_continue = u_mat[3, :, 0] < q
        new_throughput = torch.where((rr_active & rr_continue)[:, None],
                                     new_throughput / q[:, None], new_throughput)

        escaped = alive & ~hit.valid
        L = L + torch.where((escaped & lhit)[:, None], throughput * lL, 0.0)
        continues = alive & hit.valid & ms_ok & ~(rr_active & ~rr_continue)

        c3 = continues[:, None]
        out = (orig, torch.where(c3, p, ro), torch.where(c3, wi, rd),
               torch.where(continues, get_ray_offset(cosine), t_min),
               torch.where(c3, new_throughput, throughput), L, continues)
        if sort:
            # regroup surviving rays (pure permutation of per-lane state —
            # the image is unchanged; see _coherence_order)
            perm = _coherence_order(continues, out[1], out[2], sort_lo, sort_inv)
            out = tuple(a[perm] for a in out)
        return out

    # per-lane state; permuted every bounce by the coherence sort, `orig`
    # carries each lane's original index for the un-permute at the end
    state = (torch.arange(n_rays, device=dev), ro, rd,
             torch.full((n_rays,), RAY_EPSILON, dtype=torch.float32, device=dev),
             torch.ones((n_rays, 3), dtype=torch.float32, device=dev),
             torch.zeros((n_rays, 3), dtype=torch.float32, device=dev),
             torch.ones(n_rays, dtype=torch.bool, device=dev))
    orig, _, _, _, _, L, _ = _bounce_loop(scene, state, step, max_depth)
    out = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    out[orig] = L
    return out


def integrate_direct_lighting(scene: Scene, ro: Tensor, rd: Tensor, keys: Tensor,
                              *, pcoords: Tensor | None = None) -> Tensor:
    """DirectLightingIntegrator: the first hit's direct light (no MIS), or
    the light the camera ray sees.  Draws on ``keys`` themselves (no
    per-depth fold)."""
    n_rays = ro.shape[0]
    dev = ro.device
    t_min = torch.full((n_rays,), RAY_EPSILON, dtype=torch.float32, device=dev)
    t_max0 = torch.full((n_rays,), INF_DISTANCE, dtype=torch.float32, device=dev)
    lhit, ldist, lL = scene_intersect_lights(scene, ro, rd, t_min, t_max0)
    hit = scene_intersect_batch(scene, ro, rd, t_min,
                                torch.where(lhit, ldist, t_max0))
    p, nrm, mid = hit_shading(scene, hit, ro, rd)
    onb = onb_from_v(nrm)
    m = gather_material(scene.materials, mid)
    contrib = _estimate_direct_all(scene, p, nrm, -rd, onb, m, keys, hit.valid)
    L = torch.where(hit.valid[:, None], contrib, 0.0)
    return torch.where((~hit.valid & lhit)[:, None], lL, L)


def _integrate_bruteforce_common(scene: Scene, ro: Tensor, rd: Tensor,
                                 keys: Tensor, *, abs_cosine: bool,
                                 offset_tmin: bool, rr: str,
                                 stats: tuple[Tensor, Tensor] | None = None):
    """Shared bounce loop of the brute-force family: no NEE, radiance only
    where a path escapes to a light.  ``rr`` is "none", "fixed" (luminance
    below RR_CUTOFF) or "dynamic" (below the pixel's running mean at this
    depth, see :func:`integrate_brute_force_iterative_dynamic_rr`).
    Returns L, and with ``rr="dynamic"`` also the updated stats."""
    n_rays = ro.shape[0]
    dev = ro.device
    max_depth = scene.static.max_depth
    rr_depth = scene.static.russian_roulette_depth
    neg = -INF_DISTANCE
    sites = (SITE_MAT_LAYER, SITE_MAT_LOBE, SITE_MAT_2D) + (
        (SITE_RR,) if rr != "none" else ())
    nd = stats[0].shape[1] if rr == "dynamic" else 0

    def step(depth: int, state: tuple) -> tuple:
        # ``stats`` is (mean, count) with rr="dynamic", else empty
        ro, rd, t_min, throughput, L, *stats, alive = state
        u = uniform_sites(fold_in(keys, depth), sites)
        lhit, ldist, lL = scene_intersect_lights(
            scene, ro, rd, t_min, torch.where(alive, INF_DISTANCE, neg))
        t_max = torch.where(lhit, ldist, INF_DISTANCE)
        hit = scene_intersect_batch(scene, ro, rd, t_min,
                                    torch.where(alive, t_max, neg))

        p, nrm, mid = hit_shading(scene, hit, ro, rd)
        onb = onb_from_v(nrm)
        _, ms = _sample_batch(scene, mid, onb_to_local(onb, -rd), u)
        ms_ok = (ms.pdf > 0.0) & (ms.color != 0.0).any(dim=-1)

        wi = onb_to_world(onb, ms.wi)
        cosine_signed = dot(wi, nrm)
        cosine = torch.abs(cosine_signed) if abs_cosine else cosine_signed
        contrib = cosine[:, None] * ms.color / torch.where(ms.pdf > 0, ms.pdf, 1.0)[:, None]
        new_throughput = throughput * contrib
        continues = alive & hit.valid & ms_ok

        rr_active = None
        if rr == "fixed" and depth >= rr_depth:
            lum = relative_luminance(new_throughput)
            rr_active = lum < RR_CUTOFF
            q = torch.clamp_min(lum / RR_CUTOFF, 0.05)
        col = depth - rr_depth                      # this depth's bucket
        in_bucket = rr == "dynamic" and 0 <= col < nd
        if in_bucket:
            mean, count = stats
            bucket_mean, bucket_n = mean[:, col], count[:, col]
            lum = relative_luminance(new_throughput)
            rr_active = (bucket_n >= RR_MIN_SAMPLES) & (lum < bucket_mean)
            q = torch.clamp_min(
                lum / torch.where(bucket_mean > 0, bucket_mean, 1.0), 0.05)
        if rr_active is not None:
            rr_continue = u[3, :, 0] < q
            new_throughput = torch.where((rr_active & rr_continue)[:, None],
                                         new_throughput / q[:, None], new_throughput)
            continues = continues & ~(rr_active & ~rr_continue)
        if in_bucket:
            # survivors push their post-reweight luminance into the bucket;
            # out of place (a one-column select), so that the graph may
            # still read the old statistics
            n_new = bucket_n + 1
            mean_new = bucket_mean + (relative_luminance(new_throughput)
                                      - bucket_mean) / n_new.to(torch.float32)
            sel = continues[:, None] & (torch.arange(nd, device=dev) == col)
            stats = [torch.where(sel, mean_new[:, None], mean),
                     torch.where(sel, n_new[:, None], count)]

        L = L + torch.where((alive & ~hit.valid & lhit)[:, None], throughput * lL, 0.0)

        c3 = continues[:, None]
        if offset_tmin:
            t_min = torch.where(continues, get_ray_offset(torch.abs(cosine_signed)), t_min)
        return (torch.where(c3, p, ro), torch.where(c3, wi, rd), t_min,
                torch.where(c3, new_throughput, throughput), L, *stats, continues)

    state = (ro, rd,
             torch.full((n_rays,), RAY_EPSILON, dtype=torch.float32, device=dev),
             torch.ones((n_rays, 3), dtype=torch.float32, device=dev),
             torch.zeros((n_rays, 3), dtype=torch.float32, device=dev),
             *(stats if rr == "dynamic" else ()),
             torch.ones(n_rays, dtype=torch.bool, device=dev))
    state = _bounce_loop(scene, state, step, max_depth)
    if rr == "dynamic":
        return state[4], (state[5], state[6])
    return state[4]


def integrate_brute_force(scene: Scene, ro: Tensor, rd: Tensor, keys: Tensor,
                          *, pcoords: Tensor | None = None) -> Tensor:
    """BruteForceIntegrator, the recursive flavor: signed cosine, fresh ε
    t_min every bounce."""
    return _integrate_bruteforce_common(scene, ro, rd, keys, abs_cosine=False,
                                        offset_tmin=False, rr="none")


def integrate_brute_force_iterative(scene: Scene, ro: Tensor, rd: Tensor,
                                    keys: Tensor, *,
                                    pcoords: Tensor | None = None) -> Tensor:
    """BruteForceIntegratorIterative."""
    return _integrate_bruteforce_common(scene, ro, rd, keys, abs_cosine=True,
                                        offset_tmin=True, rr="none")


def integrate_brute_force_iterative_rr(scene: Scene, ro: Tensor, rd: Tensor,
                                       keys: Tensor, *,
                                       pcoords: Tensor | None = None) -> Tensor:
    """BruteForceIntegratorIterativeRR: fixed Russian roulette."""
    return _integrate_bruteforce_common(scene, ro, rd, keys, abs_cosine=True,
                                        offset_tmin=True, rr="fixed")


def dynamic_rr_buckets(scene: Scene) -> int:
    """Depth buckets of the adaptive-RR statistics."""
    return max(1, scene.static.max_depth - scene.static.russian_roulette_depth)


def integrate_brute_force_iterative_dynamic_rr(
        scene: Scene, ro: Tensor, rd: Tensor, keys: Tensor, *,
        pcoords: Tensor | None = None,
        stats: tuple[Tensor, Tensor] | None = None):
    """BruteForceIntegratorIterativeDynamicRR — the reference's adaptive-RR
    variant.

    Adaptive RR signal: per-pixel per-depth running MEAN of throughput
    luminance across samples, as Welford state ``(mean[N, nd] f32,
    count[N, nd] i32)`` threaded through the spp loop by the film — pass it
    as ``stats`` and this returns ``(L, new_stats)``.  With ``stats=None`` a
    zero-count state is used for this one sample (RR never fires below
    RR_MIN_SAMPLES observations) and only L is returned.

    Per depth >= russian_roulette_depth: once a bucket has RR_MIN_SAMPLES
    observations and the path's luminance is below the bucket mean, continue
    with probability q = max(0.05, lum/mean); survivors are reweighted and
    push their POST-reweight luminance.  Signed cosine, offset t_min.
    """
    if stats is None:
        nd = dynamic_rr_buckets(scene)
        zeros = lambda dt: torch.zeros((ro.shape[0], nd), dtype=dt, device=ro.device)
        return _integrate_bruteforce_common(
            scene, ro, rd, keys, abs_cosine=False, offset_tmin=True,
            rr="dynamic", stats=(zeros(torch.float32), zeros(torch.int32)))[0]
    return _integrate_bruteforce_common(scene, ro, rd, keys, abs_cosine=False,
                                        offset_tmin=True, rr="dynamic",
                                        stats=stats)


def integrate_whitted(scene: Scene, ro: Tensor, rd: Tensor, keys: Tensor, *,
                      pcoords: Tensor | None = None) -> Tensor:
    """WhittedIntegrator: direct lighting at every hit of a specular chain,
    which is NOT attenuated by the specular sample (reference quirk)."""
    n_rays = ro.shape[0]
    dev = ro.device
    neg = -INF_DISTANCE
    t_min = torch.full((n_rays,), RAY_EPSILON, dtype=torch.float32, device=dev)

    def step(depth: int, state: tuple) -> tuple:
        ro, rd, L, alive = state
        dkeys = fold_in(keys, depth)
        lhit, ldist, lL = scene_intersect_lights(
            scene, ro, rd, t_min, torch.where(alive, INF_DISTANCE, neg))
        t_max = torch.where(lhit, ldist, INF_DISTANCE)
        hit = scene_intersect_batch(scene, ro, rd, t_min,
                                    torch.where(alive, t_max, neg))

        p, nrm, mid = hit_shading(scene, hit, ro, rd)
        onb = onb_from_v(nrm)
        wo = -rd
        m = gather_material(scene.materials, mid)
        dmask = alive & hit.valid
        direct = _estimate_direct_all(scene, p, nrm, wo, onb, m, dkeys, dmask)
        L = L + torch.where(dmask[:, None], direct, 0.0)
        L = L + torch.where((alive & ~hit.valid & lhit)[:, None], lL, 0.0)

        u_mat = uniform_sites(dkeys, (SITE_MAT_LAYER, SITE_MAT_LOBE, SITE_MAT_2D))
        ms = material_sample(m, onb_to_local(onb, wo), u_mat[0, :, 0],
                             u_mat[1, :, 0], u_mat[2])
        continues = dmask & ((ms.properties & PROP_SPECULAR) != 0)
        c3 = continues[:, None]
        return (torch.where(c3, p, ro),
                torch.where(c3, onb_to_world(onb, ms.wi), rd), L, continues)

    state = (ro, rd, torch.zeros((n_rays, 3), dtype=torch.float32, device=dev),
             torch.ones(n_rays, dtype=torch.bool, device=dev))
    return _bounce_loop(scene, state, step, scene.static.max_depth)[2]


def integrate_mandelbrot(scene: Scene, ro: Tensor, rd: Tensor, keys: Tensor, *,
                         pcoords: Tensor | None = None) -> Tensor:
    """MandelbrotIntegrator — the film's smoke test: the escape count of
    the jittered film position ``pcoords`` over MANDELBROT_ITERATIONS,
    colored through HSV.  Traces no ray."""
    if pcoords is None:
        raise ValueError("the mandelbrot integrator needs pcoords (film x, y)")
    width, height = scene.static.width, scene.static.height
    x0, x1, y0, y1 = -2.0, 1.0, -1.0, 1.0
    x = x0 + pcoords[:, 0] * (x1 - x0) / width
    y = y0 + pcoords[:, 1] * (y1 - y0) / height

    zr, zi = x.clone(), y.clone()
    count = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    active = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    for it in range(MANDELBROT_ITERATIONS):
        if it % MANDELBROT_CHECK_EVERY == 0 and not bool(active.any()):
            break
        active = active & (zr * zr + zi * zi <= 4.0)
        new_re = zr * zr - zi * zi
        new_im = 2.0 * zr * zi
        zr = torch.where(active, x + new_re, zr)
        zi = torch.where(active, y + new_im, zi)
        count = count + active.to(torch.int32)
    value = count.to(torch.float32) / MANDELBROT_ITERATIONS
    hue = torch.remainder(torch.pow(value * 360.0, 1.5), 360.0) / 360.0
    return hsv_to_rgb(hue, torch.ones_like(value), value)


INTEGRATOR_FNS = {
    "mandelbrot": integrate_mandelbrot,
    "brute_force": integrate_brute_force,
    "brute_force_iterative": integrate_brute_force_iterative,
    "brute_force_iterative_rr": integrate_brute_force_iterative_rr,
    "brute_force_iterative_dynamic_rr": integrate_brute_force_iterative_dynamic_rr,
    "iterative_rrnee": integrate_rrnee,
    "direct_lighting": integrate_direct_lighting,
    "whitted": integrate_whitted,
}


def make_integrator(name: str):
    """The integrator function for a DSL name (one of ``INTEGRATORS``)."""
    if name not in INTEGRATOR_FNS:
        raise ValueError(f"unknown integrator {name!r}")
    return INTEGRATOR_FNS[name]
