"""Light-transport integrators over batched ray wavefronts.

Counterpart of ``simplepath_tpu/render/integrators.py``.  This slice ports
the flagship, ``integrate_rrnee`` (IntegratorIterativeRRNEE); the other seven
names raise ``NotImplementedError`` from :func:`make_integrator`.  The bounce
loop is a Python loop over the whole wavefront with an ``alive`` mask; it
exits as soon as every lane has terminated (one host sync per bounce).  An
integrator maps (scene, ro[N,3], rd[N,3], keys[N,2]) -> L[N,3].

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

RNG: every uniform draw has a static site id; per-depth keys are
``fold_in(key, depth)`` so lanes and bounces decorrelate.  The streams are
bit-equal to the JAX package's (core/rng.py).
"""

from __future__ import annotations

import os

import torch
from torch import Tensor

from ..core.color import relative_luminance
from ..core.onb import onb_from_v, onb_to_local, onb_to_world
from ..core.rng import fold_in, uniform_sites
from ..core.smath import balance_heuristic_counts
from ..core.vec import dot
from ..scene.types import ENV_NONE, INTEGRATORS, Scene
from .intersect import INF_DISTANCE, RAY_EPSILON
from .lights import (LightSample, env_light_pdf, env_light_radiance,
                     env_light_sample, get_ray_offset, get_ray_offset_nd,
                     sphere_light_pdf, sphere_light_sample)
from .materials import (HitMaterial, MatSample, gather_material, material_eval,
                        material_pdf, material_sample)
from .traverse import (hit_shading, scene_intersect_batch,
                       scene_intersect_lights, scene_intersect_p_batch)

__all__ = ["make_integrator", "integrate_rrnee", "INTEGRATOR_FNS"]

# Draw-site ids (stable across the codebase, equal to the JAX package's)
SITE_MAT_LAYER = 0
SITE_MAT_LOBE = 1
SITE_MAT_2D = 2
SITE_RR = 3
SITE_LIGHT_BASE = 16          # per light l: base + 8*l + {0: light 2D, 1-3: NEE material}

# wavefronts smaller than this are not worth sorting
SORT_MIN_RAYS = 4096


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
    triangle BVH, for wavefronts of at least SORT_MIN_RAYS rays."""
    return (device.type == "cuda" and scene.static.has_bvh
            and scene.static.num_triangles > 0 and n_rays >= SORT_MIN_RAYS)


# ------------------------------------------------------------- integrators

def integrate_rrnee(scene: Scene, ro: Tensor, rd: Tensor, keys: Tensor,
                    sort: bool | None = None) -> Tensor:
    """IntegratorIterativeRRNEE — the flagship.

    ``keys`` is the [N,2] per-(pixel, sample) threefry keys.  ``sort``
    overrides the coherence-sort decision (None = by device and batch size);
    the image is identical either way.
    """
    n_rays = ro.shape[0]
    dev = ro.device
    max_depth = scene.static.max_depth
    rr_depth = scene.static.russian_roulette_depth
    rr_cutoff = 0.1
    if sort is None:
        sort = _use_coherence_sort(scene, n_rays, dev)
    if sort:
        if scene.static.num_triangles == 0:
            raise ValueError("the coherence sort needs a triangle soup")
        sort_lo, sort_inv = _scene_sort_bounds(scene)

    # per-lane state; permuted every bounce by the coherence sort, `orig`
    # carries each lane's original index for the un-permute at the end
    orig = torch.arange(n_rays, device=dev)
    t_min = torch.full((n_rays,), RAY_EPSILON, dtype=torch.float32, device=dev)
    throughput = torch.ones((n_rays, 3), dtype=torch.float32, device=dev)
    L = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n_rays, dtype=torch.bool, device=dev)
    neg = -INF_DISTANCE

    for depth in range(max_depth):
        if not bool(alive.any()):       # one host sync per bounce
            break
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
        rr_active = (lum < rr_cutoff) if depth >= rr_depth else torch.zeros_like(alive)
        q = torch.clamp_min(lum / rr_cutoff, 0.05)
        rr_continue = u_mat[3, :, 0] < q
        new_throughput = torch.where((rr_active & rr_continue)[:, None],
                                     new_throughput / q[:, None], new_throughput)

        escaped = alive & ~hit.valid
        L = L + torch.where((escaped & lhit)[:, None], throughput * lL, 0.0)
        continues = alive & hit.valid & ms_ok & ~(rr_active & ~rr_continue)

        c3 = continues[:, None]
        ro = torch.where(c3, p, ro)
        rd = torch.where(c3, wi, rd)
        t_min = torch.where(continues, get_ray_offset(cosine), t_min)
        throughput = torch.where(c3, new_throughput, throughput)
        alive = continues
        if sort:
            # regroup surviving rays (pure permutation of per-lane state —
            # the image is unchanged; see _coherence_order)
            perm = _coherence_order(alive, ro, rd, sort_lo, sort_inv)
            orig, ro, rd, t_min, throughput, L, alive = (
                a[perm] for a in (orig, ro, rd, t_min, throughput, L, alive))

    out = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    out[orig] = L
    return out


INTEGRATOR_FNS = {"iterative_rrnee": integrate_rrnee}


def make_integrator(name: str):
    """The integrator function for a DSL name.  Only ``iterative_rrnee`` is
    ported so far; the other names of ``INTEGRATORS`` raise."""
    if name in INTEGRATOR_FNS:
        return INTEGRATOR_FNS[name]
    if name in INTEGRATORS:
        raise NotImplementedError(
            f"integrator {name!r} is ported in a later slice of "
            "simplepath_tpu_torch; only 'iterative_rrnee' is available")
    raise ValueError(f"unknown integrator {name!r}")
