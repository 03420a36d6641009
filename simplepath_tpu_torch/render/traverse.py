"""Scene intersection: closest-hit, any-hit and light-hit queries over a
flat ray batch.

Counterpart of ``simplepath_tpu/render/traverse.py`` with the batch written
out (``ro``/``rd`` are ``[N,3]``, ``t_min``/``t_max`` ``[N]``): the triangle
BVH is searched by ``cuda_traverse.closest`` / ``anyhit`` (CUDA kernels on
CUDA tensors, their plain versions on CPU tensors), the few analytic
primitives by vectorized brute force, and the winner is re-intersected from
the scene's own tables.  A geometry-sharded scene's forest is searched by
``parallel.geom_shard.sharded_closest`` / ``sharded_anyhit``: the same
wrappers once per shard, then the shards' answers combined.

Primitive kind tags in Hit: 0 = triangle, 1 = sphere, 2 = plane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..core.vec import dot
from ..scene.types import ENV_NONE, Scene
from . import cuda_traverse
from .intersect import (INF_DISTANCE, intersect_planes, intersect_spheres,
                        intersect_triangles, plane_normal, sphere_normal,
                        sphere_quadratic, triangle_normal)
from .lights import (env_light_radiance, sphere_light_intersect,
                     sphere_light_intersect_p)

__all__ = ["Hit", "scene_intersect", "scene_intersect_batch",
           "scene_intersect_p", "scene_intersect_p_batch",
           "scene_intersect_lights", "hit_shading", "KIND_TRIANGLE",
           "KIND_SPHERE", "KIND_PLANE"]

KIND_TRIANGLE = 0
KIND_SPHERE = 1
KIND_PLANE = 2


class Hit(NamedTuple):
    valid: Tensor   # [N] bool
    t: Tensor       # [N]
    kind: Tensor    # [N] int32 primitive kind
    idx: Tensor     # [N] int32 index into the kind's table
    beta: Tensor    # [N] triangle barycentrics (0 otherwise)
    gamma: Tensor


def _miss(n: int, device) -> Hit:
    return Hit(valid=torch.zeros(n, dtype=torch.bool, device=device),
               t=torch.full((n,), INF_DISTANCE, dtype=torch.float32, device=device),
               kind=torch.full((n,), -1, dtype=torch.int32, device=device),
               idx=torch.full((n,), -1, dtype=torch.int32, device=device),
               beta=torch.zeros(n, dtype=torch.float32, device=device),
               gamma=torch.zeros(n, dtype=torch.float32, device=device))


def _closer(a: Hit, b: Hit) -> Hit:
    """Pick the closer of two hits (invalid = +inf); ``a`` wins ties."""
    ta = torch.where(a.valid, a.t, INF_DISTANCE)
    tb = torch.where(b.valid, b.t, INF_DISTANCE)
    take_a = ta <= tb
    return Hit(a.valid | b.valid,
               *(torch.where(take_a, x, y) for x, y in zip(a[1:], b[1:])))


def _forest_query(scene: Scene, name: str):
    """``geom_shard.sharded_closest`` / ``sharded_anyhit`` bound to the
    scene's forest layout, with the wrappers' signature."""
    import functools

    from ..parallel import geom_shard
    return functools.partial(getattr(geom_shard, name),
                             mesh=geom_shard.scene_geom_mesh(scene))


# ---------------------------------------------------------- brute force

def _argmin_hit(t: Tensor, valid: Tensor, kind: int, beta=None, gamma=None) -> Hit:
    """Closest of [N,P] candidate hits per ray (first index wins ties)."""
    i = torch.where(valid, t, INF_DISTANCE).argmin(dim=1, keepdim=True)
    pick = lambda x: x.gather(1, i)[:, 0]
    zero = torch.zeros_like(t[:, 0])
    return Hit(valid=pick(valid), t=pick(t),
               kind=torch.full_like(i[:, 0], kind, dtype=torch.int32),
               idx=i[:, 0].to(torch.int32),
               beta=zero if beta is None else pick(beta),
               gamma=zero if gamma is None else pick(gamma))


def _brute_triangles(scene: Scene, ro, rd, t_min, t_max) -> Hit:
    tri = scene.triangles
    t, beta, gamma, valid = intersect_triangles(tri.v0, tri.v1, tri.v2,
                                                ro, rd, t_min, t_max)
    return _argmin_hit(t, valid, KIND_TRIANGLE, beta, gamma)


def _brute_spheres(scene: Scene, ro, rd, t_min, t_max) -> Hit:
    t, valid = intersect_spheres(scene.spheres, ro, rd, t_min, t_max)
    return _argmin_hit(t, valid, KIND_SPHERE)


def _brute_planes(scene: Scene, ro, rd, t_min, t_max) -> Hit:
    t, valid = intersect_planes(scene.planes, ro, rd, t_min, t_max)
    return _argmin_hit(t, valid, KIND_PLANE)


# ---------------------------------------------------------- public API

def _one_ray(ro: Tensor, rd: Tensor, t_min, t_max):
    """A single ray (``ro``/``rd`` [3], scalar interval) as a batch of one."""
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=ro.device)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=ro.device)
    return ro[None], rd[None], t_min.reshape(1), t_max.reshape(1)


def scene_intersect(scene: Scene, ro: Tensor, rd: Tensor, t_min, t_max) -> Hit:
    """Closest geometry hit of ONE ray (``ro``/``rd`` [3], scalar
    ``t_min``/``t_max``) → a Hit of 0-d fields.

    :func:`scene_intersect_batch` over a batch of one, so a CUDA tensor
    launches ``sp_closest`` for N = 1 and a CPU tensor takes its plain
    version.  The search is detached and the winning primitive is
    re-intersected differentiably, so dt/dθ flows through the ray and the
    scene's tables.
    """
    hit = scene_intersect_batch(scene, *_one_ray(ro, rd, t_min, t_max))
    return Hit(*(f[0] for f in hit))


def scene_intersect_p(scene: Scene, ro: Tensor, rd: Tensor, t_min, t_max) -> Tensor:
    """Occlusion (geometry OR lights) of ONE ray → a 0-d bool:
    :func:`scene_intersect_p_batch` over a batch of one (``sp_anyhit`` for
    N = 1 on a CUDA tensor).  Fully detached."""
    return scene_intersect_p_batch(scene, *_one_ray(ro, rd, t_min, t_max))[0]


def scene_intersect_batch(scene: Scene, ro: Tensor, rd: Tensor, t_min: Tensor,
                          t_max: Tensor) -> Hit:
    """Closest geometry hit for a flat ray batch → batched Hit.

    The SEARCH (which primitive wins) is detached from autograd — hit
    selection is discrete — and the winning primitive is then re-intersected
    from the scene's tables (:func:`_refine_hit`), the JAX package's
    detached-decision estimator.  Dead lanes carry ``t_max = -inf`` and fail
    every test without special-casing.
    """
    n = ro.shape[0]
    ro_d, rd_d = ro.detach(), rd.detach()
    t_min_d, t_max_d = t_min.detach(), t_max.detach()
    best = _miss(n, ro.device)
    st = scene.static
    if st.num_triangles > 0:
        if st.has_bvh:
            closest = cuda_traverse.closest
            if st.geom_shards:
                closest = _forest_query(scene, "sharded_closest")
            t, fi, beta, gamma, valid = closest(
                scene.bvh.records, ro_d.contiguous(), rd_d.contiguous(),
                t_min_d.contiguous(), t_max_d.contiguous())
            tri = Hit(valid=valid,
                      t=torch.where(valid, t, INF_DISTANCE),
                      kind=torch.where(valid, KIND_TRIANGLE, -1).to(torch.int32),
                      idx=torch.where(valid, fi, -1),
                      beta=beta, gamma=gamma)
        else:
            tri = _brute_triangles(scene, ro_d, rd_d, t_min_d, t_max_d)
        best = _closer(best, tri)
    if st.num_spheres > 0:
        best = _closer(best, _brute_spheres(scene, ro_d, rd_d, t_min_d, t_max_d))
    if st.num_planes > 0:
        best = _closer(best, _brute_planes(scene, ro_d, rd_d, t_min_d, t_max_d))
    return _refine_hit(scene, best, ro, rd)


def _refine_hit(scene: Scene, hit: Hit, ro: Tensor, rd: Tensor) -> Hit:
    """Recompute t/beta/gamma of the winning primitive from the scene's own
    tables (not the BVH rows), per ray."""
    idx = hit.idx.to(torch.int64)
    t, beta, gamma = hit.t, hit.beta, hit.gamma
    n = ro.shape[0]
    big = torch.full((n,), 3.4e38, dtype=torch.float32, device=ro.device)
    st = scene.static
    if st.num_triangles > 0:
        is_tri = hit.kind == KIND_TRIANGLE
        i = torch.where(is_tri, idx, 0)
        tri = scene.triangles
        tt, bb, gg, _ = intersect_triangles(tri.gather_row("v0", i)[:, None],
                                            tri.gather_row("v1", i)[:, None],
                                            tri.gather_row("v2", i)[:, None],
                                            ro, rd, -big, big)
        t = torch.where(is_tri, tt[:, 0], t)
        beta = torch.where(is_tri, bb[:, 0], beta)
        gamma = torch.where(is_tri, gg[:, 0], gamma)
    if st.num_spheres > 0:
        is_sph = hit.kind == KIND_SPHERE
        i = torch.where(is_sph, idx, 0)
        sph = scene.spheres
        b, disc, two_a = sphere_quadratic(sph.w2o_l[i], sph.w2o_t[i], ro, rd)
        # keep a benign value on lanes that didn't hit a sphere
        disc = torch.where(is_sph, torch.clamp_min(disc, 1e-12), 1.0)
        sq = torch.sqrt(disc)
        t0 = (-b - sq) / two_a
        t1 = (-b + sq) / two_a
        # pick the root the detached search selected
        pick0 = torch.abs(t0.detach() - hit.t) <= torch.abs(t1.detach() - hit.t)
        t = torch.where(is_sph, torch.where(pick0, t0, t1), t)
    if st.num_planes > 0:
        is_pl = hit.kind == KIND_PLANE
        i = torch.where(is_pl, idx, 0)
        pl = scene.planes
        row = pl.w2o_l[i][:, 1, :]
        oy = dot(row, ro) + pl.w2o_t[i][:, 1]
        dy = dot(row, rd)
        tt = -oy / torch.where(dy == 0.0, 1.0, dy)
        t = torch.where(is_pl, tt, t)
    return hit._replace(t=t, beta=beta, gamma=gamma)


def scene_intersect_lights(scene: Scene, ro: Tensor, rd: Tensor, t_min: Tensor,
                           t_max: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Closest light hit → (hit [N], distance [N], L [N,3]).

    Sphere lights at their geometric distance; the environment light "hits"
    at infinity only when t_max is still infinite.
    """
    n = ro.shape[0]
    dev = ro.device
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    dist = torch.full((n,), INF_DISTANCE, dtype=torch.float32, device=dev)
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    for li in range(scene.static.num_sphere_lights):
        t, valid = sphere_light_intersect(scene.sphere_lights, li, ro, rd, t_min, t_max)
        closer = valid & (t < dist)
        dist = torch.where(closer, t, dist)
        L = torch.where(closer[:, None], scene.sphere_lights.radiance[li], L)
        hit = hit | valid

    if scene.static.env_kind != ENV_NONE:
        env_ok = ~(t_max < INF_DISTANCE) & ~hit
        env_L = env_light_radiance(scene.env, scene.static.env_kind, rd)
        L = torch.where(env_ok[:, None], env_L, L)
        dist = torch.where(env_ok, INF_DISTANCE, dist)
        hit = hit | env_ok
    return hit, dist, L


def scene_intersect_p_batch(scene: Scene, ro: Tensor, rd: Tensor, t_min: Tensor,
                            t_max: Tensor) -> Tensor:
    """Occlusion (geometry OR lights) for a flat ray batch — behind every NEE
    shadow ray.  Lanes whose result the caller will mask out carry a
    collapsed interval (t_max = -inf) and are culled on their first visit.
    Fully detached — visibility is a discrete decision.
    """
    ro, rd = ro.detach(), rd.detach()
    t_min, t_max = t_min.detach(), t_max.detach()
    n = ro.shape[0]
    st = scene.static
    found = torch.zeros(n, dtype=torch.bool, device=ro.device)
    if st.num_triangles > 0:
        if st.has_bvh:
            anyhit = cuda_traverse.anyhit
            if st.geom_shards:
                anyhit = _forest_query(scene, "sharded_anyhit")
            found = found | anyhit(
                scene.bvh.records, ro.contiguous(), rd.contiguous(),
                t_min.contiguous(), t_max.contiguous())
        else:
            tri = scene.triangles
            found = found | intersect_triangles(tri.v0, tri.v1, tri.v2, ro, rd,
                                                t_min, t_max)[3].any(dim=1)
    if st.num_spheres > 0:
        found = found | intersect_spheres(scene.spheres, ro, rd, t_min,
                                          t_max)[1].any(dim=1)
    if st.num_planes > 0:
        found = found | intersect_planes(scene.planes, ro, rd, t_min,
                                         t_max)[1].any(dim=1)
    for li in range(st.num_sphere_lights):
        found = found | sphere_light_intersect_p(scene.sphere_lights, li,
                                                 ro, rd, t_min, t_max)
    return found


def hit_shading(scene: Scene, hit: Hit, ro: Tensor, rd: Tensor
                ) -> tuple[Tensor, Tensor, Tensor]:
    """(point [N,3], shading normal [N,3], material_id [N]) for a Hit; masked
    per kind.  As in the JAX package, all inputs to nonlinear ops are clamped
    to benign values on missed lanes BEFORE the math (kept so values match),
    and the defaults (t=1, n=+y) are only ever used masked."""
    n_rays = ro.shape[0]
    idx = hit.idx.to(torch.int64)
    t_safe = torch.where(hit.valid & torch.isfinite(hit.t), hit.t, 1.0)
    point = ro + t_safe[:, None] * rd
    n = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                     device=ro.device).expand(n_rays, 3)
    mid = torch.zeros(n_rays, dtype=torch.int64, device=ro.device)
    st = scene.static
    if st.num_triangles > 0:
        is_tri = hit.kind == KIND_TRIANGLE
        i = torch.where(is_tri, idx, 0)
        beta = torch.where(is_tri, hit.beta, 0.3)
        gamma = torch.where(is_tri, hit.gamma, 0.3)
        n_tri = triangle_normal(scene.triangles, i, beta, gamma)
        n = torch.where(is_tri[:, None], n_tri, n)
        mid = torch.where(is_tri, scene.triangles.material_id[i].to(torch.int64), mid)
    if st.num_spheres > 0:
        is_sph = hit.kind == KIND_SPHERE
        i = torch.where(is_sph, idx, 0)
        n_sph = sphere_normal(scene.spheres, i, ro, rd,
                              torch.where(is_sph, t_safe, 1.0))
        n = torch.where(is_sph[:, None], n_sph, n)
        mid = torch.where(is_sph, scene.spheres.material_id[i].to(torch.int64), mid)
    if st.num_planes > 0:
        is_pl = hit.kind == KIND_PLANE
        i = torch.where(is_pl, idx, 0)
        n = torch.where(is_pl[:, None], plane_normal(scene.planes, i), n)
        mid = torch.where(is_pl, scene.planes.material_id[i].to(torch.int64), mid)
    return point, n, mid
