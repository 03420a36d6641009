"""The reference render: chosen pixels of a frame, ``iterative_rrnee``.

Frozen copy of the port's ``render/film.py`` (``render_rays``),
``render/camera.py``, ``render/traverse.py`` and ``integrate_rrnee`` with
``_estimate_direct_mis_all`` of ``render/integrators.py`` at commit
d1155b91, for the scenes of ``scene.py``: triangles (through ``accel.py``),
planes, sphere lights and a constant environment light.  Each pixel is
rendered alone, in plain PyTorch, with no coherence sort and no checkpoint.

``state_dtype`` makes the control of the benchmark's comparison: the path's
radiance state (throughput and the radiance gathered so far) and the film
are held in that precision between bounces, as a later change storing them
in bfloat16 would hold them.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from . import core
from .core import (INF_DISTANCE, RAY_EPSILON, dot, fold_in, get_ray_offset,
                   get_ray_offset_nd, normalize, onb_from_v,
                   onb_to_local, onb_to_world, uniform_sites)

SITE_MAT_LAYER, SITE_MAT_LOBE, SITE_MAT_2D, SITE_RR = 0, 1, 2, 3
SITE_LIGHT_BASE = 16
RR_CUTOFF = 0.1


def camera_rays(cam, px: Tensor, py: Tensor) -> tuple[Tensor, Tensor]:
    fov_scale = 1.0 / torch.tan(0.5 * (cam.fov * (math.pi / 180.0)))
    lin, origin = core.look_at(cam.eye, cam.to, cam.up)
    u, v, z = lin[:, 0], lin[:, 1], lin[:, 2]
    w, h = cam.wh[0], cam.wh[1]
    vx, vy = u, -v
    vz = (-0.5 * w) * u + (0.5 * h) * v + (0.5 * h * fov_scale) * z
    d = px[..., None] * vx + py[..., None] * vy + vz
    return origin.expand(d.shape), normalize(d)


def _num_lights(s) -> int:
    return s.n_sphere_lights + (1 if s.env is not None else 0)


def _closest(s, ro, rd, t_min, t_max):
    """(valid, t, kind, idx, beta, gamma) of the nearest triangle or plane,
    the winner re-intersected from the tables as the port's
    ``scene_intersect_batch`` does.  Kind 0 triangle, 2 plane."""
    t, idx, beta, gamma, valid = s.triangles.accel.closest(ro, rd, t_min, t_max)
    t = torch.where(valid, t, INF_DISTANCE)
    kind = torch.where(valid, 0, -1)
    idx = torch.where(valid, idx, -1)
    if s.planes is not None:
        row = s.planes.w2o_l[:, 1, :]
        oy = dot(row, ro[:, None, :]) + s.planes.w2o_t[:, 1]
        dy = dot(row, rd[:, None, :])
        par = dy == 0.0
        pt = -oy / torch.where(par, torch.ones_like(dy), dy)
        pv = (~par) & (pt >= t_min[:, None]) & (pt <= t_max[:, None])
        j = torch.where(pv, pt, INF_DISTANCE).argmin(dim=1, keepdim=True)
        p_valid = pv.gather(1, j)[:, 0]
        p_t = pt.gather(1, j)[:, 0]
        ta = torch.where(valid, t, INF_DISTANCE)
        tb = torch.where(p_valid, p_t, INF_DISTANCE)
        take_a = ta <= tb
        t = torch.where(take_a, t, p_t)
        kind = torch.where(take_a, kind, 2)
        idx = torch.where(take_a, idx, j[:, 0])
        zero = torch.zeros_like(beta)
        beta = torch.where(take_a, beta, zero)
        gamma = torch.where(take_a, gamma, zero)
        valid = valid | p_valid
    # re-intersect the winner from the tables
    tri = s.triangles
    is_tri = kind == 0
    i = torch.where(is_tri, idx, 0)
    tt, bb, gg = _triangle(tri.v0[i], tri.v1[i], tri.v2[i], ro, rd)
    t = torch.where(is_tri, tt, t)
    beta = torch.where(is_tri, bb, beta)
    gamma = torch.where(is_tri, gg, gamma)
    if s.planes is not None:
        is_pl = kind == 2
        i = torch.where(is_pl, idx, 0)
        row = s.planes.w2o_l[i][:, 1, :]
        oy = dot(row, ro) + s.planes.w2o_t[i][:, 1]
        dy = dot(row, rd)
        t = torch.where(is_pl, -oy / torch.where(dy == 0.0, 1.0, dy), t)
    return valid, t, kind, idx, beta, gamma


def _triangle(v0, v1, v2, ro, rd):
    """The port's ``intersect_triangles`` for one triangle a ray → t, β, γ."""
    A = v0[:, 0] - v1[:, 0]
    B = v0[:, 1] - v1[:, 1]
    C = v0[:, 2] - v1[:, 2]
    D = v0[:, 0] - v2[:, 0]
    E = v0[:, 1] - v2[:, 1]
    F = v0[:, 2] - v2[:, 2]
    G, H, I = rd[:, 0], rd[:, 1], rd[:, 2]
    J = v0[:, 0] - ro[:, 0]
    K = v0[:, 1] - ro[:, 1]
    L = v0[:, 2] - ro[:, 2]
    EIHF = E * I - H * F
    GFDI = G * F - D * I
    DHEG = D * H - E * G
    denom = A * EIHF + B * GFDI + C * DHEG
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    beta = (J * EIHF + K * GFDI + L * DHEG) / safe
    AKJB = A * K - J * B
    JCAL = J * C - A * L
    BLKC = B * L - K * C
    gamma = (I * AKJB + H * JCAL + G * BLKC) / safe
    t = -(F * AKJB + E * JCAL + D * BLKC) / safe
    return t, beta, gamma


def _occluded(s, ro, rd, t_min, t_max) -> Tensor:
    found = s.triangles.accel.anyhit(ro, rd, t_min, t_max)
    if s.planes is not None:
        row = s.planes.w2o_l[:, 1, :]
        oy = dot(row, ro[:, None, :]) + s.planes.w2o_t[:, 1]
        dy = dot(row, rd[:, None, :])
        par = dy == 0.0
        pt = -oy / torch.where(par, torch.ones_like(dy), dy)
        found = found | ((~par) & (pt >= t_min[:, None])
                         & (pt <= t_max[:, None])).any(dim=1)
    for li in range(s.n_sphere_lights):
        found = found | core.sphere_light_intersect(
            s.sphere_lights, li, ro, rd, t_min, t_max)[1]
    return found


def _lights_hit(s, ro, rd, t_min, t_max):
    n, dev = ro.shape[0], ro.device
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    dist = torch.full((n,), INF_DISTANCE, dtype=torch.float32, device=dev)
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for li in range(s.n_sphere_lights):
        t, valid = core.sphere_light_intersect(s.sphere_lights, li, ro, rd,
                                               t_min, t_max)
        closer = valid & (t < dist)
        dist = torch.where(closer, t, dist)
        L = torch.where(closer[:, None], s.sphere_lights.radiance[li], L)
        hit = hit | valid
    if s.env is not None:
        env_ok = ~(t_max < INF_DISTANCE) & ~hit
        L = torch.where(env_ok[:, None], s.env.expand(n, 3), L)
        dist = torch.where(env_ok, INF_DISTANCE, dist)
        hit = hit | env_ok
    return hit, dist, L


def _shading(s, valid, t, kind, idx, beta, gamma, ro, rd):
    n_rays = ro.shape[0]
    t_safe = torch.where(valid & torch.isfinite(t), t, 1.0)
    point = ro + t_safe[:, None] * rd
    nrm = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                       device=ro.device).expand(n_rays, 3)
    mid = torch.zeros(n_rays, dtype=torch.int64, device=ro.device)
    tri = s.triangles
    is_tri = kind == 0
    i = torch.where(is_tri, idx, 0)
    b = torch.where(is_tri, beta, 0.3)
    g = torch.where(is_tri, gamma, 0.3)
    a = 1.0 - b - g
    n_tri = normalize(a[:, None] * tri.n0[i] + b[:, None] * tri.n1[i]
                      + g[:, None] * tri.n2[i])
    nrm = torch.where(is_tri[:, None], n_tri, nrm)
    mid = torch.where(is_tri, tri.material_id[i], mid)
    if s.planes is not None:
        is_pl = kind == 2
        i = torch.where(is_pl, idx, 0)
        nrm = torch.where(is_pl[:, None], s.planes.o2w_l[i][:, :, 1], nrm)
        mid = torch.where(is_pl, s.planes.material_id[i], mid)
    return point, nrm, mid


def _light_sample(s, li, p, n, u):
    if li < s.n_sphere_lights:
        return core.sphere_light_sample(s.sphere_lights, li, p, n, u)
    ls = core.env_light_sample(s.env, u)
    return ls._replace(t_min=get_ray_offset_nd(n, ls.wi))


def _light_pdf(s, li, p, wi):
    if li < s.n_sphere_lights:
        return core.sphere_light_pdf(s.sphere_lights, li, p)
    return torch.full(wi.shape[:-1], core.uniform_sphere_pdf(),
                      dtype=torch.float32, device=wi.device)


def _stack(items):
    return type(items[0])(*(torch.stack(xs) for xs in zip(*items)))


def _direct(s, p, nrm, wo_world, onb, m, keys, enabled):
    """The port's ``_estimate_direct_mis_all``: NEE with MIS over all lights."""
    n = p.shape[0]
    nl = _num_lights(s)
    if nl == 0:
        return torch.zeros((n, 3), dtype=torch.float32, device=p.device)
    neg_inf = -INF_DISTANCE
    has_env = s.env is not None
    sites = [SITE_LIGHT_BASE + 8 * li + k for li in range(nl) for k in range(4)]
    u_all = uniform_sites(keys, sites).reshape(nl, 4, n, 2)
    ls = _stack([_light_sample(s, li, p, nrm, u_all[li, 0]) for li in range(nl)])
    ls_ok = (ls.pdf > 0.0) & (ls.L != 0.0).any(dim=-1)
    ro_flat = p[None].expand(nl, n, 3).reshape(-1, 3)
    live1 = enabled[None] & ls_ok
    wo_local = onb_to_local(onb, wo_world)
    wi_local = onb_to_local(onb[None], ls.wi)
    if has_env:
        ms = _stack([core.material_sample(m, wo_local, u_all[li, 1, :, 0],
                                          u_all[li, 2, :, 0], u_all[li, 3])
                     for li in range(nl)])
        ms_ok = (ms.pdf > 0.0) & (ms.color != 0.0).any(dim=-1)
        wi2 = onb_to_world(onb[None], ms.wi)
        cos2 = torch.abs(dot(wi2, nrm[None]))
        mat_t_min = get_ray_offset(cos2)
        live2 = enabled[None] & ls_ok & ms_ok
        occ_all = _occluded(
            s, torch.cat([ro_flat, ro_flat]),
            torch.cat([ls.wi.reshape(-1, 3), wi2.reshape(-1, 3)]),
            torch.cat([ls.t_min.reshape(-1), mat_t_min.reshape(-1)]),
            torch.cat([torch.where(live1, ls.t_max, neg_inf).reshape(-1),
                       torch.where(live2, INF_DISTANCE, neg_inf).reshape(-1)]))
        occluded = occ_all[:nl * n].reshape(nl, n)
        blocked = occ_all[nl * n:].reshape(nl, n)
    else:
        occluded = _occluded(
            s, ro_flat, ls.wi.reshape(-1, 3), ls.t_min.reshape(-1),
            torch.where(live1, ls.t_max, neg_inf).reshape(-1)).reshape(nl, n)

    f = core.material_eval(m, wo_local, wi_local)
    bsdf_pdf = core.material_pdf(m, wo_local, wi_local)
    w1 = core.balance_heuristic_counts(1, ls.pdf, 1, bsdf_pdf)
    cos1 = torch.abs(dot(ls.wi, nrm[None]))
    strat1 = f * ls.L * (cos1 * w1 / torch.where(ls.pdf > 0, ls.pdf, 1.0))[..., None]
    strat1_ok = ls_ok & ~occluded & (f != 0.0).any(dim=-1) & (bsdf_pdf > 0.0)
    total = torch.where(strat1_ok[..., None], strat1, 0.0).sum(0)
    if not has_env:
        return total
    strat2_enabled = ls_ok & ~occluded
    light_pdf2 = torch.stack([_light_pdf(s, li, p, wi2[li]) for li in range(nl)])
    w2 = core.balance_heuristic_counts(1, ms.pdf, 1, light_pdf2)
    env_L = s.env.expand(wi2.shape)
    strat2 = ms.color * env_L * (cos2 * w2 / torch.where(ms.pdf > 0, ms.pdf, 1.0))[..., None]
    strat2_ok = strat2_enabled & ms_ok & (light_pdf2 > 0.0) & ~blocked
    return total + torch.where(strat2_ok[..., None], strat2, 0.0).sum(0)


def integrate(s, ro, rd, keys, state_dtype=None) -> Tensor:
    """``integrate_rrnee`` over a batch of camera rays → radiance [N,3]."""
    n, dev = ro.shape[0], ro.device
    neg = -INF_DISTANCE
    hold = (lambda x: x) if state_dtype is None else \
        (lambda x: x.to(state_dtype).to(torch.float32))
    t_min = torch.full((n,), RAY_EPSILON, dtype=torch.float32, device=dev)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for depth in range(s.max_depth):
        if not bool(alive.any()):
            break
        dkeys = fold_in(keys, depth)
        u_mat = uniform_sites(dkeys, (SITE_MAT_LAYER, SITE_MAT_LOBE,
                                      SITE_MAT_2D, SITE_RR))
        lhit, ldist, lL = _lights_hit(s, ro, rd, t_min,
                                      torch.where(alive, INF_DISTANCE, neg))
        t_max = torch.where(lhit, ldist, INF_DISTANCE)
        hit = _closest(s, ro, rd, t_min, torch.where(alive, t_max, neg))
        p, nrm, mid = _shading(s, *hit, ro, rd)
        valid = hit[0]
        onb = onb_from_v(nrm)
        wo = -rd
        wo_local = onb_to_local(onb, wo)
        m = core.gather_material(s.materials, mid)
        ms = core.material_sample(m, wo_local, u_mat[0, :, 0], u_mat[1, :, 0],
                                  u_mat[2])
        ms_ok = (ms.pdf > 0.0) & (ms.color != 0.0).any(dim=-1)
        nee_mask = alive & valid & ms_ok
        nee = _direct(s, p, nrm, wo, onb, m, dkeys, nee_mask)
        L = L + torch.where(nee_mask[:, None], throughput * nee, 0.0)

        wi = onb_to_world(onb, ms.wi)
        cosine = torch.abs(dot(wi, nrm))
        contrib = cosine[:, None] * ms.color / torch.where(ms.pdf > 0, ms.pdf, 1.0)[:, None]
        new_throughput = throughput * contrib
        lum = core.relative_luminance(new_throughput)
        rr_active = (lum < RR_CUTOFF) if depth >= s.rr_depth else torch.zeros_like(alive)
        q = torch.clamp_min(lum / RR_CUTOFF, 0.05)
        rr_continue = u_mat[3, :, 0] < q
        new_throughput = torch.where((rr_active & rr_continue)[:, None],
                                     new_throughput / q[:, None], new_throughput)
        escaped = alive & ~valid
        L = L + torch.where((escaped & lhit)[:, None], throughput * lL, 0.0)
        continues = alive & valid & ms_ok & ~(rr_active & ~rr_continue)
        c3 = continues[:, None]
        ro = torch.where(c3, p, ro)
        rd = torch.where(c3, wi, rd)
        t_min = torch.where(continues, get_ray_offset(cosine), t_min)
        throughput = hold(torch.where(c3, new_throughput, throughput))
        L = hold(L)
        alive = continues
    return L


def render_pixels(s, xs: Tensor, ys: Tensor, spp: int, key: Tensor,
                  state_dtype=None) -> Tensor:
    """Radiance means [N,3] of pixels (xs, ys) under the frame key ``key``:
    the port's ``render_rays`` for these pixels alone."""
    dev = xs.device
    n = xs.shape[0]
    lin = ys * s.width + xs
    pix_keys = fold_in(key.to(dev).expand(n, 2), lin)
    xf, yf = xs.to(torch.float32), ys.to(torch.float32)
    film = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for smp in range(spp):
        jitter = core.pixel_jitter(xs, ys, torch.full_like(xs, smp))
        ro, rd = camera_rays(s.camera, xf + jitter[:, 0], yf + jitter[:, 1])
        out = integrate(s, ro, rd, fold_in(pix_keys, smp), state_dtype)
        film = film + out
        if state_dtype is not None:
            film = film.to(state_dtype).to(torch.float32)
    return film / spp
