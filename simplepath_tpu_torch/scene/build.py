"""Scene compile: ParsedScene (host) → Scene (tensors on the device).

Counterpart of ``simplepath_tpu/scene/build.py``; the ``init()``-equivalent
of the reference (FileParser parse + Scene construction + BVH build): named
materials become table rows, geometry becomes SoA primitive arrays (meshes
loaded + world-baked), lights become light tables, and the BVH is built over
the triangle soup.  Everything is assembled in numpy on the host and moved
to ``device`` once at the end (an image-based light's sampling tables with
it, built once per scene); the materials' rho table is built there, once per
scene.  The mesh bake and BVH build are served from the persistent geometry
cache when they can be (``scene/cache.py``).  While tracing is on, a load
is a ``load`` span and each of its phases a ``load.*`` span inside it.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .. import tracing
from ..core.distribution import build_distribution_2d
from ..device import resolve_device
from ..io.pfm import read_pfm
from ..render.camera import make_perspective_camera
from . import cache
from .bvh import make_packed_records
from .parser import ParsedScene, parse_sp
from .ply import bake_mesh, read_ply
from .stl import read_stl
from .types import (ENV_CONST, ENV_IBL, ENV_NONE, MAT_GLOSSY, MAT_LAMBERTIAN,
                    BVHArrays, EnvLightArrays, MaterialArrays, PlaneArrays,
                    Scene, SceneStatic, SphereArrays, SphereLightArrays,
                    TriangleArrays)

logger = logging.getLogger("simplepath_tpu_torch")

__all__ = ["build_scene", "load_scene"]

BVH_MIN_TRIS = 64  # below this a vectorized brute-force scan is faster


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _i32(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


def _flatten_materials(ps: ParsedScene) -> tuple[MaterialArrays, dict[str, int]]:
    """One table row per named material; clearcoat rows inline their base
    (the DSL's material algebra is closed — see render/materials.py)."""
    names = list(ps.materials.keys())
    if not names:
        names = ["__default__"]
        rows = [dict(base_type=MAT_LAMBERTIAN, albedo=(0.5, 0.5, 0.5),
                     roughness=0.5, ior=1.5, has_cc=0, cc_ior=1.5,
                     cc_color=(1, 1, 1))]
    else:
        rows = []
        for name in names:
            d = ps.materials[name]
            if d.kind == "clearcoat":
                base = ps.materials[d.base]
                rows.append(dict(
                    base_type=MAT_GLOSSY if base.kind == "glossy" else MAT_LAMBERTIAN,
                    albedo=base.albedo, roughness=base.roughness, ior=base.ior,
                    has_cc=1, cc_ior=d.cc_ior, cc_color=d.cc_color))
            else:
                rows.append(dict(
                    base_type=MAT_GLOSSY if d.kind == "glossy" else MAT_LAMBERTIAN,
                    albedo=d.albedo, roughness=d.roughness, ior=d.ior,
                    has_cc=0, cc_ior=1.5, cc_color=(1, 1, 1)))
    mats = MaterialArrays(
        base_type=_i32([r["base_type"] for r in rows]),
        albedo=_f32([r["albedo"] for r in rows]),
        roughness=_f32([r["roughness"] for r in rows]),
        ior=_f32([r["ior"] for r in rows]),
        has_clearcoat=_i32([r["has_cc"] for r in rows]),
        cc_ior=_f32([r["cc_ior"] for r in rows]),
        cc_color=_f32([r["cc_color"] for r in rows]),
    )
    return mats, {n: i for i, n in enumerate(names)}


def _pack_xform(cls, xs, **extra):
    """Stack (fwd_linear, fwd_t, inv_linear, inv_t) numpy tuples into the
    four transform tables of ``cls`` (empty tables when ``xs`` is empty)."""
    def stack(k, shape):
        if not xs:
            return torch.zeros((0,) + shape, dtype=torch.float32)
        return _f32(np.stack([x[k] for x in xs]))
    return cls(o2w_l=stack(0, (3, 3)), o2w_t=stack(1, (3,)),
               w2o_l=stack(2, (3, 3)), w2o_t=stack(3, (3,)), **extra)


def _luminance(c: np.ndarray) -> np.ndarray:
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def _build_env(light, base_dir: str) -> tuple[int, EnvLightArrays]:
    """Environment light tables.  An image-based light reads its PFM, scales
    it by the radiance, clamps it by luminance (the reference's
    ``modify_image``) and builds the sampling tables of its 2x-resolution,
    sin(theta)-weighted luminance (``create_distribution``) — in numpy, as
    the JAX package does, then the CDFs through ``core.distribution``."""
    radiance = np.asarray(light.radiance, np.float32)
    z = torch.zeros
    tables = dict(image=z((1, 1, 3)), cdf_cond_f=z((1, 1)), cdf_cond=z((1, 2)),
                  cdf_cond_int=z((1,)), cdf_marg_f=z((1,)), cdf_marg=z((2,)),
                  cdf_marg_int=z(()))
    kind = ENV_CONST
    if light.image is not None:
        kind = ENV_IBL
        img = read_pfm(os.path.join(base_dir, light.image)).astype(np.float32)
        img = img * radiance
        max_r = np.float32(light.max_radiance)

        # modify_image: inf → max_radiance; clamp by luminance
        img = np.where(np.isinf(img), max_r, img)
        over = _luminance(img) > max_r
        maxc = np.max(img, axis=-1, keepdims=True)
        img = img * np.where(over[..., None], max_r / np.maximum(maxc, 1e-30), 1.0)

        # create_distribution: 2x resolution, nearest texel (wrap across,
        # clamp down), sin(theta)-weighted luminance, clamped
        h, w = img.shape[0], img.shape[1]
        nv, nu = 2 * h, 2 * w
        vp = (np.arange(nv) + 0.5) / nv
        up = (np.arange(nu) + 0.5) / nu
        x = np.minimum(np.round(np.mod(up, 1.0) * w).astype(np.int64), w - 1)
        y = np.minimum(np.round(np.clip(vp, 0.0, np.nextafter(1.0, 0.0)) * h
                                ).astype(np.int64), h - 1)
        func = _luminance(img[y[:, None], x[None, :]]) * np.sin(np.pi * vp)[:, None]
        func = np.where(np.isinf(func), max_r, func)
        func = np.minimum(func, max_r).astype(np.float32)

        dist = build_distribution_2d(torch.from_numpy(func))
        tables = dict(image=_f32(img), cdf_cond_f=dist.conditional_f,
                      cdf_cond=dist.conditional_cdf,
                      cdf_cond_int=dist.conditional_int,
                      cdf_marg_f=dist.marginal.function,
                      cdf_marg=dist.marginal.cdf,
                      cdf_marg_int=dist.marginal.integral)
    env = EnvLightArrays(radiance=_f32(radiance), l2w=_f32(light.transform[0]),
                         w2l=_f32(light.inverse[0]), **tables)
    return kind, env


def _build_geometry(mesh_jobs, use_bvh: bool | None) -> dict:
    """Mesh files → reordered triangle tables + packed BVH records (the
    expensive host-side step: PLY/STL parse, world bake, wide-BVH build,
    record packing), served from the geometry cache when it holds them.

    Returns dict(records|None, v0, v1, v2, n0, n1, n2, material_id).
    """
    cache.LAST_HIT = None
    if not mesh_jobs:
        z = np.zeros((0, 3), np.float32)
        return dict(records=None, v0=z, v1=z, v2=z, n0=z, n1=z, n2=z,
                    material_id=np.zeros((0,), np.int32))

    base_dir = os.path.dirname(os.path.abspath(mesh_jobs[0][0]))
    try:
        key = cache.geometry_cache_key(mesh_jobs)
    except OSError:
        key = None
    # bake-only loads (use_bvh=False) cache the baked triangle tables under
    # a key of their own: never served to a load that wants a BVH
    if use_bvh is False and key is not None:
        key = key + "_bake"
    if key is not None:
        with tracing.span("load.cache_read"):
            cached = cache.load_geometry(base_dir, key)
        if cached is not None:
            if cached["records"].size == 0:
                cached["records"] = None
            return cached

    tri_v, tri_n, tri_m = [], [], []
    for path, linear, translation, mid in mesh_jobs:
        ext = os.path.splitext(path)[1].lower()
        with tracing.span("load.mesh_read"):
            mesh = read_ply(path) if ext == ".ply" else read_stl(path)
        with tracing.span("load.bake"):
            mesh = bake_mesh(mesh, linear, translation)
        idx = mesh.indices
        tri_v.append((mesh.vertices[idx[:, 0]], mesh.vertices[idx[:, 1]],
                      mesh.vertices[idx[:, 2]]))
        tri_n.append((mesh.normals[idx[:, 0]], mesh.normals[idx[:, 1]],
                      mesh.normals[idx[:, 2]]))
        tri_m.append(np.full(idx.shape[0], mid, np.int32))

    v0 = np.concatenate([t[0] for t in tri_v])
    v1 = np.concatenate([t[1] for t in tri_v])
    v2 = np.concatenate([t[2] for t in tri_v])
    n0 = np.concatenate([t[0] for t in tri_n])
    n1 = np.concatenate([t[1] for t in tri_n])
    n2 = np.concatenate([t[2] for t in tri_n])
    tm = np.concatenate(tri_m)

    num_tris = v0.shape[0]
    if use_bvh is None:
        use_bvh = num_tris >= BVH_MIN_TRIS
    records = None
    if use_bvh and num_tris > 0:
        lo = np.minimum(np.minimum(v0, v1), v2)
        hi = np.maximum(np.maximum(v0, v1), v2)
        with tracing.span("load.bvh"):
            records, order = make_packed_records(lo, hi, v0, v1, v2)
        v0, v1, v2 = v0[order], v1[order], v2[order]
        n0, n1, n2 = n0[order], n1[order], n2[order]
        tm = tm[order]

    out = dict(records=records, v0=v0, v1=v1, v2=v2, n0=n0, n1=n1, n2=n2,
               material_id=tm)
    if key is not None and (records is not None or use_bvh is False):
        with tracing.span("load.cache_write"):
            cache.save_geometry(base_dir, key, dict(
                out, records=np.zeros((0, 0), np.float32) if records is None
                else records))
    return out


def build_scene(ps: ParsedScene, *, cli_integrator: str | None = None,
                use_bvh: bool | None = None, device=None) -> Scene:
    """ParsedScene → Scene on ``device`` (None = CUDA; raises without one)."""
    device = resolve_device(device)
    materials, mat_index = _flatten_materials(ps)

    def mat_id(name):
        if name is None or name not in mat_index:
            return 0
        return mat_index[name]

    sph_x, sph_m = [], []
    pl_x, pl_m = [], []
    mesh_jobs = []  # (path, linear, translation, material_id)

    for g in ps.geometry:
        if g.kind == "sphere":
            sph_x.append((g.transform[0], g.transform[1], g.inverse[0], g.inverse[1]))
            sph_m.append(mat_id(g.material))
        elif g.kind == "plane":
            pl_x.append((g.transform[0], g.transform[1], g.inverse[0], g.inverse[1]))
            pl_m.append(mat_id(g.material))
        elif g.kind == "mesh":
            if g.mesh_path is None:
                logger.error("mesh without file; skipping")
                continue
            path = os.path.join(ps.base_dir, g.mesh_path)
            ext = os.path.splitext(path)[1].lower()
            if ext not in (".ply", ".stl"):
                logger.error("Unable to open file format for %s", ext)
                continue
            mesh_jobs.append((path, g.transform[0], g.transform[1],
                              mat_id(g.material)))

    spheres = _pack_xform(SphereArrays, sph_x, material_id=_i32(sph_m))
    planes = _pack_xform(PlaneArrays, pl_x, material_id=_i32(pl_m))

    with tracing.span("load.geometry") as sp:
        geom = _build_geometry(mesh_jobs, use_bvh)
        sp.set(cache_hit=cache.LAST_HIT is not None)
    num_tris = geom["v0"].shape[0]
    bvh = None
    if geom["records"] is not None:
        bvh = BVHArrays(records=torch.from_numpy(geom["records"]))

    triangles = TriangleArrays.from_rows(
        geom["v0"], geom["v1"], geom["v2"],
        geom["n0"], geom["n1"], geom["n2"], geom["material_id"],
    )

    sl_x, sl_rad = [], []
    env_kind, env = ENV_NONE, None
    for light in ps.lights:
        if light.kind == "sphere_light":
            sl_x.append((light.transform[0], light.transform[1],
                         light.inverse[0], light.inverse[1]))
            sl_rad.append(light.radiance)
        else:
            env_kind, env = _build_env(light, ps.base_dir)

    radiance = (_f32(sl_rad) if sl_rad
                else torch.zeros((0, 3), dtype=torch.float32))
    sphere_lights = _pack_xform(SphereLightArrays, sl_x, radiance=radiance)

    cam_def = ps.camera
    if cam_def is None:
        raise ValueError("Scene has no perspective_camera")
    camera = make_perspective_camera(cam_def.origin, cam_def.look_at,
                                     cam_def.up, cam_def.fov,
                                     ps.width, ps.height)

    # integrator precedence: CLI > scene > DirectLighting
    integrator = cli_integrator or ps.integrator or "direct_lighting"

    static = SceneStatic(
        width=ps.width, height=ps.height,
        max_depth=ps.max_depth,
        russian_roulette_depth=ps.russian_roulette_depth,
        integrator=integrator,
        num_spheres=len(sph_m), num_planes=len(pl_m),
        num_triangles=num_tris,
        num_sphere_lights=len(sl_rad),
        env_kind=env_kind,
        num_materials=int(materials.base_type.shape[0]),
        has_bvh=bvh is not None,
        output_file_name=ps.output_file_name or "image.pfm",
    )
    scene = Scene(static=static, spheres=spheres, planes=planes,
                  triangles=triangles, bvh=bvh, materials=materials,
                  sphere_lights=sphere_lights, env=env, camera=camera)
    with tracing.span("load.to_device"):
        return scene.to(device)


def load_scene(path, *, cli_integrator: str | None = None,
               use_bvh: bool | None = None, device=None) -> Scene:
    """Parse a ``.sp`` file (or a scene's text: ``parse_sp`` takes either)
    and build its Scene on ``device`` (None = CUDA; raises without one —
    pass ``device="cpu"`` to stay on the CPU)."""
    device = resolve_device(device)  # fail before the expensive host build
    with tracing.span("load"):
        with tracing.span("load.parse"):
            ps = parse_sp(path)
        return build_scene(ps, cli_integrator=cli_integrator,
                           use_bvh=use_bvh, device=device)
