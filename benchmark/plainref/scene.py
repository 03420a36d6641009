"""A configuration's scene text and meshes → the reference's scene arrays.

Covers the scene language as far as the benchmark's configurations use it
(scene parameters, perspective camera, lambertian, glossy and clearcoat
materials, meshes, planes, sphere lights and the constant environment
light) and raises on anything else.  The transform accumulation, the PLY
reading with its vertex normals and the world bake are frozen copies of the
port's ``scene/parser.py`` (``_TransformAccum``), ``scene/ply.py`` and
``scene/build.py`` (``_flatten_materials``) at commit d1155b91, so the
triangle tables hold the bits the program's hold (in another order).
"""

from __future__ import annotations

import os
import re
from types import SimpleNamespace

import numpy as np
import torch

from . import core
from .accel import Accel

_TOKEN = re.compile(r'"[^"]*"|[{}:]|[^\s{}:"]+')


class _TransformAccum:
    def __init__(self):
        self.fl = np.eye(3)
        self.ft = np.zeros(3)
        self.il = np.eye(3)
        self.it = np.zeros(3)

    def _append(self, lin, t, lin_inv, t_inv):
        self.ft = self.fl @ t + self.ft
        self.fl = self.fl @ lin
        self.it = lin_inv @ self.it + t_inv
        self.il = lin_inv @ self.il

    def translate(self, v):
        v = np.asarray(v, np.float64)
        self._append(np.eye(3), v, np.eye(3), -v)

    def scale(self, s):
        s = np.asarray(s, np.float64)
        self._append(np.diag(s), np.zeros(3), np.diag(1.0 / s), np.zeros(3))

    def fwd(self):
        return self.fl.astype(np.float32), self.ft.astype(np.float32)

    def inv(self):
        return self.il.astype(np.float32), self.it.astype(np.float32)


def parse(text: str) -> list[tuple[str, list[tuple[str, list[str]]]]]:
    """Blocks of the scene text → [(block type, [(attribute, values)])]."""
    toks = _TOKEN.findall(text)
    blocks, i = [], 0
    while i < len(toks):
        if toks[i] == "version":
            i += 3
            continue
        kind = toks[i]
        if toks[i + 1] != "{":
            raise ValueError(f"expected '{{' after {kind}")
        i += 2
        attrs = []
        while toks[i] != "}":
            name = toks[i]
            if toks[i + 1] != ":":
                raise ValueError(f"expected ':' after {name}")
            i += 2
            vals = []
            while toks[i] != "}" and not (i + 1 < len(toks) and toks[i + 1] == ":"):
                vals.append(toks[i].strip('"'))
                i += 1
            attrs.append((name, vals))
        blocks.append((kind, attrs))
        i += 1
    return blocks


def read_ply(path: str, device) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binary little-endian PLY of float xyz vertices and triangle lists →
    (faces, vertices, vertex normals) as the port's ``read_ply`` gives them,
    bit for bit: face normals from the cross product, each vertex's sum of
    its faces' normals in numpy's ``add.at`` order (corner 0 of every face,
    then corner 1, then 2), then the normalisation."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").split()
            header.append(line)
            if line == ["end_header"]:
                break
        counts = {h[1]: int(h[2]) for h in header if h and h[0] == "element"}
        if ["format", "binary_little_endian", "1.0"] not in header:
            raise ValueError(f"{path}: not the benchmark's binary PLY")
        nv, nf = counts["vertex"], counts["face"]
        verts = np.frombuffer(f.read(12 * nv), "<f4").reshape(nv, 3).astype(np.float32)
        data = f.read()
    rec = np.ndarray((nf,), "u1", data, 0, (13,))
    if not np.all(rec == 3):
        raise ValueError(f"{path}: faces that are not triangles")
    faces = np.ndarray((nf, 3), "<i4", data, 1, (13, 4)).astype(np.int64)
    v0 = verts[faces[:, 0]]
    e0 = verts[faces[:, 1]] - v0
    e1 = verts[faces[:, 2]] - v0
    fn = np.cross(e0, e1)
    len2 = np.sum(fn * fn, axis=-1)
    keep = len2 != 0.0
    faces = faces[keep]
    fn = fn[keep] / np.sqrt(len2[keep])[:, None]
    # each vertex's contributions in add.at's order, summed one at a time on
    # the device (numpy's add.at takes tens of seconds on lucy's mesh)
    fc = torch.from_numpy(faces).to(device)
    vert = fc.T.reshape(-1)
    order = torch.argsort(vert, stable=True)
    vert = vert[order]
    contrib = torch.from_numpy(fn).to(device).repeat(3, 1)[order]
    first = torch.ones_like(vert, dtype=torch.bool)
    first[1:] = vert[1:] != vert[:-1]
    at = torch.arange(vert.shape[0], device=device)
    rank = at - torch.cummax(torch.where(first, at, 0), 0).values
    vn = torch.zeros(verts.shape, dtype=torch.float32, device=device)
    for j in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == j
        vn.index_put_((vert[sel],), vn[vert[sel]] + contrib[sel])
    vn = vn.cpu().numpy()
    norm = np.linalg.norm(vn, axis=-1)
    zero = norm == 0.0
    vn = np.where(zero[:, None], np.array([0.0, 1.0, 0.0], np.float32),
                  vn / np.where(zero, 1.0, norm)[:, None])
    return faces, verts, vn.astype(np.float32)


def _floats(vals):
    return tuple(float(v) for v in vals)


def _xform(attrs, accum):
    for name, vals in attrs:
        if name == "translate":
            accum.translate(_floats(vals))
        elif name == "scale":
            accum.scale(_floats(vals))
        elif name == "rotate":
            raise NotImplementedError("rotate is in no benchmark configuration")
    return accum


def _t(x, dev, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)


def build(text: str, mesh_dir: str, device) -> SimpleNamespace:
    """The scene of ``text`` with its meshes read from ``mesh_dir``."""
    p = SimpleNamespace(width=0, height=0, max_depth=0, rr_depth=0, mats={},
                        meshes=[], planes=[], lights=[], env=None, camera=None)
    for kind, attrs in parse(text):
        a = dict(attrs)
        if kind == "scene_parameters":
            p.width, p.height = int(a["width"][0]), int(a["height"][0])
            p.max_depth = int(a["max_depth"][0])
            p.rr_depth = int(a["russian_roulette_depth"][0])
            if a["integrator"][0] != "iterative_rrnee":
                raise NotImplementedError("the reference renders iterative_rrnee")
        elif kind == "perspective_camera":
            p.camera = (_floats(a["origin"]), _floats(a["look_at"]),
                        _floats(a.get("up", (0.0, 1.0, 0.0))),
                        float(a.get("fov", (45.0,))[0]))
        elif kind in ("material_lambertian", "material_glossy"):
            p.mats[a["name"][0]] = dict(
                base_type=core.MAT_GLOSSY if kind == "material_glossy"
                else core.MAT_LAMBERTIAN,
                albedo=_floats(a["diffuse"]),
                roughness=float(a.get("roughness", (0.5,))[0]),
                ior=float(a.get("ior", (1.5,))[0]), has_cc=0, cc_ior=1.5,
                cc_color=(1.0, 1.0, 1.0))
        elif kind == "material_clearcoat":
            base = dict(p.mats[a["base"][0]])
            base.update(has_cc=1, cc_ior=float(a.get("ior", (1.5,))[0]),
                        cc_color=_floats(a.get("color", (1.0, 1.0, 1.0))))
            p.mats[a["name"][0]] = base
        elif kind == "mesh":
            p.meshes.append((a["file"][0], _xform(attrs, _TransformAccum()),
                             a["material"][0]))
        elif kind == "plane":
            p.planes.append((_xform(attrs, _TransformAccum()), a["material"][0]))
        elif kind == "sphere_light":
            p.lights.append((_xform(attrs, _TransformAccum()),
                             _floats(a.get("radiance", (1.0, 1.0, 1.0)))))
        elif kind == "environment_light":
            if "image" in a or "rotate" in a or "scale" in a:
                raise NotImplementedError("only a constant environment light")
            p.env = _floats(a.get("radiance", (1.0, 1.0, 1.0)))
        else:
            raise NotImplementedError(f"{kind} is in no benchmark configuration")

    names = list(p.mats)
    mid = {n: i for i, n in enumerate(names)}
    rows = [p.mats[n] for n in names]
    dev = torch.device(device)
    mats = SimpleNamespace(
        base_type=_t([r["base_type"] for r in rows], dev, torch.int32),
        albedo=_t([r["albedo"] for r in rows], dev),
        roughness=_t([r["roughness"] for r in rows], dev),
        ior=_t([r["ior"] for r in rows], dev),
        has_clearcoat=_t([r["has_cc"] for r in rows], dev, torch.int32),
        cc_ior=_t([r["cc_ior"] for r in rows], dev),
        cc_color=_t([r["cc_color"] for r in rows], dev))
    mats.rho_table = core.build_rho_tables(mats.roughness, mats.ior)

    tv, tn, tm, loaded = [[], [], []], [[], [], []], [], {}
    for fname, acc, mname in p.meshes:
        if fname not in loaded:
            loaded[fname] = read_ply(os.path.join(mesh_dir, fname), dev)
        faces, verts, normals = loaded[fname]
        linear, translation = acc.fwd()
        v = (verts @ linear.T + translation).astype(np.float32)
        n = (normals @ linear.T).astype(np.float32)
        for k in range(3):
            tv[k].append(v[faces[:, k]])
            tn[k].append(n[faces[:, k]])
        tm.append(np.full(faces.shape[0], mid[mname], np.int32))
    tri = SimpleNamespace(
        v0=_t(np.concatenate(tv[0]), dev), v1=_t(np.concatenate(tv[1]), dev),
        v2=_t(np.concatenate(tv[2]), dev), n0=_t(np.concatenate(tn[0]), dev),
        n1=_t(np.concatenate(tn[1]), dev), n2=_t(np.concatenate(tn[2]), dev),
        material_id=_t(np.concatenate(tm), dev, torch.int64))
    tri.accel = Accel(tri.v0, tri.v1, tri.v2)

    def xf(items):
        fw = [it.fwd() for it in items]
        iv = [it.inv() for it in items]
        return dict(o2w_l=_t(np.stack([f[0] for f in fw]), dev),
                    o2w_t=_t(np.stack([f[1] for f in fw]), dev),
                    w2o_l=_t(np.stack([i[0] for i in iv]), dev),
                    w2o_t=_t(np.stack([i[1] for i in iv]), dev))

    planes = SimpleNamespace(**xf([pl[0] for pl in p.planes]), material_id=_t(
        [mid[pl[1]] for pl in p.planes], dev, torch.int64)) if p.planes else None
    lights = SimpleNamespace(**xf([lt[0] for lt in p.lights]),
                             radiance=_t([lt[1] for lt in p.lights], dev)) \
        if p.lights else None
    eye, to, up, fov = p.camera
    camera = SimpleNamespace(eye=_t(eye, dev), to=_t(to, dev), up=_t(up, dev),
                             fov=_t(fov, dev), wh=_t([p.width, p.height], dev))
    return SimpleNamespace(
        width=p.width, height=p.height, max_depth=p.max_depth,
        rr_depth=p.rr_depth, materials=mats, triangles=tri, planes=planes,
        sphere_lights=lights, n_sphere_lights=len(p.lights),
        env=None if p.env is None else _t(p.env, dev), camera=camera)
