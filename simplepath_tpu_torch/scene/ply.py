"""PLY mesh loader (ascii / binary little & big endian).

Host-side port of ``base/PlyReader.cpp`` with identical
semantics, vectorized with numpy:

* only triangular faces are kept; others are skipped (PlyReader.cpp:477-484)
* face normals from the CCW cross product of (v1-v0, v2-v0); zero-area faces
  are skipped entirely (PlyReader.cpp:493-506)
* vertex normals are the normalized sum of adjacent (unit) face normals;
  vertices with no faces get (0,1,0) (PlyReader.cpp:509-528)
* vertices and normals are baked to world space by the mesh transform
  (shapes/Triangle.h:35-48); normals use the plain linear matrix (reference
  quirk) and are NOT renormalized after the bake (Triangle.h:43-47).
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_ply", "MeshData", "bake_mesh"]

_SCALAR_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class MeshData:
    """indices [F,3] int64, vertices [V,3] f32, normals [V,3] f32."""

    def __init__(self, indices, vertices, normals):
        self.indices = indices
        self.vertices = vertices
        self.normals = normals


def _parse_header(f) -> tuple[str, list]:
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("Not a PLY file")
    fmt = None
    elements = []  # list of (name, count, [(kind, dtype(s), prop_name)])
    while True:
        line = f.readline()
        if not line:
            raise ValueError("Unexpected EOF in PLY header")
        parts = line.decode("ascii", "replace").split()
        if not parts:
            continue
        if parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", (_SCALAR_TYPES[parts[2]],
                                                 _SCALAR_TYPES[parts[3]]), parts[4]))
            else:
                elements[-1][2].append(("scalar", _SCALAR_TYPES[parts[1]], parts[2]))
        elif parts[0] == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"Unsupported PLY format {fmt}")
    return fmt, elements


def _read_vertices_binary(f, count, props, endian) -> np.ndarray:
    fields = [(p[2], endian + p[1]) for p in props]
    if any(p[0] == "list" for p in props):
        raise ValueError("List property in vertex element unsupported")
    dt = np.dtype(fields)
    raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt, count=count)
    return np.stack([raw["x"], raw["y"], raw["z"]], axis=-1).astype(np.float32)


def _read_faces_binary(f, count, props, endian) -> np.ndarray:
    """Returns [F,3] indices of triangular faces (others skipped)."""
    lists = [p for p in props if p[0] == "list"]
    if len(props) != 1 or len(lists) != 1:
        # general path: walk records (rare in practice)
        return _read_faces_binary_slow(f, count, props, endian)
    cnt_dt = np.dtype(endian + lists[0][1][0])
    idx_dt = np.dtype(endian + lists[0][1][1])
    data = f.read()
    # fast path: all faces are triangles → fixed-stride records
    rec3 = cnt_dt.itemsize + 3 * idx_dt.itemsize
    if len(data) >= count * rec3:
        counts = np.ndarray((count,), cnt_dt, data, 0, (rec3,))
        if np.all(counts == 3):
            idx = np.ndarray((count, 3), idx_dt, data, cnt_dt.itemsize,
                             (rec3, idx_dt.itemsize))
            return idx.astype(np.int64)
    # slow generic walk
    out = []
    off = 0
    for _ in range(count):
        c = int(np.frombuffer(data, cnt_dt, 1, off)[0])
        off += cnt_dt.itemsize
        if c == 3:
            out.append(np.frombuffer(data, idx_dt, 3, off).astype(np.int64))
        off += c * idx_dt.itemsize
    return np.stack(out) if out else np.zeros((0, 3), np.int64)


def _read_faces_binary_slow(f, count, props, endian):
    out = []
    for _ in range(count):
        for kind, dt, name in props:
            if kind == "list":
                cnt_dt = np.dtype(endian + dt[0])
                idx_dt = np.dtype(endian + dt[1])
                c = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
                vals = np.frombuffer(f.read(c * idx_dt.itemsize), idx_dt)
                if name == "vertex_indices" or name == "vertex_index":
                    if c == 3:
                        out.append(vals.astype(np.int64))
            else:
                f.read(np.dtype(endian + dt).itemsize)
    return np.stack(out) if out else np.zeros((0, 3), np.int64)


def _read_ascii(f, elements):
    verts = None
    faces = []
    for name, count, props in elements:
        if name == "vertex":
            names = [p[2] for p in props]
            rows = np.loadtxt(f, max_rows=count, ndmin=2, dtype=np.float64)
            xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
            verts = rows[:, [xi, yi, zi]].astype(np.float32)
        elif name == "face":
            for _ in range(count):
                parts = f.readline().split()
                c = int(parts[0])
                if c == 3:
                    faces.append([int(parts[1]), int(parts[2]), int(parts[3])])
        else:
            for _ in range(count):
                f.readline()
    return verts, np.asarray(faces, np.int64).reshape(-1, 3)


def read_ply(path) -> MeshData:
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        if fmt == "ascii":
            import io
            txt = io.TextIOWrapper(f, encoding="ascii", errors="replace")
            verts, faces = _read_ascii(txt, elements)
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            verts = None
            faces = None
            for name, count, props in elements:
                if name == "vertex":
                    verts = _read_vertices_binary(f, count, props, endian)
                elif name == "face":
                    faces = _read_faces_binary(f, count, props, endian)
                else:
                    # skip fixed-size elements
                    size = sum(np.dtype(endian + p[1]).itemsize for p in props
                               if p[0] == "scalar")
                    f.read(size * count)
    return _finalize(verts, faces)


def _finalize(verts: np.ndarray, faces: np.ndarray) -> MeshData:
    """Face filter + vertex normal generation (PlyReader.cpp:493-528)."""
    v0 = verts[faces[:, 0]]
    e0 = verts[faces[:, 1]] - v0
    e1 = verts[faces[:, 2]] - v0
    fn = np.cross(e0, e1)
    len2 = np.sum(fn * fn, axis=-1)
    keep = len2 != 0.0
    faces = faces[keep]
    fn = fn[keep] / np.sqrt(len2[keep])[:, None]

    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=-1)
    zero = norm == 0.0
    vn = np.where(zero[:, None], np.array([0.0, 1.0, 0.0], np.float32),
                  vn / np.where(zero, 1.0, norm)[:, None])
    return MeshData(indices=faces, vertices=verts.astype(np.float32),
                    normals=vn.astype(np.float32))


def bake_mesh(mesh: MeshData, linear: np.ndarray, translation: np.ndarray) -> MeshData:
    """World-space bake (Triangle.h:35-48): points by affine, normals by the
    plain linear matrix, NOT renormalized."""
    v = mesh.vertices @ linear.T + translation
    n = mesh.normals @ linear.T
    return MeshData(indices=mesh.indices, vertices=v.astype(np.float32),
                    normals=n.astype(np.float32))
