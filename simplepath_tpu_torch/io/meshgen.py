"""Procedural mesh generation + PLY/STL writers (numpy).

Counterpart of ``simplepath_tpu/io/meshgen.py``, kept as the port's own copy
(the port imports nothing of the JAX package); the meshes and the bytes the
writers emit are the same.  The reference ships no mesh assets (its scenes
point at Stanford PLY files that are not in the repo), so benchmarks and
tests synthesize deterministic stand-ins: subdivided icospheres with
optional fractal displacement (≈ bunny-scale triangle counts).  Writers emit
binary little-endian PLY / binary STL that both packages' loaders and the
reference's read.
"""

from __future__ import annotations

import numpy as np

__all__ = ["icosphere", "displaced_blob", "displaced_grid", "write_ply",
           "write_stl"]


def icosphere(subdivisions: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere → (vertices [V,3] f32, faces [F,3] i64).

    F = 20 * 4^subdivisions (sub=4 → 5120, sub=6 → 81920 ≈ bunny scale).
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdivisions):
        edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        edges_sorted = np.sort(edges, axis=1)
        uniq, inverse = np.unique(edges_sorted, axis=0, return_inverse=True)
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_idx = len(verts) + np.arange(len(uniq))
        verts = np.concatenate([verts, mids])
        F = len(faces)
        m01 = mid_idx[inverse[0:F]]
        m12 = mid_idx[inverse[F:2 * F]]
        m20 = mid_idx[inverse[2 * F:3 * F]]
        faces = np.concatenate([
            np.stack([faces[:, 0], m01, m20], axis=1),
            np.stack([faces[:, 1], m12, m01], axis=1),
            np.stack([faces[:, 2], m20, m12], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ])
    return verts.astype(np.float32), faces


def displaced_blob(subdivisions: int = 4, amplitude: float = 0.25,
                   seed: int = 7, octaves: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """Icosphere with deterministic multi-octave sinusoidal displacement —
    a bunny-ish irregular closed mesh for benchmarking BVH traversal."""
    v, f = icosphere(subdivisions)
    rng = np.random.RandomState(seed)
    disp = np.zeros(len(v))
    for o in range(octaves):
        freq = 2.0 ** o
        k = rng.normal(size=(3, 3)) * freq
        phase = rng.uniform(0, 2 * np.pi, 3)
        disp += (amplitude / (2.0 ** o)) * np.sin(v @ k.T + phase).sum(axis=1) / 3.0
    v = v * (1.0 + disp[:, None]).astype(np.float32)
    return v.astype(np.float32), f


def displaced_grid(n: int, extent: float = 1000.0, amplitude: float = 120.0,
                   seed: int = 11, octaves: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """n×n heightfield grid with multi-octave sinusoidal displacement →
    (vertices [n²,3] f32, faces [2(n-1)²,3] i64), centered at the origin in
    xz, y up.

    Triangle count is exactly 2(n-1)²: n=3801 → 28.88M, the lucy.ply-class
    stress size that the reference scenes point at but don't ship.
    Deterministic in ``seed``.
    """
    xs = np.linspace(-extent, extent, n, dtype=np.float64)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    rng = np.random.RandomState(seed)
    Y = np.zeros_like(X)
    for o in range(octaves):
        freq = (2.0 ** o) * np.pi / extent
        kx, kz = rng.normal(size=2) * freq
        phase = rng.uniform(0, 2 * np.pi)
        Y += (amplitude / (1.6 ** o)) * np.sin(kx * X + kz * Z + phase)
    v = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)

    ii, jj = np.meshgrid(np.arange(n - 1, dtype=np.int64),
                         np.arange(n - 1, dtype=np.int64), indexing="ij")
    q00 = (ii * n + jj).reshape(-1)
    q10 = q00 + n
    q01 = q00 + 1
    q11 = q10 + 1
    faces = np.concatenate([np.stack([q00, q10, q11], axis=1),
                            np.stack([q00, q11, q01], axis=1)])
    return v, faces


def write_ply(path, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian PLY with float x/y/z and uchar-count int lists."""
    v = np.ascontiguousarray(vertices, "<f4")
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(v)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(v.tobytes())
        rec = np.zeros(len(faces), dtype=[("c", "u1"), ("i", "<i4", 3)])
        rec["c"] = 3
        rec["i"] = faces
        f.write(rec.tobytes())


def write_stl(path, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Binary STL with CCW face normals."""
    v = np.asarray(vertices, np.float32)
    tri = v[faces]                                   # [F,3,3]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(norm > 0, n / np.maximum(norm, 1e-30), 0.0).astype(np.float32)
    rec = np.zeros(len(faces), dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)),
                                      ("attr", "<u2")])
    rec["n"] = n
    rec["v"] = tri
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(np.uint32(len(faces)).tobytes())
        f.write(rec.tobytes())
