"""Binary STL mesh loader.

Host-side port of ``base/STLReader.cpp`` with identical
semantics, vectorized with numpy:

* 80-byte header, uint32 count, 50-byte records (STLReader.cpp:45-116)
* vertices are deduplicated by exact coordinate equality
  (STLReader.cpp:19-36's map-based indexer)
* a zero file normal falls back to the CCW cross product
  (STLReader.cpp:105-109)
* reference quirk kept: a face skipped for having a zero normal still leaves
  its indices in the mesh index list (they were pushed before the check,
  STLReader.cpp:98-113) — it only drops out of vertex-normal accumulation.
* ASCII STL is unimplemented, as in the reference (STLReader.cpp:38-43).
"""

from __future__ import annotations

import numpy as np

from .ply import MeshData

__all__ = ["read_stl"]


def read_stl(path) -> MeshData:
    with open(path, "rb") as f:
        header = f.read(80)
        if header[:5] == b"solid":
            # The reference only reads binary STL; many "solid" headers are
            # still binary, so only reject if the record math fails below.
            pass
        count = int(np.frombuffer(f.read(4), "<u4")[0])
        data = f.read()
    rec = np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")])
    tris = np.frombuffer(data[:count * 50], dtype=rec, count=count)

    all_verts = tris["v"].reshape(-1, 3)            # [3F,3]
    # dedup by exact equality, preserving first-seen order (the reference's
    # std::map indexer assigns index = current size at first sight)
    _, first_idx, inverse = np.unique(all_verts, axis=0, return_index=True,
                                      return_inverse=True)
    order = np.argsort(first_idx)                   # first-seen order
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    indices = rank[inverse].reshape(-1, 3).astype(np.int64)   # [F,3]
    vertices = all_verts[np.sort(first_idx)].astype(np.float32)

    file_n = tris["n"]
    zero_file_n = np.all(file_n == 0.0, axis=-1)
    v0 = vertices[indices[:, 0]]
    e0 = vertices[indices[:, 1]] - v0
    e1 = vertices[indices[:, 2]] - v0
    cross_n = np.cross(e0, e1)
    fn = np.where(zero_file_n[:, None], cross_n, file_n)
    len2 = np.sum(fn * fn, axis=-1)
    contributes = len2 != 0.0                        # zero-normal faces skipped
    fn_unit = fn[contributes] / np.sqrt(len2[contributes])[:, None]
    contrib_faces = indices[contributes]

    vn = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(vn, contrib_faces[:, k], fn_unit)
    norm = np.linalg.norm(vn, axis=-1)
    zero = norm == 0.0
    vn = np.where(zero[:, None], np.array([0.0, 1.0, 0.0], np.float32),
                  vn / np.where(zero, 1.0, norm)[:, None])

    # quirk: ALL face indices stay in the mesh (including zero-normal ones)
    return MeshData(indices=indices, vertices=vertices, normals=vn.astype(np.float32))
