"""Persistent geometry cache: packed BVH records + reordered triangle tables.

Counterpart of ``simplepath_tpu/scene/cache.py``: the expensive host-side
build (mesh parse, world bake, wide-BVH build, record packing) is kept in a
``.spcache/`` directory next to the meshes, as an uncompressed ``.npz`` with
the JAX package's fields, under a hash of every geometry input (mesh file
identity, bake transform, material id, builder version and topology).
``SIMPLEPATH_CACHE=0`` turns it off; meshes below ``CACHE_MIN_TRIS``
triangles are rebuilt every time.

The port's entries have a prefix of their own (``torch_geom_``) and a key
salted with the package name, so neither package is ever served the other's
entry: a record table the port loads was built by the port.  Entries are
written to a temporary file and moved into place with ``os.replace``, so
processes loading the same scene side by side never read a partial file.
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np

logger = logging.getLogger("simplepath_tpu_torch")

__all__ = ["geometry_cache_key", "load_geometry", "save_geometry",
           "CACHE_MIN_TRIS"]

CACHE_VERSION = 5  # the JAX package's: bump when the record layout changes
CACHE_MIN_TRIS = 50_000  # below this a rebuild is faster than the disk trip
PREFIX = "torch_geom_"

_FIELDS = ("records", "v0", "v1", "v2", "n0", "n1", "n2", "material_id")

# path of the entry the last load_geometry call served, None after a miss
LAST_HIT: str | None = None


def cache_enabled() -> bool:
    return os.environ.get("SIMPLEPATH_CACHE", "1") != "0"


def geometry_cache_key(mesh_jobs) -> str:
    """Hash of the geometry inputs.

    mesh_jobs: sequence of (path, linear[3,3], translation[3], material_id),
    every mesh block in scene order.  File identity is (abspath, size,
    mtime_ns): hashing a 500 MB PLY would cost more than it saves.
    """
    from .bvh import LEAF_SIZE, RECORD_WIDTH, WIDTH

    h = hashlib.sha1()
    h.update(f"simplepath_tpu_torch:v{CACHE_VERSION}:{LEAF_SIZE}:{WIDTH}:"
             f"{RECORD_WIDTH}".encode())
    for path, linear, translation, mat_id in mesh_jobs:
        st = os.stat(path)
        h.update(f"|{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}"
                 f":{mat_id}".encode())
        h.update(np.asarray(linear, np.float64).tobytes())
        h.update(np.asarray(translation, np.float64).tobytes())
    return h.hexdigest()


def _cache_path(base_dir: str, key: str) -> str:
    return os.path.join(base_dir, ".spcache", f"{PREFIX}{key}.npz")


def load_geometry(base_dir: str, key: str) -> dict | None:
    """The cached geometry dict (records + reordered triangle tables) or
    None."""
    global LAST_HIT
    LAST_HIT = None
    if not cache_enabled():
        return None
    path = _cache_path(base_dir, key)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            out = {f: z[f] for f in _FIELDS}
    except Exception as e:  # corrupt/partial file: rebuild
        logger.warning("geometry cache unreadable (%s); rebuilding", e)
        return None
    logger.info("geometry cache hit: %s", path)
    LAST_HIT = path
    return out


def save_geometry(base_dir: str, key: str, arrays: dict) -> None:
    """Write an entry atomically (temp file, then ``os.replace``); a
    read-only scene directory just skips the write."""
    if not cache_enabled() or arrays["v0"].shape[0] < CACHE_MIN_TRIS:
        return
    path = _cache_path(base_dir, key)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}.npz"  # .npz suffix: savez keeps it
        np.savez(tmp, **{f: arrays[f] for f in _FIELDS})
        os.replace(tmp, path)
        logger.info("geometry cache written: %s", path)
    except OSError as e:
        logger.info("geometry cache not written (%s)", e)
