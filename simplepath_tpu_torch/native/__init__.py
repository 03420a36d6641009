"""Native (C++) host components with numpy counterparts.

The device compute path is PyTorch + CUDA; the host-side hot paths
(currently the BVH builder for large meshes) are C++ compiled on first use
from this directory's sources into the package's ignored ``build/``
directory and called through ctypes.  The builder has a pure numpy
counterpart (scene/bvh.py) so scenes still load without a C++ toolchain.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import time

import numpy as np

from .. import tracing

logger = logging.getLogger("simplepath_tpu_torch")

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_SO_PATH = os.path.join(BUILD_DIR, "_simplepath_native.so")
_SRC = os.path.join(_HERE, "bvh_builder.cpp")

_lib = None
_lib_tried = False


def _compile() -> str | None:
    # into a file of this process's own, then moved into place: the ranks
    # of a host that finds no build may all compile at once
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    try:
        t0 = time.time()
        os.makedirs(BUILD_DIR, exist_ok=True)
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
               _SRC, "-o", tmp]
        tracing.count("library.builds")
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO_PATH)
        logger.info("native BVH builder built: %s (%.1f s)", _SO_PATH,
                    time.time() - t0)
        return _SO_PATH
    except Exception as e:  # pragma: no cover - toolchain-dependent
        logger.info("native build unavailable (%s); using the numpy builder", e)
        return None


def get_lib():
    """Load (compiling if needed) the native library, or None; the first
    call is a ``library`` span (``built``: whether it ran g++)."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    stale = (not os.path.exists(_SO_PATH)
             or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC))
    with tracing.span("library", lib="native", built=stale):
        path = _compile() if stale else _SO_PATH
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.bvh_build.restype = ctypes.c_int32
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.bvh_copy_out.restype = None
        lib.bvh_copy_out.argtypes = [ctypes.POINTER(ctypes.c_float),
                                     ctypes.POINTER(ctypes.c_int32),
                                     ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    except OSError as e:  # pragma: no cover
        logger.info("native load failed (%s); using the numpy builder", e)
        _lib = None
    return _lib


def native_build_bvh_wide(lo: np.ndarray, hi: np.ndarray, leaf_size: int = 4,
                          width: int = 8) -> tuple[dict, np.ndarray] | None:
    """C++ wide-BVH build; returns (node dict, prim_order) or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = lo.shape[0]
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    num_nodes = lib.bvh_build(lo.ctypes.data_as(fp), hi.ctypes.data_as(fp),
                              np.int32(n), np.int32(leaf_size), np.int32(width))
    child_box = np.empty((num_nodes, width, 6), np.float32)
    child_meta = np.empty((num_nodes, width, 3), np.int32)
    prim_order = np.empty(n, np.int32)
    lib.bvh_copy_out(child_box.ctypes.data_as(fp),
                     child_meta.ctypes.data_as(ip), prim_order.ctypes.data_as(ip))
    return {"child_box": child_box, "child_meta": child_meta}, prim_order
