"""Native (C++) components, loaded via ctypes with graceful fallback.

The reference delegates BVH construction to a native Rust crate over FFI
(rendering-fw/RFW/system/bvh/CMakeLists.txt:12-47); here the native
builder is C++17 (``bvh_builder.cpp``, the port's own copy of
``rfw_tpu/native/bvh_builder.cpp``). At first use ``g++`` compiles it,
with rfw_tpu's flags, into ``rfw_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by the hash of the source and the
flags, so an edited source rebuilds. When the library cannot be built or
loaded every entry point returns None and callers fall back to the
vectorized numpy implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-std=c++17",
             "-shared")

_LIB = None
_TRIED = False


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"librfw_bvh_{h.hexdigest()[:16]}.so")


def _build(path: str, echo=None) -> None:
    """Compile into a temporary name, then rename: concurrent processes
    never load a half-written library. ``echo``, given, is called with
    the command line before it runs."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *GXX_FLAGS, "-o", tmp, SOURCE]
        if echo is not None:
            echo(" ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = library_path()
    if not os.path.exists(path):
        # best-effort first-use compile (the .so is a build artifact, not
        # checked in)
        try:
            _build(path)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(path)
        lib.rfw_build_bvh.restype = ctypes.c_int
        lib.rfw_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # tri_min (T*3)
            ctypes.POINTER(ctypes.c_float),   # tri_max (T*3)
            ctypes.c_int,                     # T
            ctypes.c_int,                     # leaf_size
            ctypes.POINTER(ctypes.c_float),   # out bmin (2T*3)
            ctypes.POINTER(ctypes.c_float),   # out bmax
            ctypes.POINTER(ctypes.c_int),     # out child
            ctypes.POINTER(ctypes.c_int),     # out count
            ctypes.POINTER(ctypes.c_int),     # out depth
            ctypes.POINTER(ctypes.c_int),     # out prim_order (T)
        ]
        lib.rfw_build_bvh_loc.restype = ctypes.c_int
        lib.rfw_build_bvh_loc.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # tri_min (T*3)
            ctypes.POINTER(ctypes.c_float),   # tri_max (T*3)
            ctypes.c_int,                     # T
            ctypes.c_int,                     # leaf_size
            ctypes.c_int,                     # search_radius
            ctypes.POINTER(ctypes.c_float),   # out bmin (2T*3)
            ctypes.POINTER(ctypes.c_float),   # out bmax
            ctypes.POINTER(ctypes.c_int),     # out child
            ctypes.POINTER(ctypes.c_int),     # out count
            ctypes.POINTER(ctypes.c_int),     # out depth
            ctypes.POINTER(ctypes.c_int),     # out prim_order (T)
        ]
        lib.rfw_spatial_treelets.restype = ctypes.c_int
        lib.rfw_spatial_treelets.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # tri_min (T*3)
            ctypes.POINTER(ctypes.c_float),   # tri_max (T*3)
            ctypes.c_int,                     # T
            ctypes.c_int,                     # size
            ctypes.POINTER(ctypes.c_int),     # out count (C,)
            ctypes.POINTER(ctypes.c_int),     # out order (T,)
            ctypes.POINTER(ctypes.c_float),   # out bmin (C, 3)
            ctypes.POINTER(ctypes.c_float),   # out bmax (C, 3)
        ]
        lib.rfw_collapse_wide.restype = ctypes.c_int
        lib.rfw_collapse_wide.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.rfw_extract_treelets.restype = ctypes.c_int
        lib.rfw_extract_treelets.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.rfw_refit_bvh.restype = None
        lib.rfw_refit_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
        ]
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def native_build_bvh(tri_min: np.ndarray, tri_max: np.ndarray,
                     leaf_size: int):
    """C++ binned-SAH build; returns BVH field tuple or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    t = int(tri_min.shape[0])
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    cap = max(2 * t, 16)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    child = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    depth = np.empty(cap, np.int32)
    order = np.empty(max(t, 1), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n = lib.rfw_build_bvh(
        tri_min.ctypes.data_as(fp), tri_max.ctypes.data_as(fp),
        t, int(leaf_size),
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp),
        child.ctypes.data_as(ip), count.ctypes.data_as(ip),
        depth.ctypes.data_as(ip), order.ctypes.data_as(ip))
    if n <= 0:
        return None
    return (bmin[:n].copy(), bmax[:n].copy(), child[:n].copy(),
            count[:n].copy(), order, depth[:n].copy())


def native_spatial_treelets(tri_min: np.ndarray, tri_max: np.ndarray,
                            size: int):
    """C++ centroid-median kd cut into disjoint <=size cells (the
    flagship intersector's cell builder — see bvh/wide.spatial_treelets).
    Returns (count (C,), order (T,), bmin (C,3), bmax (C,3)) or None."""
    lib = _load()
    if lib is None or not hasattr(lib, "rfw_spatial_treelets"):
        return None
    t = int(tri_min.shape[0])
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    cap = max(-(-t // max(size, 1)) * 2 + 8, 16)
    count = np.empty(cap, np.int32)
    order = np.empty(max(t, 1), np.int32)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n = lib.rfw_spatial_treelets(
        tri_min.ctypes.data_as(fp), tri_max.ctypes.data_as(fp),
        t, int(size),
        count.ctypes.data_as(ip), order.ctypes.data_as(ip),
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp))
    if n <= 0:
        return None
    return (count[:n].copy(), order, bmin[:n].copy(), bmax[:n].copy())


def native_build_bvh_loc(tri_min: np.ndarray, tri_max: np.ndarray,
                         leaf_size: int, search_radius: int = 16):
    """C++ locally-ordered-clustering build (PLOC) — the reference rtbvh
    crate's second build mode (BvhType::LocallyOrderedClustering,
    consumed at bvh_tree.cpp:74-101). Same output layout as
    ``native_build_bvh``; None if the library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "rfw_build_bvh_loc"):
        return None
    t = int(tri_min.shape[0])
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    cap = max(2 * t, 16)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    child = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    depth = np.empty(cap, np.int32)
    order = np.empty(max(t, 1), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n = lib.rfw_build_bvh_loc(
        tri_min.ctypes.data_as(fp), tri_max.ctypes.data_as(fp),
        t, int(leaf_size), int(search_radius),
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp),
        child.ctypes.data_as(ip), count.ctypes.data_as(ip),
        depth.ctypes.data_as(ip), order.ctypes.data_as(ip))
    if n <= 0:
        return None
    return (bmin[:n].copy(), bmax[:n].copy(), child[:n].copy(),
            count[:n].copy(), order, depth[:n].copy())


def native_refit_bvh(bvh, tri_min: np.ndarray, tri_max: np.ndarray):
    """In-place bottom-up refit of a builder BVH; returns False if the native
    library is unavailable (callers use the numpy/jax refit instead)."""
    lib = _load()
    if lib is None:
        return False
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    assert bvh.bmin.flags.c_contiguous and bvh.bmax.flags.c_contiguous
    lib.rfw_refit_bvh(
        bvh.bmin.ctypes.data_as(fp), bvh.bmax.ctypes.data_as(fp),
        bvh.child.ctypes.data_as(ip), bvh.count.ctypes.data_as(ip),
        bvh.node_count,
        tri_min.ctypes.data_as(fp), tri_max.ctypes.data_as(fp),
        bvh.prim_order.ctypes.data_as(ip))
    return True


def native_collapse_wide(bvh, width: int):
    """C++ wide collapse; returns WideBVH field tuple or None."""
    lib = _load()
    if lib is None:
        return None
    n = bvh.node_count
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    out_bmin = np.zeros((n, width, 3), np.float32)
    out_bmax = np.zeros((n, width, 3), np.float32)
    out_child = np.full((n, width), -1, np.int32)
    out_count = np.full((n, width), -1, np.int32)
    bmin = np.ascontiguousarray(bvh.bmin, np.float32)
    bmax = np.ascontiguousarray(bvh.bmax, np.float32)
    child = np.ascontiguousarray(bvh.child, np.int32)
    count = np.ascontiguousarray(bvh.count, np.int32)
    nw = lib.rfw_collapse_wide(
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp),
        child.ctypes.data_as(ip), count.ctypes.data_as(ip), n, width,
        out_bmin.ctypes.data_as(fp), out_bmax.ctypes.data_as(fp),
        out_child.ctypes.data_as(ip), out_count.ctypes.data_as(ip))
    if nw <= 0:
        return None
    return (out_bmin[:nw].copy(), out_bmax[:nw].copy(),
            out_child[:nw].copy(), out_count[:nw].copy())


def native_extract_treelets(bvh, size: int):
    """C++ treelet cut; returns (first, count, bmin, bmax) or None."""
    lib = _load()
    if lib is None:
        return None
    n = bvh.node_count
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    cap = max(n, 1)
    out_first = np.zeros(cap, np.int32)
    out_count = np.zeros(cap, np.int32)
    out_bmin = np.zeros((cap, 3), np.float32)
    out_bmax = np.zeros((cap, 3), np.float32)
    bmin = np.ascontiguousarray(bvh.bmin, np.float32)
    bmax = np.ascontiguousarray(bvh.bmax, np.float32)
    child = np.ascontiguousarray(bvh.child, np.int32)
    count = np.ascontiguousarray(bvh.count, np.int32)
    nt = lib.rfw_extract_treelets(
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp),
        child.ctypes.data_as(ip), count.ctypes.data_as(ip), n, size,
        out_first.ctypes.data_as(ip), out_count.ctypes.data_as(ip),
        out_bmin.ctypes.data_as(fp), out_bmax.ctypes.data_as(fp))
    if nt <= 0:
        return None
    return (out_first[:nt].copy(), out_count[:nt].copy(),
            out_bmin[:nt].copy(), out_bmax[:nt].copy())
