"""Native (C++) components and their loaders.

The reference's native surface is external binaries (PhysX, Warp, pysdf —
SURVEY.md §2.5); ours is small, build-time-only C++ compiled on demand with
the system toolchain and loaded via ctypes.  Nothing here runs in the jitted
hot path — native code prepares static arrays (SDF voxel grids) that XLA
kernels then consume on the device.

Every native entry point has a pure-NumPy fallback so the package works
without a compiler (slower grid builds only).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "sdf_voxelize.cpp")
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _build_lib() -> Optional[str]:
    """Compile sdf_voxelize.cpp into a cached .so; return its path."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    cache = os.path.join(tempfile.gettempdir(),
                         f"igma_sdf_{tag}_{os.getuid()}.so")
    if os.path.exists(cache):
        return cache
    tmp = cache + f".build{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        try:  # retry without openmp/march (minimal toolchains)
            cmd = ["g++", "-O2", "-shared", "-fPIC", _SRC, "-o", tmp]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    os.replace(tmp, cache)
    return cache


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = _build_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.sdf_voxelize.argtypes = [f32p, ctypes.c_int32, i32p, ctypes.c_int32,
                                 f32p, f32p, i32p, f32p]
    lib.sdf_voxelize.restype = None
    lib.sdf_query_points.argtypes = [f32p, ctypes.c_int32, i32p,
                                     ctypes.c_int32, f32p, ctypes.c_int32,
                                     f32p]
    lib.sdf_query_points.restype = None
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# NumPy fallback (same algorithms, vectorized over triangles per point)
def _point_tri_dist_np(p, a, b, c):
    """p (3,), a/b/c (T, 3) -> distances (T,).  Ericson 5.1.5, vectorized."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    eps = 1e-30
    v_edge_ab = d1 / np.maximum(d1 - d3, eps)
    w_edge_ac = d2 / np.maximum(d2 - d6, eps)
    w_edge_bc = (d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), eps)
    denom = 1.0 / np.maximum(va + vb + vc, eps)
    v_in = vb * denom
    w_in = vc * denom

    q = a + v_in[:, None] * ab + w_in[:, None] * ac  # interior default
    q = np.where((va <= 0)[:, None] & ((d4 - d3) >= 0)[:, None]
                 & ((d5 - d6) >= 0)[:, None],
                 b + w_edge_bc[:, None] * (c - b), q)
    q = np.where((vb <= 0)[:, None] & (d2 >= 0)[:, None] & (d6 <= 0)[:, None],
                 a + w_edge_ac[:, None] * ac, q)
    q = np.where((vc <= 0)[:, None] & (d1 >= 0)[:, None] & (d3 <= 0)[:, None],
                 a + v_edge_ab[:, None] * ab, q)
    q = np.where(((d6 >= 0) & (d5 <= d6))[:, None], c, q)
    q = np.where(((d3 >= 0) & (d4 <= d3))[:, None], b, q)
    q = np.where(((d1 <= 0) & (d2 <= 0))[:, None], a, q)
    d = p - q
    return np.sqrt((d * d).sum(-1))


def _signed_distance_np(verts, tris, pts):
    """pts (P, 3) -> signed distances (P,)."""
    a = verts[tris[:, 0]]
    b = verts[tris[:, 1]]
    c = verts[tris[:, 2]]
    out = np.empty(len(pts), np.float32)
    for i, p in enumerate(pts):
        d = _point_tri_dist_np(p, a, b, c).min()
        va, vb_, vc_ = a - p, b - p, c - p
        la = np.linalg.norm(va, axis=-1)
        lb = np.linalg.norm(vb_, axis=-1)
        lc = np.linalg.norm(vc_, axis=-1)
        numer = (va * np.cross(vb_, vc_)).sum(-1)
        denom = (la * lb * lc + (va * vb_).sum(-1) * lc
                 + (va * vc_).sum(-1) * lb + (vb_ * vc_).sum(-1) * la)
        wind = 2.0 * np.arctan2(numer, denom)
        out[i] = -d if abs(wind.sum()) > 2.0 * np.pi else d
    return out


# ---------------------------------------------------------------------------
# public API
def voxelize_mesh(verts: np.ndarray, tris: np.ndarray, origin, spacing,
                  dims) -> np.ndarray:
    """Signed-distance voxel grid of a triangle mesh.

    verts (V, 3) float, tris (T, 3) int; voxel center (i,j,k) sits at
    origin + spacing * (i,j,k); returns (dims[0], dims[1], dims[2]) f32.
    """
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    origin = np.ascontiguousarray(origin, np.float32)
    spacing = np.ascontiguousarray(spacing, np.float32)
    dims = np.ascontiguousarray(dims, np.int32)
    # disk cache keyed on the exact inputs: grid baking dominates task
    # construction for mesh-heavy scenes (AllegroKuka: ~110 s), and every
    # process (train CLI, tests, benches) rebuilds the same grids
    h = hashlib.sha256()
    # key includes the SDF implementation (native lib vs numpy fallback) and
    # an algorithm version so an implementation change invalidates old grids
    h.update(b"igma-sdf-v1:" + (b"native" if _load() is not None else b"numpy"))
    for a in (verts, tris, origin, spacing, dims):
        h.update(a.tobytes())
    cache = os.path.join(tempfile.gettempdir(),
                         f"igma_sdfgrid_{h.hexdigest()[:20]}_{os.getuid()}.npy")
    if os.path.exists(cache):
        try:
            g = np.load(cache)
            if g.shape == (int(dims[0]), int(dims[1]), int(dims[2])):
                return g
        except Exception:
            pass
    out = np.empty(int(dims[0]) * int(dims[1]) * int(dims[2]), np.float32)
    lib = _load()
    if lib is not None:
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.sdf_voxelize(
            verts.ctypes.data_as(f32p), np.int32(len(verts)),
            tris.ctypes.data_as(i32p), np.int32(len(tris)),
            origin.ctypes.data_as(f32p), spacing.ctypes.data_as(f32p),
            dims.ctypes.data_as(i32p), out.ctypes.data_as(f32p))
    else:
        ii, jj, kk = np.meshgrid(np.arange(dims[0]), np.arange(dims[1]),
                                 np.arange(dims[2]), indexing="ij")
        pts = origin[None, :] + spacing[None, :] * np.stack(
            [ii.ravel(), jj.ravel(), kk.ravel()], -1).astype(np.float32)
        out[:] = _signed_distance_np(verts, tris, pts)
    grid = out.reshape(int(dims[0]), int(dims[1]), int(dims[2]))
    try:
        tmp = cache + f".w{os.getpid()}"
        np.save(tmp, grid)
        os.replace(tmp + ".npy" if not tmp.endswith(".npy") else tmp, cache)
    except Exception:
        pass
    return grid


def query_mesh_sdf(verts: np.ndarray, tris: np.ndarray,
                   pts: np.ndarray) -> np.ndarray:
    """Signed distances of arbitrary points to a mesh (host-side; the
    device path samples a precomputed grid instead)."""
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    pts = np.ascontiguousarray(pts, np.float32)
    lib = _load()
    if lib is None:
        return _signed_distance_np(verts, tris, pts)
    out = np.empty(len(pts), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.sdf_query_points(
        verts.ctypes.data_as(f32p), np.int32(len(verts)),
        tris.ctypes.data_as(i32p), np.int32(len(tris)),
        pts.ctypes.data_as(f32p), np.int32(len(pts)),
        out.ctypes.data_as(f32p))
    return out
