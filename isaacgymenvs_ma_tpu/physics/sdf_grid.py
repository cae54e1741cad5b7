"""On-device signed-distance voxel grids.

The native voxelizer (native/sdf_voxelize.cpp) bakes a triangle mesh into a
dense SDF grid at scene-build time; this module is the hot-path side: batched
trilinear sampling + analytic trilinear gradients as pure XLA ops, used by
the contact narrowphase (mesh-shaped collision targets — PhysX "SDF-Based
Collisions", docs/factory.md) and by SDF-based shaped rewards
(industreal_algo_utils.py:202-283).

Outside the grid bounds the field is extended with the clamped boundary value
plus the Euclidean distance to the bounding box, which keeps queries repulsive
and gradients pointing home from any distance.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SDFGrid(NamedTuple):
    """Static per-scene grid (closed over by the jitted step, not traced)."""

    values: jax.Array    # (dx, dy, dz) f32 signed distances at voxel centers
    origin: jax.Array    # (3,) world/body-frame position of voxel (0,0,0)
    spacing: jax.Array   # (3,) voxel pitch per axis


def from_mesh(verts: np.ndarray, tris: np.ndarray, resolution: int = 48,
              pad: float = 0.15) -> SDFGrid:
    """Bake a mesh into an SDFGrid (native C++ when available).

    ``resolution``: voxels along the longest bbox axis; ``pad``: margin
    around the bbox as a fraction of its longest side.
    """
    from ..native import voxelize_mesh
    verts = np.asarray(verts, np.float32)
    lo = verts.min(0)
    hi = verts.max(0)
    extent = hi - lo
    margin = float(extent.max()) * pad
    lo = lo - margin
    hi = hi + margin
    extent = hi - lo
    h = float(extent.max()) / (resolution - 1)
    dims = np.maximum(np.ceil(extent / h).astype(np.int32) + 1, 4)
    vals = voxelize_mesh(verts, tris, lo, np.full(3, h, np.float32), dims)
    return SDFGrid(values=jnp.asarray(vals), origin=jnp.asarray(lo),
                   spacing=jnp.asarray(np.full(3, h, np.float32)))


def sample(grid: SDFGrid, pts: jax.Array) -> jax.Array:
    """Trilinear SDF values at pts (..., 3) -> (...,)."""
    d, _ = sample_with_normal(grid, pts)
    return d


def sample_with_normal(grid: SDFGrid, pts: jax.Array):
    """(values (...,), outward normals (..., 3)) at pts (..., 3).

    The normal is the analytic gradient of the trilinear interpolant
    (piecewise constant per cell per axis), normalized; outside the bbox it
    blends with the direction away from the box.
    """
    vals = grid.values
    dims = jnp.asarray(vals.shape, jnp.float32)
    u = (pts - grid.origin) / grid.spacing            # voxel coordinates
    uc = jnp.clip(u, 0.0, dims - 1.0 - 1e-4)
    i0 = jnp.floor(uc).astype(jnp.int32)
    i0 = jnp.minimum(i0, jnp.asarray(vals.shape, jnp.int32) - 2)
    f = uc - i0.astype(uc.dtype)                      # (..., 3) in [0, 1]

    ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
    # Packed-corner gather: all 8 cell corners contiguous in the minor dim,
    # so each query is ONE 8-wide vectorized gather instead of 8 scattered
    # scalar gathers (gathers are latency-bound; the scattered form was
    # the larger part of the factory-tier step on the previous accelerator).  grid.values is a compile-time
    # constant, so XLA constant-folds the pack once per compilation.
    dx, dy, dz = vals.shape
    pack = jnp.stack(
        [vals[ox: dx - 1 + ox, oy: dy - 1 + oy, oz: dz - 1 + oz]
         for ox in (0, 1) for oy in (0, 1) for oz in (0, 1)],
        axis=-1).reshape(-1, 8)
    cell = (ix * (dy - 1) + iy) * (dz - 1) + iz
    c8 = pack[cell]                                   # (..., 8)
    (c000, c001, c010, c011,
     c100, c101, c110, c111) = [c8[..., k] for k in range(8)]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    d = c0 * (1 - fx) + c1 * fx

    # analytic trilinear gradient (d/dvoxel, then to length units)
    gx = (c1 - c0) / grid.spacing[0]
    gy = ((c01 - c00) * (1 - fx) + (c11 - c10) * fx) / grid.spacing[1]
    gz = (((c001 - c000) * (1 - fy) + (c011 - c010) * fy) * (1 - fx)
          + ((c101 - c100) * (1 - fy) + (c111 - c110) * fy) * fx
          ) / grid.spacing[2]
    n = jnp.stack([gx, gy, gz], -1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)

    # outside-the-bbox extension: clamped value + distance to the box
    over = (u - uc) * grid.spacing
    out_d = jnp.linalg.norm(over, axis=-1)
    outside = out_d > 0.0
    d = d + out_d
    n_out = over / jnp.maximum(out_d, 1e-9)[..., None]
    n = jnp.where(outside[..., None], n_out, n)
    return d, n
