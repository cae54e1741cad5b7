"""Procedural terrain (the ``isaacgym.terrain_utils`` replacement).

The reference's AnymalTerrain builds a heightfield from the external
``isaacgym.terrain_utils`` generators (``tasks/anymal_terrain.py:542-673``:
SubTerrain, random_uniform/pyramid_sloped/discrete_obstacles/stepping_stones/
stairs terrain, curriculum grid of 10 levels x 20 types).  Here the
generators are pure numpy at build time, and the runtime surface is a
:class:`TerrainGrid` with a jit-safe bilinear ``height_at(x, y)`` used both by
the contact solver (ground height under contact points) and by the task's
140-point height-sample observations (:503-538).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class SubTerrain:
    """Height patch in integer units of ``vertical_scale`` (terrain_utils parity)."""

    def __init__(self, name="terrain", width=256, length=256,
                 vertical_scale=0.005, horizontal_scale=0.1):
        self.name = name
        self.width = width
        self.length = length
        self.vertical_scale = vertical_scale
        self.horizontal_scale = horizontal_scale
        self.height_field_raw = np.zeros((width, length), dtype=np.int16)


def random_uniform_terrain(terrain: SubTerrain, min_height, max_height,
                           step=0.05, downsampled_scale=None, rng=None):
    rng = rng or np.random.default_rng()
    if downsampled_scale is None:
        downsampled_scale = terrain.horizontal_scale
    hmin = int(min_height / terrain.vertical_scale)
    hmax = int(max_height / terrain.vertical_scale)
    hstep = max(int(step / terrain.vertical_scale), 1)
    levels = np.arange(hmin, hmax + hstep, hstep)
    dw = max(int(terrain.width * terrain.horizontal_scale / downsampled_scale), 2)
    dl = max(int(terrain.length * terrain.horizontal_scale / downsampled_scale), 2)
    coarse = rng.choice(levels, (dw, dl))
    # bilinear upsample to the full grid
    xi = np.linspace(0, dw - 1, terrain.width)
    yi = np.linspace(0, dl - 1, terrain.length)
    x0 = np.clip(xi.astype(int), 0, dw - 2)
    y0 = np.clip(yi.astype(int), 0, dl - 2)
    fx = (xi - x0)[:, None]
    fy = (yi - y0)[None, :]
    c00 = coarse[x0][:, y0]
    c10 = coarse[x0 + 1][:, y0]
    c01 = coarse[x0][:, y0 + 1]
    c11 = coarse[x0 + 1][:, y0 + 1]
    up = (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
          + c01 * (1 - fx) * fy + c11 * fx * fy)
    terrain.height_field_raw += up.astype(np.int16)
    return terrain


def sloped_terrain(terrain: SubTerrain, slope=1.0):
    x = np.arange(terrain.width)
    max_h = int(slope * terrain.horizontal_scale / terrain.vertical_scale
                * terrain.width)
    terrain.height_field_raw += (max_h * x / terrain.width)[:, None].astype(np.int16)
    return terrain


def pyramid_sloped_terrain(terrain: SubTerrain, slope=1.0, platform_size=1.0):
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    cx, cy = terrain.width // 2, terrain.length // 2
    xf = (cx - np.abs(cx - x)) / cx
    yf = (cy - np.abs(cy - y)) / cy
    max_h = int(slope * (terrain.horizontal_scale / terrain.vertical_scale)
                * (terrain.width / 2))
    hf = max_h * np.outer(xf, yf)
    platform = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = cx - platform, cx + platform
    hf_center = hf[x1: x2, cy - platform: cy + platform]
    cap = hf_center.min() if slope > 0 else hf_center.max()
    hf = np.clip(hf, None, cap) if slope > 0 else np.clip(hf, cap, None)
    terrain.height_field_raw += hf.astype(np.int16)
    return terrain


def discrete_obstacles_terrain(terrain: SubTerrain, max_height=0.15,
                               min_size=1.0, max_size=2.0, num_rects=20,
                               platform_size=1.0, rng=None):
    rng = rng or np.random.default_rng()
    hmax = int(max_height / terrain.vertical_scale)
    heights = np.array([-hmax, -hmax // 2, hmax // 2, hmax])
    wmin = int(min_size / terrain.horizontal_scale)
    wmax = int(max_size / terrain.horizontal_scale)
    for _ in range(num_rects):
        w = int(rng.integers(wmin, wmax))
        l = int(rng.integers(wmin, wmax))
        sx = int(rng.integers(0, max(terrain.width - w, 1)))
        sy = int(rng.integers(0, max(terrain.length - l, 1)))
        terrain.height_field_raw[sx: sx + w, sy: sy + l] = rng.choice(heights)
    cx, cy = terrain.width // 2, terrain.length // 2
    platform = int(platform_size / terrain.horizontal_scale / 2)
    terrain.height_field_raw[cx - platform: cx + platform,
                             cy - platform: cy + platform] = 0
    return terrain


def wave_terrain(terrain: SubTerrain, num_waves=1, amplitude=1.0):
    amp = int(0.5 * amplitude / terrain.vertical_scale)
    if num_waves > 0:
        dx = np.arange(terrain.width) / terrain.width * num_waves * 2 * np.pi
        dy = np.arange(terrain.length) / terrain.length * num_waves * 2 * np.pi
        terrain.height_field_raw += (
            amp * (np.cos(dx)[:, None] + np.sin(dy)[None, :])).astype(np.int16)
    return terrain


def stairs_terrain(terrain: SubTerrain, step_width=0.75, step_height=0.1):
    sw = int(step_width / terrain.horizontal_scale)
    sh = int(step_height / terrain.vertical_scale)
    h = 0
    for i in range(terrain.width // sw):
        terrain.height_field_raw[i * sw: (i + 1) * sw, :] += h
        h += sh
    return terrain


def pyramid_stairs_terrain(terrain: SubTerrain, step_width=0.75,
                           step_height=0.1, platform_size=1.0):
    sw = int(step_width / terrain.horizontal_scale)
    sh = int(step_height / terrain.vertical_scale)
    platform = int(platform_size / terrain.horizontal_scale)
    h = 0
    sx, ex = 0, terrain.width
    sy, ey = 0, terrain.length
    while (ex - sx) > platform and (ey - sy) > platform:
        sx += sw; ex -= sw; sy += sw; ey -= sw
        h += sh
        terrain.height_field_raw[sx: ex, sy: ey] = h
    return terrain


def stepping_stones_terrain(terrain: SubTerrain, stone_size=1.0,
                            stone_distance=0.25, max_height=0.2,
                            platform_size=1.0, depth=-10.0, rng=None):
    rng = rng or np.random.default_rng()
    ss = max(int(stone_size / terrain.horizontal_scale), 1)
    sd = int(stone_distance / terrain.horizontal_scale)
    hmax = int(max_height / terrain.vertical_scale)
    d = int(depth / terrain.vertical_scale)
    terrain.height_field_raw[:] = d
    y = 0
    while y < terrain.length:
        x = int(rng.integers(0, ss)) - ss
        while x < terrain.width:
            x1, x2 = max(x, 0), min(x + ss, terrain.width)
            h = int(rng.integers(-hmax, hmax + 1))
            terrain.height_field_raw[x1: x2, y: min(y + ss, terrain.length)] = h
            x += ss + sd
        y += ss + sd
    cx, cy = terrain.width // 2, terrain.length // 2
    platform = int(platform_size / terrain.horizontal_scale / 2)
    terrain.height_field_raw[cx - platform: cx + platform,
                             cy - platform: cy + platform] = 0
    return terrain


class TerrainGrid(NamedTuple):
    """Runtime heightfield: world-aligned grid with bilinear lookup."""

    heights: jax.Array        # (W, L) meters
    horizontal_scale: float
    origin_xy: tuple          # world coords of grid[0, 0]

    def normal_at(self, x: jax.Array, y: jax.Array) -> jax.Array:
        """Outward surface normal from central differences of the bilinear
        field, (..., 3).  On steep features (stepping-stone gap walls,
        stair risers) the normal tilts toward horizontal, giving contacts
        lateral wall support — PhysX collides the same heightfield as a
        triangle MESH whose near-vertical wall triangles wedge a foot that
        clips a gap edge; with straight-up normals the foot plunges
        unsupported instead (the stones-curriculum gate, VERDICT r4 #4)."""
        e = 0.5 * self.horizontal_scale
        hx = (self.height_at(x + e, y) - self.height_at(x - e, y)) / (2 * e)
        hy = (self.height_at(x, y + e) - self.height_at(x, y - e)) / (2 * e)
        n = jnp.stack([-hx, -hy, jnp.ones_like(hx)], axis=-1)
        return n / jnp.linalg.norm(n, axis=-1, keepdims=True)

    def height_and_normal(self, x: jax.Array, y: jax.Array):
        return self.height_at(x, y), self.normal_at(x, y)

    def height_at(self, x: jax.Array, y: jax.Array) -> jax.Array:
        hx = (x - self.origin_xy[0]) / self.horizontal_scale
        hy = (y - self.origin_xy[1]) / self.horizontal_scale
        W, L = self.heights.shape
        x0 = jnp.clip(jnp.floor(hx).astype(jnp.int32), 0, W - 2)
        y0 = jnp.clip(jnp.floor(hy).astype(jnp.int32), 0, L - 2)
        fx = jnp.clip(hx - x0, 0.0, 1.0)
        fy = jnp.clip(hy - y0, 0.0, 1.0)
        h00 = self.heights[x0, y0]
        h10 = self.heights[x0 + 1, y0]
        h01 = self.heights[x0, y0 + 1]
        h11 = self.heights[x0 + 1, y0 + 1]
        return (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
                + h01 * (1 - fx) * fy + h11 * fx * fy)

    def height_min2(self, x, y):
        """The reference's conservative sample: min of two nearby cells
        (anymal_terrain.py:515-538 uses min(h[x, y], h[x+1, y+1]))."""
        hx = (x - self.origin_xy[0]) / self.horizontal_scale
        hy = (y - self.origin_xy[1]) / self.horizontal_scale
        W, L = self.heights.shape
        x0 = jnp.clip(jnp.floor(hx).astype(jnp.int32), 0, W - 2)
        y0 = jnp.clip(jnp.floor(hy).astype(jnp.int32), 0, L - 2)
        return jnp.minimum(self.heights[x0, y0], self.heights[x0 + 1, y0 + 1])

    def local_window(self, cx: jax.Array, cy: jax.Array, size: int):
        """Per-env local window for the step's terrain lookups.

        Batched point gathers from the global grid were slow on the
        previous accelerator, where they lowered to scalar loops (6+
        height_at calls per control step).  All of a step's queries are
        within ~1.5 m of the robot base, so slice one (size, size) patch
        per env here — once per control step — and resolve every lookup
        inside the patch with one-hot GEMMs (LocalTerrain).  Not yet
        re-measured against a native gather on the GPU.  ``size`` must cover the query radius:
        2 * ceil(radius / horizontal_scale) + 4."""
        W, L = self.heights.shape
        s = self.horizontal_scale
        ix = jnp.clip(jnp.round((cx - self.origin_xy[0]) / s).astype(jnp.int32)
                      - size // 2, 0, W - size)
        iy = jnp.clip(jnp.round((cy - self.origin_xy[1]) / s).astype(jnp.int32)
                      - size // 2, 0, L - size)
        patch = jax.vmap(
            lambda i, j: jax.lax.dynamic_slice(self.heights, (i, j),
                                               (size, size)))(ix, iy)
        return LocalTerrain(patch=patch,
                            base_cell=jnp.stack([ix, iy], -1),
                            horizontal_scale=self.horizontal_scale,
                            origin_xy=self.origin_xy)


class LocalTerrain(NamedTuple):
    """Per-env heightfield window with GEMM-shaped lookups.

    Drop-in for TerrainGrid.height_at/height_min2 over batched (N, P) query
    points that lie inside each env's window (points beyond it clamp to the
    window edge — the window is sized to cover every legitimate query).
    Bilinear interpolation is separable, so height_at is a single
    soft-one-hot GEMM pair per query set instead of four gathers."""

    patch: jax.Array          # (N, S, S)
    base_cell: jax.Array      # (N, 2) int32 global grid coords of patch[0,0]
    horizontal_scale: float
    origin_xy: tuple

    def _frac_coords(self, x, y):
        s = self.horizontal_scale
        hx = (x - self.origin_xy[0]) / s - self.base_cell[:, None, 0]
        hy = (y - self.origin_xy[1]) / s - self.base_cell[:, None, 1]
        S = self.patch.shape[-1]
        x0 = jnp.clip(jnp.floor(hx).astype(jnp.int32), 0, S - 2)
        y0 = jnp.clip(jnp.floor(hy).astype(jnp.int32), 0, S - 2)
        return x0, y0, jnp.clip(hx - x0, 0.0, 1.0), jnp.clip(hy - y0, 0.0, 1.0)

    def _sep_lookup(self, wx, wy):
        """h[n, p] = sum_{i,j} wx[n,p,i] patch[n,i,j] wy[n,p,j] — two batched
        GEMM-shaped contractions."""
        rows = jnp.einsum("npi,nij->npj", wx, self.patch)
        return jnp.sum(rows * wy, -1)

    def _soft_one_hot(self, i0, frac):
        S = self.patch.shape[-1]
        cells = jnp.arange(S, dtype=jnp.int32)
        at0 = (i0[..., None] == cells).astype(self.patch.dtype)
        at1 = (i0[..., None] + 1 == cells).astype(self.patch.dtype)
        return at0 * (1.0 - frac[..., None]) + at1 * frac[..., None]

    def height_at(self, x: jax.Array, y: jax.Array) -> jax.Array:
        x0, y0, fx, fy = self._frac_coords(x, y)
        return self._sep_lookup(self._soft_one_hot(x0, fx),
                                self._soft_one_hot(y0, fy))

    def normal_at(self, x: jax.Array, y: jax.Array) -> jax.Array:
        """Surface normal (see TerrainGrid.normal_at — lateral wall support
        on steep features)."""
        return self.height_and_normal(x, y)[1]

    def height_and_normal(self, x: jax.Array, y: jax.Array):
        """(height, normal) sharing one set of soft-one-hot weights: the
        bilinear gradient is the same separable contraction with the
        weight DERIVATIVE ((at1-at0)/scale) on one axis — 2 extra small
        GEMMs instead of 8 lookup passes."""
        s = self.horizontal_scale
        x0, y0, fx, fy = self._frac_coords(x, y)
        wx = self._soft_one_hot(x0, fx)
        wy = self._soft_one_hot(y0, fy)
        dwx = self._soft_one_hot(x0, jnp.ones_like(fx)) \
            - self._soft_one_hot(x0, jnp.zeros_like(fx))
        dwy = self._soft_one_hot(y0, jnp.ones_like(fy)) \
            - self._soft_one_hot(y0, jnp.zeros_like(fy))
        rows = jnp.einsum("npi,nij->npj", wx, self.patch)
        drows = jnp.einsum("npi,nij->npj", dwx, self.patch)
        h = jnp.sum(rows * wy, -1)
        hx = jnp.sum(drows * wy, -1) / s
        hy = jnp.sum(rows * dwy, -1) / s
        n = jnp.stack([-hx, -hy, jnp.ones_like(hx)], axis=-1)
        return h, n / jnp.linalg.norm(n, axis=-1, keepdims=True)

    def height_min2(self, x, y):
        x0, y0, _, _ = self._frac_coords(x, y)
        z = jnp.zeros_like(x)
        h00 = self._sep_lookup(self._soft_one_hot(x0, z),
                               self._soft_one_hot(y0, z))
        h11 = self._sep_lookup(self._soft_one_hot(x0 + 1, z),
                               self._soft_one_hot(y0 + 1, z))
        return jnp.minimum(h00, h11)


class CurriculumTerrain:
    """The AnymalTerrain map: rows = difficulty levels, cols = terrain types
    (anymal_terrain.py:543-673), assembled into one TerrainGrid with per-cell
    env origins for curriculum placement."""

    def __init__(self, num_levels=10, num_types=20, terrain_width=8.0,
                 terrain_length=8.0, horizontal_scale=0.1, vertical_scale=0.005,
                 border_size=20.0, slope_threshold=None, seed=17,
                 proportions=(0.1, 0.1, 0.35, 0.25, 0.2), curriculum=True):
        rng = np.random.default_rng(seed)
        self.num_levels = num_levels
        self.num_types = num_types
        self.env_length = terrain_length
        self.env_width = terrain_width
        w = int(terrain_width / horizontal_scale)
        l = int(terrain_length / horizontal_scale)
        border = int(border_size / horizontal_scale)
        H = num_levels * w + 2 * border
        L = num_types * l + 2 * border
        field = np.zeros((H, L), np.float64)
        self.env_origins = np.zeros((num_levels, num_types, 3))
        props = np.cumsum(proportions) / np.sum(proportions)

        for i in range(num_levels):
            for j in range(num_types):
                t = SubTerrain(width=w, length=l, vertical_scale=vertical_scale,
                               horizontal_scale=horizontal_scale)
                if curriculum:
                    difficulty = i / max(num_levels - 1, 1)
                    choice = j / num_types + 0.001
                else:
                    difficulty = rng.uniform(0.5, 0.9)
                    choice = rng.uniform()
                slope = difficulty * 0.4
                step_height = 0.05 + 0.175 * difficulty
                discrete_height = 0.025 + 0.15 * difficulty
                stone_size = 2.0 - 1.4 * difficulty
                if choice < props[0]:
                    pyramid_sloped_terrain(t, slope=slope if choice >= props[0] / 2
                                           else -slope, platform_size=3.0)
                elif choice < props[1]:
                    pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
                    random_uniform_terrain(t, -0.05, 0.05, 0.005,
                                           downsampled_scale=0.2, rng=rng)
                elif choice < props[2]:
                    pyramid_stairs_terrain(
                        t, step_width=0.31,
                        step_height=step_height if choice >= (props[1] + props[2]) / 2
                        else -step_height, platform_size=3.0)
                elif choice < props[3]:
                    discrete_obstacles_terrain(t, discrete_height, 1.0, 2.0, 40,
                                               platform_size=3.0, rng=rng)
                else:
                    stepping_stones_terrain(t, stone_size=stone_size,
                                            stone_distance=0.1, max_height=0.0,
                                            platform_size=3.0, rng=rng)
                x0 = border + i * w
                y0 = border + j * l
                field[x0: x0 + w, y0: y0 + l] = (
                    t.height_field_raw.astype(np.float64) * vertical_scale)
                env_origin_x = (i + 0.5) * terrain_width - border_size * 0 \
                    + x0 * 0  # origins in world frame below
                cx1, cx2 = x0 + w // 2 - 1, x0 + w // 2 + 1
                cy1, cy2 = y0 + l // 2 - 1, y0 + l // 2 + 1
                env_origin_z = field[cx1: cx2, cy1: cy2].max()
                self.env_origins[i, j] = [
                    (x0 + w / 2) * horizontal_scale,
                    (y0 + l / 2) * horizontal_scale,
                    env_origin_z,
                ]
        self.grid = TerrainGrid(
            heights=jnp.asarray(field, jnp.float32),
            horizontal_scale=horizontal_scale,
            origin_xy=(0.0, 0.0),
        )
        self.env_origins_j = jnp.asarray(self.env_origins, jnp.float32)
