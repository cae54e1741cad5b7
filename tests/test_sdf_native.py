"""Native SDF voxelizer + on-device grid sampling + engine SDF-grid contacts.

Replaces the reference's mesh-distance stack (PhysX SDF collisions
docs/factory.md, Warp SAPU queries industreal_algo_utils.py:49-157, pysdf
SDF rewards :202-283) with: C++ voxelizer (native/sdf_voxelize.cpp, NumPy
fallback) -> static grid -> XLA trilinear sampling in the narrowphase.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from isaacgymenvs_ma_tpu.models.meshes import (
    box_mesh, cylinder_mesh, tube_mesh, threaded_rod_mesh, uv_sphere_mesh,
    surface_sample)
from isaacgymenvs_ma_tpu.native import (
    query_mesh_sdf, voxelize_mesh, _signed_distance_np, native_available)
from isaacgymenvs_ma_tpu.physics import sdf_grid
from isaacgymenvs_ma_tpu.physics.engine import (
    PhysicsEngine, SimParams, Control, SimState)
from isaacgymenvs_ma_tpu.models.model import (
    ModelBuilder, FREE, FIXED, GEOM_SPHERE)


def test_query_matches_analytic_sphere():
    v, t = uv_sphere_mesh(0.5, nu=48, nv=24)
    pts = np.array([[0, 0, 0], [0.25, 0, 0], [0.7, 0, 0], [0, 0.6, 0],
                    [0.2, 0.2, 0.2]], np.float32)
    d = query_mesh_sdf(v, t, pts)
    ref = np.linalg.norm(pts, axis=-1) - 0.5
    np.testing.assert_allclose(d, ref, atol=6e-3)


def test_native_matches_numpy_fallback():
    v, t = box_mesh([0.2, 0.3, 0.1])
    pts = np.array([[0, 0, 0], [0.25, 0, 0], [0.1, 0.1, 0.05],
                    [-0.4, 0.2, 0.3]], np.float32)
    ref = _signed_distance_np(v, t, pts)
    got = query_mesh_sdf(v, t, pts)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_grid_trilinear_sampling_accuracy():
    v, t = box_mesh([0.2, 0.2, 0.2])
    g = sdf_grid.from_mesh(v, t, resolution=40)
    pts = jnp.asarray([[0.0, 0, 0], [0.3, 0, 0], [0, 0, 0.25],
                       [0.1, 0.1, 0.1]])
    d, n = jax.jit(sdf_grid.sample_with_normal, static_argnums=())(g, pts)
    d = np.asarray(d)
    assert abs(d[0] + 0.2) < 0.02          # center: inside by 0.2
    assert abs(d[1] - 0.1) < 0.02          # 0.1 outside +x face
    assert abs(d[2] - 0.05) < 0.02
    n = np.asarray(n)
    assert n[1, 0] > 0.9                   # +x face normal
    assert n[2, 2] > 0.9


def test_grid_outside_bbox_extension():
    v, t = uv_sphere_mesh(0.1, nu=24, nv=12)
    g = sdf_grid.from_mesh(v, t, resolution=24)
    far = jnp.asarray([[5.0, 0.0, 0.0]])
    d, n = sdf_grid.sample_with_normal(g, far)
    assert float(d[0]) > 4.0               # repulsive far field
    assert float(n[0, 0]) > 0.99           # pointing away from the box


def test_threaded_rod_mesh_watertight_sign():
    v, t = threaded_rod_mesh(0.012, 0.010, 0.03, pitch=0.004,
                             n_seg=24, segs_per_turn=24)
    pts = np.array([[0, 0, 0], [0.05, 0, 0]], np.float32)
    d = query_mesh_sdf(v, t, pts)
    assert d[0] < -0.005                   # axis point is inside
    assert d[1] > 0.03                     # outside radially


def test_ball_rests_on_sdf_mesh_tray():
    """Dynamic: sphere dropped on a fixed SDF-grid box tray settles on top."""
    bv, bt = box_mesh([0.4, 0.4, 0.05])
    b = ModelBuilder()
    tray = b.add_body("tray", -1, FIXED, body_pos=(0, 0, 0.3))
    g_tray = b.add_sdf_geom(tray, bv, bt, resolution=32, name="tray_sdf")
    b.begin_actor()
    ball = b.add_body("ball", -1, FREE)
    g_ball = b.add_geom(ball, GEOM_SPHERE, [0.1, 0, 0], density=200.0)
    eng = PhysicsEngine(b.finalize(), SimParams(dt=1 / 60, substeps=2),
                        ground=False, pair_specs=[(g_ball, g_tray)])
    st = eng.default_state(2)
    st = SimState(st.q.at[:, 2].set(0.8), st.qd)
    ctrl = Control(tau=jnp.zeros((2, eng.nv)))

    @jax.jit
    def run(s):
        def body(s, _):
            s, _ = eng.step(s, ctrl)
            return s, None
        s, _ = jax.lax.scan(body, s, None, length=240)
        return s

    st = run(st)
    z = np.asarray(st.q[:, 2])
    # rest height = tray top (0.35) + radius (0.1); grid resolution ~2.6 cm
    assert np.all(np.abs(z - 0.45) < 0.04), z


def test_surface_sample_on_mesh():
    v, t = cylinder_mesh(0.1, 0.2, n=32)
    pts = surface_sample(v, t, 256, seed=3)
    d = np.abs(query_mesh_sdf(v, t, pts))
    assert pts.shape == (256, 3)
    assert d.max() < 1e-3                  # samples lie on the surface


def test_tube_mesh_has_hole():
    v, t = tube_mesh(0.03, 0.016, 0.016, n=32)
    pts = np.array([[0, 0, 0], [0.023, 0, 0], [0.05, 0, 0]], np.float32)
    d = query_mesh_sdf(v, t, pts)
    assert d[0] > 0.01                     # hole center is outside material
    assert d[1] < 0.0                      # annulus wall is inside
    assert d[2] > 0.01


def test_industreal_grid_matches_analytic_sapu():
    """Grid SAPU/SDF-reward track the analytic primitives on the peg task
    (sub-half-millimeter agreement away from sharp edges)."""
    from isaacgymenvs_ma_tpu.tasks.industreal import (
        IndustRealTaskPegsInsert, TASK_CFGS, PLUG_LENGTH, SOCKET_HALF,
        TABLE_HEIGHT)
    import copy
    cfg = copy.deepcopy(TASK_CFGS["IndustRealTaskPegsInsert"])
    cfg["env"]["numEnvs"] = 8
    task = IndustRealTaskPegsInsert(cfg)
    assert task.use_mesh_sdf
    n = 8
    key = jax.random.PRNGKey(0)
    # plug poses hovering near/within the socket mouth
    pos = jnp.asarray([0.0, 0.0, TABLE_HEIGHT + 2 * SOCKET_HALF[2]
                       + PLUG_LENGTH / 2]) + \
        0.004 * jax.random.normal(key, (n, 3))
    quat = jnp.tile(jnp.asarray([0.0, 0, 0, 1.0]), (n, 1))
    pen_grid = np.asarray(task._sapu_interpen(pos, quat))
    rew_grid = np.asarray(task._sdf_reward(pos, quat))
    task.use_mesh_sdf = False
    pen_ana = np.asarray(task._sapu_interpen(pos, quat))
    rew_ana = np.asarray(task._sdf_reward(pos, quat))
    np.testing.assert_allclose(pen_grid, pen_ana, atol=7e-4)
    # log-scale reward: compare the underlying mean distances
    np.testing.assert_allclose(np.exp(-rew_grid), np.exp(-rew_ana),
                               atol=7e-4)
