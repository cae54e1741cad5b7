"""Dynamics-core unit tests against analytic solutions.

The reference has no such tests (SURVEY.md §4); these fill that gap and anchor
the from-scratch engine: pendulum vs closed-form joint-space integration,
double-pendulum energy conservation, free-fall of a free body, and ground
contact resting stability.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from isaacgymenvs_ma_tpu.models.model import ModelBuilder, FREE, HINGE, SLIDE, GEOM_SPHERE
from isaacgymenvs_ma_tpu.physics.engine import PhysicsEngine, SimParams, Control, SimState


def rollout(eng, st, ctrl, n):
    @jax.jit
    def run(st):
        def body(s, _):
            s, out = eng.step(s, ctrl)
            return s, None
        s, _ = jax.lax.scan(body, st, None, length=n)
        return s
    return run(st)


def test_pendulum_matches_analytic():
    b = ModelBuilder()
    root = b.add_body("pend", -1, HINGE, jnt_axis=(0, 1, 0))
    b.set_body_mass(root, 1.0, com=(0, 0, -1.0), inertia=np.eye(3) * 1e-8)
    eng = PhysicsEngine(b.finalize(), SimParams(dt=0.001, substeps=1), ground=False)
    st = eng.default_state(2)
    st = SimState(st.q.at[:, 0].set(0.3), st.qd)
    ctrl = Control(tau=jnp.zeros((2, 1)))
    st = rollout(eng, st, ctrl, 300)

    # analytic: I = m l^2 = 1 about the hinge; same semi-implicit Euler.
    # rotating about +y by q moves the com (0,0,-1) to (-sin q, 0, -cos q);
    # gravity torque about +y is (com x F)_y = (-mg)(-(-sin q)) = -mg sin q.
    q, qd = 0.3, 0.0
    for _ in range(300):
        qdd = -9.81 * np.sin(q)
        qd += 0.001 * qdd
        q += 0.001 * qd
    assert abs(float(st.q[0, 0]) - q) < 2e-3


def test_double_pendulum_energy_conservation():
    b = ModelBuilder()
    l1 = b.add_body("l1", -1, HINGE, jnt_axis=(0, 1, 0))
    b.set_body_mass(l1, 1.0, com=(0, 0, -0.5), inertia=np.eye(3) * 0.02)
    l2 = b.add_body("l2", l1, HINGE, jnt_axis=(0, 1, 0), body_pos=(0, 0, -1.0))
    b.set_body_mass(l2, 0.7, com=(0, 0, -0.4), inertia=np.eye(3) * 0.015)
    m = b.finalize()
    eng = PhysicsEngine(m, SimParams(dt=0.0005, substeps=1), ground=False)
    st = eng.default_state(1)
    st = SimState(st.q.at[:, 0].set(1.2).at[:, 1].set(0.4), st.qd)
    ctrl = Control(tau=jnp.zeros((1, 2)))

    def energy(eng, st):
        bx, bq = eng.fk(st.q)
        S = eng.dof_motion(bx, bq)
        V = eng.body_velocities(S, st.qd)
        I_O, _ = eng.spatial_inertia(bx, bq)
        ke = 0.5 * jnp.einsum("nbd,nbde,nbe->n", V, I_O, V)
        from isaacgymenvs_ma_tpu.ops import maths
        com_w = bx + maths.quat_apply(bq, eng.com)
        pe = jnp.sum(eng.mass * 9.81 * com_w[..., 2], axis=-1)
        return float((ke + pe)[0])

    e0 = energy(eng, st)
    st = rollout(eng, st, ctrl, 2000)  # 1 s
    e1 = energy(eng, st)
    assert abs(e1 - e0) < 0.05 * abs(e0) + 0.05


def test_free_fall():
    b = ModelBuilder()
    root = b.add_body("ball", -1, FREE)
    b.set_body_mass(root, 2.0, inertia=np.eye(3) * 0.01)
    eng = PhysicsEngine(b.finalize(), SimParams(dt=0.01, substeps=1), ground=False)
    st = eng.default_state(3)
    st = SimState(st.q.at[:, 2].set(10.0), st.qd)
    ctrl = Control(tau=jnp.zeros((3, 6)))
    st = rollout(eng, st, ctrl, 100)  # 1 s
    # semi-implicit Euler: z = z0 - g*dt*sum(k) = 10 - 9.81*0.01*(1+..+100)*0.01
    expected = 10.0 - 9.81 * 0.01 * 0.01 * (100 * 101 / 2)
    assert abs(float(st.q[0, 2]) - expected) < 1e-3
    assert abs(float(st.qd[0, 2]) + 9.81) < 1e-4


def test_translating_free_flight_is_torque_free():
    """A free body translating horizontally while falling picks up ZERO
    angular velocity.  Regression: with mass-matrix reuse (substeps > 1),
    gravity applied through the CACHED spatial inertia paired a stale com
    with the fresh motion subspace, torquing every floating base by
    |g|*h*v per substep (a sliding ball spun up at ~0.14 rad/s per step;
    fixed round 3 via engine.gravity_wrench on the cached paths)."""
    b = ModelBuilder()
    root = b.add_body("ball", -1, FREE)
    b.set_body_mass(root, 1.0, inertia=np.eye(3) * 0.01)
    eng = PhysicsEngine(b.finalize(), SimParams(substeps=2), ground=False)
    assert eng.params.reuse_mass_matrix
    st = eng.default_state(1)
    st = SimState(st.q.at[:, 2].set(2.0).at[:, 0].set(1.0),
                  st.qd.at[:, 0].set(2.0))
    ctrl = Control(tau=jnp.zeros((1, 6)))
    st = rollout(eng, st, ctrl, 10)
    assert float(jnp.abs(st.qd[0, 3:6]).max()) < 1e-5
    assert abs(float(st.qd[0, 0]) - 2.0) < 1e-5


def test_spinning_top_momentum():
    """Angular velocity of a torque-free symmetric body stays constant."""
    b = ModelBuilder()
    root = b.add_body("top", -1, FREE)
    b.set_body_mass(root, 1.0, inertia=np.eye(3) * 0.1)
    eng = PhysicsEngine(b.finalize(), SimParams(dt=0.002, substeps=1, gravity=(0, 0, 0)),
                        ground=False)
    st = eng.default_state(1)
    st = SimState(st.q, st.qd.at[:, 3:6].set(jnp.array([1.0, 2.0, 3.0])))
    ctrl = Control(tau=jnp.zeros((1, 6)))
    st = rollout(eng, st, ctrl, 500)
    w = np.asarray(st.qd[0, 3:6])
    assert np.allclose(w, [1.0, 2.0, 3.0], atol=1e-3)


def test_ball_rests_on_ground():
    b = ModelBuilder()
    root = b.add_body("ball", -1, FREE)
    ridx = b.add_geom(root, GEOM_SPHERE, (0.1, 0, 0), density=200.0)
    eng = PhysicsEngine(b.finalize(), SimParams(dt=1 / 60, substeps=2), ground=True)
    st = eng.default_state(2)
    st = SimState(st.q.at[:, 2].set(0.3), st.qd)
    ctrl = Control(tau=jnp.zeros((2, 6)))
    st = rollout(eng, st, ctrl, 120)  # 2 s: drop and settle
    z = float(st.q[0, 2])
    assert abs(z - 0.1) < 0.01, z
    assert abs(float(st.qd[0, 2])) < 0.05


def test_slide_joint():
    b = ModelBuilder()
    root = b.add_body("cart", -1, SLIDE, jnt_axis=(0, 1, 0))
    b.set_body_mass(root, 2.0, inertia=np.eye(3) * 0.01)
    eng = PhysicsEngine(b.finalize(), SimParams(dt=0.01, substeps=1), ground=False)
    st = eng.default_state(1)
    ctrl = Control(tau=jnp.full((1, 1), 4.0))
    st = rollout(eng, st, ctrl, 100)
    # a = F/m = 2; semi-implicit euler x = sum k*dt^2*a
    expected = 2.0 * 0.01 * 0.01 * (100 * 101 / 2)
    assert abs(float(st.q[0, 0]) - expected) < 1e-3


def test_sweep_inverse_matches_linalg():
    """The batch-last Gauss-Jordan sweep is an exact SPD inverse, and
    spd_inverse (the sweep behind a batch-last transpose) agrees."""
    import jax
    import jax.numpy as jnp
    from isaacgymenvs_ma_tpu.physics.engine import (
        _sweep_inverse_batchlast, spd_inverse)

    for n in (3, 7, 14, 23):
        key = jax.random.PRNGKey(n)
        A = jax.random.normal(key, (64, n, n))
        H = jnp.einsum("nij,nkj->nik", A, A) + 10.0 * jnp.eye(n)
        ref = jnp.linalg.inv(H)
        out = jnp.transpose(
            _sweep_inverse_batchlast(jnp.transpose(H, (1, 2, 0))), (2, 0, 1))
        assert jnp.max(jnp.abs(out - ref)) < 1e-4, n
        out2 = spd_inverse(H)
        assert jnp.max(jnp.abs(out2 - ref)) < 1e-4, n
