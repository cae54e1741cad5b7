"""The articulation dynamics chain (physics/engine.py) against independent
float64 computations: the SPD inverse against NumPy, the CRBA mass matrix
against per-body kinetic energy, the spatial inertias against the rigid-body
formula, and the gravity bias against the potential-energy gradient."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from isaacgymenvs_ma_tpu.physics.engine import spd_inverse
from isaacgymenvs_ma_tpu.tasks import registry
from isaacgymenvs_ma_tpu.utils.config import deep_merge

# nv: Ant 14 (free base + 8 hinges), ShadowHand 30, FactoryTaskNutBoltPick 15
TASKS = ["Ant", "ShadowHand", "FactoryTaskNutBoltPick"]


def _task(name, n=8):
    cfg = deep_merge(registry.task_default_config(name),
                     {"env": {"numEnvs": n}})
    return registry.create_task(name, cfg)


def _generic_state(task, seed=0):
    """Reset state with randomized joint coordinates and velocities."""
    eng = task.engine
    sim = task.initial_state(jax.random.PRNGKey(seed)).sim
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 1))
    q = np.array(sim.q)
    q[:, eng.scalar_qids] += 0.3 * np.asarray(jax.random.normal(
        k1, (q.shape[0], len(eng.scalar_qids))))
    qd = np.asarray(jax.random.normal(k2, sim.qd.shape))
    return jnp.asarray(q), jnp.asarray(qd, jnp.float32)


def _chain(eng, q, mass_scale=None):
    bx, bq = eng.fk(q)
    S = eng.dof_motion(bx, bq)
    I_O, _ = eng.spatial_inertia(bx, bq, mass_scale)
    return bx, bq, S, I_O, eng.mass_matrix(S, I_O)


@pytest.mark.parametrize("name", TASKS)
def test_spd_inverse_matches_numpy(name):
    task = _task(name)
    eng = task.engine
    q, _ = _generic_state(task)
    M = np.asarray(_chain(eng, q)[-1], np.float64)
    H = M + np.diag(np.asarray(eng.dof_armature, np.float64) + 1e-3)
    ref = np.linalg.inv(H)
    out = np.asarray(jax.jit(spd_inverse)(jnp.asarray(H, jnp.float32)),
                     np.float64)
    cond = np.linalg.cond(H)
    err = np.abs(out - ref).max(axis=(1, 2)) / np.abs(ref).max(axis=(1, 2))
    assert np.all(err <= 64 * cond * np.finfo(np.float32).eps), (err, cond)


@pytest.mark.parametrize("name", TASKS)
def test_mass_matrix_matches_kinetic_energy(name):
    """0.5 qd^T M qd equals the sum of the bodies' 0.5 V^T I V, and M is
    symmetric positive definite."""
    task = _task(name)
    eng = task.engine
    q, qd = _generic_state(task)
    bx, bq, S, I_O, M = _chain(eng, q)
    V = np.asarray(eng.body_velocities(S, qd), np.float64)      # (N, nb, 6)
    I = np.asarray(I_O, np.float64)
    ke_bodies = 0.5 * np.einsum("nbi,nbij,nbj->n", V, I, V)
    M = np.asarray(M, np.float64)
    qd = np.asarray(qd, np.float64)
    ke_joint = 0.5 * np.einsum("ni,nij,nj->n", qd, M, qd)
    np.testing.assert_allclose(ke_joint, ke_bodies, rtol=2e-4,
                               atol=1e-5 * ke_bodies.max())
    np.testing.assert_allclose(M, np.swapaxes(M, 1, 2), atol=1e-5 * np.abs(M).max())
    # the armature-free chain of a floating base can be singular only along
    # massless dofs; with armature it must be PD
    Ha = M + np.diag(np.asarray(eng.dof_armature, np.float64) + 1e-6)
    assert np.linalg.eigvalsh(Ha).min() > 0


def _quat_to_rot(qt):
    x, y, z, w = qt[..., 0], qt[..., 1], qt[..., 2], qt[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def test_spatial_inertia_matches_rigid_body_energy():
    """0.5 V^T I_O V = 0.5 m |v_com|^2 + 0.5 w^T (R I R^T) w per body, with
    a per-env mass scale."""
    task = _task("Ant")
    eng = task.engine
    q, qd = _generic_state(task, seed=3)
    N = q.shape[0]
    ms = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (N, eng.nb),
                                       minval=0.6, maxval=1.5))
    bx, bq, S, I_O, _ = _chain(eng, q, jnp.asarray(ms))
    V = np.asarray(eng.body_velocities(S, qd), np.float64)
    w, v_o = V[..., :3], V[..., 3:]
    R = _quat_to_rot(np.asarray(bq, np.float64))
    com = np.asarray(bx, np.float64) + np.einsum(
        "nbij,bj->nbi", R, np.asarray(eng.com, np.float64))
    v_com = v_o + np.cross(w, com)
    m = np.asarray(eng.mass, np.float64)[None] * ms
    Ic = m[..., None, None] / np.asarray(eng.mass, np.float64)[
        None, :, None, None].clip(1e-12) * np.einsum(
        "nbij,bjk,nblk->nbil", R, np.asarray(eng.inertia, np.float64), R)
    ke_ref = 0.5 * (m * np.sum(v_com ** 2, -1)
                    + np.einsum("nbi,nbij,nbj->nb", w, Ic, w))
    ke = 0.5 * np.einsum("nbi,nbij,nbj->nb", V, np.asarray(I_O, np.float64), V)
    np.testing.assert_allclose(ke, ke_ref, rtol=2e-4, atol=1e-6 * ke_ref.max())


def test_gravity_bias_matches_potential_gradient():
    """With qd = 0 the RNEA bias is the gradient of the gravitational
    potential sum_b m_b g . com_b over the joint coordinates."""
    task = _task("Ant", n=4)
    eng = task.engine
    q, _ = _generic_state(task, seed=5)
    qd0 = jnp.zeros((q.shape[0], eng.nv), jnp.float32)
    bx, bq, S, I_O, _ = _chain(eng, q)
    C = np.asarray(eng.bias_force(S, qd0, eng.body_velocities(S, qd0), I_O))

    def potential(qs):
        x, r = eng.fk(qs)
        c = x + jnp.einsum("nbij,bj->nbi", jax.vmap(jax.vmap(
            lambda qq: jnp.asarray(_rot_jnp(qq))))(r), eng.com)
        return -jnp.sum(eng.mass * eng.grav_mask
                        * jnp.einsum("nbi,i->nb", c, eng.gravity))
    # scalar (hinge) dofs: dq = dtheta, so dU/dq is the generalized force
    g = np.asarray(jax.grad(lambda qs: potential(qs))(
        q.astype(jnp.float32)))
    dofs = eng.scalar_dofs
    np.testing.assert_allclose(C[:, dofs], g[:, eng.scalar_qids],
                               rtol=1e-3, atol=1e-3 * np.abs(g).max())


def _rot_jnp(qt):
    x, y, z, w = qt[0], qt[1], qt[2], qt[3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)]),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)]),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)])])
