"""Contact warm starting (SimParams.warm_start — the PhysX
persistent-contact warm-start analog, SimState.lam carry).

On the previous accelerator it lost on Ant (the lam carry + up-front
seeding matvecs cost more than the iterations they save, and aggressive
iteration cuts inject energy), so it ships default-off; these tests pin the
semantics of the flag-gated path."""
import jax
import jax.numpy as jnp
import numpy as np

from isaacgymenvs_ma_tpu.tasks.ant import Ant, TASK_CFG
from isaacgymenvs_ma_tpu.utils.config import deep_merge


def _make(physx):
    # isolate the cross-step warm-start flag from in-step impulse
    # continuation (reuse_contact_rows seeds substeps 2+ itself)
    cfg = deep_merge(TASK_CFG, {"env": {"numEnvs": 8},
                                "sim": {"physx": {
                                    "reuse_contact_rows": False, **physx}}})
    return Ant(cfg)


def test_warm_state_allocated_and_threaded():
    t = _make({"warm_start": 1.0})
    assert t.engine.params.warm_start == 1.0
    st = t.initial_state(jax.random.PRNGKey(0))
    assert st.sim.lam is not None
    lam_rows, lam_lo, lam_hi = st.sim.lam
    assert lam_rows.shape == (8, t.engine.n_ground, 3)
    assert lam_lo.shape == (8, t.engine.nv)
    acts = jnp.zeros((8, t.num_actions))
    st2, _ = t.step(st, acts)
    # after a settle step the ant stands on its feet: nonzero normal impulses
    for _ in range(5):
        st2, _ = t.step(st2, acts)
    assert float(jnp.abs(st2.sim.lam[0]).max()) > 0.0
    # pytree structure is stable across steps (scan-compatible)
    assert (jax.tree_util.tree_structure(st)
            == jax.tree_util.tree_structure(st2))


def test_warm_start_same_fixed_point():
    """At convergence (many iterations) warm and cold solves agree — warm
    starting changes the iteration path, not the fixed point."""
    t_cold = _make({"num_iterations": 64})
    t_warm = _make({"num_iterations": 64, "warm_start": 1.0})
    acts = jax.random.uniform(jax.random.PRNGKey(1), (8, 8), minval=-1, maxval=1)
    sc = t_cold.initial_state(jax.random.PRNGKey(0))
    sw = t_warm.initial_state(jax.random.PRNGKey(0))
    # contact dynamics is chaotic: solver-path differences of O(1e-6) per
    # substep amplify exponentially, so keep the horizon short
    for _ in range(5):
        sc, rc = t_cold.step(sc, acts)
        sw, rw = t_warm.step(sw, acts)
    np.testing.assert_allclose(np.asarray(sc.sim.q), np.asarray(sw.sim.q),
                               rtol=0, atol=2e-3)


def test_warm_impulses_zeroed_on_reset():
    t = _make({"warm_start": 1.0})
    st = t.initial_state(jax.random.PRNGKey(0))
    acts = jnp.zeros((8, t.num_actions))
    for _ in range(6):
        st, _ = t.step(st, acts)
    assert float(jnp.abs(st.sim.lam[0]).max()) > 0.0
    # force every env to reset on the next step: lam for reset envs must be
    # zeroed before the post-reset state is observed
    st = st._replace(reset_buf=jnp.ones_like(st.reset_buf))
    st2, _ = t.step(st, acts)
    # envs reset at the top of the step, then stepped once from the reset
    # pose — impulses reflect only that single post-reset substep pair, so
    # they must not exceed a fresh env's own first-step impulses
    fresh = t.initial_state(jax.random.PRNGKey(3))
    fresh2, _ = t.step(fresh, acts)
    hi = float(jnp.abs(fresh2.sim.lam[0]).max()) * 4 + 1e-6
    assert float(jnp.abs(st2.sim.lam[0]).max()) <= hi


def test_warm_start_off_is_default_and_none():
    t = _make({})
    assert t.engine.params.warm_start == 0.0
    st = t.initial_state(jax.random.PRNGKey(0))
    assert st.sim.lam is None
