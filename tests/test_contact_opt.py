"""Contact-path optimizations: active-set compaction, ground-candidate
pruning, and local terrain windows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isaacgymenvs_ma_tpu.tasks import registry
from isaacgymenvs_ma_tpu.utils.config import deep_merge


def test_ground_prune_fixed_base_hand():
    """ShadowHand: every hand body rides a fixed tree ~0.65 m up — only the
    free cube's corners may generate ground rows (engine._ground_reachable)."""
    cfg = deep_merge(registry.task_default_config("ShadowHand"),
                     {"env": {"numEnvs": 2}})
    t = registry.create_task("ShadowHand", cfg)
    E = t.engine
    assert E.n_pts == 80
    assert E.n_ground == 8
    # kept candidates all live on the free-base object body
    m = t.model
    for b in np.asarray(E.gnd_body):
        root = int(b)
        while m.parent[root] != -1:
            root = int(m.parent[root])
        assert int(m.jnt_type[root]) == 0  # FREE


def test_ground_prune_keeps_free_base():
    """Ant floats: nothing may be pruned."""
    from isaacgymenvs_ma_tpu.tasks.ant import Ant, TASK_CFG
    t = Ant(deep_merge(TASK_CFG, {"env": {"numEnvs": 2}}))
    assert t.engine.n_ground == t.engine.n_pts == 25


def test_compaction_equivalence():
    """capacity >= #active rows is bitwise-equivalent to the full solve.

    Compared on a settled palm grasp (20 steps in): the cube's initial
    drop-in briefly makes more speculative rows proximate than any capacity
    worth shipping, exactly like PhysX's max_gpu_contact_pairs truncation."""
    cfg = deep_merge(registry.task_default_config("ShadowHand"),
                     {"env": {"numEnvs": 16}})
    t = registry.create_task("ShadowHand", cfg)
    st = t.initial_state(jax.random.PRNGKey(0))
    acts = jax.random.uniform(jax.random.PRNGKey(1),
                              (16, t.num_actions), minval=-1, maxval=1)
    assert t.engine.params.contact_capacity == 32
    step_cap = jax.jit(t.step)
    for _ in range(20):
        st, _ = step_cap(st, acts)
    st_cap, _ = step_cap(st, acts)
    t.engine.params = t.engine.params._replace(contact_capacity=None)
    st_full, _ = jax.jit(t.step)(st, acts)
    np.testing.assert_allclose(np.asarray(st_cap.sim.qd),
                               np.asarray(st_full.sim.qd), rtol=0, atol=1e-5)


def test_local_terrain_matches_global():
    """LocalTerrain lookups equal TerrainGrid's for in-window points."""
    from isaacgymenvs_ma_tpu.physics.terrain import TerrainGrid
    rng = np.random.default_rng(3)
    heights = jnp.asarray(rng.normal(size=(64, 96)).astype(np.float32))
    grid = TerrainGrid(heights=heights, horizontal_scale=0.1,
                       origin_xy=(-1.0, -2.0))
    N, P = 8, 17
    cx = jnp.asarray(rng.uniform(1.0, 3.0, N).astype(np.float32))
    cy = jnp.asarray(rng.uniform(1.0, 3.0, N).astype(np.float32))
    local = grid.local_window(cx, cy, size=24)
    dx = rng.uniform(-0.9, 0.9, (N, P)).astype(np.float32)
    dy = rng.uniform(-0.9, 0.9, (N, P)).astype(np.float32)
    px = cx[:, None] + dx
    py = cy[:, None] + dy
    np.testing.assert_allclose(np.asarray(local.height_at(px, py)),
                               np.asarray(grid.height_at(px, py)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(local.height_min2(px, py)),
                               np.asarray(grid.height_min2(px, py)),
                               rtol=1e-5, atol=1e-5)


def test_osc_spd_inverse_matches_lu():
    """The sweep-based OSC matches the LU-inverse formulation."""
    from isaacgymenvs_ma_tpu.physics.controllers import osc_torques
    rng = np.random.default_rng(0)
    B = 32
    A = rng.normal(size=(B, 7, 7)).astype(np.float32)
    mm = jnp.asarray(A @ np.swapaxes(A, 1, 2) + 3.0 * np.eye(7, dtype=np.float32))
    j_eef = jnp.asarray(rng.normal(size=(B, 6, 7)).astype(np.float32))
    eef_vel = jnp.asarray(rng.normal(size=(B, 6)).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(B, 7)).astype(np.float32))
    qd = jnp.asarray(rng.normal(size=(B, 7)).astype(np.float32))
    dpose = jnp.asarray(rng.normal(size=(B, 6)).astype(np.float32))
    dflt = jnp.asarray(rng.normal(size=(7,)).astype(np.float32))
    u = osc_torques(mm, j_eef, eef_vel, q, qd, dpose, dflt)

    mm_inv = jnp.linalg.inv(mm)
    m_eef = jnp.linalg.inv(j_eef @ mm_inv @ jnp.swapaxes(j_eef, 1, 2))
    kp, kp_null = 150.0, 10.0
    kd, kd_null = 2.0 * jnp.sqrt(kp), 2.0 * jnp.sqrt(kp_null)
    u_ref = jnp.swapaxes(j_eef, 1, 2) @ m_eef @ (
        kp * dpose - kd * eef_vel)[..., None]
    j_eef_inv = m_eef @ j_eef @ mm_inv
    u_null = kd_null * -qd + kp_null * ((dflt - q + np.pi) % (2 * np.pi) - np.pi)
    u_null = mm @ u_null[..., None]
    proj = jnp.eye(7) - jnp.swapaxes(j_eef, 1, 2) @ j_eef_inv
    u_ref = (u_ref + proj @ u_null)[..., 0]
    np.testing.assert_allclose(np.asarray(u), np.asarray(u_ref),
                               rtol=2e-3, atol=2e-3)


def test_contact_row_reuse_near_equivalent():
    """reuse_contact_rows (narrowphase once per control step, the PhysX
    model) stays within O(h*qd) of the exact per-substep row rebuild over a
    short horizon, and is exact for envs at rest."""
    from isaacgymenvs_ma_tpu.tasks.ant import Ant, TASK_CFG
    mk = lambda flag: Ant(deep_merge(TASK_CFG, {
        "env": {"numEnvs": 8},
        "sim": {"physx": {"reuse_contact_rows": flag}}}))
    t_on, t_off = mk(True), mk(False)
    assert t_on.engine.params.reuse_contact_rows
    assert not t_off.engine.params.reuse_contact_rows
    acts = jnp.zeros((8, t_on.num_actions))
    s_on = t_on.initial_state(jax.random.PRNGKey(0))
    s_off = t_off.initial_state(jax.random.PRNGKey(0))
    for _ in range(5):
        s_on, _ = t_on.step(s_on, acts)
        s_off, _ = t_off.step(s_off, acts)
    assert bool(jnp.all(jnp.isfinite(s_on.sim.q)))
    np.testing.assert_allclose(np.asarray(s_on.sim.q),
                               np.asarray(s_off.sim.q), rtol=0, atol=5e-3)


def test_contact_row_reuse_hand_settles():
    """ShadowHand (pair rows + compaction + reuse): the held cube must stay
    finite and near the palm over a settle horizon."""
    cfg = deep_merge(registry.task_default_config("ShadowHand"),
                     {"env": {"numEnvs": 4}})
    t = registry.create_task("ShadowHand", cfg)
    assert t.engine.params.reuse_contact_rows
    st = t.initial_state(jax.random.PRNGKey(0))
    acts = jnp.zeros((4, t.num_actions))

    @jax.jit
    def roll(st):
        def body(s, _):
            s, r = t.step(s, acts)
            return s, r.obs
        return jax.lax.scan(body, st, None, length=20)

    st, obs = roll(st)
    assert bool(jnp.all(jnp.isfinite(st.sim.q)))
    assert bool(jnp.all(jnp.isfinite(obs)))


def test_allegro_kuka_capacity_near_equivalent():
    """Deepest-16 compaction on AllegroKuka (34 candidate rows) must match
    the uncompacted solve while #active <= 16 — a settle horizon from the
    initial grasp pose stays within integration tolerance."""
    from isaacgymenvs_ma_tpu.tasks.allegro_kuka import resolve_allegro_kuka
    import copy
    from isaacgymenvs_ma_tpu.tasks.allegro_kuka import TASK_CFG

    def mk(cap):
        cfg = copy.deepcopy(TASK_CFG)
        cfg["env"]["numEnvs"] = 4
        cfg["sim"]["physx"]["contact_capacity"] = cap
        return resolve_allegro_kuka(cfg)

    t_k, t_full = mk(16), mk(None)
    assert t_k.engine.params.contact_capacity == 16
    assert t_full.engine.params.contact_capacity is None
    s_k = t_k.initial_state(jax.random.PRNGKey(0))
    s_f = t_full.initial_state(jax.random.PRNGKey(0))
    step_k, step_f = jax.jit(t_k.step), jax.jit(t_full.step)
    for _ in range(5):
        s_k, _ = step_k(s_k, t_k.zero_actions())
        s_f, _ = step_f(s_f, t_full.zero_actions())
    assert bool(jnp.all(jnp.isfinite(s_k.sim.q)))
    np.testing.assert_allclose(np.asarray(s_k.sim.q), np.asarray(s_f.sim.q),
                               rtol=0, atol=5e-3)
