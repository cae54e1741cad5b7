"""Round-4 grasp-stack regressions: speculative contact margin (thin-wall
tunneling), direction-aware mass splitting, and the hand-family training
mechanics (resetTime clock, random object forces, action smoothing).

Motivated by the Factory pick forensics (training lift success 0.00):
fingerpads tunneled through the 3.5 mm hex-nut wall because contact rows only
activated AFTER penetration, and the per-body mass-splitting count throttled
the squeeze impulse by the orthogonal table-resting cloud.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isaacgymenvs_ma_tpu.models import meshes
from isaacgymenvs_ma_tpu.models.model import (FIXED, FREE, GEOM_BOX,
                                              GEOM_SPHERE, ModelBuilder,
                                              compose_scene)
from isaacgymenvs_ma_tpu.physics.engine import (Control, PhysicsEngine,
                                                SimParams, SimState)


def _thin_wall_scene():
    """Free 2 mm sphere probe flying at a thin (2 mm) fixed SDF wall."""
    tb = ModelBuilder()
    tb.begin_actor()
    t = tb.add_body("wall", -1, FIXED)
    v, tr = meshes.box_mesh(np.array([0.001, 0.05, 0.05]))
    tb.add_sdf_geom(t, v, tr, resolution=48, name="wall_geom")
    ob = ModelBuilder()
    ob.begin_actor()
    probe = ob.add_body("probe", -1, FREE)
    ob.add_geom(probe, GEOM_SPHERE, np.array([0.002, 0, 0]), density=1000.0,
                friction=0.5, name="probe_geom")
    m = compose_scene([(tb.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                       (ob.finalize(), (0, 0, 0), (0, 0, 0, 1))])
    names = [g.name for g in m.geoms]
    return m, names


def _fly_at_wall(margin):
    m, names = _thin_wall_scene()
    params = SimParams(dt=1 / 60, substeps=2, gravity=(0.0, 0.0, 0.0),
                       num_iterations=16, contact_margin=margin)
    eng = PhysicsEngine(m, params, ground=False,
                        pair_specs=[(names.index("probe_geom"),
                                     names.index("wall_geom"))])
    s = eng.default_state(1)
    probe = names.index("probe_geom")
    pb = m.geoms[probe].body
    qa = int(m.q_adr[pb])
    va = int(m.v_adr[pb])
    # start 36.5 mm before the wall (substep landings straddle the band), incoming at 1.2 m/s (10 mm/substep vs a
    # 6 mm contact band |x| < wall_half + radius: a substep can clear the
    # whole band, so without speculative rows the probe tunnels);
    # free-joint qd layout is [lin 0:3, ang 3:6]
    q = s.q.at[:, qa].set(-0.0365)
    qd = s.qd.at[:, va].set(1.2)
    s = SimState(q, qd)
    ctrl = Control(tau=jnp.zeros((1, eng.nv), jnp.float32))
    step = jax.jit(lambda st: eng.step(st, ctrl)[0])
    for _ in range(30):
        s = step(s)
    return float(s.q[0, qa])


@pytest.mark.slow
def test_speculative_margin_stops_thin_wall_tunneling():
    x_no_margin = _fly_at_wall(0.0)
    x_margin = _fly_at_wall(0.012)
    # without the margin the probe crosses the wall (ends on +x side);
    # with it the probe is stopped at/behind the contact surface on the -x
    # side (surface = wall half-thickness 1 mm + probe radius 2 mm; a
    # perfectly resolved inelastic stop rests exactly at -3 mm)
    assert x_no_margin > 0.0, f"expected tunneling baseline, got {x_no_margin}"
    assert x_margin < -0.0025, f"probe crossed despite margin: {x_margin}"


def test_contact_margin_parsed_from_physx_contact_offset():
    from isaacgymenvs_ma_tpu.tasks.base import parse_sim_params
    p = parse_sim_params({"physx": {"contact_offset": 0.005}})
    assert p.contact_margin == pytest.approx(0.005)
    assert parse_sim_params({}).contact_margin == 0.0


# ---------------------------------------------------------------------------
def _mk_hand(**env):
    from isaacgymenvs_ma_tpu.tasks.allegro_hand import AllegroHand, TASK_CFG
    cfg = copy.deepcopy(TASK_CFG)
    cfg["env"]["numEnvs"] = 4
    cfg["env"].update(env)
    return AllegroHand(cfg)


@pytest.mark.slow
def test_reset_time_overrides_episode_length():
    t = _mk_hand(resetTime=16, controlFrequencyInv=2)
    # 16 s / (2 * 0.01667 s) = 480 policy steps
    assert t.max_episode_length == 480


@pytest.mark.slow
def test_force_scale_perturbs_object():
    t = _mk_hand(forceScale=50.0, forceProbRange=[1.0, 1.0])
    st = t.initial_state(jax.random.PRNGKey(0))
    step = jax.jit(t.step)
    st, _ = step(st, t.zero_actions())
    for _ in range(4):
        st, _ = step(st, t.zero_actions())
    # with p=1 triggering every step, the persistent force state is nonzero
    assert float(jnp.abs(st.task.rb_force).max()) > 0.0
    # and the cube must visibly accelerate vs the unforced task
    t0 = _mk_hand(forceScale=0.0)
    st0 = t0.initial_state(jax.random.PRNGKey(0))
    step0 = jax.jit(t0.step)
    st0, _ = step0(st0, t0.zero_actions())
    for _ in range(4):
        st0, _ = step0(st0, t0.zero_actions())
    v_f = float(jnp.abs(st.sim.qd[:, t.obj_va: t.obj_va + 6]).max())
    v_0 = float(jnp.abs(st0.sim.qd[:, t0.obj_va: t0.obj_va + 6]).max())
    assert v_f > v_0 + 0.05, (v_f, v_0)


@pytest.mark.slow
def test_action_moving_average_slows_targets():
    t_fast = _mk_hand(actionsMovingAverage=1.0)
    t_slow = _mk_hand(actionsMovingAverage=0.2)
    full = jnp.ones((4, 16), jnp.float32)

    def first_target(t):
        st = t.initial_state(jax.random.PRNGKey(0))
        st, _ = jax.jit(t.step)(st, t.zero_actions())
        st, _ = jax.jit(t.step)(st, full)
        return np.asarray(st.task.prev_targets)

    tf = first_target(t_fast)
    ts = first_target(t_slow)
    hi = np.asarray(t_fast.dof_upper)
    # full-scale action: ama=1 jumps to the upper limit, ama=0.2 moves 20%
    assert np.abs(tf[:, t_fast.actuated] - hi[t_fast.actuated]).max() < 1e-4
    assert np.abs(ts - tf).max() > 0.1


@pytest.mark.slow
def test_max_consecutive_successes_resets_clock():
    t = _mk_hand(maxConsecutiveSuccesses=50, resetTime=16,
                 successTolerance=10.0)  # every step is a "success"
    st = t.initial_state(jax.random.PRNGKey(0))
    step = jax.jit(t.step)
    st, _ = step(st, t.zero_actions())
    for _ in range(5):
        st, res = step(st, t.zero_actions())
    # tolerance 10 rad: success every step -> progress clock pinned at 0
    assert int(st.progress.max()) == 0
    assert float(st.task.successes.min()) >= 5.0
