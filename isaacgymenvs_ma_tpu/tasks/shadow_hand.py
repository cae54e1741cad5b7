"""ShadowHand in-hand cube reorientation (reference tasks/shadow_hand.py,
813 LoC) — act 20, obs per ``observationType``.

24-dof Shadow hand (parsed from the OpenAI mjcf with include expansion) holds
a block that must be spun to a goal orientation:
* obs types (ref :103-132): ``full_no_vel`` (77), ``full`` (157),
  ``full_state`` (211, default) — dof states(+forces), object/goal poses,
  relative quat, fingertip states(+wrenches), actions,
* reward (kernel :747+): dist * -10 + 1/(|rot_dist| + 0.1), action penalty,
  reach-goal bonus 250 with in-step goal resampling on success, fall reset at
  0.24 m, consecutive-success tracking with ``av_factor``,
* position-controlled actuated dofs (20); the four tendon-coupled distal
  joints track their middle joints (PhysX tendon approximation),
* contacts: fingertip/palm candidate points vs the cube SDF + cube corners
  vs the palm box — a reduced static contact set sized for device memory.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import (DRIVE_POS, FREE, GEOM_BOX, ModelBuilder,
                            compose_scene, model_from_spec)
from ..ops import maths
from ..physics.engine import Control, PhysicsEngine, SimState
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "ShadowHand",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 8192,
        "envSpacing": 0.75,
        "episodeLength": 600,
        "enableDebugVis": False,
        "aggregateMode": 1,
        "clipObservations": 5.0,
        "clipActions": 1.0,
        "stiffnessScale": 1.0,
        "forceLimitScale": 1.0,
        "useRelativeControl": False,
        "dofSpeedScale": 20.0,
        "actionsMovingAverage": 1.0,
        "controlFrequencyInv": 1,
        "startPositionNoise": 0.01,
        "startRotationNoise": 0.0,
        "resetPositionNoise": 0.01,
        "resetRotationNoise": 0.0,
        "resetDofPosRandomInterval": 0.2,
        "resetDofVelRandomInterval": 0.0,
        "distRewardScale": -10.0,
        "rotRewardScale": 1.0,
        "rotEps": 0.1,
        "actionPenaltyScale": -0.0002,
        "reachGoalBonus": 250.0,
        "fallDistance": 0.24,
        "fallPenalty": 0.0,
        "objectType": "block",
        "observationType": "full_state",
        "asymmetric_observations": False,
        "successTolerance": 0.1,
        "printNumSuccesses": False,
        "maxConsecutiveSuccesses": 0,
        "averFactor": 0.1,
    },
    "sim": {
        "dt": 0.01667,
        "substeps": 2,
        "up_axis": "z",
        "use_gpu_pipeline": True,
        "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4, "solver_type": 1, "use_gpu": True,
            "num_position_iterations": 8, "num_velocity_iterations": 0,
            # 60 candidate rows; the settled palm grasp keeps <= ~9 proximate
            # but landings/manipulation spike speculative rows — 24 visibly
            # truncated the solve during the drop-in (round 3 measurement)
            "contact_capacity": 32,
            "reuse_contact_rows": True,  # persistent grasp: PhysX-style once-per-step rows
            "contact_offset": 0.002, "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.2, "max_depenetration_velocity": 1000.0,
            # a pinched cube carries 10+ coincident contact rows at once —
            # plain Jacobi diverges (R*relaxation > 2) and launches the cube
            "mass_splitting": True,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 8388608, "contact_collection": 0,
        },
    },
    "task": {"randomize": False, "randomization_params": {}},
}

HAND_POS = np.array([0.0, 0.0, 0.5])
# where the goal VISUALIZATION actor sits (ref shadow_hand.py:320-326) —
# display only, never part of the reward
GOAL_DISPLACEMENT = np.array([-0.2, -0.06, 0.12 - 0.04])
# Scene placement is SELF-ALIGNING (round 2): the hand part is rotated so
# its palm surface normal points up and translated so the palm lands at
# PALM_TARGET; the cube spawns just above it, and the REWARD goal is the
# cube spawn dropped 4 cm (ref :402-403 ``goal_states = object_init_state;
# goal_states[z] -= 0.04``).  Round 1 used the reference Shadow mount
# offsets verbatim against spec frames that carry their own MJCF world
# transform — the cube spawned ~30 cm away from the palm in empty space
# (masked at the time by the also-broken limp drives), so no hand task
# could ever hold, let alone learn.
PALM_TARGET = np.array([0.0, -0.01, 0.55])
OBJ_SPAWN_HEIGHT = 0.06          # cube center above the palm anchor
# legacy module constants (superseded by task.obj_start / task.goal_pos)
OBJ_START = PALM_TARGET + np.array([0.0, 0.0, OBJ_SPAWN_HEIGHT])
GOAL_POS = OBJ_START + np.array([0.0, 0.0, -0.04])


def _part_body_pose0(m, body: int):
    """World pose of a part body at q = 0 (numpy, build-time only)."""
    from ..models.model import _quat_to_mat_np, _quat_mul_np
    chain = []
    b = body
    while b != -1:
        chain.append(b)
        b = int(m.parent[b])
    pos = np.zeros(3)
    quat = np.array([0.0, 0, 0, 1.0])
    for b in reversed(chain):
        pos = pos + _quat_to_mat_np(quat) @ np.asarray(m.body_pos[b], float)
        quat = _quat_mul_np(quat, np.asarray(m.body_quat[b], float))
    return pos, quat


def _palm_up_placement(hand, palm_geom_name: str, palm_axis: np.ndarray,
                       distal_axis=None, tilt: float = 0.0):
    """(base_pos, base_quat) rotating the hand part so the palm-frame axis
    ``palm_axis`` points at world +z and the palm geom center lands at
    PALM_TARGET.

    ``tilt``: extra rotation (rad) tipping the palm plane DOWN toward the
    ``distal_axis`` (palm-frame finger direction) — the reference mounts
    the allegro hand at Rot(x, 0.47*pi), 5.4 degrees short of flat
    (allegro_hand.py:285), so gravity feeds the cube into the finger/thumb
    pocket instead of letting it drift to the unreachable palm heel.
    Round-3 gait probing showed exactly that failure on a flat palm:
    closing fingers punt the cube heel-ward, after which every finger phi
    is +5 cm and no action can influence the cube again."""
    from ..models.model import _quat_to_mat_np, _quat_mul_np
    g = next(g for g in hand.geoms if g.name == palm_geom_name)
    bp, bq = _part_body_pose0(hand, g.body)
    Rb = _quat_to_mat_np(bq)
    c_part = bp + Rb @ np.asarray(g.pos, float)
    v = Rb @ np.asarray(palm_axis, float)
    v = v / np.linalg.norm(v)
    axis = np.cross(v, [0.0, 0, 1.0])
    s = np.linalg.norm(axis)
    if s < 1e-8:
        q = (np.array([0.0, 0, 0, 1.0]) if v[2] > 0
             else np.array([1.0, 0, 0, 0.0]))
    else:
        ang = float(np.arctan2(s, v[2]))
        axis = axis / s
        q = np.concatenate([axis * np.sin(ang / 2), [np.cos(ang / 2)]])
    if tilt and distal_axis is not None:
        d_w = _quat_to_mat_np(q) @ (Rb @ np.asarray(distal_axis, float))
        d_w[2] = 0.0
        d_w /= max(np.linalg.norm(d_w), 1e-9)
        ax = np.cross([0.0, 0, 1.0], d_w)   # rotating +tilt tips d_w down
        qt = np.concatenate([ax * np.sin(tilt / 2), [np.cos(tilt / 2)]])
        q = _quat_mul_np(qt, q)
    base = PALM_TARGET - _quat_to_mat_np(q) @ c_part
    return base, q
CUBE_SIZE = 0.065  # block object half ~0.0325 (cube_multicolor urdf scale)

FINGERTIP_BODIES = ["robot0:ffdistal", "robot0:mfdistal", "robot0:rfdistal",
                    "robot0:lfdistal", "robot0:thdistal"]

OBS_DIMS = {"openai": 42, "full_no_vel": 77, "full": 157, "full_state": 211}


class HandTaskState(NamedTuple):
    goal_rot: jax.Array        # (N, 4)
    successes: jax.Array       # (N,)
    consecutive: jax.Array     # scalar running mean
    prev_targets: jax.Array    # (N, 24)
    rb_force: jax.Array        # (N, 3) persistent object-local random force


class ShadowHand(VecTaskBase):
    num_hand_dofs = 24
    num_hand_actuated = 20
    fingertip_names = FINGERTIP_BODIES
    obs_dims = OBS_DIMS
    obs_include_fingertips = True

    def __init__(self, cfg):
        e = cfg["env"]
        self.obs_type = e.get("observationType", "full_state")
        e["numObservations"] = self.obs_dims[self.obs_type]
        e["numActions"] = self.num_hand_actuated
        if e.get("asymmetric_observations"):
            # privileged critic state = the family's full_state layout
            # (211 for Shadow, 88 for Allegro)
            e["numStates"] = self.obs_dims["full_state"]
        # resetTime overrides episodeLength (ref shadow_hand.py:139-141):
        # the episode ends resetTime seconds after the last goal success —
        # the urgency that kills the hold-still local optimum
        reset_time = float(e.get("resetTime", -1.0) or -1.0)
        if reset_time > 0.0:
            cfi = int(e.get("controlFrequencyInv", 1))
            dt = float(cfg.get("sim", {}).get("dt", 1.0 / 60.0))
            e["episodeLength"] = int(round(reset_time / (cfi * dt)))
        self.max_consecutive_successes = int(
            e.get("maxConsecutiveSuccesses", 0))
        # random object force perturbations (ref :616-626): persistent
        # local-frame force with exponential decay, re-rolled per env with a
        # static log-uniform probability
        self.force_scale = float(e.get("forceScale", 0.0))
        self.force_decay = float(e.get("forceDecay", 0.99))
        self.force_decay_interval = float(e.get("forceDecayInterval", 0.08))
        fpr = e.get("forceProbRange", (0.001, 0.1))
        rs = np.random.RandomState(4273)
        n_env = int(e["numEnvs"])
        self.random_force_prob = jnp.asarray(np.exp(
            np.log(fpr[0]) + (np.log(fpr[1]) - np.log(fpr[0]))
            * rs.rand(n_env)), jnp.float32)
        # actionsMovingAverage: scalar, or the AllegroHandLSTM dict form
        # {range: [lo, hi], schedule_steps} — per-env static sample of the
        # range (the frame-scheduled range annealing is not modeled)
        ama = e.get("actionsMovingAverage", 1.0)
        if isinstance(ama, dict):
            lo, hi = ama.get("range", (1.0, 1.0))
            self.act_moving_average = jnp.asarray(
                lo + (hi - lo) * rs.rand(n_env, 1), jnp.float32)
        else:
            self.act_moving_average = float(ama)
        self.dist_reward_scale = float(e["distRewardScale"])
        self.rot_reward_scale = float(e["rotRewardScale"])
        self.rot_eps = float(e["rotEps"])
        self.action_penalty_scale = float(e["actionPenaltyScale"])
        self.success_tolerance = float(e["successTolerance"])
        self.reach_goal_bonus = float(e["reachGoalBonus"])
        self.fall_dist = float(e["fallDistance"])
        self.fall_penalty = float(e["fallPenalty"])
        self.reset_dof_pos_interval = float(e["resetDofPosRandomInterval"])
        self.reset_pos_noise = float(e["resetPositionNoise"])
        self.av_factor = float(e.get("averFactor", 0.1))
        self.use_relative_control = bool(e.get("useRelativeControl", False))
        self.dof_speed_scale = float(e.get("dofSpeedScale", 20.0))
        self.force_torque_obs_scale = 10.0
        self.vel_obs_scale = 0.2
        super().__init__(cfg)

        m = self.model
        names = m.body_names
        nh = self.num_hand_dofs
        self.fingertip_bodies = np.asarray(
            [names.index(n) for n in self.fingertip_names], np.int32)
        self.object_body = names.index("object")
        self.obj_qa = int(m.q_adr[self.object_body])
        self.obj_va = int(m.v_adr[self.object_body])
        self.obj_mass = float(np.asarray(m.mass)[self.object_body])
        sd = self.engine.scalar_dofs
        self.hand_dofs = np.asarray(sd[:nh])
        dl = np.asarray(m.dof_lower)[self.hand_dofs]
        du = np.asarray(m.dof_upper)[self.hand_dofs]
        self.dof_lower = jnp.asarray(dl, jnp.float32)
        self.dof_upper = jnp.asarray(du, jnp.float32)
        dof_names = [names[int(m.dof_body[d])] for d in self.hand_dofs]
        self.coupled_distal = np.asarray(
            [i for i, n in enumerate(dof_names)
             if n.split(":")[-1] in ("ffdistal", "mfdistal", "rfdistal", "lfdistal")],
            np.int32)
        self.actuated = np.asarray(
            [i for i in range(nh) if i not in self.coupled_distal], np.int32)

    # MJCF position-actuator gains/force limits per driven joint (OpenAI
    # shared.xml:250-269): wrist kp 5, fingers/thumb kp 1; forcerange is the
    # DRIVE force limit PhysX enforces (dof_props['effort']).  Keyed by the
    # dof's child-body name; tendon-coupled distals inherit their middle
    # joint's values.
    DRIVE_PARAMS = {
        "wrist": (5.0, 4.785), "palm": (5.0, 2.175),
        "ffknuckle": (1.0, 0.9), "ffproximal": (1.0, 0.9),
        "ffmiddle": (1.0, 0.7245), "ffdistal": (1.0, 0.7245),
        "mfknuckle": (1.0, 0.9), "mfproximal": (1.0, 0.9),
        "mfmiddle": (1.0, 0.7245), "mfdistal": (1.0, 0.7245),
        "rfknuckle": (1.0, 0.9), "rfproximal": (1.0, 0.9),
        "rfmiddle": (1.0, 0.7245), "rfdistal": (1.0, 0.7245),
        "lfmetacarpal": (1.0, 0.9), "lfknuckle": (1.0, 0.9),
        "lfproximal": (1.0, 0.9), "lfmiddle": (1.0, 0.7245),
        "lfdistal": (1.0, 0.7245),
        "thbase": (1.0, 2.3722), "thproximal": (1.0, 1.45),
        "thhub": (1.0, 0.99), "thmiddle": (1.0, 0.99),
        "thdistal": (1.0, 0.81),
    }

    def create_model(self):
        from ..models.specs.shadow_hand import SPEC
        import copy
        hand = model_from_spec(copy.deepcopy(SPEC))
        # position drives on all hand dofs (OpenAI position actuators)
        for d in range(hand.nv):
            bname = hand.body_names[int(hand.dof_body[d])].split(":")[-1]
            kp, eff = self.DRIVE_PARAMS.get(bname, (1.0, 0.9))
            hand.dof_drive_mode[d] = DRIVE_POS
            hand.dof_stiffness[d] = kp
            hand.dof_drive_damping[d] = 0.1
            hand.dof_effort_limit[d] = eff
        # palm-frame axes after self-alignment: -y (palmar normal) -> world
        # up; the palm-frame +z finger direction maps through R.  The cube
        # spawns over the palm/knuckle junction — the reference spawns it
        # 0.39 m along the forearm from the hand root (shadow_hand.py:313,
        # dy=-0.39), i.e. over the FINGERS, not the palm center: a cube the
        # fingers rest against is a cube every exploratory twitch perturbs.
        # Round 2/3a centered it on the palm, where the learned optimum was
        # "never touch it" and the cube's pose stayed frozen all episode.
        base, quat = _palm_up_placement(hand, "robot0:C_palm0",
                                        np.array([0.0, -1.0, 0.0]),
                                        distal_axis=np.array([0.0, 0, 1.0]),
                                        tilt=0.095)
        from ..models.model import _quat_to_mat_np
        Rq = _quat_to_mat_np(np.asarray(quat, float))
        self.obj_start = (PALM_TARGET + Rq @ np.array([0.0, 0.0, 0.055])
                          + np.array([0.0, 0.0, 0.05]))
        # reward goal position = spawn dropped 4 cm (ref :402-403)
        self.goal_pos = self.obj_start + np.array([0.0, 0.0, -0.04])
        ob = ModelBuilder()
        ob.begin_actor()
        obj = ob.add_body("object", -1, FREE, body_pos=self.obj_start)
        ob.add_geom(obj, GEOM_BOX, np.full(3, CUBE_SIZE / 2), density=400.0,
                    name="object_geom")
        # (-y alignment: the palm box's thin axis is y and finger flexion —
        # positive rotation about the +x hinges — curls fingertips toward
        # -y, so -y is the palmar surface normal.  Round 2 aligned +z, the
        # finger axis: fingers pointed at the sky and the cube balanced on
        # the fingertips.)
        model = compose_scene([
            (hand, base, tuple(quat)),
            (ob.finalize(), (0, 0, 0), (0, 0, 0, 1))])
        # fingertip sensors on the composed model
        ft = [model.body_names.index(n) for n in FINGERTIP_BODIES]
        model.sensor_body = np.asarray(ft, np.int32)
        model.sensor_pos = np.zeros((len(ft), 3))
        return model, True

    def build_engine(self, model, ground):
        # contact pairs: fingertip & palm points vs the cube SDF + cube
        # corners vs the palm box
        names = [g.name for g in model.geoms]
        obj_geom = names.index("object_geom")
        pair_names = ["robot0:C_palm0", "robot0:C_palm1", "robot0:C_ffdistal",
                      "robot0:C_mfdistal", "robot0:C_rfdistal",
                      "robot0:C_lfdistal", "robot0:C_thdistal",
                      "robot0:C_ffmiddle", "robot0:C_mfmiddle",
                      "robot0:C_rfmiddle", "robot0:C_lfmiddle",
                      "robot0:C_thmiddle"]
        pairs = []
        for pn in pair_names:
            if pn in names:
                pairs.append((names.index(pn), obj_geom))
        # cube corners vs palm boxes
        for pn in ("robot0:C_palm0", "robot0:C_palm1"):
            if pn in names:
                pairs.append((obj_geom, names.index(pn)))
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs)

    # ------------------------------------------------------------------
    def initial_task_state(self):
        n = self.num_envs
        return HandTaskState(
            goal_rot=jnp.tile(jnp.array([0.0, 0, 0, 1.0]), (n, 1)),
            successes=jnp.zeros(n, jnp.float32),
            consecutive=jnp.asarray(0.0, jnp.float32),
            prev_targets=jnp.zeros((n, self.num_hand_dofs), jnp.float32),
            rb_force=jnp.zeros((n, 3), jnp.float32))

    def _random_quat(self, key, n):
        """Block goal randomization: rand about z then y (ref randomize_rotation)."""
        k1, k2 = jax.random.split(key)
        rz = maths.quat_from_angle_axis(
            jax.random.uniform(k1, (n,), minval=-np.pi, maxval=np.pi),
            jnp.array([0.0, 0, 1.0]))
        ry = maths.quat_from_angle_axis(
            jax.random.uniform(k2, (n,), minval=-np.pi, maxval=np.pi),
            jnp.array([0.0, 1.0, 0.0]))
        return maths.quat_mul(rz, ry)

    def pre_physics(self, state: EnvState, actions: jax.Array) -> Control:
        n = self.num_envs
        task: HandTaskState = state.task
        cur = task.prev_targets
        act_lo = self.dof_lower[self.actuated]
        act_hi = self.dof_upper[self.actuated]
        if self.use_relative_control:
            t_act = cur[:, self.actuated] + self.dof_speed_scale * self.dt * actions
        else:
            t_act = maths.scale(actions, act_lo, act_hi)
            ama = self.act_moving_average
            if not (isinstance(ama, float) and ama == 1.0):
                # target low-pass (ref :609-611): cur = a*new + (1-a)*prev
                t_act = ama * t_act + (1.0 - ama) * cur[:, self.actuated]
        t_act = jnp.clip(t_act, act_lo, act_hi)
        targets = cur.at[:, self.actuated].set(t_act)
        # tendon-coupled distal joints follow their middle joints
        dof_pos = self.engine.dof_pos(state.sim)[:, : self.num_hand_dofs]
        if len(self.coupled_distal):
            targets = targets.at[:, self.coupled_distal].set(
                dof_pos[:, self.coupled_distal - 1])
        self._new_targets = targets
        f_ext = None
        if self.force_scale > 0.0:
            # persistent random object forces (ref :616-626): decay, re-roll
            # per env with its static probability, apply in LOCAL space
            k_fire, k_mag = jax.random.split(jax.random.fold_in(state.rng, 77))
            decay = self.force_decay ** (self.dt / self.force_decay_interval)
            rb = task.rb_force * decay
            fire = jax.random.uniform(k_fire, (n,)) < self.random_force_prob
            new = jax.random.normal(k_mag, (n, 3)) * self.obj_mass \
                * self.force_scale
            rb = jnp.where(fire[:, None], new, rb)
            self._rb_force = rb
            obj_quat = state.sim.q[:, self.obj_qa + 3: self.obj_qa + 7]
            f_world = maths.quat_apply(obj_quat, rb)
            f_ext = jnp.zeros((n, self.engine.nb, 6), jnp.float32)
            f_ext = f_ext.at[:, self.object_body, 3:6].set(f_world)
        else:
            self._rb_force = task.rb_force
        pos_target = jnp.zeros((n, self.engine.nv), jnp.float32)
        pos_target = pos_target.at[:, self.hand_dofs].set(targets)
        return Control(tau=jnp.zeros((n, self.engine.nv), jnp.float32),
                       pos_target=pos_target,
                       vel_target=jnp.zeros((n, self.engine.nv), jnp.float32),
                       f_ext=f_ext)

    def reset_idx(self, sim: SimState, task: HandTaskState, mask, key):
        n = self.num_envs
        ks = jax.random.split(key, 5)
        # object pose: start + noise, random orientation
        pos = jnp.asarray(self.obj_start, jnp.float32) + self.reset_pos_noise \
            * jax.random.normal(ks[0], (n, 3))
        quat = self._random_quat(ks[1], n)
        oq = jnp.concatenate([pos, quat], -1)
        qa, va = self.obj_qa, self.obj_va
        q = sim.q.at[:, qa: qa + 7].set(
            masked_update(mask, oq, sim.q[:, qa: qa + 7]))
        qd = sim.qd.at[:, va: va + 6].set(
            masked_update(mask, jnp.zeros((n, 6)), sim.qd[:, va: va + 6]))
        # hand dofs: default + U(-interval/2, interval/2)
        nh = self.num_hand_dofs
        noise = self.reset_dof_pos_interval * (
            jax.random.uniform(ks[2], (n, nh)) - 0.5)
        dof = jnp.clip(noise, self.dof_lower, self.dof_upper)
        full_pos = self.engine.dof_pos(SimState(q, qd))
        full_pos = full_pos.at[:, :nh].set(
            masked_update(mask, dof, full_pos[:, :nh]))
        sim = self.engine.set_dof_pos(SimState(q, qd), full_pos)
        dv = self.engine.dof_vel(sim)
        sim = self.engine.set_dof_vel(
            sim, dv.at[:, :nh].set(masked_update(mask, jnp.zeros((n, nh)),
                                                 dv[:, :nh])))
        goal = self._random_quat(ks[3], n)
        task = HandTaskState(
            goal_rot=masked_update(mask, goal, task.goal_rot),
            successes=jnp.where(mask, 0.0, task.successes),
            consecutive=task.consecutive,
            prev_targets=masked_update(mask, dof, task.prev_targets),
            rb_force=masked_update(mask, jnp.zeros((n, 3)), task.rb_force))
        return sim, task

    def post_physics(self, state: EnvState, out, actions):
        n = self.num_envs
        task: HandTaskState = state.task
        obj = out.root_states[:, 1]
        obj_pos, obj_rot = obj[:, 0:3], obj[:, 3:7]
        obj_linvel, obj_angvel = obj[:, 7:10], obj[:, 10:13]
        goal_pos = jnp.asarray(self.goal_pos, jnp.float32)
        goal_rot = task.goal_rot

        quat_diff = maths.quat_mul(obj_rot, maths.quat_conjugate(goal_rot))
        rot_dist = 2.0 * jnp.arcsin(jnp.clip(
            jnp.linalg.norm(quat_diff[:, 0:3], axis=-1), 0.0, 1.0))
        goal_dist = jnp.linalg.norm(obj_pos - goal_pos, axis=-1)

        nh = self.num_hand_dofs
        dof_pos = self.engine.dof_pos(state.sim)[:, :nh]
        dof_vel = self.engine.dof_vel(state.sim)[:, :nh]
        ft_pos = out.body_pos[:, self.fingertip_bodies]
        ft_rot = out.body_quat[:, self.fingertip_bodies]
        ft_vel = out.body_vel[:, self.fingertip_bodies]
        ft_state = jnp.concatenate([ft_pos, ft_rot, ft_vel], -1)  # (N,5,13)

        def assemble(obs_type, dim):
            if obs_type == "openai":
                # ref compute_fingertip_observations(no_vel=True): fingertip
                # positions, object position, relative goal quat, actions
                x = jnp.concatenate([ft_pos.reshape(n, -1), obj_pos,
                                     quat_diff, actions], -1)
                if x.shape[-1] < dim:
                    x = jnp.pad(x, ((0, 0), (0, dim - x.shape[-1])))
                return x[:, :dim]
            pieces = [maths.unscale(dof_pos, self.dof_lower, self.dof_upper)]
            if obs_type != "full_no_vel":
                pieces.append(self.vel_obs_scale * dof_vel)
            if obs_type == "full_state":
                pieces.append(self.force_torque_obs_scale
                              * out.dof_force[:, self.hand_dofs])
            pieces += [obj_pos, obj_rot]
            if obs_type != "full_no_vel":
                pieces += [obj_linvel, self.vel_obs_scale * obj_angvel]
            pieces += [jnp.broadcast_to(goal_pos, (n, 3)), goal_rot, quat_diff]
            # ShadowHand layouts carry fingertip states (+wrenches in
            # full_state) before the actions (ref shadow_hand.py
            # compute_full_state); AllegroHand's do NOT — its full_state 88
            # is exactly dofs+forces+object+goal+quat_diff+actions (ref
            # allegro_hand.py compute_full_state).  Including them here
            # pushed the action block past the trim, hiding the policy's
            # own previous actions from it.
            if self.obs_include_fingertips:
                pieces.append(ft_state.reshape(n, -1))
                if obs_type == "full_state":
                    pieces.append(self.force_torque_obs_scale
                                  * out.sensor_forces.reshape(n, -1))
            pieces.append(actions)
            x = jnp.concatenate(pieces, -1)
            # pad/trim to the declared dim (obs-type layouts differ slightly)
            if x.shape[-1] < dim:
                x = jnp.pad(x, ((0, 0), (0, dim - x.shape[-1])))
            elif x.shape[-1] > dim:
                x = x[:, :dim]
            return x

        obs = assemble(self.obs_type, self.num_obs)

        # reward kernel (ref :747+), terms kept named for the episode extras
        action_penalty = jnp.sum(jnp.square(actions), -1)
        dist_rew = goal_dist * self.dist_reward_scale
        rot_rew = (1.0 / (jnp.abs(rot_dist) + self.rot_eps)
                   * self.rot_reward_scale)
        reward = dist_rew + rot_rew + self.action_penalty_scale * action_penalty
        success = jnp.abs(rot_dist) <= self.success_tolerance
        reward = jnp.where(success, reward + self.reach_goal_bonus, reward)
        fallen = goal_dist >= self.fall_dist
        reward = jnp.where(fallen, reward + self.fall_penalty, reward)

        # in-step goal resample on success (ref: goal_resets)
        key_g = jax.random.fold_in(state.rng, 41)
        new_goal = self._random_quat(key_g, n)
        goal_rot = jnp.where(success[:, None], new_goal, goal_rot)
        successes = task.successes + success.astype(jnp.float32)

        timeout = state.progress >= self.max_episode_length - 1
        if self.max_consecutive_successes > 0:
            # ref kernel :639-647: each success restarts the episode clock
            # (resetTime semantics — the env only times out if no goal was
            # reached for a full window), envs reset after max successes,
            # and timing out costs half the fall penalty
            timeout = timeout & ~success
            reset = (fallen | timeout
                     | (successes >= self.max_consecutive_successes)
                     ).astype(jnp.int32)
            reward = jnp.where(timeout, reward + 0.5 * self.fall_penalty,
                               reward)
        else:
            reset = (fallen | timeout).astype(jnp.int32)
        done_count = jnp.sum(reset)
        cons = jnp.where(
            done_count > 0,
            (1 - self.av_factor) * task.consecutive + self.av_factor
            * jnp.sum(jnp.where(reset > 0, successes, 0.0))
            / jnp.maximum(done_count, 1),
            task.consecutive)

        # asymmetric actor-critic: privileged state is always the full_state
        # layout (211) regardless of the policy obs type (ref shadow_hand.py
        # :125-132 — numStates=211 when asymmetric_observations)
        states = (assemble("full_state", self.num_states)
                  if self.num_states > 0 else None)
        task = HandTaskState(goal_rot=goal_rot, successes=successes,
                             consecutive=cons, prev_targets=self._new_targets,
                             rb_force=getattr(self, "_rb_force",
                                              task.rb_force))
        extras = {
            "consecutive_successes": cons, "true_objective": cons,
            # per-term diagnostics (ref extras['episode'] channel,
            # anymal_terrain.py:420-425 pattern) — rot_dist/goal_dist means
            # make the "why no successes" question answerable from the log
            "episode": {
                "rot_dist": rot_dist, "goal_dist": goal_dist,
                "dist_rew": dist_rew, "rot_rew": rot_rew,
                "success_rate_step": success.astype(jnp.float32),
                "fall_rate_step": fallen.astype(jnp.float32),
            },
        }
        if self.max_consecutive_successes > 0:
            # restart the episode clock on success (resetTime semantics);
            # consumed by VecTaskBase.step after the timeout computation
            extras["_reset_progress_mask"] = success
        return obs, states, reward, reset, task, extras
