"""AllegroHandDextreme{ManualDR,ADR} (reference
tasks/dextreme/allegro_hand_dextreme.py, 1688 LoC).

Dextreme = Allegro in-hand cube reorientation hardened for sim-to-real:

* **dict observations** (``dict_obs_cls = True`` — ref :57): the policy sees
  named groups (dof_pos, object_pose, goal_pose, relative rotation, last
  actions); the asymmetric critic additionally sees velocities, dof forces and
  fingertip wrenches.  Here the flat obs vector is the concatenation of
  ``obs_spec`` groups and :meth:`split_obs` recovers the dict view (the
  ComplexObsRLGPUEnv contract, rlgames_utils.py:300-424).
* **cube-pose camera-noise model** (ref pose-estimation corruption): the
  observed object pose gets gaussian position/rotation noise plus occasional
  large "unreliable tracking" jumps.
* **RandomNetworkAdversary** action perturbation (utils/rna_util.py:37):
  actions are blended with a fixed random network's output; dropout masks
  refresh every ``rnaRefreshInterval`` steps.
* **ADR** (ADR variant — tasks/dextreme/adr_vec_task.py): the DR parameter
  ranges themselves adapt via boundary-worker performance, driving both the
  engine's per-env PhysScales and the noise magnitudes.  The ADR ranges are
  part of the checkpointable env state (``get_env_state``).

Batched redesign: ADR state and per-env sampled parameter rows live in the task
pytree; everything (sampling, boundary bookkeeping, range updates, noise)
happens inside the jitted step — no host-side queues.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import maths
from ..physics.engine import Control, SimState
from ..utils.adr import ADR, ADRConfig, ADRState
from ..utils.config import deep_merge
from ..utils.domain_rand import PhysScales
from ..utils.rna_util import RandomNetworkAdversary, RNAState
from .allegro_hand import AllegroHand, TASK_CFG as ALLEGRO_CFG
from .base import EnvState, masked_update
from .shadow_hand import HandTaskState

MAX_ACTION_LATENCY = 8   # action-history depth (policy steps)

# ADR parameter tree — the full 27-parameter reference tree with the
# reference's own init ranges / limits / deltas
# (cfg/task/AllegroHandDextremeADR.yaml:250-422).  Each name is wired to a
# batched effect: per-dof drive/property scales and limit shifts, per-body
# mass/friction/restitution, affine obs/action corruption (a*x + b + c),
# action latency, cube-pose camera refresh, RNA.  Tasks can override the
# whole tree via the task config's ``adr`` section.
DEFAULT_ADR_PARAMS = {
    # hand dof properties (scales on the allegro drive/dof values; lower/
    # upper are ADDITIVE limit shifts in radians)
    "hand_damping": {"init_range": [0.5, 2.0], "limits": [0.01, 20.0],
                     "delta": 0.01},
    "hand_stiffness": {"init_range": [0.8, 1.2], "limits": [0.01, 20.0],
                       "delta": 0.01},
    "hand_joint_friction": {"init_range": [0.8, 1.2], "limits": [0.0, 10.0],
                            "delta": 0.01},
    "hand_armature": {"init_range": [0.8, 1.2], "limits": [0.0, 10.0],
                      "delta": 0.01},
    "hand_effort": {"init_range": [0.9, 1.1], "limits": [0.4, 10.0],
                    "delta": 0.01},
    "hand_lower": {"init_range": [0.0, 0.0], "limits": [-5.0, 5.0],
                   "delta": 0.02},
    "hand_upper": {"init_range": [0.0, 0.0], "limits": [-5.0, 5.0],
                   "delta": 0.02},
    "hand_mass": {"init_range": [0.8, 1.2], "limits": [0.01, 10.0],
                  "delta": 0.01},
    "hand_friction_fingertips": {"init_range": [0.9, 1.1],
                                 "limits": [0.1, 2.0], "delta": 0.01},
    "hand_restitution": {"init_range": [0.0, 0.1], "limits": [0.0, 1.0],
                         "delta": 0.01},
    # object physical properties
    "object_mass": {"init_range": [0.8, 1.2], "limits": [0.01, 10.0],
                    "delta": 0.01},
    "object_friction": {"init_range": [0.4, 0.8], "limits": [0.01, 2.0],
                        "delta": 0.01},
    "object_restitution": {"init_range": [0.0, 0.1], "limits": [0.0, 1.0],
                           "delta": 0.01},
    # cube-pose camera model: inverse refresh rate + extra-delay chance
    "cube_obs_delay_prob": {"init_range": [0.0, 0.05], "limits": [0.0, 0.7],
                            "delta": 0.01},
    "cube_pose_refresh_rate": {"init_range": [1.0, 1.0], "limits": [1.0, 6.0],
                               "delta": 0.2},
    # action latency (policy steps held in the action-history ring; the
    # reference allows up to 60 — the ring is statically sized, so the
    # effective ceiling is the ring depth)
    "action_delay_prob": {"init_range": [0.0, 0.05], "limits": [0.0, 0.7],
                          "delta": 0.01},
    "action_latency": {"init_range": [0.0, 0.0],
                       "limits": [0.0, float(MAX_ACTION_LATENCY - 2)],
                       "delta": 0.1},
    # affine corruption a*x + b + c (OAI-style): _scaling is the std of the
    # per-episode multiplicative coefficient (a ~ N(1, std)), _additive the
    # per-episode bias std, _white the per-step noise std
    "affine_action_scaling": {"init_range": [0.0, 0.0], "limits": [0.0, 4.0],
                              "delta": 0.0},
    "affine_action_additive": {"init_range": [0.0, 0.04],
                               "limits": [0.0, 4.0], "delta": 0.01},
    "affine_action_white": {"init_range": [0.0, 0.04], "limits": [0.0, 4.0],
                            "delta": 0.01},
    "affine_cube_pose_scaling": {"init_range": [0.0, 0.0],
                                 "limits": [0.0, 4.0], "delta": 0.0},
    "affine_cube_pose_additive": {"init_range": [0.0, 0.04],
                                  "limits": [0.0, 4.0], "delta": 0.01},
    "affine_cube_pose_white": {"init_range": [0.0, 0.04],
                               "limits": [0.0, 4.0], "delta": 0.01},
    "affine_dof_pos_scaling": {"init_range": [0.0, 0.0],
                               "limits": [0.0, 4.0], "delta": 0.0},
    "affine_dof_pos_additive": {"init_range": [0.0, 0.04],
                                "limits": [0.0, 4.0], "delta": 0.01},
    "affine_dof_pos_white": {"init_range": [0.0, 0.04],
                             "limits": [0.0, 4.0], "delta": 0.01},
    # RandomNetworkAdversary blend weight
    "rna_alpha": {"init_range": [0.0, 0.0], "limits": [0.0, 1.0],
                  "delta": 0.01},
}

TASK_CFG = deep_merge(ALLEGRO_CFG, {
    "name": "AllegroHandDextremeManualDR",
    "env": {
        "numEnvs": 8192,
        "observationType": "full_state",
        "asymmetric_observations": True,
        # camera-noise model (ref cube pose corruption)
        "cubePosNoise": 0.01,
        "cubeRotNoise": 0.05,
        "unreliableProb": 0.05,
        "unreliablePosJump": 0.1,
        "unreliableRotJump": 0.5,
        # RNA (ref rna perturbation config)
        "rnaEnabled": True,
        "rnaAlpha": 0.2,
        "rnaProb": 0.2,
        "rnaRefreshInterval": 600,
        "actionNoise": 0.02,
        # hand-family training mechanics (the recipe that cracked
        # ShadowHandOpenAI_FF in round 4) — the reference Dextreme yaml has
        # them too (AllegroHandDextremeADR.yaml:11 resetTime 8, :60-64
        # object force perturbations, :93 maxConsecutiveSuccesses 50,
        # :31-34 action smoothing): without urgency + perturbations the
        # boundary workers never reach the 5/20 ADR success band
        "resetTime": 8,
        "forceScale": 2.0,
        "forceProbRange": [0.001, 0.1],
        "forceDecay": 0.99,
        "forceDecayInterval": 0.08,
        "maxConsecutiveSuccesses": 50,
        "actionsMovingAverage": {"range": [0.15, 0.2],
                                 "schedule_steps": 1000_000,
                                 "schedule_freq": 500},
    },
    # reference adr section values (AllegroHandDextremeADR.yaml:227-247)
    "adr": {
        "use_adr": True,
        "worker_adr_boundary_fraction": 0.4,
        "adr_queue_threshold_length": 256,
        "adr_objective_threshold_low": 5.0,
        "adr_objective_threshold_high": 20.0,
        "params": DEFAULT_ADR_PARAMS,
    },
})


class DextremeTaskState(NamedTuple):
    hand: HandTaskState
    rna: RNAState
    step_count: jax.Array               # scalar int32 (RNA refresh clock)
    # affine corruption state (per-episode biases + action-latency ring +
    # camera-refresh hold) — reference adr_vec_task affine transforms /
    # cube_pose_refresh_rate / action_latency params
    act_hist: jax.Array                 # (N, L, A) newest-first action ring
    act_bias: jax.Array                 # (N, A) per-episode action bias
    cube_pos_bias: jax.Array            # (N, 3) per-episode cube-pos bias
    dof_bias: jax.Array                 # (N, nh) per-episode dof-obs bias
    # per-episode multiplicative corruption a ~ N(1, affine_*_scaling std)
    act_scale: jax.Array                # (N, A)
    cube_pos_scale: jax.Array           # (N, 3)
    dof_scale: jax.Array                # (N, nh)
    held_pos: jax.Array                 # (N, 3) last refreshed cube pos obs
    held_rot: jax.Array                 # (N, 4)
    pose_counter: jax.Array             # (N,) steps until next pose refresh
    adr: Optional[ADRState] = None      # ADR variant only
    adr_params: Optional[jax.Array] = None  # (N, P) per-env sampled values


class AllegroHandDextremeManualDR(AllegroHand):
    """Fixed-magnitude DR variant (ref AllegroHandDextremeManualDR)."""

    dict_obs_cls = True
    use_adr = False

    def __init__(self, cfg):
        e = cfg["env"]
        # policy obs groups (ref obs_spec names); critic gets the rest
        self.obs_spec = [
            ("dof_pos", 16),
            ("object_pose", 7),
            ("goal_pose", 7),
            ("goal_relative_rot", 4),
            ("last_actions", 16),
        ]
        self.state_spec = self.obs_spec + [
            ("dof_vel", 16),
            ("dof_force", 16),
            ("object_vels", 6),
            ("ft_force_torques", 24),
        ]
        e["numObservations"] = sum(s for _, s in self.obs_spec)
        e["numStates"] = sum(s for _, s in self.state_spec)
        e["asymmetric_observations"] = True
        self.cube_pos_noise = float(e.get("cubePosNoise", 0.01))
        self.cube_rot_noise = float(e.get("cubeRotNoise", 0.05))
        self.unreliable_prob = float(e.get("unreliableProb", 0.05))
        self.unreliable_pos_jump = float(e.get("unreliablePosJump", 0.1))
        self.unreliable_rot_jump = float(e.get("unreliableRotJump", 0.5))
        self.rna_enabled = bool(e.get("rnaEnabled", True))
        self.rna_alpha = float(e.get("rnaAlpha", 0.2))
        self.rna_prob = float(e.get("rnaProb", 0.2))
        self.rna_refresh = int(e.get("rnaRefreshInterval", 600))
        self.action_noise = float(e.get("actionNoise", 0.02))
        super().__init__(cfg)
        # ShadowHand.__init__ overwrote numObservations via obs_dims; restore
        self.num_obs = sum(s for _, s in self.obs_spec)
        self.num_states = sum(s for _, s in self.state_spec)
        self.rna = RandomNetworkAdversary(
            num_obs=self.num_hand_dofs, num_actions=self.num_actions,
            units=(256, 256))

    # -- dict-obs surface ----------------------------------------------
    def split_obs(self, flat: jax.Array, spec=None) -> dict:
        spec = spec or self.obs_spec
        out, i = {}, 0
        for name, size in spec:
            out[name] = flat[..., i: i + size]
            i += size
        return out

    def split_states(self, flat: jax.Array) -> dict:
        return self.split_obs(flat, self.state_spec)

    # -- per-env DR magnitudes (ManualDR: fixed; ADR: from adr_params) --
    def _adr_value(self, task: DextremeTaskState, name: str) -> jax.Array:
        """Per-env (N,) value of an ADR-tree parameter.  ManualDR pins the
        legacy fixed magnitudes; the ADR subclass samples from its adaptive
        ranges (reference adr_vec_task.py:489-920)."""
        n = self.num_envs
        fixed = {
            "affine_action_white": self.action_noise,
            "affine_cube_pose_white": self.cube_pos_noise,
            "affine_cube_rot_white": self.cube_rot_noise,
            "rna_alpha": self.rna_alpha,
            "cube_pose_refresh_rate": 1.0,
        }
        return jnp.full((n,), fixed.get(name, 0.0), jnp.float32)

    def _noise_mags(self, task: DextremeTaskState):
        return {"action_noise": self._adr_value(task, "affine_action_white"),
                "cube_pos_noise": self._adr_value(task,
                                                  "affine_cube_pose_white"),
                "cube_rot_noise": self._adr_value(task,
                                                  "affine_cube_rot_white"),
                "rna_alpha": self._adr_value(task, "rna_alpha")}

    # -- lifecycle ------------------------------------------------------
    def initial_task_state(self):
        hand = super().initial_task_state()
        rna = self.rna.init(jax.random.PRNGKey(97))
        n = self.num_envs
        nh = self.num_hand_dofs
        return DextremeTaskState(
            hand=hand, rna=rna, step_count=jnp.asarray(0, jnp.int32),
            act_hist=jnp.zeros((n, MAX_ACTION_LATENCY, self.num_actions),
                               jnp.float32),
            act_bias=jnp.zeros((n, self.num_actions), jnp.float32),
            cube_pos_bias=jnp.zeros((n, 3), jnp.float32),
            dof_bias=jnp.zeros((n, nh), jnp.float32),
            act_scale=jnp.ones((n, self.num_actions), jnp.float32),
            cube_pos_scale=jnp.ones((n, 3), jnp.float32),
            dof_scale=jnp.ones((n, nh), jnp.float32),
            held_pos=jnp.zeros((n, 3), jnp.float32),
            held_rot=jnp.tile(jnp.asarray([0.0, 0, 0, 1.0]), (n, 1)),
            pose_counter=jnp.zeros((n,), jnp.float32))

    def _hand(self, task):
        return task.hand

    def pre_physics(self, state: EnvState, actions: jax.Array) -> Control:
        task: DextremeTaskState = state.task
        n = self.num_envs
        key = jax.random.fold_in(state.rng, 7)
        k_n, k_p, k_r, k_d = jax.random.split(key, 4)
        mags = self._noise_mags(task)
        # ---- action latency (ref action_latency/action_delay_prob): the
        # executed action comes from a newest-first history ring, per-env
        # delayed by floor(latency) plus a stochastic extra step
        act_hist = jnp.concatenate(
            [actions[:, None, :], task.act_hist[:, :-1]], axis=1)
        lat = jnp.floor(self._adr_value(task, "action_latency"))
        extra = (jax.random.uniform(k_d, (n,))
                 < self._adr_value(task, "action_delay_prob"))
        lat = jnp.clip(lat + extra.astype(jnp.float32), 0,
                       MAX_ACTION_LATENCY - 1)
        sel = jax.nn.one_hot(lat.astype(jnp.int32), MAX_ACTION_LATENCY,
                             dtype=actions.dtype)
        actions = jnp.einsum("nl,nla->na", sel, act_hist)
        # ---- affine corruption a*x + b + c: per-episode scale + bias,
        # per-step white noise
        actions = task.act_scale * actions + task.act_bias \
            + mags["action_noise"][:, None] * \
            jax.random.normal(k_n, actions.shape)
        if self.rna_enabled:
            dof_pos = self.engine.dof_pos(state.sim)[:, : self.num_hand_dofs]
            adv = self.rna(task.rna, dof_pos)
            use = (jax.random.uniform(k_p, (self.num_envs,)) < self.rna_prob)
            alpha = jnp.where(use, mags["rna_alpha"], 0.0)[:, None]
            actions = (1.0 - alpha) * actions + alpha * adv
        actions = jnp.clip(actions, -1.0, 1.0)
        # masks refresh on the DR clock (ref refresh cadence)
        refresh = (task.step_count % self.rna_refresh) == 0
        fresh = self.rna.refresh(task.rna)
        rna = RNAState(
            params=task.rna.params,
            masks=tuple(jnp.where(refresh, f, o)
                        for f, o in zip(fresh.masks, task.rna.masks)),
            key=jnp.where(refresh, fresh.key, task.rna.key))
        self._task_updates = dict(rna=rna, step_count=task.step_count + 1,
                                  act_hist=act_hist)
        # delegate position-target drive to the hand task
        hand_state = state._replace(task=task.hand)
        return super().pre_physics(hand_state, actions)

    def reset_idx(self, sim: SimState, task: DextremeTaskState, mask, key):
        sim, hand = super().reset_idx(sim, task.hand, mask, key)
        task = task._replace(hand=hand)
        # per-episode affine biases, sampled with the (possibly adaptive)
        # _additive stds; action ring and camera hold restart
        n = self.num_envs
        ks = jax.random.split(jax.random.fold_in(key, 23), 6)
        act_bias = self._adr_value(task, "affine_action_additive")[:, None] \
            * jax.random.normal(ks[0], (n, self.num_actions))
        pos_bias = self._adr_value(task, "affine_cube_pose_additive")[:, None] \
            * jax.random.normal(ks[1], (n, 3))
        dof_bias = self._adr_value(task, "affine_dof_pos_additive")[:, None] \
            * jax.random.normal(ks[2], (n, self.num_hand_dofs))
        # per-episode multiplicative coefficients (affine a*x + b + c)
        act_scale = 1.0 + self._adr_value(task, "affine_action_scaling")[:, None] \
            * jax.random.normal(ks[3], (n, self.num_actions))
        pos_scale = 1.0 + self._adr_value(task, "affine_cube_pose_scaling")[:, None] \
            * jax.random.normal(ks[4], (n, 3))
        dof_scale = 1.0 + self._adr_value(task, "affine_dof_pos_scaling")[:, None] \
            * jax.random.normal(ks[5], (n, self.num_hand_dofs))
        task = task._replace(
            act_hist=jnp.where(mask[:, None, None], 0.0, task.act_hist),
            act_bias=masked_update(mask, act_bias, task.act_bias),
            cube_pos_bias=masked_update(mask, pos_bias, task.cube_pos_bias),
            dof_bias=masked_update(mask, dof_bias, task.dof_bias),
            act_scale=masked_update(mask, act_scale, task.act_scale),
            cube_pos_scale=masked_update(mask, pos_scale, task.cube_pos_scale),
            dof_scale=masked_update(mask, dof_scale, task.dof_scale),
            pose_counter=jnp.where(mask, 0.0, task.pose_counter))
        return sim, task

    def post_physics(self, state: EnvState, out, actions):
        task: DextremeTaskState = state.task
        n = self.num_envs
        hand_state = state._replace(task=task.hand)
        _, _, rew, reset, hand, extras = super().post_physics(
            hand_state, out, actions)

        # ---- dict observations with the camera-noise model ----
        key = jax.random.fold_in(state.rng, 13)
        ks = jax.random.split(key, 5)
        mags = self._noise_mags(task)
        obj = out.root_states[:, 1]
        obj_pos, obj_rot = obj[:, 0:3], obj[:, 3:7]
        unreliable = (jax.random.uniform(ks[0], (n,)) < self.unreliable_prob)
        pos_std = jnp.where(unreliable, self.unreliable_pos_jump,
                            mags["cube_pos_noise"])
        rot_std = jnp.where(unreliable, self.unreliable_rot_jump,
                            mags["cube_rot_noise"])
        noisy_pos = task.cube_pos_scale * obj_pos + task.cube_pos_bias \
            + pos_std[:, None] * jax.random.normal(ks[1], (n, 3))
        axis = jax.random.normal(ks[2], (n, 3))
        axis = axis / jnp.maximum(jnp.linalg.norm(axis, axis=-1, keepdims=True),
                                  1e-8)
        ang = rot_std * jax.random.normal(ks[3], (n,))
        noisy_rot = maths.quat_mul(maths.quat_from_angle_axis(ang, axis),
                                   obj_rot)

        # camera refresh model (ref cube_pose_refresh_rate /
        # cube_obs_delay_prob): the observed pose only updates every
        # refresh-rate steps, with a stochastic extra hold
        counter = task.pose_counter - 1.0
        refresh_now = counter <= 0.0
        extra_hold = (jax.random.uniform(ks[4], (n,))
                      < self._adr_value(task, "cube_obs_delay_prob"))
        next_counter = jnp.where(
            refresh_now,
            jnp.round(self._adr_value(task, "cube_pose_refresh_rate"))
            + extra_hold.astype(jnp.float32),
            counter)
        held_pos = jnp.where(refresh_now[:, None], noisy_pos, task.held_pos)
        held_rot = jnp.where(refresh_now[:, None], noisy_rot, task.held_rot)
        self._task_updates.update(held_pos=held_pos, held_rot=held_rot,
                                  pose_counter=next_counter)

        nh = self.num_hand_dofs
        dof_pos = self.engine.dof_pos(state.sim)[:, :nh]
        dof_vel = self.engine.dof_vel(state.sim)[:, :nh]
        goal_pos = jnp.broadcast_to(
            jnp.asarray(self.goal_pos, jnp.float32), (n, 3))
        rel = maths.quat_mul(held_rot, maths.quat_conjugate(hand.goal_rot))
        k_dof = jax.random.fold_in(state.rng, 17)
        dof_obs = task.dof_scale \
            * maths.unscale(dof_pos, self.dof_lower, self.dof_upper) \
            + task.dof_bias \
            + self._adr_value(task, "affine_dof_pos_white")[:, None] \
            * jax.random.normal(k_dof, (n, nh))
        obs = jnp.concatenate([
            dof_obs,
            held_pos, held_rot,
            goal_pos, hand.goal_rot,
            rel,
            actions,
        ], -1)
        # critic sees the TRUE (noise-free) simulator state
        true_rel = maths.quat_mul(obj_rot, maths.quat_conjugate(hand.goal_rot))
        states = jnp.concatenate([
            maths.unscale(dof_pos, self.dof_lower, self.dof_upper),
            obj_pos, obj_rot, goal_pos, hand.goal_rot, true_rel, actions,
            self.vel_obs_scale * dof_vel,
            self.force_torque_obs_scale * out.dof_force[:, self.hand_dofs],
            obj[:, 7:13],
            self.force_torque_obs_scale * out.sensor_forces.reshape(n, -1),
        ], -1)

        task = task._replace(hand=hand, **self._task_updates)
        task = self._adr_update(task, reset, hand)
        return obs, states, rew, reset, task, extras

    def _adr_update(self, task, reset, hand):
        return task

    def get_env_state(self, state: EnvState):
        return None


class AllegroHandDextremeADR(AllegroHandDextremeManualDR):
    """ADR variant: the full reference parameter tree (hand drive scales,
    object mass/friction, affine obs/action noise, action latency, camera
    refresh, RNA alpha — cfg/task/AllegroHandDextremeADR.yaml:250-422)
    adapts via jitted boundary workers (adr_vec_task.py:489-920)."""

    use_adr = True

    def __init__(self, cfg):
        super().__init__(cfg)
        from ..utils.adr import adr_config_from_params
        adr_cfg = dict(cfg.get("adr") or {})
        if "params" not in adr_cfg:
            adr_cfg["params"] = DEFAULT_ADR_PARAMS
        self._adr_cfg_tree = adr_cfg
        self.adr = ADR(adr_config_from_params(adr_cfg), self.num_envs)
        self._adr_idx = {n: i for i, n in enumerate(self.adr.cfg.names)}
        # per-dof / per-body wiring masks for the physics-level parameters
        m = self.model
        nv, nb = self.engine.nv, self.engine.nb
        hand_dof = np.zeros(nv, np.float32)
        hand_dof[np.asarray(self.hand_dofs)] = 1.0
        self._hand_dof_mask = jnp.asarray(hand_dof)
        obj_body = m.body_names.index("object")
        hand_body = np.zeros(nb, np.float32)
        for i, nme in enumerate(m.body_names):
            if i != obj_body:
                hand_body[i] = 1.0
        self._hand_body_mask = jnp.asarray(hand_body)
        self._obj_body_mask = jnp.asarray(
            np.eye(nb, dtype=np.float32)[obj_body])
        ft = np.zeros(nb, np.float32)
        ft[np.asarray(self.fingertip_bodies)] = 1.0
        self._fingertip_body_mask = jnp.asarray(ft)

    def _adr_value(self, task: DextremeTaskState, name: str) -> jax.Array:
        # the reference's affine_cube_pose_* family corrupts the full pose;
        # the ManualDR-era rot-noise name rides the same adaptive std
        if name == "affine_cube_rot_white":
            name = "affine_cube_pose_white"
        if task.adr_params is not None and name in self._adr_idx:
            return task.adr_params[:, self._adr_idx[name]]
        return super()._adr_value(task, name)

    def initial_task_state(self):
        base = super().initial_task_state()
        st = self.adr.init()
        params = self.adr.sample(jax.random.PRNGKey(3), st)
        return base._replace(adr=st, adr_params=params)

    def initial_phys(self, key=None):
        """Must mirror :meth:`update_phys`'s pytree structure AND shapes —
        the PPO rollout scan carries EnvState.phys, so a (N, 1) ones
        placeholder against (N, nb)/(N, nv) updated fields breaks the carry
        (latent since round 1; surfaced by the round-3 ADR families)."""
        import types
        st = self.adr.init()
        params = self.adr.sample(jax.random.PRNGKey(3), st)
        shim = types.SimpleNamespace(task=types.SimpleNamespace(
            adr_params=params))
        return self.update_phys(shim, None, None)

    def update_phys(self, state: EnvState, reset_mask, key):
        """Per-property engine values from the sampled tree (the full
        reference dof_properties / rigid_body / rigid_shape families):
        drive damping/stiffness/effort + joint friction/armature scales and
        additive limit shifts on the hand dofs, per-body mass for hand vs
        object, per-body contact friction (fingertips vs object) and
        restitution values."""
        t = state.task

        def v(name):
            return self._adr_value(t, name)[:, None]

        hd, hb, ob = (self._hand_dof_mask, self._hand_body_mask,
                      self._obj_body_mask)
        damping = 1.0 + (v("hand_damping") - 1.0) * hd
        stiffness = 1.0 + (v("hand_stiffness") - 1.0) * hd
        mass = (1.0 + (v("hand_mass") - 1.0) * hb
                + (v("object_mass") - 1.0) * ob)
        friction = (1.0
                    + (v("hand_friction_fingertips") - 1.0)
                    * self._fingertip_body_mask
                    + (v("object_friction") - 1.0) * ob)
        restitution = v("hand_restitution") * hb + v("object_restitution") * ob
        return PhysScales(
            mass=mass, damping=damping, stiffness=stiffness,
            friction=friction,
            joint_friction=1.0 + (v("hand_joint_friction") - 1.0) * hd,
            armature=1.0 + (v("hand_armature") - 1.0) * hd,
            effort=1.0 + (v("hand_effort") - 1.0) * hd,
            dof_lower_shift=v("hand_lower") * hd,
            dof_upper_shift=v("hand_upper") * hd,
            restitution=restitution)

    def reset_idx(self, sim: SimState, task: DextremeTaskState, mask, key):
        # resample the per-env parameter row FIRST so the per-episode
        # affine biases drawn in super().reset_idx use the fresh stds
        fresh = self.adr.sample(jax.random.fold_in(key, 11), task.adr)
        params = masked_update(mask, fresh, task.adr_params)
        task = task._replace(adr_params=params)
        sim, task = super().reset_idx(sim, task, mask, key)
        return sim, task

    def _adr_update(self, task: DextremeTaskState, reset, hand):
        # boundary performance = consecutive successes achieved this episode
        st = self.adr.observe(task.adr, reset > 0, hand.successes)
        return task._replace(adr=st)

    def post_physics(self, state, out, actions):
        obs, states, rew, reset, task, extras = super().post_physics(
            state, out, actions)
        extras = dict(extras)
        extras["adr_npd"] = self.adr.npd(task.adr)
        return obs, states, rew, reset, task, extras

    def get_env_state(self, state: EnvState):
        """ADR ranges persist into checkpoints (adr_load_from_checkpoint —
        docs/domain_randomization.md:337)."""
        return {"adr": state.task.adr}

    def set_env_state(self, state: EnvState, env_state):
        if env_state and "adr" in env_state:
            return state._replace(
                task=state.task._replace(adr=env_state["adr"]))
        return state
