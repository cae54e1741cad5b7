"""AnymalTerrain — heightfield-terrain locomotion with curriculum
(reference tasks/anymal_terrain.py, 687 LoC) — obs 188 / act 12.

Mechanics reproduced:
* procedural curriculum terrain: 10 levels x 20 types (physics/terrain.py),
  level promotion/demotion on reset (:427-435), per-env origins,
* custom decimation-4 control with in-task PD torques clipped to +-80 N·m
  (:441-451) — realized as the engine's implicit PD recomputed every 5 ms
  substep (better-conditioned than the reference's explicit loop; the clipped
  explicit torque is still used for the torque/acc reward terms),
* 140 height samples in the yaw frame with the min-of-two lookup (:503-538),
* 13-term reward with per-term episode sums -> ``extras['episode']``
  (:316-385, :420-425), termination on base/knee contact (:294-300),
* random robot pushes every ``pushInterval_s`` (:437-439, :461-462),
* additive uniform observation noise (:174-186).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import DRIVE_POS, model_from_spec
from ..ops import maths
from ..physics.engine import Control, SimState
from ..physics.terrain import CurriculumTerrain
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "AnymalTerrain",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 4096,
        "numObservations": 188,
        "numActions": 12,
        "envSpacing": 3.0,
        "enableDebugVis": False,
        "clipObservations": 100.0,
        "clipActions": 100.0,
        "terrain": {
            "terrainType": "trimesh",
            "staticFriction": 1.0,
            "dynamicFriction": 1.0,
            "restitution": 0.0,
            "curriculum": True,
            "maxInitMapLevel": 0,
            "mapLength": 8.0,
            "mapWidth": 8.0,
            "numLevels": 10,
            "numTerrains": 20,
            "terrainProportions": [0.1, 0.1, 0.35, 0.25, 0.2],
            "slopeTreshold": 0.5,
        },
        "baseInitState": {
            "pos": [0.0, 0.0, 0.62],
            "rot": [0.0, 0.0, 0.0, 1.0],
            "vLinear": [0.0, 0.0, 0.0],
            "vAngular": [0.0, 0.0, 0.0],
        },
        "randomCommandVelocityRanges": {
            "linear_x": [-1.0, 1.0], "linear_y": [-1.0, 1.0], "yaw": [-3.14, 3.14]},
        "control": {"stiffness": 80.0, "damping": 2.0, "actionScale": 0.5,
                    "decimation": 4},
        "defaultJointAngles": {
            "LF_HAA": 0.03, "LH_HAA": 0.03, "RF_HAA": -0.03, "RH_HAA": -0.03,
            "LF_HFE": 0.4, "LH_HFE": -0.4, "RF_HFE": 0.4, "RH_HFE": -0.4,
            "LF_KFE": -0.8, "LH_KFE": 0.8, "RF_KFE": -0.8, "RH_KFE": 0.8,
        },
        "learn": {
            "allowKneeContacts": True,
            "terminalReward": 0.0,
            "linearVelocityXYRewardScale": 1.0,
            "linearVelocityZRewardScale": -4.0,
            "angularVelocityXYRewardScale": -0.05,
            "angularVelocityZRewardScale": 0.5,
            "orientationRewardScale": -0.0,
            "torqueRewardScale": -0.00002,
            "jointAccRewardScale": -0.0005,
            "baseHeightRewardScale": -0.0,
            "feetAirTimeRewardScale": 1.0,
            "kneeCollisionRewardScale": -0.25,
            "feetStumbleRewardScale": -0.0,
            "actionRateRewardScale": -0.01,
            "hipRewardScale": -0.0,
            "linearVelocityScale": 2.0,
            "angularVelocityScale": 0.25,
            "dofPositionScale": 1.0,
            "dofVelocityScale": 0.05,
            "heightMeasurementScale": 5.0,
            "addNoise": True,
            "noiseLevel": 1.0,
            "dofPositionNoise": 0.01,
            "dofVelocityNoise": 1.5,
            "linearVelocityNoise": 0.1,
            "angularVelocityNoise": 0.2,
            "gravityNoise": 0.05,
            "heightMeasurementNoise": 0.06,
            "randomizeFriction": True,
            "frictionRange": [0.5, 1.25],
            "pushRobots": True,
            "pushInterval_s": 15,
            "episodeLength_s": 20,
        },
        "enableCameraSensors": False,
    },
    "sim": {
        "dt": 0.005,
        "substeps": 1,
        "up_axis": "z",
        "use_gpu_pipeline": True,
        "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4, "solver_type": 1, "use_gpu": True,
            "num_position_iterations": 4, "num_velocity_iterations": 1,
            "contact_capacity": 16,  # as Anymal
            # the decimation fold widens the substep window to 20 ms; a
            # mass matrix reused that long is stale at trot rates — force a
            # fresh articulation-inertia evaluation per 5 ms tick
            "reuse_mass_matrix": False,
            "contact_offset": 0.02, "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.2, "max_depenetration_velocity": 100.0,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 8388608, "contact_collection": 1,
        },
    },
    "task": {"randomize": False, "randomization_params": {}},
}

_JOINT_ORDER = ["LF_HAA", "LF_HFE", "LF_KFE", "RF_HAA", "RF_HFE", "RF_KFE",
                "LH_HAA", "LH_HFE", "LH_KFE", "RH_HAA", "RH_HFE", "RH_KFE"]

_EP_TERMS = ["lin_vel_xy", "ang_vel_z", "lin_vel_z", "ang_vel_xy", "orient",
             "torques", "joint_acc", "collision", "stumble", "action_rate",
             "air_time", "base_height", "hip"]


class ATTaskState(NamedTuple):
    commands: jax.Array         # (N, 4): vx, vy, yaw (computed), heading tgt
    actions: jax.Array          # (N, 12)
    last_actions: jax.Array
    last_dof_vel: jax.Array
    feet_air_time: jax.Array    # (N, 4)
    terrain_levels: jax.Array   # (N,) int32
    terrain_types: jax.Array    # (N,) int32
    common_step: jax.Array      # scalar int32
    episode_sums: jax.Array     # (N, len(_EP_TERMS))


class AnymalTerrain(VecTaskBase):
    def __init__(self, cfg):
        e = cfg["env"]
        learn = e["learn"]
        self.decimation = int(e["control"]["decimation"])
        # Fold the reference's decimation loop (pre_physics_step :441-451,
        # 4x gym.simulate per policy step) into ENGINE substeps: the target
        # is constant across the decimation window and the PD drive is
        # implicit per substep either way, so the physics tick (h = dt) is
        # identical — but the articulation-inertia chain and the jit
        # step-loop overheads run once per POLICY step instead of once per
        # tick (measured: the mass-matrix chain dominated this task's
        # 4-engine-step loop).
        sim_dt_tick = float(cfg["sim"]["dt"])
        cfg["sim"]["substeps"] = self.decimation * int(
            cfg["sim"].get("substeps", 1))
        cfg["sim"]["dt"] = sim_dt_tick * self.decimation
        e["controlFrequencyInv"] = 1
        dt_policy = cfg["sim"]["dt"]
        self.max_episode_length_s = float(learn["episodeLength_s"])
        e["episodeLength"] = int(self.max_episode_length_s / dt_policy + 0.5)
        self.lin_vel_scale = float(learn["linearVelocityScale"])
        self.ang_vel_scale = float(learn["angularVelocityScale"])
        self.dof_pos_scale = float(learn["dofPositionScale"])
        self.dof_vel_scale = float(learn["dofVelocityScale"])
        self.height_meas_scale = float(learn["heightMeasurementScale"])
        self.action_scale = float(e["control"]["actionScale"])
        self.Kp = float(e["control"]["stiffness"])
        self.Kd = float(e["control"]["damping"])
        self.allow_knee_contacts = bool(learn["allowKneeContacts"])
        self.curriculum = bool(e["terrain"]["curriculum"])
        self.push_interval = int(learn["pushInterval_s"] / dt_policy + 0.5)
        self.add_noise = bool(learn["addNoise"])
        self.rew_scales = {
            "lin_vel_xy": learn["linearVelocityXYRewardScale"],
            "ang_vel_z": learn["angularVelocityZRewardScale"],
            "lin_vel_z": learn["linearVelocityZRewardScale"],
            "ang_vel_xy": learn["angularVelocityXYRewardScale"],
            "orient": learn["orientationRewardScale"],
            "torque": learn["torqueRewardScale"],
            "joint_acc": learn["jointAccRewardScale"],
            "base_height": learn["baseHeightRewardScale"],
            "air_time": learn["feetAirTimeRewardScale"],
            "collision": learn["kneeCollisionRewardScale"],
            "stumble": learn["feetStumbleRewardScale"],
            "action_rate": learn["actionRateRewardScale"],
            "hip": learn["hipRewardScale"],
            "termination": learn["terminalReward"],
        }
        self.command_ranges = e["randomCommandVelocityRanges"]
        super().__init__(cfg)
        # policy-dt-scaled reward scales (ref :94-97)
        self.policy_dt = dt_policy
        self.rew_scales = {k: v * dt_policy if k != "termination" else v
                           for k, v in self.rew_scales.items()}
        m = self.model
        default = [e["defaultJointAngles"][n] for n in _JOINT_ORDER]
        names = [m.body_names[int(b)] for b in
                 np.asarray(m.dof_body)[self.engine.scalar_dofs]]
        order = [n.replace("_HIP", "_HAA").replace("_THIGH", "_HFE")
                 .replace("_SHANK", "_KFE") for n in names]
        self.default_dof_pos = jnp.asarray(
            [dict(zip(_JOINT_ORDER, default))[n] for n in order], jnp.float32)
        self.base_index = 0
        self.knee_indices = np.asarray(
            [i for i, n in enumerate(m.body_names) if "THIGH" in n], np.int32)
        self.feet_indices = np.asarray(
            [i for i, n in enumerate(m.body_names) if "SHANK" in n], np.int32)
        self.hip_dofs = np.asarray(
            [i for i, n in enumerate(order) if n.endswith("HAA")], np.int32)
        self.gravity_vec = jnp.array([0.0, 0.0, -1.0])
        self.forward_vec = jnp.array([1.0, 0.0, 0.0])
        base_init = e["baseInitState"]
        self.base_init = np.array(
            base_init["pos"] + base_init["rot"] + base_init["vLinear"]
            + base_init["vAngular"])

        # terrain map + height sample points (1m x 1.6m grid, ref :503-513)
        tc = e["terrain"]
        self.terrain_map = CurriculumTerrain(
            num_levels=int(tc["numLevels"]), num_types=int(tc["numTerrains"]),
            terrain_width=float(tc["mapWidth"]), terrain_length=float(tc["mapLength"]),
            proportions=tuple(tc["terrainProportions"]),
            curriculum=self.curriculum)
        self.terrain = self.terrain_map.grid
        self._terrain_win = 2 * int(np.ceil(1.3 / self.terrain.horizontal_scale)) + 4
        # terrain KIND per type column (same cumulative-proportion decision
        # the generator makes, terrain.py:300-335) — powers the per-kind
        # curriculum-level diagnostics that localize promotion stalls.
        # Only valid under curriculum=True (choice = j/num_types); the
        # non-curriculum generator draws random choices per cell, so the
        # per-kind labels would be wrong — mark them invalid (-1) there.
        props = np.cumsum(tc["terrainProportions"]) \
            / np.sum(tc["terrainProportions"])
        choices = np.arange(int(tc["numTerrains"])) / int(tc["numTerrains"]) \
            + 0.001
        self._type_kind = jnp.asarray(
            np.searchsorted(props, choices) if self.curriculum
            else np.full(int(tc["numTerrains"]), -1), jnp.int32)
        ys = 0.1 * np.array([-5, -4, -3, -2, -1, 1, 2, 3, 4, 5])
        xs = 0.1 * np.array([-8, -7, -6, -5, -4, -3, -2, 2, 3, 4, 5, 6, 7, 8])
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        self.height_points = jnp.asarray(
            np.stack([gx.ravel(), gy.ravel()], -1), jnp.float32)  # (140, 2)
        # noise scale vector (ref :174-186)
        nl = float(learn["noiseLevel"])
        nv = np.zeros(188, np.float32)
        nv[0:3] = learn["linearVelocityNoise"] * nl * self.lin_vel_scale
        nv[3:6] = learn["angularVelocityNoise"] * nl * self.ang_vel_scale
        nv[6:9] = learn["gravityNoise"] * nl
        nv[12:24] = learn["dofPositionNoise"] * nl * self.dof_pos_scale
        nv[24:36] = learn["dofVelocityNoise"] * nl * self.dof_vel_scale
        nv[36:176] = learn["heightMeasurementNoise"] * nl * self.height_meas_scale
        self.noise_scale_vec = jnp.asarray(nv)

    def create_model(self):
        from ..models.specs.anymal import SPEC
        model = model_from_spec(SPEC)
        for d in range(model.nv - 6):
            model.dof_drive_mode[6 + d] = DRIVE_POS
            model.dof_stiffness[6 + d] = 80.0
            model.dof_drive_damping[6 + d] = 2.0
        return model, True

    def initial_task_state(self):
        n = self.num_envs
        key = jax.random.PRNGKey(0)
        levels = jnp.zeros(n, jnp.int32)  # maxInitMapLevel 0
        types = jnp.asarray(
            np.arange(n) % self.terrain_map.num_types, jnp.int32)
        return ATTaskState(
            commands=jnp.zeros((n, 4), jnp.float32),
            actions=jnp.zeros((n, 12), jnp.float32),
            last_actions=jnp.zeros((n, 12), jnp.float32),
            last_dof_vel=jnp.zeros((n, 12), jnp.float32),
            feet_air_time=jnp.zeros((n, 4), jnp.float32),
            terrain_levels=levels,
            terrain_types=types,
            common_step=jnp.asarray(0, jnp.int32),
            episode_sums=jnp.zeros((n, len(_EP_TERMS)), jnp.float32),
        )

    # ------------------------------------------------------------------
    def pre_physics(self, state: EnvState, actions: jax.Array) -> Control:
        targets = self.action_scale * actions + self.default_dof_pos
        pos_target = jnp.zeros((self.num_envs, self.engine.nv), jnp.float32)
        pos_target = pos_target.at[:, self.engine.scalar_dofs].set(targets)
        return Control(
            tau=jnp.zeros((self.num_envs, self.engine.nv), jnp.float32),
            pos_target=pos_target,
            vel_target=jnp.zeros((self.num_envs, self.engine.nv), jnp.float32))

    def _env_origin(self, levels, types):
        return self.terrain_map.env_origins_j[levels, types]

    def reset_idx(self, sim: SimState, task: ATTaskState, mask, key):
        n = self.num_envs
        ks = jax.random.split(key, 7)
        pos = self.default_dof_pos * jax.random.uniform(ks[0], (n, 12), minval=0.5, maxval=1.5)
        vel = jax.random.uniform(ks[1], (n, 12), minval=-0.1, maxval=0.1)
        sim = self.engine.set_dof_pos(
            sim, masked_update(mask, pos, self.engine.dof_pos(sim)))
        sim = self.engine.set_dof_vel(
            sim, masked_update(mask, vel, self.engine.dof_vel(sim)))

        # terrain curriculum (ref :427-435)
        origins = self._env_origin(task.terrain_levels, task.terrain_types)
        dist = jnp.linalg.norm(sim.q[:, 0:2] - origins[:, 0:2], axis=-1)
        cmd_norm = jnp.linalg.norm(task.commands[:, 0:2], axis=-1)
        demote = dist < cmd_norm * self.max_episode_length_s * 0.25
        promote = dist > self.terrain_map.env_length / 2
        new_levels = task.terrain_levels - demote.astype(jnp.int32) \
            + promote.astype(jnp.int32)
        new_levels = jnp.clip(new_levels, 0, None) % self.terrain_map.num_levels
        levels = jnp.where(mask & jnp.asarray(self.curriculum), new_levels,
                           task.terrain_levels)
        origins = self._env_origin(levels, task.terrain_types)

        root0 = jnp.asarray(self.base_init, jnp.float32)
        xy_noise = jax.random.uniform(ks[2], (n, 2), minval=-0.5, maxval=0.5)
        root_pos = origins + root0[0:3] + jnp.concatenate(
            [xy_noise, jnp.zeros((n, 1))], -1)
        q = masked_update(
            mask, jnp.concatenate([root_pos,
                                   jnp.broadcast_to(root0[3:7], (n, 4))], -1),
            sim.q[:, 0:7])
        qd = masked_update(mask, jnp.broadcast_to(root0[7:13], (n, 6)),
                           sim.qd[:, 0:6])
        sim = SimState(sim.q.at[:, 0:7].set(q), sim.qd.at[:, 0:6].set(qd))

        cr = self.command_ranges
        cmd = jnp.stack([
            jax.random.uniform(ks[3], (n,), minval=cr["linear_x"][0], maxval=cr["linear_x"][1]),
            jax.random.uniform(ks[4], (n,), minval=cr["linear_y"][0], maxval=cr["linear_y"][1]),
            jnp.zeros(n),
            jax.random.uniform(ks[5], (n,), minval=cr["yaw"][0], maxval=cr["yaw"][1]),
        ], -1)
        # zero-out small commands (ref :412)
        cmd = cmd * (jnp.linalg.norm(cmd[:, 0:2], axis=-1) > 0.25)[:, None]

        task = ATTaskState(
            commands=masked_update(mask, cmd, task.commands),
            actions=masked_update(mask, jnp.zeros((n, 12)), task.actions),
            last_actions=masked_update(mask, jnp.zeros((n, 12)), task.last_actions),
            last_dof_vel=masked_update(mask, jnp.zeros((n, 12)), task.last_dof_vel),
            feet_air_time=masked_update(mask, jnp.zeros((n, 4)), task.feet_air_time),
            terrain_levels=levels,
            terrain_types=task.terrain_types,
            common_step=task.common_step,
            episode_sums=masked_update(
                mask, jnp.zeros((n, len(_EP_TERMS))), task.episode_sums),
        )
        return sim, task

    # ------------------------------------------------------------------
    def post_physics(self, state: EnvState, out, actions):
        task: ATTaskState = state.task
        n = self.num_envs
        sim = state.sim
        common_step = task.common_step + 1

        # random pushes (ref :437-439): overwrite xy lin vel of every base
        key_push = jax.random.fold_in(state.rng, 17)
        do_push = (common_step % self.push_interval) == 0
        push_vel = jax.random.uniform(key_push, (n, 2), minval=-1.0, maxval=1.0)
        qd = sim.qd.at[:, 0:2].set(
            jnp.where(do_push, push_vel, sim.qd[:, 0:2]))
        sim = SimState(sim.q, qd)
        out = self.engine.forward(sim, prev_out=out)

        root = out.root_states[:, 0]
        base_quat = root[:, 3:7]
        base_lin_vel = maths.quat_rotate_inverse(base_quat, root[:, 7:10])
        base_ang_vel = maths.quat_rotate_inverse(base_quat, root[:, 10:13])
        projected_gravity = maths.quat_rotate_inverse(base_quat, self.gravity_vec)
        forward = maths.quat_apply(base_quat, self.forward_vec)
        heading = jnp.arctan2(forward[:, 1], forward[:, 0])
        yaw_cmd = jnp.clip(
            0.5 * maths.normalize_angle(task.commands[:, 3] - heading), -1.0, 1.0)
        commands = task.commands.at[:, 2].set(yaw_cmd)

        dof_pos = self.engine.dof_pos(sim)
        dof_vel = self.engine.dof_vel(sim)
        targets = self.action_scale * actions + self.default_dof_pos
        torques = jnp.clip(self.Kp * (targets - dof_pos) - self.Kd * dof_vel,
                           -80.0, 80.0)

        # height samples in the yaw frame (ref :515-538)
        yaw_quat = maths.quat_from_angle_axis(heading, jnp.array([0.0, 0, 1.0]))
        pts = maths.quat_apply(yaw_quat[:, None, :],
                               jnp.concatenate([
                                   jnp.broadcast_to(self.height_points,
                                                    (n, 140, 2)),
                                   jnp.zeros((n, 140, 1))], -1))
        px = pts[..., 0] + root[:, None, 0]
        py = pts[..., 1] + root[:, None, 1]
        measured = self.step_terrain(state.sim).height_min2(px, py)
        heights_obs = jnp.clip(root[:, None, 2] - 0.5 - measured, -1.0, 1.0) \
            * self.height_meas_scale

        obs = jnp.concatenate([
            base_lin_vel * self.lin_vel_scale,
            base_ang_vel * self.ang_vel_scale,
            projected_gravity,
            commands[:, 0:3] * jnp.array(
                [self.lin_vel_scale, self.lin_vel_scale, self.ang_vel_scale]),
            dof_pos * self.dof_pos_scale,
            dof_vel * self.dof_vel_scale,
            heights_obs,
            actions,
        ], axis=-1)
        if self.add_noise:
            key_noise = jax.random.fold_in(state.rng, 23)
            obs = obs + (2.0 * jax.random.uniform(key_noise, obs.shape) - 1.0) \
                * self.noise_scale_vec

        # ---- termination (ref :294-300)
        cf = out.contact_force
        base_contact = jnp.linalg.norm(cf[:, self.base_index], axis=-1) > 1.0
        reset = base_contact
        knee_contact = jnp.linalg.norm(cf[:, self.knee_indices], axis=-1) > 1.0
        if not self.allow_knee_contacts:
            reset = reset | jnp.any(knee_contact, axis=1)
        timeout = state.progress >= self.max_episode_length - 1
        reset = (reset | timeout).astype(jnp.int32)

        # ---- reward (ref :316-385)
        rs = self.rew_scales
        lin_vel_error = jnp.sum(jnp.square(commands[:, :2] - base_lin_vel[:, :2]), 1)
        ang_vel_error = jnp.square(commands[:, 2] - base_ang_vel[:, 2])
        terms = {}
        terms["lin_vel_xy"] = jnp.exp(-lin_vel_error / 0.25) * rs["lin_vel_xy"]
        terms["ang_vel_z"] = jnp.exp(-ang_vel_error / 0.25) * rs["ang_vel_z"]
        terms["lin_vel_z"] = jnp.square(base_lin_vel[:, 2]) * rs["lin_vel_z"]
        terms["ang_vel_xy"] = jnp.sum(jnp.square(base_ang_vel[:, :2]), 1) * rs["ang_vel_xy"]
        terms["orient"] = jnp.sum(jnp.square(projected_gravity[:, :2]), 1) * rs["orient"]
        terms["base_height"] = jnp.square(root[:, 2] - 0.52) * rs["base_height"]
        terms["torques"] = jnp.sum(jnp.square(torques), 1) * rs["torque"]
        terms["joint_acc"] = jnp.sum(jnp.square(task.last_dof_vel - dof_vel), 1) * rs["joint_acc"]
        terms["collision"] = jnp.sum(knee_contact.astype(jnp.float32), 1) * rs["collision"]
        feet_cf = cf[:, self.feet_indices]
        stumble = ((jnp.linalg.norm(feet_cf[..., :2], axis=-1) > 5.0)
                   & (jnp.abs(feet_cf[..., 2]) < 1.0))
        terms["stumble"] = jnp.sum(stumble.astype(jnp.float32), 1) * rs["stumble"]
        terms["action_rate"] = jnp.sum(jnp.square(task.last_actions - actions), 1) * rs["action_rate"]
        contact = feet_cf[..., 2] > 1.0
        first_contact = (task.feet_air_time > 0.0) & contact
        feet_air_time = task.feet_air_time + self.policy_dt
        rew_air = jnp.sum((feet_air_time - 0.5) * first_contact.astype(jnp.float32), 1) \
            * rs["air_time"]
        rew_air = rew_air * (jnp.linalg.norm(commands[:, :2], axis=-1) > 0.1)
        terms["air_time"] = rew_air
        feet_air_time = feet_air_time * (~contact)
        terms["hip"] = jnp.sum(jnp.abs(dof_pos[:, self.hip_dofs]
                                       - self.default_dof_pos[self.hip_dofs]), 1) * rs["hip"]

        rew = sum(terms.values())
        rew = jnp.maximum(rew, 0.0)
        rew = rew + rs["termination"] * reset * (~timeout)

        episode_sums = task.episode_sums + jnp.stack(
            [terms[k] for k in _EP_TERMS], -1)
        extras = {
            "episode": {
                f"rew_{k}": jnp.sum(jnp.where(reset > 0, episode_sums[:, i], 0.0))
                / jnp.maximum(jnp.sum(reset), 1) / self.max_episode_length_s
                for i, k in enumerate(_EP_TERMS)
            }
        }
        extras["episode"]["terrain_level"] = jnp.mean(
            task.terrain_levels.astype(jnp.float32))
        # per-kind level means: which terrain family gates the curriculum
        env_kind = self._type_kind[task.terrain_types]
        lv = task.terrain_levels.astype(jnp.float32)
        for k, kname in enumerate(("slope", "rough", "stairs", "discrete",
                                   "stones")):
            sel = (env_kind == k).astype(jnp.float32)
            extras["episode"][f"lvl_{kname}"] = (
                jnp.sum(lv * sel) / jnp.maximum(jnp.sum(sel), 1.0))

        task = ATTaskState(
            commands=commands, actions=actions, last_actions=actions,
            last_dof_vel=dof_vel, feet_air_time=feet_air_time,
            terrain_levels=task.terrain_levels, terrain_types=task.terrain_types,
            common_step=common_step, episode_sums=episode_sums)
        # note: sim was modified by pushes — write it back through state
        self._pushed_sim = sim
        return obs, None, rew, reset, task, extras

    def step_terrain(self, sim):
        # Per-env local heightfield window (physics/terrain.py LocalTerrain):
        # the obs sample grid reaches 0.8 m from the base, the legs ~0.7 m,
        # and the base drifts < 2 cm within one control step, so a 1.3 m
        # radius window covers every lookup (chosen over global-grid
        # gathers on the previous accelerator; not yet re-measured).
        size = self._terrain_win
        return self.terrain.local_window(sim.q[:, 0], sim.q[:, 1], size)

    def step(self, state, actions):
        # intercept to persist the pushed sim state (base.step uses post's sim)
        new_state, res = super().step(state, actions)
        if hasattr(self, "_pushed_sim") and self._pushed_sim is not None:
            new_state = new_state._replace(sim=self._pushed_sim)
            self._pushed_sim = None
        return new_state, res
