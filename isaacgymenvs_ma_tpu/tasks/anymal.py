"""Anymal flat-ground velocity tracking (reference tasks/anymal.py) —
obs 48 / act 12.

Quadruped tracks random (vx, vy, yaw-rate) commands.  PD position drives
(kp 85 / kd 2, cfg/task/Anymal.yaml:31-33) with targets = actionScale * a +
default joint angles (:227-229); exp-tracking reward + torque penalty, reset
on base/knee contact (kernel :313-356); obs: base-local velocities,
projected gravity, scaled commands/dofs/actions (kernel :359-390).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import DRIVE_POS, model_from_spec
from ..models.urdf import load_urdf
from ..ops import maths
from ..physics.engine import Control, SimState
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "Anymal",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 4096,
        "envSpacing": 4.0,
        "clipObservations": 5.0,
        "clipActions": 1.0,
        "plane": {"staticFriction": 1.0, "dynamicFriction": 1.0, "restitution": 0.0},
        "baseInitState": {
            "pos": [0.0, 0.0, 0.62],
            "rot": [0.0, 0.0, 0.0, 1.0],
            "vLinear": [0.0, 0.0, 0.0],
            "vAngular": [0.0, 0.0, 0.0],
        },
        "randomCommandVelocityRanges": {
            "linear_x": [-2.0, 2.0], "linear_y": [-1.0, 1.0], "yaw": [-1.0, 1.0]},
        "control": {"stiffness": 85.0, "damping": 2.0, "actionScale": 0.5,
                    "controlFrequencyInv": 1},
        "defaultJointAngles": {
            "LF_HAA": 0.03, "LH_HAA": 0.03, "RF_HAA": -0.03, "RH_HAA": -0.03,
            "LF_HFE": 0.4, "LH_HFE": -0.4, "RF_HFE": 0.4, "RH_HFE": -0.4,
            "LF_KFE": -0.8, "LH_KFE": 0.8, "RF_KFE": -0.8, "RH_KFE": 0.8,
        },
        "urdfAsset": {"collapseFixedJoints": True, "fixBaseLink": False,
                      "defaultDofDriveMode": 4},
        "learn": {
            "linearVelocityXYRewardScale": 1.0,
            "angularVelocityZRewardScale": 0.5,
            "torqueRewardScale": -0.000025,
            "linearVelocityScale": 2.0,
            "angularVelocityScale": 0.25,
            "dofPositionScale": 1.0,
            "dofVelocityScale": 0.05,
            "episodeLength_s": 50,
        },
        "enableCameraSensors": False,
    },
    "sim": {
        "dt": 0.02,
        "substeps": 2,
        "up_axis": "z",
        "use_gpu_pipeline": True,
        "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4, "solver_type": 1, "use_gpu": True,
            "num_position_iterations": 4, "num_velocity_iterations": 1,
            "contact_capacity": 16,  # 68 candidate rows, 4 feet active
            "contact_offset": 0.02, "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.2, "max_depenetration_velocity": 100.0,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 8388608, "contact_collection": 1,
        },
    },
    "task": {"randomize": False, "randomization_params": {}},
}

# URDF joint order after collapse: per leg (HAA, HFE, KFE) x LF, RF, LH, RH
_JOINT_ORDER = ["LF_HAA", "LF_HFE", "LF_KFE", "RF_HAA", "RF_HFE", "RF_KFE",
                "LH_HAA", "LH_HFE", "LH_KFE", "RH_HAA", "RH_HFE", "RH_KFE"]


class AnymalTaskState(NamedTuple):
    commands: jax.Array   # (N, 3) vx, vy, yaw-rate
    actions: jax.Array    # (N, 12)


class Anymal(VecTaskBase):
    def __init__(self, cfg):
        cfg["env"]["numObservations"] = 48
        cfg["env"]["numActions"] = 12
        e = cfg["env"]
        learn = e["learn"]
        self.lin_vel_scale = float(learn["linearVelocityScale"])
        self.ang_vel_scale = float(learn["angularVelocityScale"])
        self.dof_pos_scale = float(learn["dofPositionScale"])
        self.dof_vel_scale = float(learn["dofVelocityScale"])
        self.action_scale = float(e["control"]["actionScale"])
        self.Kp = float(e["control"]["stiffness"])
        self.Kd = float(e["control"]["damping"])
        self.rew_scales = {
            "lin_vel_xy": float(learn["linearVelocityXYRewardScale"]),
            "ang_vel_z": float(learn["angularVelocityZRewardScale"]),
            "torque": float(learn["torqueRewardScale"]),
        }
        self.command_x_range = e["randomCommandVelocityRanges"]["linear_x"]
        self.command_y_range = e["randomCommandVelocityRanges"]["linear_y"]
        self.command_yaw_range = e["randomCommandVelocityRanges"]["yaw"]
        dt = cfg["sim"]["dt"]
        e["episodeLength"] = int(learn["episodeLength_s"] / dt + 0.5)
        e["controlFrequencyInv"] = int(e["control"].get("controlFrequencyInv", 1))
        base_init = e["baseInitState"]
        self.base_init = np.array(
            base_init["pos"] + base_init["rot"] + base_init["vLinear"]
            + base_init["vAngular"])
        super().__init__(cfg)
        m = self.model
        # reward scales premultiplied by dt (reference anymal.py:76-80)
        self.rew_scales = {k: v * self.dt for k, v in self.rew_scales.items()}
        default = [e["defaultJointAngles"][n] for n in _JOINT_ORDER]
        # joint order = tree order (LF, RF, LH, RH legs) — verify by names
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
        self.gravity_vec = jnp.array([0.0, 0.0, -1.0])

    def create_model(self):
        asset = self.cfg["env"].get("asset", {})
        if asset.get("assetFileName"):
            import os
            model = load_urdf(
                os.path.join(asset.get("assetRoot", "."), asset["assetFileName"]),
                collapse_fixed=self.cfg["env"]["urdfAsset"]["collapseFixedJoints"])
        else:
            from ..models.specs.anymal import SPEC
            model = model_from_spec(SPEC)
        # PD drives on all 12 dofs (cfg control stiffness/damping)
        for d in range(model.nv - 6):
            model.dof_drive_mode[6 + d] = DRIVE_POS
            model.dof_stiffness[6 + d] = 85.0
            model.dof_drive_damping[6 + d] = 2.0
        return model, True

    def initial_task_state(self):
        n = self.num_envs
        return AnymalTaskState(
            commands=jnp.zeros((n, 3), jnp.float32),
            actions=jnp.zeros((n, 12), jnp.float32))

    # ------------------------------------------------------------------
    def pre_physics(self, state: EnvState, actions: jax.Array) -> Control:
        targets = self.action_scale * actions + self.default_dof_pos
        pos_target = jnp.zeros((self.num_envs, self.engine.nv), jnp.float32)
        pos_target = pos_target.at[:, self.engine.scalar_dofs].set(targets)
        return Control(
            tau=jnp.zeros((self.num_envs, self.engine.nv), jnp.float32),
            pos_target=pos_target,
            vel_target=jnp.zeros((self.num_envs, self.engine.nv), jnp.float32))

    def reset_idx(self, sim: SimState, task: AnymalTaskState, mask, key):
        n = self.num_envs
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        # dof pos = default * U(0.5, 1.5); vel ~ U(-0.1, 0.1) (ref :283-287)
        pos = self.default_dof_pos * jax.random.uniform(
            k1, (n, 12), minval=0.5, maxval=1.5)
        vel = jax.random.uniform(k2, (n, 12), minval=-0.1, maxval=0.1)
        sim = self.engine.set_dof_pos(
            sim, masked_update(mask, pos, self.engine.dof_pos(sim)))
        sim = self.engine.set_dof_vel(
            sim, masked_update(mask, vel, self.engine.dof_vel(sim)))
        root0 = jnp.asarray(self.base_init, jnp.float32)
        q = masked_update(mask, jnp.broadcast_to(root0[:7], (n, 7)), sim.q[:, 0:7])
        qd = masked_update(mask, jnp.broadcast_to(root0[7:13], (n, 6)), sim.qd[:, 0:6])
        sim = SimState(sim.q.at[:, 0:7].set(q), sim.qd.at[:, 0:6].set(qd))
        cmd = jnp.stack([
            jax.random.uniform(k3, (n,), minval=self.command_x_range[0],
                               maxval=self.command_x_range[1]),
            jax.random.uniform(k4, (n,), minval=self.command_y_range[0],
                               maxval=self.command_y_range[1]),
            jax.random.uniform(k5, (n,), minval=self.command_yaw_range[0],
                               maxval=self.command_yaw_range[1]),
        ], axis=-1)
        task = AnymalTaskState(
            commands=masked_update(mask, cmd, task.commands),
            actions=masked_update(mask, jnp.zeros((n, 12)), task.actions))
        return sim, task

    def post_physics(self, state: EnvState, out, actions):
        task: AnymalTaskState = state.task
        root = out.root_states[:, 0]
        base_quat = root[:, 3:7]
        base_lin_vel = maths.quat_rotate_inverse(base_quat, root[:, 7:10])
        base_ang_vel = maths.quat_rotate_inverse(base_quat, root[:, 10:13])
        projected_gravity = maths.quat_apply(base_quat, self.gravity_vec)
        dof_pos = self.engine.dof_pos(state.sim)
        dof_vel = self.engine.dof_vel(state.sim)

        # applied PD torques for the penalty (dof_force readout equivalent)
        targets = self.action_scale * actions + self.default_dof_pos
        torques = self.Kp * (targets - dof_pos) - self.Kd * dof_vel

        cmd_scale = jnp.array(
            [self.lin_vel_scale, self.lin_vel_scale, self.ang_vel_scale])
        obs = jnp.concatenate([
            base_lin_vel * self.lin_vel_scale,
            base_ang_vel * self.ang_vel_scale,
            projected_gravity,
            task.commands * cmd_scale,
            (dof_pos - self.default_dof_pos) * self.dof_pos_scale,
            dof_vel * self.dof_vel_scale,
            actions,
        ], axis=-1)

        # reward kernel (ref :313-356)
        lin_vel_error = jnp.sum(
            jnp.square(task.commands[:, :2] - base_lin_vel[:, :2]), axis=1)
        ang_vel_error = jnp.square(task.commands[:, 2] - base_ang_vel[:, 2])
        rew = (jnp.exp(-lin_vel_error / 0.25) * self.rew_scales["lin_vel_xy"]
               + jnp.exp(-ang_vel_error / 0.25) * self.rew_scales["ang_vel_z"]
               + jnp.sum(jnp.square(torques), axis=1) * self.rew_scales["torque"])
        rew = jnp.maximum(rew, 0.0)

        cf = out.contact_force
        base_contact = jnp.linalg.norm(cf[:, self.base_index], axis=-1) > 1.0
        knee_contact = jnp.any(
            jnp.linalg.norm(cf[:, self.knee_indices], axis=-1) > 1.0, axis=1)
        reset = jnp.where(
            base_contact | knee_contact
            | (state.progress >= self.max_episode_length - 1), 1, 0)
        task = AnymalTaskState(commands=task.commands, actions=actions)
        return obs, None, rew, reset.astype(jnp.int32), task, {}
