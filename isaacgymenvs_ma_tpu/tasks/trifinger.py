"""Trifinger cube-repositioning (reference tasks/trifinger.py, 1512 LoC).

Three 3-dof fingers around a 0.195 m arena move a 0.065 m cube to a goal pose.
Parity surface:

* obs spec (ref :325-331): robot_q(9) + robot_u(9) + object_q(7) +
  object_q_des(7) + command(9) = 41, normalized by ``scale_transform`` with
  the robot/object limit tables (ref :234-306) when ``normalize_obs``;
  asymmetric states (ref :333-342) add object_u(6) + fingertip_state(39) +
  joint torques(9) + fingertip wrenches(18) = 113.
* command modes (ref :1013-1028): ``torque`` (default; actions in [-1,1]
  unscaled to +-0.36 N*m) and ``position`` (PD with kp=[10,10,10],
  kd=[0.1,0.3,0.001] per finger), both with optional safety damping
  [0.08,0.08,0.04] and torque saturation (ref :1030-1043).
* reward (ref compute_trifinger_reward :1293-1383): finger-movement penalty,
  finger-reach-object rate term, and the keypoint reward
  ``2000 * dt * mean_k lgsk_kernel(|kp_obj - kp_goal|, scale=30, eps=2)``
  over the 8 cube corners (``gen_keypoints`` :1278, ``lgsk_kernel`` :1261).
* difficulty-staged goal sampling (ref :927-990): 1 = random on table,
  2 = fixed in air, 3 = random in air, 4 = random pose in air with
  orientation; success tolerances pos 0.02 / rot 0.4 (ref :1063-1101).
  Resets happen on timeout only; successes are tracked for logging/PBT.
* reset distributions (ref :833-925): robot "default"/"random"
  (dof_pos_stddev), object "default"/"random" (uniform in arena disc,
  random yaw).

Notes: the finger-reach schedule (ref ft_sched_end=5e7) is driven through
``set_train_info`` frames; the visual goal-object actor and the boundary wall
mesh are not simulated (the arena constraint matters only for fallen cubes,
which score ~0 reward and time out).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import FREE, GEOM_BOX, GEOM_SPHERE, Geom, ModelBuilder, \
    compose_scene, model_from_spec
from ..ops import maths
from ..physics.engine import Control, PhysicsEngine, SimState
from .base import EnvState, VecTaskBase, masked_update

ARENA_RADIUS = 0.195
CUBE_SIZE = 0.065
CUBE_RADIUS_3D = CUBE_SIZE * np.sqrt(3) / 2
MAX_COM_DIST = ARENA_RADIUS - CUBE_RADIUS_3D
MIN_HEIGHT = CUBE_SIZE / 2
MAX_HEIGHT = 0.1
MAX_TORQUE = 0.36
MAX_JOINT_VEL = 10.0
TIP_OFFSET = np.array([0.019, 0.0, -0.16])   # finger_lower_to_tip_joint origin
TIP_RADIUS = 0.0155

DOF_DEFAULT = np.array([0.0, 0.9, -2.0] * 3, np.float32)
KP = np.array([10.0, 10.0, 10.0] * 3, np.float32)
KD = np.array([0.1, 0.3, 0.001] * 3, np.float32)
SAFETY_KD = np.array([0.08, 0.08, 0.04] * 3, np.float32)

TASK_CFG = {
    "name": "Trifinger",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 16384,
        "envSpacing": 1.0,
        "episodeLength": 750,
        "clipObservations": 5.0,
        "clipActions": 1.0,
        "task_difficulty": 4,
        "enable_ft_sensors": False,
        "asymmetric_obs": True,
        "normalize_obs": True,
        "apply_safety_damping": True,
        "command_mode": "torque",
        "normalize_action": True,
        "cube_obs_keypoints": True,
        "reset_distribution": {
            "object_initial_state": {"type": "random"},
            "robot_initial_state": {"type": "default",
                                    "dof_pos_stddev": 0.4,
                                    "dof_vel_stddev": 0.2},
        },
        "reward_terms": {
            "finger_move_penalty": {"activate": True, "weight": -0.5},
            "finger_reach_object_rate": {"activate": True, "weight": -250.0},
            "object_dist": {"activate": False, "weight": 2000.0},
            "object_rot": {"activate": False, "weight": 2000.0},
            "keypoints_dist": {"activate": True, "weight": 2000.0},
        },
        "termination_conditions": {
            "success": {"orientation_tolerance": 0.4,
                        "position_tolerance": 0.02}},
    },
    "sim": {
        "dt": 0.02, "substeps": 4, "up_axis": "z",
        "gravity": [0.0, 0.0, -9.81],
        "physx": {"num_position_iterations": 8, "num_velocity_iterations": 0,
                  "contact_offset": 0.002, "rest_offset": 0.0,
                  "reuse_contact_rows": True,
                  "max_depenetration_velocity": 1000.0},
    },
    # Reference Trifinger.yaml:85-160 ships randomize: True.  Supported:
    # obs/action gaussian noise (incl. correlated action noise), per-env
    # object scale (setup_only, via PhysScales.shape), object mass
    # (setup_only, per-actor), contact friction.  Per-dof limit noise is
    # not modeled (robot dof_properties lower/upper).
    "task": {
        "randomize": True,
        "randomization_params": {
            "frequency": 750,
            "observations": {"range": [0, 0.002],
                             "range_correlated": [0, 0.000],
                             "operation": "additive",
                             "distribution": "gaussian"},
            "actions": {"range": [0, 0.02],
                        "range_correlated": [0, 0.01],
                        "operation": "additive",
                        "distribution": "gaussian"},
            "actor_params": {
                "object": {
                    "scale": {"range": [0.97, 1.03], "operation": "scaling",
                              "distribution": "uniform", "setup_only": True},
                    "rigid_body_properties": {
                        "mass": {"range": [0.7, 1.3], "operation": "scaling",
                                 "distribution": "uniform",
                                 "setup_only": True}},
                    "rigid_shape_properties": {
                        "friction": {"range": [0.7, 1.3],
                                     "operation": "scaling",
                                     "distribution": "uniform"}},
                },
            },
        },
    },
}


class TrifingerTaskState(NamedTuple):
    goal_pose: jax.Array       # (N, 7)
    last_ft_pos: jax.Array     # (N, 3, 3) previous-step fingertip positions
    last_obj_pos: jax.Array    # (N, 3)
    successes: jax.Array       # (N,) success at current step (for logging)
    frames: jax.Array          # scalar — drives the finger-reach schedule


def lgsk_kernel(x, scale=50.0, eps=2.0):
    """Logistic kernel bounding distance to (0, 1/(2+eps)] (ref :1261-1275)."""
    scaled = x * scale
    return 1.0 / (jnp.exp(scaled) + eps + jnp.exp(-scaled))


_CORNERS = np.array([[(1 if ((i >> k) & 1) == 0 else -1) * CUBE_SIZE / 2
                      for k in range(3)] for i in range(8)], np.float32)


def gen_keypoints(pose):
    """Cube corner keypoints in world frame (ref gen_keypoints :1278-1290)."""
    pos, quat = pose[..., 0:3], pose[..., 3:7]
    return pos[..., None, :] + maths.quat_apply(
        quat[..., None, :], jnp.asarray(_CORNERS))


class Trifinger(VecTaskBase):
    def __init__(self, cfg):
        e = cfg["env"]
        self.asymmetric_obs = bool(e.get("asymmetric_obs", True))
        e["numObservations"] = 41
        e["numActions"] = 9
        e["numStates"] = 113 if self.asymmetric_obs else 0
        self.difficulty = int(e.get("task_difficulty", 4))
        self.command_mode = e.get("command_mode", "torque")
        self.normalize_action = bool(e.get("normalize_action", True))
        self.normalize_obs = bool(e.get("normalize_obs", True))
        self.safety_damping = bool(e.get("apply_safety_damping", True))
        rt = e.get("reward_terms", TASK_CFG["env"]["reward_terms"])
        self.w_move = float(rt["finger_move_penalty"]["weight"])
        self.w_reach = float(rt["finger_reach_object_rate"]["weight"])
        self.w_dist = float(rt["object_dist"]["weight"])
        self.w_rot = float(rt["object_rot"]["weight"])
        self.w_kp = float(rt["keypoints_dist"]["weight"])
        self.use_keypoints = bool(rt["keypoints_dist"].get("activate", True))
        tc = e.get("termination_conditions",
                   TASK_CFG["env"]["termination_conditions"])
        self.pos_tol = float(tc["success"]["position_tolerance"])
        self.rot_tol = float(tc["success"]["orientation_tolerance"])
        rd = e.get("reset_distribution",
                   TASK_CFG["env"]["reset_distribution"])
        self.robot_reset = rd["robot_initial_state"]
        self.object_reset = rd["object_initial_state"]
        super().__init__(cfg)

        m = self.model
        self.object_body = m.body_names.index("object")
        self.obj_qa = int(m.q_adr[self.object_body])
        self.obj_va = int(m.v_adr[self.object_body])
        self.lower_links = np.asarray(
            [m.body_names.index(f"finger_lower_link_{a}")
             for a in (0, 120, 240)], np.int32)
        sd = self.engine.scalar_dofs
        self.finger_dofs = np.asarray(sd[:9])
        self.dof_lower = jnp.asarray(np.asarray(m.dof_lower)[self.finger_dofs])
        self.dof_upper = jnp.asarray(np.asarray(m.dof_upper)[self.finger_dofs])
        # observation normalization bounds (ref __configure_mdp_spaces
        # :592-676): [robot_q, robot_u, object pose, goal pose, command]
        cmd = MAX_TORQUE if self.command_mode == "torque" else 1.0
        self._obs_low = jnp.concatenate([
            self.dof_lower, jnp.full((9,), -MAX_JOINT_VEL),
            jnp.asarray([-0.3, -0.3, 0.0]), -jnp.ones(4),
            jnp.asarray([-0.3, -0.3, 0.0]), -jnp.ones(4),
            jnp.full((9,), -cmd)])
        self._obs_high = jnp.concatenate([
            self.dof_upper, jnp.full((9,), MAX_JOINT_VEL),
            jnp.asarray([0.3, 0.3, 0.3]), jnp.ones(4),
            jnp.asarray([0.3, 0.3, 0.3]), jnp.ones(4),
            jnp.full((9,), cmd)])

    # ------------------------------------------------------------------
    def create_model(self):
        import copy
        from ..models.specs.trifinger import SPEC
        robot = model_from_spec(copy.deepcopy(SPEC))
        # torque control (command_mode torque): no implicit drives
        for d in range(robot.nv):
            robot.dof_damping[d] = max(robot.dof_damping[d], 0.01)
        # fingertip contact spheres at the tip-frame offset (mesh collisions
        # in the URDF are approximated by the tip sphere, ref tip_sim.stl)
        for a in (0, 120, 240):
            b = robot.body_names.index(f"finger_lower_link_{a}")
            robot.geoms.append(Geom(
                body=b, gtype=GEOM_SPHERE,
                size=np.array([TIP_RADIUS, 0, 0]), pos=TIP_OFFSET.copy(),
                quat=np.array([0.0, 0, 0, 1]), friction=1.0, contact=True,
                name=f"tip_{a}"))
        ob = ModelBuilder()
        ob.begin_actor()
        obj = ob.add_body("object", -1, FREE,
                          body_pos=np.array([0.0, 0.0, MIN_HEIGHT]))
        # cube_multicolor_rrc: 0.065 cube, 0.094 kg
        ob.add_geom(obj, GEOM_BOX, np.full(3, CUBE_SIZE / 2),
                    density=0.094 / CUBE_SIZE ** 3, name="object_geom")
        model = compose_scene([
            (robot, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0)),
            (ob.finalize(), (0, 0, 0), (0, 0, 0, 1))])
        # fingertip force/torque sensors (enable_ft_sensors / states)
        model.sensor_body = np.asarray(
            [model.body_names.index(f"finger_lower_link_{a}")
             for a in (0, 120, 240)], np.int32)
        model.sensor_pos = np.tile(TIP_OFFSET, (3, 1))
        return model, True

    def build_engine(self, model, ground):
        names = [g.name for g in model.geoms]
        obj_geom = names.index("object_geom")
        pairs = [(names.index(f"tip_{a}"), obj_geom) for a in (0, 120, 240)]
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs)

    # ------------------------------------------------------------------
    def _tip_positions(self, out):
        xb = out.body_pos[:, self.lower_links]
        qb = out.body_quat[:, self.lower_links]
        return xb + maths.quat_apply(qb, jnp.asarray(TIP_OFFSET))

    def initial_task_state(self):
        n = self.num_envs
        return TrifingerTaskState(
            goal_pose=jnp.tile(
                jnp.asarray([0, 0, MIN_HEIGHT, 0, 0, 0, 1.0], jnp.float32),
                (n, 1)),
            last_ft_pos=jnp.zeros((n, 3, 3), jnp.float32),
            last_obj_pos=jnp.zeros((n, 3), jnp.float32),
            successes=jnp.zeros(n, jnp.float32),
            frames=jnp.asarray(0.0, jnp.float32))

    def pre_physics(self, state: EnvState, actions: jax.Array) -> Control:
        n = self.num_envs
        qd = self.engine.dof_vel(state.sim)[:, :9]
        if self.normalize_action:
            if self.command_mode == "torque":
                cmd = actions * MAX_TORQUE
            else:
                cmd = maths.unscale_transform(actions, self.dof_lower,
                                              self.dof_upper)
        else:
            cmd = actions
        if self.command_mode == "torque":
            tau9 = cmd
        else:
            q9 = self.engine.dof_pos(state.sim)[:, :9]
            tau9 = jnp.asarray(KP) * (cmd - q9) - jnp.asarray(KD) * qd
        tau9 = jnp.clip(tau9, -MAX_TORQUE, MAX_TORQUE)
        if self.safety_damping:
            tau9 = jnp.clip(tau9 - jnp.asarray(SAFETY_KD) * qd,
                            -MAX_TORQUE, MAX_TORQUE)
        tau = jnp.zeros((n, self.engine.nv), jnp.float32)
        tau = tau.at[:, self.finger_dofs].set(tau9)
        return Control(tau=tau,
                       pos_target=jnp.zeros((n, self.engine.nv), jnp.float32),
                       vel_target=jnp.zeros((n, self.engine.nv), jnp.float32))

    # -- samplers (ref :1427-1516) -------------------------------------
    def _random_xy(self, key, n, max_r):
        k1, k2 = jax.random.split(key)
        r = max_r * jnp.sqrt(jax.random.uniform(k1, (n,)))
        th = jax.random.uniform(k2, (n,), minval=0.0, maxval=2 * np.pi)
        return r * jnp.cos(th), r * jnp.sin(th)

    def _random_yaw_quat(self, key, n):
        yaw = jax.random.uniform(key, (n,), minval=-np.pi, maxval=np.pi)
        return maths.quat_from_angle_axis(yaw, jnp.asarray([0.0, 0, 1.0]))

    def _random_quat(self, key, n):
        u = jax.random.uniform(key, (n, 3))
        q = jnp.stack([
            jnp.sqrt(1 - u[:, 0]) * jnp.sin(2 * np.pi * u[:, 1]),
            jnp.sqrt(1 - u[:, 0]) * jnp.cos(2 * np.pi * u[:, 1]),
            jnp.sqrt(u[:, 0]) * jnp.sin(2 * np.pi * u[:, 2]),
            jnp.sqrt(u[:, 0]) * jnp.cos(2 * np.pi * u[:, 2])], -1)
        return q

    def _sample_goal(self, key, n):
        ks = jax.random.split(key, 3)
        d = self.difficulty
        if d == 1 or d == -1:
            x, y = self._random_xy(ks[0], n, MAX_COM_DIST)
            z = jnp.full((n,), MIN_HEIGHT)
            quat = (self._random_yaw_quat(ks[1], n) if d == -1 else
                    jnp.tile(jnp.asarray([0.0, 0, 0, 1.0]), (n, 1)))
        elif d == 2:
            x = y = jnp.zeros((n,))
            z = jnp.full((n,), MIN_HEIGHT + 0.05)
            quat = jnp.tile(jnp.asarray([0.0, 0, 0, 1.0]), (n, 1))
        elif d == 3:
            x, y = self._random_xy(ks[0], n, MAX_COM_DIST)
            z = jax.random.uniform(ks[1], (n,), minval=MIN_HEIGHT,
                                   maxval=MAX_HEIGHT)
            quat = jnp.tile(jnp.asarray([0.0, 0, 0, 1.0]), (n, 1))
        else:  # difficulty 4
            x, y = self._random_xy(ks[0], n, MAX_COM_DIST)
            z = jax.random.uniform(ks[1], (n,), minval=CUBE_RADIUS_3D,
                                   maxval=MAX_HEIGHT)
            quat = self._random_quat(ks[2], n)
        return jnp.concatenate([jnp.stack([x, y, z], -1), quat], -1)

    def reset_idx(self, sim: SimState, task: TrifingerTaskState, mask, key):
        n = self.num_envs
        ks = jax.random.split(key, 6)
        # robot state (ref _sample_robot_state)
        dof = jnp.tile(jnp.asarray(DOF_DEFAULT), (n, 1))
        dvel = jnp.zeros((n, 9))
        if self.robot_reset.get("type") == "random":
            dof = dof + float(self.robot_reset["dof_pos_stddev"]) * \
                jax.random.normal(ks[0], (n, 9))
            dof = jnp.clip(dof, self.dof_lower, self.dof_upper)
            dvel = float(self.robot_reset["dof_vel_stddev"]) * \
                jax.random.normal(ks[1], (n, 9))
        full_pos = self.engine.dof_pos(sim)
        full_pos = full_pos.at[:, :9].set(
            masked_update(mask, dof, full_pos[:, :9]))
        sim = self.engine.set_dof_pos(sim, full_pos)
        full_vel = self.engine.dof_vel(sim)
        full_vel = full_vel.at[:, :9].set(
            masked_update(mask, dvel, full_vel[:, :9]))
        sim = self.engine.set_dof_vel(sim, full_vel)
        # object pose (ref _sample_object_poses)
        if self.object_reset.get("type") == "random":
            x, y = self._random_xy(ks[2], n, MAX_COM_DIST)
            quat = self._random_yaw_quat(ks[3], n)
        else:
            x = y = jnp.zeros((n,))
            quat = jnp.tile(jnp.asarray([0.0, 0, 0, 1.0]), (n, 1))
        opose = jnp.concatenate(
            [jnp.stack([x, y, jnp.full((n,), MIN_HEIGHT)], -1), quat], -1)
        qa, va = self.obj_qa, self.obj_va
        q = sim.q.at[:, qa: qa + 7].set(
            masked_update(mask, opose, sim.q[:, qa: qa + 7]))
        qd = sim.qd.at[:, va: va + 6].set(
            masked_update(mask, jnp.zeros((n, 6)), sim.qd[:, va: va + 6]))
        sim = SimState(q, qd)
        goal = self._sample_goal(ks[4], n)
        out = self.engine.forward(sim)
        task = TrifingerTaskState(
            goal_pose=masked_update(mask, goal, task.goal_pose),
            last_ft_pos=masked_update(mask, self._tip_positions(out),
                                      task.last_ft_pos),
            last_obj_pos=masked_update(mask, opose[:, 0:3], task.last_obj_pos),
            successes=jnp.where(mask, 0.0, task.successes),
            frames=task.frames)
        return sim, task

    def post_physics(self, state: EnvState, out, actions):
        n = self.num_envs
        task: TrifingerTaskState = state.task
        dt = self.dt
        obj = out.root_states[:, 1]
        obj_pose, obj_vel = obj[:, 0:7], obj[:, 7:13]
        ft_pos = self._tip_positions(out)

        # ---- reward (ref :1293-1383) ----
        ft_vel = (ft_pos - task.last_ft_pos) / dt
        move_penalty = self.w_move * jnp.sum(
            jnp.square(ft_vel).reshape(n, -1), -1)
        curr_norms = jnp.linalg.norm(ft_pos - obj_pose[:, None, 0:3], axis=-1)
        prev_norms = jnp.linalg.norm(
            task.last_ft_pos - task.last_obj_pos[:, None, :], axis=-1)
        # ft schedule: active for env-step counts in [0, 5e7] (ref :1317-1318)
        ft_sched = (task.frames <= 5e7).astype(jnp.float32)
        reach_reward = self.w_reach * ft_sched * jnp.sum(
            curr_norms - prev_norms, -1)
        if self.use_keypoints:
            kp_obj = gen_keypoints(obj_pose)
            kp_goal = gen_keypoints(task.goal_pose)
            d = jnp.linalg.norm(kp_obj - kp_goal, axis=-1)
            pose_reward = self.w_kp * dt * jnp.mean(
                lgsk_kernel(d, scale=30.0, eps=2.0), -1)
        else:
            od = jnp.linalg.norm(obj_pose[:, 0:3] - task.goal_pose[:, 0:3], -1)
            dist_reward = self.w_dist * dt * lgsk_kernel(od, 50.0, 2.0)
            ang = maths.quat_diff_rad(obj_pose[:, 3:7], task.goal_pose[:, 3:7])
            rot_reward = self.w_rot * dt / (3.0 * jnp.abs(ang) + 0.01)
            pose_reward = dist_reward + rot_reward
        reward = move_penalty + reach_reward + pose_reward

        # ---- termination bookkeeping (ref _check_termination) ----
        pos_dist = jnp.linalg.norm(obj_pose[:, 0:3] - task.goal_pose[:, 0:3],
                                   axis=-1)
        rot_dist = jnp.abs(maths.quat_diff_rad(obj_pose[:, 3:7],
                                               task.goal_pose[:, 3:7]))
        pos_ok = pos_dist <= self.pos_tol
        rot_ok = rot_dist <= self.rot_tol
        if self.difficulty < 4:
            success = pos_ok
        else:
            success = pos_ok & rot_ok
        reset = (state.progress >= self.max_episode_length - 1).astype(jnp.int32)

        # ---- observations ----
        q9 = self.engine.dof_pos(state.sim)[:, :9]
        u9 = self.engine.dof_vel(state.sim)[:, :9]
        obs = jnp.concatenate([q9, u9, obj_pose, task.goal_pose, actions], -1)
        if self.normalize_obs:
            obs = maths.scale_transform(obs, self._obs_low, self._obs_high)
        states = None
        if self.asymmetric_obs:
            ft_rot = out.body_quat[:, self.lower_links]
            ft_vel6 = out.body_vel[:, self.lower_links]
            ft_state = jnp.concatenate([ft_pos, ft_rot, ft_vel6], -1)
            states = jnp.concatenate([
                obs, obj_vel, ft_state.reshape(n, -1),
                out.dof_force[:, self.finger_dofs],
                out.sensor_forces.reshape(n, -1)], -1)

        task = TrifingerTaskState(
            goal_pose=task.goal_pose, last_ft_pos=ft_pos,
            last_obj_pos=obj_pose[:, 0:3],
            successes=success.astype(jnp.float32),
            frames=task.frames + self.num_envs)
        extras = {"consecutive_successes": jnp.mean(task.successes),
                  "true_objective": jnp.mean(task.successes)}
        return obs, states, reward, reset, task, extras

    def set_train_info(self, state: EnvState, env_frames):
        task = state.task._replace(frames=jnp.asarray(env_frames, jnp.float32))
        return state._replace(task=task)
