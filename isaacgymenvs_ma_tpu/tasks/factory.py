"""Factory nut-bolt task family (reference tasks/factory/, ~4.3 kLoC:
factory_base.py + factory_env_nut_bolt.py + factory_task_nut_bolt_{pick,
place,screw}.py + the schema classes).

Scene: Franka at (0.5, 0, 0) facing -x over a table (top z = 0.4,
FactoryBase.yaml:40-41), M16 nut + bolt (factory_asset_info_nut_bolt.yaml:
nut width 0.024/height 0.013, bolt shank r 0.008/length 0.025/head 0.016,
thread pitch 0.002).

Parity surface:

* 12-dim actions -> fingertip-midpoint pose deltas (pos_action_scale 0.1,
  axis-angle rot with clamp_rot_thresh) + optional force/torque targets
  (factory_task_nut_bolt_pick.py:292-334); torques from the controller
  library (ops/controllers.py == factory_control.py) using the engine's
  mass-matrix/jacobian readouts; all 7 ctrl modes via the task yaml ``ctrl``
  schema (default joint_space_id, gains 40/8, gripper 500/20).
* keypoint rewards: uniformly spaced keypoints along the gripper/nut/bolt
  axes (``_get_keypoint_offsets`` :335), reward = -keypoint_dist * scale -
  action_penalty; success bonus at episode end (pick: lift success 3x nut
  height; place: nut close to bolt tip; screw: nut near shank base).
* resets: franka to initial dof pos + gripper pose randomization via
  jacobian IK (replaces the reference's 20-sim-step move), nut/bolt XY
  noise on the table.

Batched redesign: the screw task's nut rides a SCREW joint on the bolt (pitch
0.002 m/rev) — the XLA-native replacement for SDF thread-mesh collision
(docs/factory.md "SDF collisions"); gripper-pad friction on the nut flats
drives it exactly as on hardware.  The pick task's open-loop close-and-lift
epilogue (:350-377) is exposed as the jittable ``evaluate_lift`` (run it on
final states to score lift success, as the reference does after the last
RL step).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.franka import FRANKA_DEFAULT_DOF_POS, build_franka
from ..models.model import (FIXED, FREE, GEOM_BOX, GEOM_CYLINDER, GEOM_SPHERE,
                            SCREW, Geom, ModelBuilder, compose_scene)
from ..ops import controllers as fc
from ..ops import maths
from ..physics.engine import Control, PhysicsEngine, SimState
from .base import EnvState, VecTaskBase, masked_update

TABLE_HEIGHT = 0.4
FRANKA_DEPTH = 0.5
# M16 nut/bolt (factory_asset_info_nut_bolt.yaml:85-98)
NUT_WIDTH = 0.024          # across flats
NUT_HEIGHT = 0.013
NUT_HOLE_R = 0.0085        # bore radius (0.5 mm clearance over the shank)
BOLT_WIDTH = 0.016         # shank diameter
BOLT_HEAD_HEIGHT = 0.016
BOLT_SHANK_LENGTH = 0.025
THREAD_PITCH = 0.002
FRANKA_HAND_LENGTH = 0.0584   # factory_asset_info_franka_table.yaml:1
FRANKA_FINGER_LENGTH = 0.053671
FRANKA_FINGERPAD_LENGTH = 0.017608
GRIPPER_WIDTH_MAX = 0.08
ARM_INIT = np.array([0.3413, -0.8011, -0.0670, -1.8299, 0.0266, 1.0185,
                     1.0927], np.float32)

# Mode sections mirror the reference task yamls: only gym_default pins its
# own gripper gains (500/20); every other mode inherits them from the task's
# ``all`` section (hydra-merge semantics, fc.parse_ctrl_cfg).
_CTRL_YAML = {
    "all": {"jacobian_type": "geometric"},
    "gym_default": {"ik_method": "dls", "joint_prop_gains": [40.0] * 7,
                    "joint_deriv_gains": [8.0] * 7,
                    "gripper_prop_gains": [500.0, 500.0],
                    "gripper_deriv_gains": [20.0, 20.0]},
    "joint_space_ik": {"ik_method": "dls", "joint_prop_gains": [1.0] * 7,
                       "joint_deriv_gains": [0.1] * 7},
    "joint_space_id": {"ik_method": "dls", "joint_prop_gains": [40.0] * 7,
                       "joint_deriv_gains": [8.0] * 7},
    "task_space_impedance": {"motion_ctrl_axes": [1] * 6,
                             "task_prop_gains": [40.0] * 6,
                             "task_deriv_gains": [8.0] * 6},
    "operational_space_motion": {"motion_ctrl_axes": [1] * 6,
                                 "task_prop_gains": [1.0] * 6,
                                 "task_deriv_gains": [1.0] * 6},
    "open_loop_force": {"force_ctrl_axes": [0, 0, 1, 0, 0, 0]},
    "closed_loop_force": {"force_ctrl_axes": [0, 0, 1, 0, 0, 0],
                          "wrench_prop_gains": [0.1] * 6},
    "hybrid_force_motion": {"motion_ctrl_axes": [1, 1, 0, 1, 1, 1],
                            "force_ctrl_axes": [0, 0, 1, 0, 0, 0],
                            "task_prop_gains": [40.0] * 6,
                            "task_deriv_gains": [8.0] * 6,
                            "wrench_prop_gains": [0.1] * 6},
}


def _base_cfg(name, num_obs, num_act, episode_len):
    return {
        "name": name,
        "physics_engine": "physx",
        "env": {"numEnvs": 128, "envSpacing": 0.5,
                "numObservations": num_obs, "numActions": num_act,
                "episodeLength": episode_len,
                "clipObservations": 5.0, "clipActions": 1.0,
                "close_and_lift": True,
                "num_gripper_close_sim_steps": 25,
                "num_gripper_lift_sim_steps": 25,
                # mesh-accurate SDF collisions (PhysX SDF-collision analog,
                # docs/factory.md §Collisions): nut/bolt as baked voxel-grid
                # geoms.  False falls back to primitive proxies.
                "use_mesh_sdf": True},
        "randomize": {
            "franka_arm_initial_dof_pos": ARM_INIT.tolist(),
            "fingertip_midpoint_pos_initial": [0.0, -0.2, 0.2],
            "fingertip_midpoint_pos_noise": [0.2, 0.2, 0.1],
            "fingertip_midpoint_rot_initial": [3.1416, 0.0, 3.1416],
            "fingertip_midpoint_rot_noise": [0.3, 0.3, 1.0],
            "nut_pos_xy_initial": [0.0, -0.3],
            "nut_pos_xy_initial_noise": [0.1, 0.1],
            "bolt_pos_xy_initial": [0.0, 0.0],
            "bolt_pos_xy_noise": [0.1, 0.1],
        },
        "rl": {"pos_action_scale": [0.1, 0.1, 0.1],
               "rot_action_scale": [0.1, 0.1, 0.1],
               "force_action_scale": [1.0, 1.0, 1.0],
               "torque_action_scale": [1.0, 1.0, 1.0],
               "clamp_rot": True, "clamp_rot_thresh": 1.0e-6,
               "num_keypoints": 4, "keypoint_scale": 0.5,
               "keypoint_reward_scale": 1.0, "action_penalty_scale": 0.0,
               "max_episode_length": episode_len, "success_bonus": 0.0,
               "far_error_thresh": 0.1},
        "ctrl": dict(_CTRL_YAML, ctrl_type="joint_space_id"),
        "sim": {"dt": 0.016667, "substeps": 2, "up_axis": "z",
                "gravity": [0.0, 0.0, -9.81],
                # reuse_contact_rows measured neutral here (96.4 vs 96.3
                # ms/step: the 16-iteration solve dominates) — keep the
                # per-substep row rebuild for accuracy
                "physx": {"num_position_iterations": 16,
                          "num_velocity_iterations": 0,
                          "max_depenetration_velocity": 5.0,
                          # speculative activation band (ref FactoryBase.yaml
                          # contact_offset 0.005): without it the fingerpads
                          # tunnel through the 3.5 mm hex-nut wall
                          "contact_offset": 0.005,
                          # persistent-contact impulse cache (PhysX warm
                          # starting): the gripper squeeze builds across
                          # steps instead of restarting from zero
                          "warm_start": 0.9,
                          # mesh contact clouds rest many coincident rows at
                          # once — Jacobi needs per-body impulse splitting
                          "mass_splitting": True}},
        "task": {"randomize": False, "randomization_params": {}},
    }


class FactoryTaskState(NamedTuple):
    actions: jax.Array         # (N, 12) last policy actions
    lift_success: jax.Array    # (N,) evaluated at episode end (pick)


class FactoryBase(VecTaskBase):
    """Franka-over-table base with task-space controllers (factory_base.py)."""

    nut_free = True            # screw task overrides

    def __init__(self, cfg):
        e = cfg["env"]
        e.setdefault("clipObservations", 5.0)
        self.cfg_rl = cfg["rl"]
        self.cfg_rand = cfg["randomize"]
        self.use_mesh_sdf = bool(e.get("use_mesh_sdf", True))
        self.ctrl_type = cfg["ctrl"].get("ctrl_type", "joint_space_id")
        e["episodeLength"] = int(self.cfg_rl["max_episode_length"])
        super().__init__(cfg)
        self.cfg_ctrl = fc.parse_ctrl_cfg(cfg["ctrl"], self.ctrl_type,
                                          self.num_envs)
        m = self.model
        self.hand_body = m.body_names.index("panda_hand")
        self.grip_site = m.body_names.index("panda_grip_site")
        self.lf_body = m.body_names.index("panda_leftfinger")
        self.rf_body = m.body_names.index("panda_rightfinger")
        self.nut_body = m.body_names.index("nut")
        sd = self.engine.scalar_dofs
        self.franka_dofs = np.asarray(sd[:9])
        dl = np.asarray(m.dof_lower)[self.franka_dofs]
        du = np.asarray(m.dof_upper)[self.franka_dofs]
        self.dof_lower = jnp.asarray(dl)
        self.dof_upper = jnp.asarray(du)
        self.default_dof = jnp.asarray(
            np.concatenate([ARM_INIT, [0.035, 0.035]]), jnp.float32)
        self.pos_scale = jnp.asarray(self.cfg_rl["pos_action_scale"])
        self.rot_scale = jnp.asarray(self.cfg_rl["rot_action_scale"])
        self.force_scale_a = jnp.asarray(self.cfg_rl["force_action_scale"])
        self.torque_scale_a = jnp.asarray(self.cfg_rl["torque_action_scale"])
        kp = self.cfg_rl["num_keypoints"]
        self.keypoint_offsets = np.zeros((kp, 3), np.float32)
        self.keypoint_offsets[:, 2] = (np.linspace(0.0, 1.0, kp) - 0.5) \
            * self.cfg_rl["keypoint_scale"]

    # -- scene ----------------------------------------------------------
    def _nut_geom(self, ob, parent_kwargs):
        raise NotImplementedError

    def create_model(self):
        franka = build_franka(hand_contact_sphere=0.0)
        for d in range(franka.nv):
            franka.dof_drive_mode[d] = 0  # torque control via controllers
            # Zero passive joint damping (ref factory_base.py:414-416:
            # DOF_MODE_EFFORT with stiffness/damping = 0).  build_franka's
            # default damping of 10 N*m*s/rad swamped the weak factory
            # gains (40/8 arm, 50/2 gripper): the closed loop crawled at
            # ~tau/10 rad/s and stalled ~7-10 cm from any target — the
            # round-3/4 "policy ends 5-8 cm off the grasp pose" plateau
            # was this, not an RL failure (scripts/probe_pick_stepresp.py).
            franka.dof_damping[d] = 0.0
        # The factory franka URDF REMOVES the joint-7 limit (and its damping):
        # assets/factory/urdf/factory_franka.urdf:147-154 comments out
        # ``<limit effort="12" lower="-2.8973" upper="2.8973" .../>`` — the
        # wrist is a continuous revolute.  This is what makes NutBoltScrew
        # solvable: 1.85 cm of descent = ~9 revolutions = 58 rad of nut
        # rotation, far beyond a +-2.9 rad wrist; with unidirectional_rot
        # the policy just keeps yawing clockwise.  (+-1e9 survives
        # compose_scene's limit round-trip; has_limit is re-derived from the
        # +-1e8 sentinel, model.py:510-512.)
        franka.dof_lower[6] = -1e9
        franka.dof_upper[6] = 1e9
        franka.dof_has_limit[6] = False
        # sim.add_damping (FactoryBase.yaml:17, default True): franka links
        # get rigid linear/angular damping 1.0/5.0 "to improve stability"
        # (factory_base.py:122-125).  This is the stabilizer for the task
        # axes the factory controllers leave uncontrolled (e.g. the Screw
        # OSC controls only z + yaw): without it the hand random-walks
        # laterally off the spinning nut in ~200 steps
        # (scripts/probe_screw_descent.py).
        if self.cfg.get("sim", {}).get("add_damping", True):
            franka.body_lin_damping = np.ones(franka.nb)
            franka.body_ang_damping = np.full(franka.nb, 5.0)
        # Fingerpad contact clouds on both finger tips: a 3x2 grid of 4 mm
        # spheres covering the FLAT pad face (the real Franka pad is a
        # plane; a single-sphere pad gave a 2-point knife-edge pinch that
        # ratcheted over the hex corners and squirted the nut out — plane
        # contact traps it like the reference's mesh fingers do).
        pad_pts = np.array(
            [[sx, 0.0, FRANKA_FINGER_LENGTH - FRANKA_FINGERPAD_LENGTH + dz]
             for sx in (-0.005, 0.005)
             for dz in (0.003, 0.0088, 0.0146)], np.float32)
        for n in ("panda_leftfinger", "panda_rightfinger"):
            b = franka.body_names.index(n)
            franka.geoms.append(Geom(
                body=b, gtype=GEOM_SPHERE, size=np.array([0.004, 0, 0]),
                pos=np.array([0.0, 0.0, 0.0]),
                quat=np.array([0.0, 0, 0, 1]), friction=1.0, contact=True,
                contact_points=pad_pts, name=f"pad_{n}"))
            # flat pad face as an analytic box SDF target (used by the
            # Screw task's inverted nut-points-vs-pad-plane pairs; inert
            # otherwise) — the 4 mm y half-extent matches the sphere pads'
            # contact surface
            franka.geoms.append(Geom(
                body=b, gtype=GEOM_BOX,
                size=np.array([0.008, 0.004,
                               FRANKA_FINGERPAD_LENGTH / 2]),
                pos=np.array([0.0, 0.0, FRANKA_FINGER_LENGTH
                              - FRANKA_FINGERPAD_LENGTH / 2]),
                quat=np.array([0.0, 0, 0, 1]), friction=1.0, contact=False,
                name=f"padbox_{n}"))
        tb = ModelBuilder()
        tb.begin_actor()
        tbody = tb.add_body("table", -1, FIXED,
                            body_pos=(0.0, 0.0, TABLE_HEIGHT / 2))
        # reference table: depth 0.6 (x) x width 1.0 (y)
        # (factory_asset_info_franka_table.yaml:6-7, factory_base.py:158-159).
        # A 0.3 y half-extent put the nut spawn band (y in [-0.4,-0.2],
        # FactoryTaskNutBoltPick.yaml:30-31) half off the table edge — nuts
        # free-fell past the tabletop and thrashed inside the box.
        tb.add_geom(tbody, GEOM_BOX, np.array([0.3, 0.5, TABLE_HEIGHT / 2]),
                    friction=0.3, name="table_top")
        parts = [
            (franka, (FRANKA_DEPTH, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0)),
            (tb.finalize(), (0, 0, 0), (0, 0, 0, 1)),
        ]
        parts += self._extra_parts()
        model = compose_scene(parts)
        # the franka is simulated gravity-free (factory_base.py:132
        # franka_options.disable_gravity = True) so the weak factory gains
        # need no gravity compensation
        for i, n in enumerate(model.body_names):
            if n.startswith("panda_"):
                model.body_gravity[i] = 0.0
        model.sensor_body = np.asarray(
            [model.body_names.index("panda_leftfinger"),
             model.body_names.index("panda_rightfinger")], np.int32)
        model.sensor_pos = np.zeros((2, 3))
        return model, True

    def _extra_parts(self):
        return []

    def build_engine(self, model, ground):
        names = [g.name for g in model.geoms]
        pairs = []
        nut_geom = names.index("nut_geom")
        table = names.index("table_top")
        for pn in names:
            if pn.startswith("pad_"):
                pairs.append((names.index(pn), nut_geom))
                # fingers collide with the tabletop (the reference franka's
                # collision meshes do): without this the policy's descent
                # has no floor — trained policies sank the gripper 10+ cm
                # BELOW the grasp frame through the table
                pairs.append((names.index(pn), table))
        if self.nut_free:
            pairs.append((nut_geom, table))
            if "bolt_geom" in names:
                pairs.append((nut_geom, names.index("bolt_geom")))
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs)

    # -- controller plumbing --------------------------------------------
    def _fingertip_state(self, out):
        pos = out.body_pos[:, self.grip_site]
        quat = out.body_quat[:, self.grip_site]
        vel = out.body_vel[:, self.grip_site]
        return pos, quat, vel[:, 0:3], vel[:, 3:6]

    def _arm_readouts(self, sim):
        """(jacobian (N,6,7), arm mass matrix (N,7,7), fingertip pose)."""
        M, body_x, body_q, S, V = self.engine.dynamics_readout(sim)
        arm = self.franka_dofs[:7]
        J_full = self.engine.point_jacobian(S, body_x, self.grip_site,
                                            point=body_x[:, self.grip_site])
        J = jnp.swapaxes(J_full[:, arm, :], 1, 2)      # (N, 6, 7) [lin;ang]
        M_arm = M[:, arm][:, :, arm]
        ft_pos = body_x[:, self.grip_site]
        ft_quat = body_q[:, self.grip_site]
        Vg = V[:, self.grip_site]
        ang = Vg[:, 0:3]
        lin = Vg[:, 3:6] + jnp.cross(ang, ft_pos)      # velocity at the point
        return J, M_arm, ft_pos, ft_quat, lin, ang

    def _apply_actions_as_ctrl_targets(self, sim, actions, gripper_target,
                                       do_scale=True):
        J, M_arm, ft_pos, ft_quat, lin, ang = self._arm_readouts(sim)
        pos_actions = actions[:, 0:3] * (self.pos_scale if do_scale else 1.0)
        target_pos = ft_pos + pos_actions
        rot_actions = actions[:, 3:6]
        if do_scale and self.cfg_rl.get("unidirectional_rot"):
            # constrain the z-rot action to [-1, 0]: the wrist only ever yaws
            # clockwise = the screw-down direction (ref
            # factory_task_nut_bolt_screw.py:254-255, Screw yaml
            # unidirectional_rot: True)
            rot_actions = rot_actions.at[:, 2].set(
                -(rot_actions[:, 2] + 1.0) * 0.5)
        rot_actions = rot_actions * (self.rot_scale if do_scale else 1.0)
        angle = jnp.linalg.norm(rot_actions, axis=-1)
        axis = rot_actions / jnp.maximum(angle, 1e-9)[:, None]
        rot_quat = maths.quat_from_angle_axis(angle, axis)
        if self.cfg_rl.get("clamp_rot", True):
            ident = jnp.asarray([0.0, 0, 0, 1.0])
            rot_quat = jnp.where(
                (angle > self.cfg_rl["clamp_rot_thresh"])[:, None],
                rot_quat, ident)
        target_quat = maths.quat_mul(rot_quat, ft_quat)
        wrench = None
        if self.cfg_ctrl.get("do_force_ctrl"):
            wrench = jnp.concatenate(
                [actions[:, 6:9] * self.force_scale_a,
                 actions[:, 9:12] * self.torque_scale_a], -1)
        n = self.num_envs
        dof_pos = self.engine.dof_pos(sim)[:, self.franka_dofs]
        dof_vel = self.engine.dof_vel(sim)[:, self.franka_dofs]
        lf = jnp.zeros((n, 3))
        rf = jnp.zeros((n, 3))
        gt = jnp.broadcast_to(jnp.asarray(gripper_target, jnp.float32),
                              (n, 2)) if jnp.ndim(gripper_target) < 2 \
            else gripper_target
        tau9 = fc.compute_dof_torque(
            self.cfg_ctrl, dof_pos, dof_vel, ft_pos, ft_quat, lin, ang,
            J, M_arm, gt, target_pos, target_quat,
            target_contact_wrench=wrench,
            left_finger_force=lf, right_finger_force=rf)
        tau = jnp.zeros((n, self.engine.nv), jnp.float32)
        return tau.at[:, self.franka_dofs].set(tau9)

    def _gripper_target_rl(self):
        """Gripper dof target during RL steps (pick: open; screw: closed)."""
        return GRIPPER_WIDTH_MAX / 2

    def pre_physics(self, state: EnvState, actions: jax.Array) -> Control:
        self._actions = actions
        tau = self._apply_actions_as_ctrl_targets(
            state.sim, actions, self._gripper_target_rl())
        n = self.num_envs
        return Control(tau=tau,
                       pos_target=jnp.zeros((n, self.engine.nv), jnp.float32),
                       vel_target=jnp.zeros((n, self.engine.nv), jnp.float32))

    # -- resets ---------------------------------------------------------
    def _ik_to_random_gripper_pose(self, sim, key):
        """Jacobian-IK to a randomized fingertip pose (replaces the
        reference's 20-sim-step _randomize_gripper_pose :389)."""
        n = self.num_envs
        k1, k2 = jax.random.split(key)
        tp = jnp.asarray([0.0, 0.0, TABLE_HEIGHT]) + jnp.asarray(
            self.cfg_rand["fingertip_midpoint_pos_initial"])
        noise = jnp.asarray(self.cfg_rand["fingertip_midpoint_pos_noise"])
        target_pos = tp + noise * jax.random.uniform(
            k1, (n, 3), minval=-1.0, maxval=1.0)
        euler = jnp.asarray(self.cfg_rand["fingertip_midpoint_rot_initial"]) \
            + jnp.asarray(self.cfg_rand["fingertip_midpoint_rot_noise"]) \
            * jax.random.uniform(k2, (n, 3), minval=-1.0, maxval=1.0)
        target_quat = maths.quat_from_euler_xyz(
            euler[:, 0], euler[:, 1], euler[:, 2])

        def ik_step(sim_q, _):
            s = SimState(sim_q, jnp.zeros_like(self.engine.default_state(n).qd))
            J, _, ft_pos, ft_quat, _, _ = self._arm_readouts(s)
            pe, ae = fc.get_pose_error(ft_pos, ft_quat, target_pos,
                                       target_quat)
            dq = fc.get_delta_dof_pos(jnp.concatenate([pe, ae], -1),
                                      "dls", J)
            dof = self.engine.dof_pos(s)
            dof = dof.at[:, self.franka_dofs[:7]].add(0.5 * dq)
            return self.engine.set_dof_pos(s, dof).q, None

        q0 = self.engine.set_dof_pos(
            sim, self.engine.dof_pos(sim).at[:, self.franka_dofs].set(
                self.default_dof)).q
        qf, _ = jax.lax.scan(ik_step, q0, None, length=12)
        return qf

    def reset_idx(self, sim: SimState, task, mask, key):
        ks = jax.random.split(key, 4)

        # The randomized-gripper IK (12 iterations, each a full FK +
        # jacobian readout) runs under the masked-reset contract EVERY
        # step; factory episodes are lockstep (resets only at the horizon
        # or rare sim-health events), so gate the whole reset behind a
        # cond — it dominated the factory step otherwise (the "0.029M
        # regardless of batch size" scaling wall, bench_suite @1024 rows).
        def do_reset(sim):
            q_ik = self._ik_to_random_gripper_pose(sim, ks[0])
            q = jnp.where(mask[:, None], q_ik, sim.q)
            qd = jnp.where(mask[:, None], jnp.zeros_like(sim.qd), sim.qd)
            out = self._reset_objects(SimState(q, qd), mask, ks[1])
            return SimState(out.q, out.qd)   # lam dropped (both branches)

        # both branches drop warm-start lam — the pre-cond code rebuilt
        # SimState(q, qd) unconditionally and VecTaskBase.step restores it
        sim = jax.lax.cond(jnp.any(mask), do_reset,
                           lambda s: SimState(s.q, s.qd), sim)
        if hasattr(task, "lift_success"):
            task = task._replace(lift_success=jnp.where(
                mask, 0.0, task.lift_success))
        return sim, task

    def _reset_objects(self, sim, mask, key):
        return sim

    def initial_task_state(self):
        n = self.num_envs
        return FactoryTaskState(
            actions=jnp.zeros((n, self.num_actions), jnp.float32),
            lift_success=jnp.zeros(n, jnp.float32))

    # -- keypoints ------------------------------------------------------
    def _keypoints_from(self, pos, quat):
        off = jnp.asarray(self.keypoint_offsets)
        return pos[:, None, :] + maths.quat_apply(quat[:, None, :], off)


# ---------------------------------------------------------------------------
TASK_CFG_PICK = _base_cfg("FactoryTaskNutBoltPick", 20, 12, 100)
TASK_CFG_PLACE = _base_cfg("FactoryTaskNutBoltPlace", 27, 12, 200)
TASK_CFG_SCREW = _base_cfg("FactoryTaskNutBoltScrew", 32, 12, 8192)
# Per-task gripper gains from each reference yaml's ``all`` section — an
# order of magnitude softer than gym_default's 500/20 (a 500-gain squeeze
# ejects the 28 g nut; 50/2 closes at ~2 N and grips cleanly):
# FactoryTaskNutBoltPick.yaml:63-65 (50/2), Place (100/2), Screw (100/1 +
# ctrl_type operational_space_motion with z/yaw-only motion axes :74-77).
TASK_CFG_PICK["ctrl"]["all"] = {"jacobian_type": "geometric",
                                "gripper_prop_gains": [50.0, 50.0],
                                "gripper_deriv_gains": [2.0, 2.0]}
TASK_CFG_PLACE["ctrl"]["all"] = {"jacobian_type": "geometric",
                                 "gripper_prop_gains": [100.0, 100.0],
                                 "gripper_deriv_gains": [2.0, 2.0]}
TASK_CFG_SCREW["ctrl"]["all"] = {"jacobian_type": "geometric",
                                 "gripper_prop_gains": [100.0, 100.0],
                                 "gripper_deriv_gains": [1.0, 1.0]}
TASK_CFG_SCREW["rl"]["unidirectional_rot"] = True  # Screw yaml:29
TASK_CFG_SCREW["ctrl"]["ctrl_type"] = "operational_space_motion"
TASK_CFG_SCREW["ctrl"]["operational_space_motion"] = {
    "motion_ctrl_axes": [0, 0, 1, 0, 0, 1],
    "task_prop_gains": [1.0, 1, 1, 1, 1, 200.0],
    "task_deriv_gains": [1.0] * 6}
# screw starts GRASPING the nut atop the bolt: fixed arm pose, no gripper
# randomization (FactoryTaskNutBoltScrew.yaml:20, _reset_franka :173-181)
TASK_CFG_SCREW["randomize"]["franka_arm_initial_dof_pos"] = [
    1.5178e-03, -1.9651e-01, -1.4364e-03, -1.9761e+00, -2.7717e-04,
    1.7796e+00, 7.8556e-01]
TASK_CFG_SCREW["randomize"]["nut_rot_initial"] = 30.0
TASK_CFG = TASK_CFG_PICK


class FactoryTaskNutBoltPick(FactoryBase):
    """Pick the nut off the table (factory_task_nut_bolt_pick.py, 463 LoC)."""

    def _extra_parts(self):
        ob = ModelBuilder()
        ob.begin_actor()
        nut = ob.add_body("nut", -1, FREE,
                          body_pos=(0.0, -0.3, TABLE_HEIGHT + NUT_HEIGHT / 2))
        if self.use_mesh_sdf:
            # mesh-accurate hex nut: SDF target for the fingerpads, structured
            # corner/rim cloud as candidate points vs table and bolt (PhysX
            # SDF collisions, docs/factory.md §Collisions and Contacts)
            from ..models import meshes
            nv_, nt_ = meshes.hex_nut_mesh(NUT_WIDTH, NUT_HEIGHT, NUT_HOLE_R)
            cp = meshes.hex_nut_contact_points(NUT_WIDTH, NUT_HEIGHT,
                                               NUT_HOLE_R)
            # collision field: SOLID hex prism (no bore).  The nut's SDF is
            # only ever the fingerpads' target (nut-vs-table/bolt collide via
            # the contact-point cloud) and the bored wall is 3.5 mm thin —
            # the interior ridge flips the gradient and pads tunnel through;
            # mass/inertia still integrate the true bored solid.
            solid = meshes.cylinder_mesh(NUT_WIDTH / np.sqrt(3.0),
                                         NUT_HEIGHT / 2.0, n=6)
            ob.add_sdf_geom(nut, nv_, nt_, density=7850.0, friction=0.8,
                            resolution=40, contact_points=cp,
                            sdf_from=[solid], name="nut_geom")
        else:
            # hex nut approximated by its bounding box (across-flats width)
            ob.add_geom(nut, GEOM_BOX,
                        np.array([NUT_WIDTH / 2, NUT_WIDTH / 2,
                                  NUT_HEIGHT / 2]),
                        density=7850.0, friction=0.8, name="nut_geom")
        bb = ModelBuilder()
        bb.begin_actor()
        bolt = bb.add_body("bolt", -1, FIXED,
                           body_pos=(0.0, 0.0, TABLE_HEIGHT))
        if self.use_mesh_sdf:
            from ..models import meshes
            head, shank = meshes.bolt_mesh_parts(
                NUT_WIDTH, BOLT_HEAD_HEIGHT, BOLT_WIDTH / 2,
                BOLT_SHANK_LENGTH)
            bb.add_sdf_geom(bolt, head[0], head[1], friction=0.5,
                            resolution=64, union_with=[shank],
                            name="bolt_geom")
        else:
            bb.add_geom(bolt, GEOM_CYLINDER,
                        np.array([BOLT_WIDTH / 2,
                                  (BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH) / 2,
                                  0]),
                        pos=np.array([0, 0, (BOLT_HEAD_HEIGHT
                                             + BOLT_SHANK_LENGTH) / 2]),
                        friction=0.5, name="bolt_geom")
        return [(ob.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                (bb.finalize(), (0, 0, 0), (0, 0, 0, 1))]

    def _reset_objects(self, sim, mask, key):
        n = self.num_envs
        k1, k2 = jax.random.split(key)
        xy0 = jnp.asarray(self.cfg_rand["nut_pos_xy_initial"])
        noise = jnp.asarray(self.cfg_rand["nut_pos_xy_initial_noise"])
        xy = xy0 + noise * jax.random.uniform(k1, (n, 2), minval=-1.0,
                                              maxval=1.0)
        yaw = jax.random.uniform(k2, (n,), minval=-np.pi, maxval=np.pi)
        quat = maths.quat_from_angle_axis(yaw, jnp.asarray([0.0, 0, 1.0]))
        pose = jnp.concatenate(
            [xy, jnp.full((n, 1), TABLE_HEIGHT + NUT_HEIGHT / 2), quat], -1)
        m = self.model
        qa = int(m.q_adr[self.nut_body])
        va = int(m.v_adr[self.nut_body])
        q = sim.q.at[:, qa: qa + 7].set(
            masked_update(mask, pose, sim.q[:, qa: qa + 7]))
        qd = sim.qd.at[:, va: va + 6].set(
            masked_update(mask, jnp.zeros((n, 6)), sim.qd[:, va: va + 6]))
        return SimState(q, qd)

    def evaluate_lift(self, state: EnvState):
        """Scripted close-and-lift epilogue (ref _close_gripper/_lift_gripper
        :350-377): close the gripper, lift 0.3 m open-loop, then score
        lift success (nut > table + 3x nut height).  Jittable."""
        n = self.num_envs
        close_steps = int(self.cfg["env"].get("num_gripper_close_sim_steps",
                                              25))
        lift_steps = int(self.cfg["env"].get("num_gripper_lift_sim_steps", 25))

        phys = getattr(state, "phys", None)

        def phase(sim, actions6, gripper, length):
            def body(s, _):
                tau = self._apply_actions_as_ctrl_targets(
                    s, actions6, gripper, do_scale=False)
                ctrl = Control(
                    tau=tau,
                    pos_target=jnp.zeros((n, self.engine.nv), jnp.float32),
                    vel_target=jnp.zeros((n, self.engine.nv), jnp.float32))
                # thread per-env physics (DR) so the epilogue is scored
                # under the same dynamics as the episode
                s2, _ = self.engine.step(s, ctrl, phys=phys)
                return s2, None
            sim, _ = jax.lax.scan(body, sim, None, length=length)
            return sim

        still = jnp.zeros((n, 12))
        sim = phase(state.sim, still, 0.0, close_steps)
        lift = jnp.zeros((n, 12)).at[:, 2].set(0.3)
        sim = phase(sim, lift, 0.0, lift_steps)
        out = self.engine.forward(sim)
        nut_z = out.root_states[:, 2, 2]
        return (nut_z > TABLE_HEIGHT + NUT_HEIGHT * 3.0).astype(jnp.float32)

    def _nut_grasp_frame(self, out):
        """Grasp pose on the nut = the nut COM (ref _acquire_task_tensors
        :87-92: ``nut_grasp_heights = bolt_head_heights + nut_heights*0.5
        # nut COM`` — the reference nut ASSET origin sits bolt_head_height
        below the nut, see _reset_object :249 ``table_height -
        bolt_head_heights``, so that offset lands on the COM.  Our nut body
        origin IS the COM, so the local offset is zero.  Round 3 carried the
        reference's literal offset, planting the grasp target 22.5 mm above
        the nut — the scripted close grabbed air and post-fix lift success
        was 0.00."""
        nut = out.root_states[:, 2]
        pos = nut[:, 0:3]
        quat = maths.quat_mul(nut[:, 3:7],
                              jnp.asarray([0.0, 1.0, 0.0, 0.0]))
        return pos, quat

    def post_physics(self, state: EnvState, out, actions):
        n = self.num_envs
        task: FactoryTaskState = state.task
        ft_pos, ft_quat, ft_lin, ft_ang = self._fingertip_state(out)
        grasp_pos, grasp_quat = self._nut_grasp_frame(out)

        kp_gripper = self._keypoints_from(ft_pos, ft_quat)
        kp_nut = self._keypoints_from(grasp_pos, grasp_quat)
        kp_dist = jnp.sum(jnp.linalg.norm(kp_nut - kp_gripper, axis=-1), -1)
        action_penalty = jnp.linalg.norm(actions, axis=-1)
        reward = -kp_dist * self.cfg_rl["keypoint_reward_scale"] \
            - action_penalty * self.cfg_rl["action_penalty_scale"]

        is_last = state.progress >= self.max_episode_length - 1
        if self.cfg["env"].get("close_and_lift", True):
            # Reference semantics: lift success is scored AFTER the scripted
            # close-and-lift epilogue on the final episode step
            # (factory_task_nut_bolt_pick.py:144-203 — _close_gripper +
            # _lift_gripper in pre-physics of the last step, then
            # _check_lift_success(3.0)).  Episodes are lockstep (reset only
            # on timeout), so run the epilogue once per episode under a cond
            # — ~50 extra sim steps per 100-step episode only on that step.
            lift_success = jax.lax.cond(
                jnp.any(is_last),
                self.evaluate_lift,
                lambda s: jnp.zeros(n, jnp.float32),
                state)
            # Force-resets of unhealthy envs (base.py:301) can desync
            # progress; mask so only episode-final envs are scored and
            # mid-episode envs never bank an epilogue success.
            lift_success = lift_success * is_last.astype(jnp.float32)
        else:
            nut_z = out.root_states[:, 2, 2]
            lift_success = (nut_z > TABLE_HEIGHT + NUT_HEIGHT * 3.0).astype(
                jnp.float32)
        reward = reward + is_last.astype(jnp.float32) * lift_success \
            * self.cfg_rl["success_bonus"]
        reset = is_last.astype(jnp.int32)

        obs = jnp.concatenate([ft_pos, ft_quat, ft_lin, ft_ang,
                               grasp_pos, grasp_quat], -1)
        task = task._replace(actions=actions, lift_success=lift_success)
        n_last = jnp.sum(is_last.astype(jnp.float32))
        extras = {"successes": jnp.where(
            n_last > 0,
            jnp.sum(lift_success) / jnp.maximum(n_last, 1.0), 0.0)}
        return obs, None, reward, reset, task, extras


class FactoryTaskNutBoltPlace(FactoryTaskNutBoltPick):
    """Place the held nut onto the bolt tip
    (factory_task_nut_bolt_place.py, 463 LoC)."""

    def _gripper_target_rl(self):
        return 0.0  # gripper stays closed on the nut

    def _reset_objects(self, sim, mask, key):
        """Nut starts in the closed gripper (ref reset closes onto nut)."""
        n = self.num_envs
        out = self.engine.forward(sim)
        ft_pos, ft_quat, _, _ = self._fingertip_state(out)
        grip_quat = maths.quat_mul(ft_quat, jnp.asarray([0.0, 1.0, 0, 0]))
        pose = jnp.concatenate([ft_pos, grip_quat], -1)
        m = self.model
        qa = int(m.q_adr[self.nut_body])
        va = int(m.v_adr[self.nut_body])
        q = sim.q.at[:, qa: qa + 7].set(
            masked_update(mask, pose, sim.q[:, qa: qa + 7]))
        # fingers closed to the nut width
        dof = self.engine.dof_pos(SimState(q, sim.qd))
        half = NUT_WIDTH / 2
        dof = dof.at[:, self.franka_dofs[7:9]].set(
            masked_update(mask, jnp.full((n, 2), half),
                          dof[:, self.franka_dofs[7:9]]))
        sim2 = self.engine.set_dof_pos(SimState(q, sim.qd), dof)
        qd = sim2.qd.at[:, va: va + 6].set(
            masked_update(mask, jnp.zeros((n, 6)), sim2.qd[:, va: va + 6]))
        return SimState(sim2.q, qd)

    def post_physics(self, state: EnvState, out, actions):
        n = self.num_envs
        task: FactoryTaskState = state.task
        ft_pos, ft_quat, ft_lin, ft_ang = self._fingertip_state(out)
        nut = out.root_states[:, 2]
        bolt = out.root_states[:, 3]
        # target: nut centered on the bolt tip
        bolt_tip = bolt[:, 0:3] + jnp.asarray(
            [0.0, 0.0, BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH], jnp.float32)
        ident = jnp.tile(jnp.asarray([0.0, 0, 0, 1.0]), (n, 1))
        kp_nut = self._keypoints_from(nut[:, 0:3], nut[:, 3:7])
        kp_target = self._keypoints_from(bolt_tip, ident)
        kp_dist = jnp.sum(jnp.linalg.norm(kp_target - kp_nut, axis=-1), -1)
        action_penalty = jnp.linalg.norm(actions, axis=-1)
        reward = -kp_dist * self.cfg_rl["keypoint_reward_scale"] \
            - action_penalty * self.cfg_rl["action_penalty_scale"]

        is_last = state.progress >= self.max_episode_length - 1
        close = (jnp.linalg.norm(nut[:, 0:3] - bolt_tip, axis=-1)
                 < 0.01).astype(jnp.float32)
        reward = reward + is_last.astype(jnp.float32) * close \
            * self.cfg_rl["success_bonus"]
        reset = is_last.astype(jnp.int32)
        obs = jnp.concatenate([ft_pos, ft_quat, ft_lin, ft_ang,
                               nut[:, 0:3], nut[:, 3:7],
                               bolt[:, 0:3], bolt[:, 3:7]], -1)
        task = task._replace(actions=actions, lift_success=close)
        extras = {"successes": jnp.where(jnp.any(is_last), jnp.mean(close),
                                         0.0)}
        return obs, None, reward, reset, task, extras


class FactoryTaskNutBoltScrew(FactoryBase):
    """Screw the nut down the bolt (factory_task_nut_bolt_screw.py, 386 LoC).

    The nut rides a SCREW joint (pitch 0.002 m/rev) anchored to the bolt
    axis — rotating the nut translates it down the shank exactly as the
    thread geometry would."""

    nut_free = False

    def build_engine(self, model, ground):
        """Inverted grip pairs: nut corner/rim points vs the pad-face box
        SDFs, so every grip normal is the pad normal (see _extra_parts)."""
        names = [g.name for g in model.geoms]
        nut_geom = names.index("nut_geom")
        pairs = [(nut_geom, names.index(f"padbox_panda_{s}finger"))
                 for s in ("left", "right")]
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs)

    def _gripper_target_rl(self):
        return 0.0

    def _extra_parts(self):
        bb = ModelBuilder()
        bb.begin_actor()
        bolt = bb.add_body("bolt", -1, FIXED,
                           body_pos=(0.0, 0.0, TABLE_HEIGHT))
        bb.add_geom(bolt, GEOM_CYLINDER,
                    np.array([BOLT_WIDTH / 2,
                              (BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH) / 2, 0]),
                    pos=np.array([0, 0,
                                  (BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH) / 2]),
                    friction=0.3, contact=False, name="bolt_geom")
        # nut on the screw joint: +q rotates clockwise and descends.
        # Start: nut BOTTOM flush with the shank tip, COM at table + shank +
        # bolt_head + nut/2 = 0.4475 (ref _reset_object :202-211 root z =
        # table + shank_length with the asset origin bolt_head below the
        # COM).  Round-4 started the COM at the shank tip — 6.5 mm lower —
        # which burned 9 of the 15.3 mm slip-guard budget at reset against
        # the reference-tuned fixed grasp arm pose.
        # Travel: down to seated on the bolt head (COM at head + nut/2) =
        # full shank length = 12.5 revolutions.
        travel = BOLT_SHANK_LENGTH
        nut = bb.add_body(
            "nut", bolt, SCREW, jnt_axis=(0, 0, -1.0),
            jnt_pitch=THREAD_PITCH,
            body_pos=(0.0, 0.0, BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH
                      + NUT_HEIGHT * 0.5),
            limit_lower=[0.0],
            limit_upper=[2 * np.pi * travel / THREAD_PITCH],
            damping=0.02)
        if self.use_mesh_sdf:
            # INVERTED contact representation for the spinning grip: the
            # nut carries its corner/flat-rim candidate cloud and collides
            # against analytic BOX SDFs on the fingerpads (build_engine
            # below).  With points-on-pads vs the hex SDF, the contact
            # normal came from the hex gradient: +-30 degree swings per flat
            # and a 60-degree flip at every corner passage (~20/s while
            # spinning) laterally kicked the hand — which has NO control
            # authority in x/y under the Screw OSC — past the 15.3 mm slip
            # guard every ~200 steps (a smooth-cylinder proxy was worse: a
            # convex body pinched between point pads is an unstable
            # marble-squirt equilibrium).  Points-on-nut vs the pad PLANE
            # makes every grip normal the pad face normal — pure squeeze,
            # zero lateral bias — which is exactly the reference's
            # plane-pad-on-flat mesh behavior (scripts/probe_screw_descent).
            from ..models import meshes
            nv_, nt_ = meshes.hex_nut_mesh(NUT_WIDTH, NUT_HEIGHT, NUT_HOLE_R)
            cp = meshes.hex_nut_contact_points(NUT_WIDTH, NUT_HEIGHT,
                                               NUT_HOLE_R)
            # mid-height corner/flat rings: the rim rings sit at the pad
            # box's z-edges (where box-SDF normals tilt); mid-height points
            # stay on the clean face and carry the grip with pure +-y
            # normals
            mid = np.concatenate([
                meshes._ring(NUT_WIDTH / np.sqrt(3.0), 0.0, 6),
                meshes._ring(NUT_WIDTH / 2.0, 0.0, 6, np.pi / 6)])
            cp = np.concatenate([cp, mid.astype(np.float32)])
            solid = meshes.cylinder_mesh(NUT_WIDTH / np.sqrt(3.0),
                                         NUT_HEIGHT / 2.0, n=6)
            bb.add_sdf_geom(nut, nv_, nt_, density=7850.0, friction=0.8,
                            resolution=40, contact_points=cp,
                            sdf_from=[solid], name="nut_geom")
        else:
            bb.add_geom(nut, GEOM_BOX,
                        np.array([NUT_WIDTH / 2, NUT_WIDTH / 2,
                                  NUT_HEIGHT / 2]),
                        density=7850.0, friction=0.8, name="nut_geom")
        return [(bb.finalize(), (0, 0, 0), (0, 0, 0, 1))]

    def reset_idx(self, sim: SimState, task, mask, key):
        """Screw reset (ref _reset_franka :173-181): the arm goes to the
        FIXED grasp pose over the bolt — no gripper-pose randomization (the
        base class's random IK left the gripper 20 cm from the nut and the
        ``slipped`` guard ended every episode at step 1) — with a 1.1x
        nut-half-width finger buffer to avoid initial contact."""
        n = self.num_envs
        arm = jnp.asarray(self.cfg_rand["franka_arm_initial_dof_pos"],
                          jnp.float32)
        dof9 = jnp.concatenate([
            jnp.broadcast_to(arm, (n, 7)),
            jnp.full((n, 2), NUT_WIDTH / 2 * 1.1)], -1)
        dof = self.engine.dof_pos(sim)
        dof = dof.at[:, self.franka_dofs].set(
            masked_update(mask, dof9, dof[:, self.franka_dofs]))
        sim = self.engine.set_dof_pos(sim, dof)
        qd = jnp.where(mask[:, None], jnp.zeros_like(sim.qd), sim.qd)
        sim = self._reset_objects(SimState(sim.q, qd), mask, key)
        if hasattr(task, "lift_success"):
            task = task._replace(lift_success=jnp.where(
                mask, 0.0, task.lift_success))
        return sim, task

    def _reset_objects(self, sim, mask, key):
        """Nut starts at the top of the shank, rotated nut_rot_initial."""
        m = self.model
        qa = int(m.q_adr[self.nut_body])
        va = int(m.v_adr[self.nut_body])
        # SCREW joint coordinate: +q descends; nut_rot_initial (deg) of
        # pre-engagement (ref _reset_object :195-200)
        q0 = float(np.radians(self.cfg_rand.get("nut_rot_initial", 0.0)))
        q = sim.q.at[:, qa].set(jnp.where(mask, q0, sim.q[:, qa]))
        qd = sim.qd.at[:, va].set(jnp.where(mask, 0.0, sim.qd[:, va]))
        return SimState(q, qd)

    def post_physics(self, state: EnvState, out, actions):
        n = self.num_envs
        task: FactoryTaskState = state.task
        ft_pos, ft_quat, ft_lin, ft_ang = self._fingertip_state(out)
        nut_pos = out.body_pos[:, self.nut_body]
        nut_quat = out.body_quat[:, self.nut_body]
        nut_vel = out.body_vel[:, self.nut_body]
        target = jnp.asarray(
            [0.0, 0.0, TABLE_HEIGHT + BOLT_HEAD_HEIGHT + NUT_HEIGHT * 0.5],
            jnp.float32)
        dist_to_target = jnp.linalg.norm(target - nut_pos, axis=-1)

        # 4-point axis-keypoint distances (ref _get_keypoint_dist :289-339):
        # endpoints + 1/3 + 2/3 along a hand+finger-length axis.
        axis_len = FRANKA_HAND_LENGTH + FRANKA_FINGER_LENGTH
        fracs = jnp.asarray([0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0])[None, :, None]

        def axis_kp_dist(p1, p2, t1, t2):
            kp = p1[:, None, :] + (p2 - p1)[:, None, :] * fracs
            kt = t1[:, None, :] + (t2 - t1)[:, None, :] * fracs
            return jnp.sum(jnp.linalg.norm(kt - kp, axis=-1), -1)

        up = jnp.asarray([0.0, 0.0, axis_len], jnp.float32)
        targ_n = jnp.broadcast_to(target, (n, 3))
        # body='nut': nut axis (COM -> +local z * L) vs target axis
        nut_kp_dist = axis_kp_dist(
            nut_pos, nut_pos + maths.quat_apply(nut_quat, up),
            targ_n, targ_n + up)
        # fingerpad midpoint = finger-origin midpoint translated along the
        # hand z to the pad centers (ref _refresh_task_tensors :96-99 —
        # using the raw finger origins put the "slip" point 5 cm above the
        # pads and ended every episode at step 1)
        pad_off = maths.quat_apply(
            out.body_quat[:, self.hand_body],
            jnp.asarray([0.0, 0.0, FRANKA_FINGER_LENGTH
                         - FRANKA_FINGERPAD_LENGTH * 0.5], jnp.float32))
        pad_mid = 0.5 * (out.body_pos[:, self.lf_body]
                         + out.body_pos[:, self.rf_body]) + pad_off
        finger_nut_dist = jnp.linalg.norm(pad_mid - nut_pos, axis=-1)
        # body='finger_nut': fingerpad axis (pad midpoint -> -fingertip local
        # z * L, i.e. back up the hand) vs the nut's +z axis
        ft_down = maths.quat_apply(ft_quat, -up)
        finger_nut_kp_dist = axis_kp_dist(
            pad_mid, pad_mid + ft_down,
            nut_pos, nut_pos + maths.quat_apply(nut_quat, up))

        action_penalty = jnp.linalg.norm(actions, axis=-1)
        success = dist_to_target < THREAD_PITCH
        reward = -(nut_kp_dist + finger_nut_kp_dist) \
            * self.cfg_rl["keypoint_reward_scale"] \
            - action_penalty * self.cfg_rl["action_penalty_scale"] \
            + success.astype(jnp.float32) * self.cfg_rl["success_bonus"]

        expired = state.progress >= self.max_episode_length - 1
        far = dist_to_target > self.cfg_rl["far_error_thresh"]
        slipped = finger_nut_dist > (FRANKA_FINGERPAD_LENGTH * 0.5
                                     + NUT_HEIGHT * 0.5)
        reset = (success | expired | (far & ~success)
                 | (slipped & ~success)).astype(jnp.int32)

        obs = jnp.concatenate([
            ft_pos, ft_quat, ft_lin, ft_ang,
            nut_pos, nut_quat, nut_vel[:, 3:6], nut_vel[:, 0:3],
            out.sensor_forces[:, 0, 0:3], out.sensor_forces[:, 1, 0:3]], -1)
        task = task._replace(actions=actions,
                             lift_success=success.astype(jnp.float32))
        extras = {"successes": jnp.mean(success.astype(jnp.float32))}
        return obs, None, reward, reset, task, extras


TASK_CFGS = {
    "FactoryTaskNutBoltPick": TASK_CFG_PICK,
    "FactoryTaskNutBoltPlace": TASK_CFG_PLACE,
    "FactoryTaskNutBoltScrew": TASK_CFG_SCREW,
}


# ---------------------------------------------------------------------------
# Gears / Insertion scenes: the reference ships these as policy-less scene
# playgrounds (factory_task_gears.py / factory_task_insertion.py — reward and
# reset hooks are `pass`; docs/rl_examples.md "no trained policies provided").
TASK_CFG_GEARS = _base_cfg("FactoryTaskGears", 32, 12, 1024)
TASK_CFG_INSERT = _base_cfg("FactoryTaskInsertion", 32, 12, 1024)
for _c in (TASK_CFG_GEARS, TASK_CFG_INSERT):
    # FactoryTaskGears/Insertion.yaml ``all``: gripper 500/2
    _c["ctrl"]["all"] = {"jacobian_type": "geometric",
                         "gripper_prop_gains": [500.0, 500.0],
                         "gripper_deriv_gains": [2.0, 2.0]}


class FactoryTaskGears(FactoryBase):
    """Gear-assembly scene (factory_task_gears.py, 302 LoC): base plate with
    two shafts + medium gear as the manipulated free body."""

    def _extra_parts(self):
        bb = ModelBuilder()
        bb.begin_actor()
        base = bb.add_body("gear_base", -1, FIXED,
                           body_pos=(0.0, 0.0, TABLE_HEIGHT))
        # base plate + two shafts (factory_asset_info_gears.yaml)
        bb.add_geom(base, GEOM_BOX, np.array([0.05, 0.03, 0.0025]),
                    pos=np.array([0, 0, 0.0025]), name="gear_base_geom")
        for i, dx in enumerate((-0.025, 0.025)):
            bb.add_geom(base, GEOM_CYLINDER, np.array([0.003, 0.025, 0]),
                        pos=np.array([dx, 0, 0.03]), contact=False,
                        name=f"shaft{i}")
        ob = ModelBuilder()
        ob.begin_actor()
        gear = ob.add_body("nut", -1, FREE,  # manipulated object slot
                           body_pos=(0.0, -0.2, TABLE_HEIGHT + 0.01))
        # box contact proxy (the engine samples contact points from
        # sphere/capsule/box geoms; cylinders serve as SDF targets only)
        ob.add_geom(gear, GEOM_BOX, np.array([0.035, 0.035, 0.01]),
                    density=1200.0, friction=0.8, name="nut_geom")
        return [(bb.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                (ob.finalize(), (0, 0, 0), (0, 0, 0, 1))]

    def _reset_objects(self, sim, mask, key):
        n = self.num_envs
        xy = jnp.asarray([0.0, -0.2]) + 0.05 * jax.random.uniform(
            key, (n, 2), minval=-1.0, maxval=1.0)
        pose = jnp.concatenate(
            [xy, jnp.full((n, 1), TABLE_HEIGHT + 0.012),
             jnp.tile(jnp.asarray([0.0, 0, 0, 1.0]), (n, 1))], -1)
        m = self.model
        qa = int(m.q_adr[self.nut_body])
        va = int(m.v_adr[self.nut_body])
        q = sim.q.at[:, qa: qa + 7].set(
            masked_update(mask, pose, sim.q[:, qa: qa + 7]))
        qd = sim.qd.at[:, va: va + 6].set(
            masked_update(mask, jnp.zeros((n, 6)), sim.qd[:, va: va + 6]))
        return SimState(q, qd)

    def post_physics(self, state: EnvState, out, actions):
        n = self.num_envs
        ft_pos, ft_quat, ft_lin, ft_ang = self._fingertip_state(out)
        obj = out.root_states[:, 2]
        obs = jnp.concatenate([ft_pos, ft_quat, ft_lin, ft_ang,
                               obj[:, 0:13]], -1)
        obs = jnp.pad(obs, ((0, 0), (0, self.num_obs - obs.shape[-1])))
        reward = jnp.zeros(n)  # ref _update_rew_buf is a no-op
        reset = (state.progress >= self.max_episode_length - 1).astype(
            jnp.int32)
        task = state.task._replace(actions=actions)
        return obs, None, reward, reset, task, {}


class FactoryTaskInsertion(FactoryTaskGears):
    """Peg-in-hole scene (factory_task_insertion.py, 295 LoC): round peg as
    the manipulated body, socket fixed on the table."""

    def _extra_parts(self):
        bb = ModelBuilder()
        bb.begin_actor()
        sock = bb.add_body("socket", -1, FIXED,
                           body_pos=(0.0, 0.0, TABLE_HEIGHT))
        # 8mm round socket block (factory_asset_info_insertion.yaml)
        bb.add_geom(sock, GEOM_BOX, np.array([0.015, 0.015, 0.0125]),
                    pos=np.array([0, 0, 0.0125]), name="socket_geom")
        ob = ModelBuilder()
        ob.begin_actor()
        peg = ob.add_body("nut", -1, FREE,
                          body_pos=(0.0, -0.2, TABLE_HEIGHT + 0.025))
        ob.add_geom(peg, GEOM_BOX, np.array([0.004, 0.004, 0.025]),
                    density=7850.0, friction=0.8, name="nut_geom")
        return [(bb.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                (ob.finalize(), (0, 0, 0), (0, 0, 0, 1))]


TASK_CFGS.update({
    "FactoryTaskGears": TASK_CFG_GEARS,
    "FactoryTaskInsertion": TASK_CFG_INSERT,
})
