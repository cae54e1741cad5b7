"""IndustReal tasks (reference tasks/industreal/, ~3.7 kLoC):
IndustRealTaskPegsInsert + IndustRealTaskGearsInsert with the three
IndustReal algorithms (industreal_algo_utils.py, 562 LoC):

* **SAPU** (:49-200) — interpenetration-aware reward scaling.  The reference
  samples plug-mesh points and queries socket meshes through NVIDIA Warp;
  here the plug's sampled surface points are queried against an *analytic*
  socket-material SDF (block minus hole = ``max(sdf_box, -sdf_hole)``), so
  the same weight/filter rule runs entirely inside XLA: envs with
  interpenetration <= thresh scale reward by ``1 - tanh(d/thresh)``, envs
  above keep their previous reward.
* **SDF-based dense reward** (:202-283) — mean distance of the plug's
  sampled points to the plug-at-goal isosurface (analytic cylinder/gear
  SDF), ``reward = -log(mean_dist)`` scaled by ``sdf_reward_scale``.
* **SBC** sampling-based curriculum (:284-334) — per-episode max initial
  downward displacement adapts to the insertion success rate between
  ``curriculum_height_bound``; the end-of-episode reward is shrunk/grown by
  the curriculum stage scale.

Success checking (:346-510): engaged = plug base below socket top AND
keypoints close; inserted = plug near assembled height AND close; the
engagement bonus scales with closeness to full insertion.

Scene: Franka (gravity-free, factory-style controllers from
ops/controllers.py) rigidly holding the plug via a grab constraint (the
closed gripper), socket fixed on the table with a 4-box rim so the plug can
physically enter the hole.  Actions are 6-dim pose deltas (no gripper).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import FIXED, FREE, GEOM_BOX, GEOM_CYLINDER, Geom, \
    ModelBuilder
from ..ops import controllers as fc
from ..ops import maths
from ..physics.engine import Control, PhysicsEngine, SimState
from .base import EnvState, masked_update
from .factory import FactoryBase, TABLE_HEIGHT, _base_cfg

# 8mm round peg / socket (factory_asset_info_insertion.yaml round_peg_8mm)
PLUG_RADIUS = 0.004
PLUG_LENGTH = 0.050
SOCKET_HALF = np.array([0.0145, 0.0145, 0.0125])   # socket block half-extents
SOCKET_HOLE_R = 0.0042
SOCKET_BASE_HEIGHT = 0.003
SOCKET_POS = np.array([0.0, 0.0, TABLE_HEIGHT], np.float32)

# gear/shaft (factory_asset_info_gears.yaml)
GEAR_RADIUS = 0.04
GEAR_HEIGHT = 0.020
SHAFT_RADIUS = 0.003
SHAFT_HEIGHT = 0.050
GEAR_HOLE_R = 0.0032


def _cfg_insert(name):
    cfg = _base_cfg(name, 24, 6, 256)
    cfg["rl"].update({
        "interpen_thresh": 0.001,
        "sdf_reward_scale": 10.0,
        "initial_max_disp": 0.01,
        "curriculum_success_thresh": 0.75,
        "curriculum_failure_thresh": 0.5,
        "curriculum_height_step": [-0.005, 0.003],
        "curriculum_height_bound": [-0.01, 0.01],
        "close_error_thresh": 0.15,
        "success_height_thresh": 0.003,
        "engagement_bonus": 10.0,
        "max_episode_length": 256,
    })
    cfg["env"]["socket_base_height"] = SOCKET_BASE_HEIGHT
    cfg["env"]["numObservations"] = 24
    cfg["env"]["numActions"] = 6
    # IndustReal policies run task-space impedance control
    cfg["ctrl"]["ctrl_type"] = "task_space_impedance"
    # IndustRealTaskPegsInsert.yaml: mode section has no gripper gains —
    # they come from ``all`` (500/2, an order softer derivative than
    # gym_default's 500/20)
    cfg["ctrl"]["all"] = {"jacobian_type": "geometric",
                          "gripper_prop_gains": [500.0, 500.0],
                          "gripper_deriv_gains": [2.0, 2.0]}
    cfg["ctrl"]["task_space_impedance"] = {
        "motion_ctrl_axes": [1, 1, 1, 1, 1, 1],
        "task_prop_gains": [300.0, 300.0, 300.0, 50.0, 50.0, 50.0],
        "task_deriv_gains": [34.0, 34.0, 34.0, 1.4, 1.4, 1.4]}
    return cfg


# -- analytic SDFs (the Warp mesh-query replacements) -----------------------
def sdf_cylinder(p, radius, half_h):
    """Signed distance to a z-axis cylinder at the origin (negative inside)."""
    d_r = jnp.linalg.norm(p[..., 0:2], axis=-1) - radius
    d_z = jnp.abs(p[..., 2]) - half_h
    outside = jnp.sqrt(jnp.maximum(d_r, 0.0) ** 2 + jnp.maximum(d_z, 0.0) ** 2)
    inside = jnp.minimum(jnp.maximum(d_r, d_z), 0.0)
    return outside + inside


def sdf_box(p, half):
    q = jnp.abs(p) - jnp.asarray(half)
    outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside


def sdf_socket_material(p):
    """Socket block minus the hole: the solid the plug must not penetrate."""
    centered = p - jnp.asarray([0.0, 0.0, SOCKET_HALF[2]])
    box = sdf_box(centered, SOCKET_HALF)
    hole = sdf_cylinder(centered, SOCKET_HOLE_R, SOCKET_HALF[2] + 1e-3)
    return jnp.maximum(box, -hole)


def _plug_sample_points(n_side=6, n_ring=8):
    """Static surface samples on the peg (the Warp sampled-points analog)."""
    zs = np.linspace(-PLUG_LENGTH / 2, PLUG_LENGTH / 2, n_side)
    th = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    pts = [[PLUG_RADIUS * np.cos(t), PLUG_RADIUS * np.sin(t), z]
           for z in zs for t in th]
    pts += [[0, 0, -PLUG_LENGTH / 2], [0, 0, PLUG_LENGTH / 2]]
    return np.asarray(pts, np.float32)


class IndustRealTaskState(NamedTuple):
    actions: jax.Array
    prev_rew: jax.Array        # (N,) SAPU filter memory
    curr_max_disp: jax.Array   # scalar — SBC stage
    insert_success: jax.Array  # (N,)
    ep_success_rate: jax.Array  # scalar — rolling per-episode success


class IndustRealTaskPegsInsert(FactoryBase):
    """Peg-into-socket with SAPU + SDF reward + SBC
    (industreal_task_pegs_insert.py, ~850 LoC)."""

    nut_free = True

    def __init__(self, cfg):
        self._samples = self._sample_points()
        # mesh-SDF path (default): bake the socket material and the
        # plug-at-goal isosurface into voxel grids with the native voxelizer
        # — the direct analog of the reference's Warp mesh queries (SAPU,
        # industreal_algo_utils.py:49-157) and pysdf reward (:202-283).
        # use_mesh_sdf=False falls back to the analytic primitive SDFs.
        self.use_mesh_sdf = bool(cfg.get("env", {}).get("use_mesh_sdf", True))
        if self.use_mesh_sdf:
            from ..physics import sdf_grid
            sv, stt = self._material_solid_mesh()
            self._socket_grid = sdf_grid.from_mesh(sv, stt, resolution=56)
            pv, ptt = self._goal_solid_mesh()
            self._goal_grid = sdf_grid.from_mesh(pv, ptt, resolution=48)
        super().__init__(cfg)
        self.plug_body = self.nut_body   # FactoryBase resolves "nut"
        self.socket_actor = 3            # franka, table, plug, socket
        self.interpen_thresh = float(self.cfg_rl["interpen_thresh"])
        self.sdf_scale = float(self.cfg_rl["sdf_reward_scale"])
        self.close_thresh = float(self.cfg_rl["close_error_thresh"])
        self.success_h = float(self.cfg_rl["success_height_thresh"])
        self.engagement_bonus = float(self.cfg_rl["engagement_bonus"])
        self.h_bound = tuple(self.cfg_rl["curriculum_height_bound"])
        self.h_step = tuple(self.cfg_rl["curriculum_height_step"])
        self.succ_thresh = float(self.cfg_rl["curriculum_success_thresh"])
        self.fail_thresh = float(self.cfg_rl["curriculum_failure_thresh"])

    # -- scene ----------------------------------------------------------
    def _extra_parts(self):
        ob = ModelBuilder()
        ob.begin_actor()
        plug = ob.add_body(
            "nut", -1, FREE,
            body_pos=(0.0, 0.0,
                      TABLE_HEIGHT + SOCKET_HALF[2] * 2 + PLUG_LENGTH / 2))
        if self.use_mesh_sdf:
            # round peg as a baked mesh: SDF pad target + structured rim
            # rings as candidate points vs the socket material
            from ..models import meshes
            pv, pt = meshes.cylinder_mesh(PLUG_RADIUS, PLUG_LENGTH / 2, n=24)
            cp = meshes.cylinder_contact_points(PLUG_RADIUS, PLUG_LENGTH / 2,
                                                n_ring=8, n_rows=3)
            ob.add_sdf_geom(plug, pv, pt, density=7850.0, friction=0.5,
                            resolution=40, contact_points=cp, name="nut_geom")
        else:
            ob.add_geom(plug, GEOM_BOX,
                        np.array([PLUG_RADIUS, PLUG_RADIUS, PLUG_LENGTH / 2]),
                        density=7850.0, friction=0.5, name="nut_geom")
        sb = ModelBuilder()
        sb.begin_actor()
        sock = sb.add_body("socket", -1, FIXED, body_pos=SOCKET_POS)
        h = SOCKET_HALF
        if self.use_mesh_sdf:
            # the real socket solid (block minus bore) as one GEOM_SDF
            # collision target — the same mesh the SAPU/Warp-analog reward
            # queries, now also what the peg physically collides with
            from ..models import meshes
            sv, stt = meshes.box_with_hole_mesh(h[:2], h[2], SOCKET_HOLE_R,
                                                n=64)
            sb.add_sdf_geom(sock, sv, stt, pos=np.array([0.0, 0.0, h[2]]),
                            friction=0.3, resolution=72, name="socket_sdf")
        else:
            rim = (h[0] - SOCKET_HOLE_R) / 2
            off = SOCKET_HOLE_R + rim
            # 4-box rim around the hole so the plug can physically enter
            for i, (dx, dy, hx, hy) in enumerate((
                    (off, 0, rim, h[1]), (-off, 0, rim, h[1]),
                    (0, off, SOCKET_HOLE_R, rim),
                    (0, -off, SOCKET_HOLE_R, rim))):
                sb.add_geom(sock, GEOM_BOX, np.array([hx, hy, h[2]]),
                            pos=np.array([dx, dy, h[2]]), friction=0.3,
                            name=f"socket_rim{i}")
        return [(ob.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                (sb.finalize(), (0, 0, 0), (0, 0, 0, 1))]

    def build_engine(self, model, ground):
        names = [g.name for g in model.geoms]
        nut_geom = names.index("nut_geom")
        pairs = [(names.index(pn), nut_geom) for pn in names
                 if pn.startswith("pad_")]
        # fingers collide with the tabletop (FactoryBase parity — this
        # override dropped it): without a floor under the hand the policy
        # dives THROUGH the table, drags the grab-held plug into deep
        # socket interpenetration, and freezes the SAPU reward at its
        # pre-violation value forever (a training run reached reward
        # 2900 with plugs at z=0)
        table = names.index("table_top")
        pairs += [(names.index(pn), table) for pn in names
                  if pn.startswith("pad_")]
        if "socket_sdf" in names:
            pairs.append((nut_geom, names.index("socket_sdf")))
        else:
            pairs += [(nut_geom, names.index(f"socket_rim{i}"))
                      for i in range(4)]
        if "shaft_geom" in names and self.use_mesh_sdf:
            # gears scene: the real gear has a bore, so its rim points can
            # ride the shaft (analytic cylinder target — exact SDF)
            pairs.append((nut_geom, names.index("shaft_geom")))
        pairs.append((nut_geom, names.index("table_top")))
        # rigid grasp: grip site holds the plug top (closed gripper)
        grabs = [(model.body_names.index("panda_grip_site"), (0.0, 0.0, 0.0),
                  model.body_names.index("nut"),
                  (0.0, 0.0, PLUG_LENGTH / 2))]
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs, grabs=grabs)

    def initial_task_state(self):
        n = self.num_envs
        return IndustRealTaskState(
            actions=jnp.zeros((n, self.num_actions), jnp.float32),
            prev_rew=jnp.zeros(n, jnp.float32),
            curr_max_disp=jnp.asarray(self.cfg_rl["initial_max_disp"],
                                      jnp.float32),
            insert_success=jnp.zeros(n, jnp.float32),
            ep_success_rate=jnp.zeros((), jnp.float32))

    # -- geometry helpers ----------------------------------------------
    def _socket_frame(self):
        return jnp.asarray(SOCKET_POS, jnp.float32)

    def _goal_pos(self):
        """Assembled plug center (bottom at the socket base)."""
        return self._socket_frame() + jnp.asarray(
            [0.0, 0.0, SOCKET_BASE_HEIGHT + PLUG_LENGTH / 2])

    def _plug_points_world(self, pos, quat):
        return pos[:, None, :] + maths.quat_apply(
            quat[:, None, :], jnp.asarray(self._samples))

    def _sample_points(self):
        return _plug_sample_points()

    def _material_solid_mesh(self):
        """Mesh of the solid the held part must not penetrate, in the
        ``pts - socket_frame`` query frame."""
        from ..models import meshes
        sv, stt = meshes.box_with_hole_mesh(
            SOCKET_HALF[:2], SOCKET_HALF[2], SOCKET_HOLE_R, n=64)
        return sv + np.asarray([0.0, 0.0, SOCKET_HALF[2]], np.float32), stt

    def _goal_solid_mesh(self):
        """Mesh of the assembled plug (for the goal-isosurface grid)."""
        from ..models import meshes
        return meshes.cylinder_mesh(PLUG_RADIUS, PLUG_LENGTH / 2, n=48)

    def _sapu_interpen(self, pos, quat):
        pts = self._plug_points_world(pos, quat)          # (N, P, 3)
        rel = pts - self._socket_frame()
        if self.use_mesh_sdf:
            from ..physics import sdf_grid
            sdf = sdf_grid.sample(self._socket_grid, rel)
        else:
            sdf = sdf_socket_material(rel)
        return jnp.maximum(-sdf, 0.0).max(-1)             # max penetration

    def _sdf_reward(self, pos, quat):
        pts = self._plug_points_world(pos, quat)
        goal = self._goal_pos()
        rel = pts - goal
        if self.use_mesh_sdf:
            from ..physics import sdf_grid
            d = jnp.maximum(sdf_grid.sample(self._goal_grid, rel), 0.0)
        else:
            d = jnp.maximum(
                sdf_cylinder(rel, PLUG_RADIUS, PLUG_LENGTH / 2), 0.0)
        return -jnp.log(jnp.maximum(jnp.mean(d, -1), 1e-6))

    # -- control: grab is always active --------------------------------
    def pre_physics(self, state: EnvState, actions: jax.Array) -> Control:
        act12 = jnp.concatenate(
            [actions, jnp.zeros((self.num_envs, 6))], -1)
        ctrl = super().pre_physics(state, act12)
        return ctrl._replace(
            grab_active=jnp.ones((self.num_envs, 1), jnp.float32))

    def _gripper_target_rl(self):
        return 0.0

    # -- reset with SBC -------------------------------------------------
    def _reset_objects(self, sim, mask, key):
        n = self.num_envs
        ks = jax.random.split(key, 3)
        xy = 0.002 * jax.random.uniform(ks[0], (n, 2), minval=-1, maxval=1)
        # SBC: downward displacement from the engagement height, up to
        # curr_max_disp (positive = deeper = easier)
        disp = self._sbc_disp(ks[1], n)
        top_z = TABLE_HEIGHT + SOCKET_HALF[2] * 2
        z = top_z + PLUG_LENGTH / 2 - disp
        pose = jnp.concatenate(
            [xy + self._socket_frame()[0:2], z[:, None],
             jnp.tile(jnp.asarray([0.0, 0, 0, 1.0]), (n, 1))], -1)
        m = self.model
        qa = int(m.q_adr[self.plug_body])
        va = int(m.v_adr[self.plug_body])
        q = sim.q.at[:, qa: qa + 7].set(
            masked_update(mask, pose, sim.q[:, qa: qa + 7]))
        qd = sim.qd.at[:, va: va + 6].set(
            masked_update(mask, jnp.zeros((n, 6)), sim.qd[:, va: va + 6]))
        return SimState(q, qd)

    def _sbc_disp(self, key, n):
        task = getattr(self, "_task_for_reset", None)
        max_disp = task.curr_max_disp if task is not None else \
            jnp.asarray(self.cfg_rl["initial_max_disp"])
        return jax.random.uniform(key, (n,)) * max_disp

    def reset_idx(self, sim, task, mask, key):
        self._task_for_reset = task
        sim, task = super().reset_idx(sim, task, mask, key)
        self._task_for_reset = None
        return sim, task

    # -- reward ---------------------------------------------------------
    def post_physics(self, state: EnvState, out, actions):
        n = self.num_envs
        task: IndustRealTaskState = state.task
        plug = out.root_states[:, 2]
        plug_pos, plug_quat = plug[:, 0:3], plug[:, 3:7]
        socket_pos = jnp.broadcast_to(self._socket_frame(), (n, 3))
        socket_top = socket_pos + jnp.asarray(
            [0.0, 0.0, float(SOCKET_HALF[2] * 2)])

        # SDF dense reward + SAPU weight/filter
        rew = self.sdf_scale * self._sdf_reward(plug_pos, plug_quat)
        interpen = self._sapu_interpen(plug_pos, plug_quat)
        low = interpen <= self.interpen_thresh
        rew = jnp.where(low, rew * (1.0 - jnp.tanh(
            interpen / self.interpen_thresh)), task.prev_rew)

        # keypoints along the plug/goal axes
        kp_plug = self._keypoints_from(plug_pos, plug_quat)
        goal = jnp.broadcast_to(self._goal_pos(), (n, 3))
        ident = jnp.tile(jnp.asarray([0.0, 0, 0, 1.0]), (n, 1))
        kp_goal = self._keypoints_from(goal, ident)
        kp_dist = jnp.sum(jnp.linalg.norm(kp_goal - kp_plug, axis=-1), -1)
        close = kp_dist < self.close_thresh
        engaged = ((plug_pos[:, 2] - PLUG_LENGTH / 2 + SOCKET_BASE_HEIGHT
                    < socket_top[:, 2]) & close)
        inserted = ((plug_pos[:, 2] < goal[:, 2] + self.success_h) & close)

        is_last = state.progress >= self.max_episode_length - 1
        height_dist = plug_pos[:, 2] - goal[:, 2]
        eng_scale = jnp.where(
            engaged, 1.0 / (jnp.maximum(height_dist - self.success_h, 0.0)
                            + 0.1), 0.0)
        rew = rew + is_last.astype(jnp.float32) * eng_scale \
            * self.engagement_bonus
        # SBC stage scale on the last step (shrink neg, grow pos)
        stage = (self.h_bound[1] - task.curr_max_disp) / \
            (self.h_bound[1] - self.h_bound[0]) + 1.0
        rew = jnp.where(is_last, jnp.where(rew < 0, rew / stage, rew * stage),
                        rew)

        # SBC curriculum update at episode end
        succ_rate = jnp.mean(jnp.where(low, inserted, False).astype(
            jnp.float32))
        new_disp = jnp.where(
            succ_rate > self.succ_thresh,
            jnp.maximum(task.curr_max_disp + self.h_step[0], self.h_bound[0]),
            jnp.where(succ_rate < self.fail_thresh,
                      jnp.minimum(task.curr_max_disp + self.h_step[1],
                                  self.h_bound[1]),
                      task.curr_max_disp))
        any_last = jnp.any(is_last)
        curr_max_disp = jnp.where(any_last, new_disp, task.curr_max_disp)
        ep_rate = jnp.where(any_last, succ_rate, task.ep_success_rate)

        reset = is_last.astype(jnp.int32)

        # obs (ref compute_observations :282-320): arm dofs + fingertip &
        # noisy goal poses in the robot base frame + noisy delta
        ft_pos, ft_quat, _, _ = self._fingertip_state(out)
        arm_q = self.engine.dof_pos(state.sim)[:, self.franka_dofs[:7]]
        base_pos = jnp.asarray([0.5, 0.0, 0.0])
        base_quat = jnp.asarray([0.0, 0.0, 1.0, 0.0])
        inv = maths.quat_conjugate(base_quat)
        to_base = lambda p: maths.quat_apply(inv, p - base_pos)
        goal_grip = socket_top + jnp.asarray(
            [0.0, 0.0, PLUG_LENGTH / 2])
        key_n = jax.random.fold_in(state.rng, 29)
        noisy_goal = goal_grip + 0.002 * jax.random.normal(key_n, (n, 3))
        obs = jnp.concatenate([
            arm_q,
            to_base(ft_pos),
            maths.quat_mul(inv, ft_quat),
            to_base(noisy_goal),
            maths.quat_mul(inv, jnp.broadcast_to(base_quat, (n, 4))),
            noisy_goal - ft_pos,
        ], -1)

        task = IndustRealTaskState(
            actions=actions, prev_rew=rew, curr_max_disp=curr_max_disp,
            insert_success=inserted.astype(jnp.float32),
            ep_success_rate=ep_rate)
        # engagement depth: how far the plug BOTTOM sits below the socket
        # top (m, >=0); the VERDICT r4 "engagement depth rising" metric
        eng_depth = jnp.maximum(
            socket_top[:, 2] - (plug_pos[:, 2] - PLUG_LENGTH / 2), 0.0)
        extras = {"sdf_reward": jnp.mean(rew),
                  "insertion_successes": jnp.mean(
                      inserted.astype(jnp.float32)),
                  "engagement_depth": jnp.mean(eng_depth),
                  "curr_max_disp": curr_max_disp,
                  "successes": ep_rate}
        return obs, None, rew, reset, task, extras

    def get_env_state(self, state):
        """SBC stage persists into checkpoints (ref curr_max_disp)."""
        return {"curr_max_disp": state.task.curr_max_disp}

    def set_env_state(self, state, env_state):
        if env_state and "curr_max_disp" in env_state:
            return state._replace(task=state.task._replace(
                curr_max_disp=jnp.asarray(env_state["curr_max_disp"])))
        return state


class IndustRealTaskGearsInsert(IndustRealTaskPegsInsert):
    """Gear onto shaft (industreal_task_gears_insert.py): same SAPU/SDF/SBC
    machinery over gear/shaft geometry."""

    def _extra_parts(self):
        ob = ModelBuilder()
        ob.begin_actor()
        gear = ob.add_body(
            "nut", -1, FREE,
            body_pos=(0.0, 0.0, TABLE_HEIGHT + SHAFT_HEIGHT + GEAR_HEIGHT))
        if self.use_mesh_sdf:
            # annular gear blank with the real bore: SDF pad target +
            # outer/bore rim rings as candidate points (plate + shaft)
            from ..models import meshes
            gv, gt = meshes.tube_mesh(GEAR_RADIUS, GEAR_HOLE_R,
                                      GEAR_HEIGHT / 2, n=32)
            cp = meshes.tube_contact_points(GEAR_RADIUS, GEAR_HOLE_R,
                                            GEAR_HEIGHT / 2, n_ring=8)
            ob.add_sdf_geom(gear, gv, gt, density=1200.0, friction=0.5,
                            resolution=48, contact_points=cp,
                            name="nut_geom")
        else:
            ob.add_geom(gear, GEOM_BOX,
                        np.array([GEAR_RADIUS * 0.8, GEAR_RADIUS * 0.8,
                                  GEAR_HEIGHT / 2]),
                        density=1200.0, friction=0.5, name="nut_geom")
        sb = ModelBuilder()
        sb.begin_actor()
        base = sb.add_body("socket", -1, FIXED, body_pos=SOCKET_POS)
        sb.add_geom(base, GEOM_BOX, np.array([0.05, 0.03, 0.0025]),
                    pos=np.array([0, 0, 0.0025]), friction=0.3,
                    name="socket_rim0")
        for i in range(1, 4):  # keep the 4-rim contact interface shape
            sb.add_geom(base, GEOM_BOX, np.array([0.001, 0.001, 0.0005]),
                        pos=np.array([0.04 + 0.002 * i, 0.028, 0.0005]),
                        friction=0.3, name=f"socket_rim{i}")
        sb.add_geom(base, GEOM_CYLINDER,
                    np.array([SHAFT_RADIUS, SHAFT_HEIGHT / 2, 0]),
                    pos=np.array([0, 0, SHAFT_HEIGHT / 2]), contact=False,
                    name="shaft_geom")
        return [(ob.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                (sb.finalize(), (0, 0, 0), (0, 0, 0, 1))]

    def _goal_pos(self):
        return self._socket_frame() + jnp.asarray(
            [0.0, 0.0, 0.005 + GEAR_HEIGHT / 2])

    def _sample_points(self):
        """Gear-shaped surface samples (tube with the shaft bore)."""
        from ..models import meshes
        v, t = meshes.tube_mesh(GEAR_RADIUS, GEAR_HOLE_R, GEAR_HEIGHT / 2,
                                n=32)
        return meshes.surface_sample(v, t, 64, seed=11)

    def _material_solid_mesh(self):
        """The shaft the gear must not penetrate (query frame = socket)."""
        from ..models import meshes
        v, t = meshes.cylinder_mesh(SHAFT_RADIUS, SHAFT_HEIGHT / 2, n=48)
        return v + np.asarray([0.0, 0.0, SHAFT_HEIGHT / 2], np.float32), t

    def _goal_solid_mesh(self):
        """Assembled gear: annular tube with the bore carved out."""
        from ..models import meshes
        return meshes.tube_mesh(GEAR_RADIUS, GEAR_HOLE_R, GEAR_HEIGHT / 2,
                                n=48)

    def _sapu_interpen(self, pos, quat):
        """Gear interpenetration against the shaft, excluding the bore rim
        (points at the bore radius legitimately slide along the shaft)."""
        pts = self._plug_points_world(pos, quat)
        rel = pts - self._socket_frame()
        if self.use_mesh_sdf:
            from ..physics import sdf_grid
            sdf = sdf_grid.sample(self._socket_grid, rel)
        else:
            sdf = sdf_cylinder(
                rel - jnp.asarray([0.0, 0.0, SHAFT_HEIGHT / 2]),
                SHAFT_RADIUS, SHAFT_HEIGHT / 2)
        r_xy = jnp.linalg.norm(pts[..., 0:2]
                               - self._socket_frame()[0:2], axis=-1)
        pen = jnp.where(r_xy > GEAR_HOLE_R, jnp.maximum(-sdf, 0.0), 0.0)
        return pen.max(-1)

    def _sdf_reward(self, pos, quat):
        pts = self._plug_points_world(pos, quat)
        rel = pts - self._goal_pos()
        if self.use_mesh_sdf:
            from ..physics import sdf_grid
            d = jnp.maximum(sdf_grid.sample(self._goal_grid, rel), 0.0)
        else:
            d = jnp.maximum(
                sdf_cylinder(rel, GEAR_RADIUS, GEAR_HEIGHT / 2), 0.0)
        return -jnp.log(jnp.maximum(jnp.mean(d, -1), 1e-6))


TASK_CFGS = {
    "IndustRealTaskPegsInsert": _cfg_insert("IndustRealTaskPegsInsert"),
    "IndustRealTaskGearsInsert": _cfg_insert("IndustRealTaskGearsInsert"),
}
TASK_CFG = TASK_CFGS["IndustRealTaskPegsInsert"]
