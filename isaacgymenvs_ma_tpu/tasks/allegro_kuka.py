"""AllegroKuka family (reference tasks/allegro_kuka/, ~3.9 kLoC):
Reorientation / Regrasping / Throw subtasks on a KUKA iiwa7 + Allegro hand,
plus the TwoArms variants.  Resolver-dispatched via ``env.subtask``
(tasks/__init__.py:65-90).

Parity surface (allegro_kuka_base.py):

* 23-dof arm+hand, position-drive control: arm targets integrate
  ``dofSpeedScale * dt * action`` (ref :1393-1396), hand targets are scaled
  absolute positions with an action moving average (ref :1378-1391).
* full_state obs (ref compute_full_state :1091-1172): unscaled dof pos, dof
  vel, palm center pos + palm rot/vel/angvel, object rot/vel/angvel,
  fingertip positions relative to palm, keypoints relative to palm and goal,
  object scales, episode-best keypoint distance, per-finger episode-best
  distances, lifted flag, log-progress, log-successes, previous reward.
* reward (ref :854-930): fingertip-delta (episode-closest improvements,
  pre-lift only) + lifting reward + one-time lifting bonus + keypoint-delta
  reward (post-lift) + arm/hand action penalties + near-goal bonus spread
  over ``successSteps``; success after ``near_goal_steps >= successSteps``;
  goal-only resample on success (deferred to the next step, as the
  reference's pre_physics_step does with ``reset_goal_buf``).
* success-tolerance curriculum (allegro_kuka_utils.py:87-116): tolerance
  multiplies by ``toleranceCurriculumIncrement`` every
  ``toleranceCurriculumInterval`` frames once mean successes >= 3;
  ``true_objective`` = tolerance interpolation + successes
  (tolerance_successes_objective :128-158) — the DexPBT objective.
* random decaying forces on the object (ref :1402-1415) via ``f_ext``.

Batched redesign notes: per-env curriculum/goal state lives in the task pytree;
goal resets are masked updates inside ``reset_idx``; the random-size cuboid
sweep (generate_cuboids.py:38-131) keeps XLA shapes static by expressing the
per-axis sizes as per-env ``PhysScales.shape`` leaves — the engine scales the
cuboid's SDF extents, contact points and inertia per env, keypoints/obs carry
the true per-env scales, matching the reference's per-env URDF assignment
(allegro_kuka_base.py:414-428).
The throw-task bucket is a goal volume only (no bucket-wall collisions).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import (DRIVE_POS, FIXED, FREE, GEOM_BOX, GEOM_SPHERE,
                            Geom, ModelBuilder, compose_scene,
                            model_from_spec)
from ..ops import maths
from ..physics.engine import Control, PhysicsEngine, SimState
from .base import EnvState, VecTaskBase, masked_update

ARM_POS = np.array([0.0, 0.8, 0.0], np.float32)
TABLE_POS = ARM_POS + np.array([0.0, -0.8, 0.38], np.float32)
TABLE_SIZE = np.array([0.475, 0.4, 0.3], np.float32)   # table_narrow.urdf
OBJ_START = ARM_POS + np.array([0.0, -0.8, 0.63], np.float32)
KUKA_DEFAULT = np.array([-1.571, 1.571, 0.0, 1.376, 0.0, 1.485, 2.358],
                        np.float32)
FINGERTIPS = ["index_link_3", "middle_link_3", "ring_link_3", "thumb_link_3"]
FINGERTIP_OFFSETS = np.array([[0.05, 0.005, 0]] * 3 + [[0.06, 0.005, 0]],
                             np.float32)
PALM_OFFSET = np.array([-0.00, -0.02, 0.16], np.float32)
PALM_BODY = "iiwa7_link_7"
# target volume (ref allegro_kuka_base.py:302-304)
TARGET_ORIGIN = np.array([0.0, 0.05, 0.8], np.float32)
TARGET_EXTENT = np.array([[-0.4, 0.4], [-0.05, 0.3], [-0.12, 0.25]],
                         np.float32)

TASK_CFG = {
    "name": "AllegroKuka",
    "physics_engine": "physx",
    "env": {
        "subtask": "reorientation",
        "numEnvs": 8192,
        "envSpacing": 1.2,
        "episodeLength": 600,
        "clampAbsObservations": 10.0,
        "useRelativeControl": False,
        "dofSpeedScale": 10.0,
        "actionsMovingAverage": 1.0,
        "controlFrequencyInv": 1,
        "resetPositionNoiseX": 0.1,
        "resetPositionNoiseY": 0.1,
        "resetPositionNoiseZ": 0.02,
        "resetRotationNoise": 1.0,
        "resetDofPosRandomIntervalFingers": 0.1,
        "resetDofPosRandomIntervalArm": 0.1,
        "resetDofVelRandomInterval": 0.5,
        "forceScale": 2.0,
        "forceProbRange": [0.001, 0.1],
        "forceDecay": 0.99,
        "forceDecayInterval": 0.08,
        "liftingRewScale": 20.0,
        "liftingBonus": 300.0,
        "liftingBonusThreshold": 0.15,
        "keypointRewScale": 200.0,
        "distanceDeltaRewScale": 50.0,
        "reachGoalBonus": 1000.0,
        "kukaActionsPenaltyScale": 0.003,
        "allegroActionsPenaltyScale": 0.0003,
        "fallDistance": 0.24,
        "fallPenalty": 0.0,
        "privilegedActions": False,
        "privilegedActionsTorque": 0.02,
        "allegroStiffness": 40.0,
        "kukaStiffness": 40.0,
        "allegroDamping": 5.0,
        "kukaDamping": 5.0,
        "keypointScale": 1.5,
        "objectBaseSize": 0.05,
        "objectType": "block",
        "observationType": "full_state",
        "successTolerance": 0.075,
        "targetSuccessTolerance": 0.01,
        "toleranceCurriculumIncrement": 0.9,
        "toleranceCurriculumInterval": 3000,
        "maxConsecutiveSuccesses": 50,
        "successSteps": 1,
    },
    "sim": {
        "dt": 0.01667, "substeps": 2, "up_axis": "z",
        "gravity": [0.0, 0.0, -9.81],
        # contact_capacity 16: 34 candidate rows (21 plane + 13 pair), a
        # grasp + table rest uses well under 16, so deepest-16 compaction
        # is exact in practice.  Both it and contact-row reuse were chosen
        # by speed on the previous accelerator (reuse lost without the
        # compaction: cached full-row Jacobians at 34 rows cost more memory
        # traffic than the fused rebuild); neither is re-measured on the
        # GPU yet.
        "physx": {"num_position_iterations": 8, "num_velocity_iterations": 0,
                  "contact_capacity": 16, "reuse_contact_rows": True,
                  "max_depenetration_velocity": 1000.0},
    },
    "task": {"randomize": False, "randomization_params": {}},
}


class KukaTaskState(NamedTuple):
    goal_pose: jax.Array               # (N, 7)
    successes: jax.Array               # (N,)
    prev_episode_successes: jax.Array  # (N,)
    near_goal_steps: jax.Array         # (N,) int32
    goal_reset: jax.Array              # (N,) int32 — target resample next step
    lifted_object: jax.Array           # (N,) bool
    closest_keypoint_max_dist: jax.Array  # (N,) (-1 = uninitialized)
    closest_fingertip_dist: jax.Array  # (N, F)
    furthest_hand_dist: jax.Array      # (N,)
    prev_targets: jax.Array            # (N, nd)
    rb_force: jax.Array                # (N, 3) decaying random object force
    force_prob: jax.Array              # (N,)
    success_tolerance: jax.Array       # scalar
    last_curriculum_update: jax.Array  # scalar
    frames: jax.Array                  # scalar
    prev_rew: jax.Array                # (N,) reward obs


class AllegroKukaBase(VecTaskBase):
    """Single-arm base; subtasks override keypoints/goal sampling."""

    num_arms = 1
    num_fingertips = 4

    def _keypoint_offsets_unit(self):
        raise NotImplementedError

    def __init__(self, cfg):
        e = cfg["env"]
        self.num_arm_dofs = 7
        self.num_hand_dofs = 16
        self.nd = (self.num_arm_dofs + self.num_hand_dofs) * self.num_arms
        self.privileged_actions = bool(e.get("privilegedActions", False))
        self.privileged_torque = float(e.get("privilegedActionsTorque", 0.02))
        self.kp_scale = float(e.get("keypointScale", 1.5))
        self.object_size = float(e.get("objectBaseSize", 0.05))
        offs = np.asarray(self._keypoint_offsets_unit(), np.float32)
        self.keypoint_offsets = offs * self.object_size / 2 * self.kp_scale
        self.num_keypoints = len(offs)
        F = self.num_fingertips * self.num_arms
        self.full_state_size = (
            2 * self.nd + (3 + 10) * self.num_arms + 10 + 3 * F
            + self.num_keypoints * 3 * self.num_arms + self.num_keypoints * 3
            + 3 + 1 + 1 + 2 + F + 1)
        e["numObservations"] = self.full_state_size
        e["numActions"] = self.nd + (3 if self.privileged_actions else 0)
        e["numStates"] = 0
        e["clipObservations"] = float(e.get("clampAbsObservations", 10.0))
        self.dof_speed_scale = float(e.get("dofSpeedScale", 10.0))
        self.act_avg = float(e.get("actionsMovingAverage", 1.0))
        self.lifting_rew_scale = float(e.get("liftingRewScale", 20.0))
        self.lifting_bonus = float(e.get("liftingBonus", 300.0))
        self.lifting_threshold = float(e.get("liftingBonusThreshold", 0.15))
        self.keypoint_rew_scale = float(e.get("keypointRewScale", 200.0))
        self.dist_delta_scale = float(e.get("distanceDeltaRewScale", 50.0))
        self.reach_goal_bonus = float(e.get("reachGoalBonus", 1000.0))
        self.kuka_pen = float(e.get("kukaActionsPenaltyScale", 0.003))
        self.allegro_pen = float(e.get("allegroActionsPenaltyScale", 0.0003))
        self.initial_tolerance = float(e.get("successTolerance", 0.075))
        self.target_tolerance = float(e.get("targetSuccessTolerance", 0.01))
        self.tol_increment = float(e.get("toleranceCurriculumIncrement", 0.9))
        self.tol_interval = int(e.get("toleranceCurriculumInterval", 3000))
        self.max_consecutive = int(e.get("maxConsecutiveSuccesses", 50))
        self.success_steps = int(e.get("successSteps", 1))
        self.force_scale = float(e.get("forceScale", 0.0))
        self.force_prob_range = tuple(e.get("forceProbRange", [0.001, 0.1]))
        self.force_decay = float(e.get("forceDecay", 0.99))
        self.force_decay_interval = float(e.get("forceDecayInterval", 0.08))
        self.reset_noise_fingers = float(
            e.get("resetDofPosRandomIntervalFingers", 0.1))
        self.reset_noise_arm = float(e.get("resetDofPosRandomIntervalArm", 0.1))
        self.reset_vel_noise = float(e.get("resetDofVelRandomInterval", 0.5))
        self.reset_pos_noise = np.array([
            float(e.get("resetPositionNoiseX", 0.1)),
            float(e.get("resetPositionNoiseY", 0.1)),
            float(e.get("resetPositionNoiseZ", 0.02))], np.float32)
        super().__init__(cfg)

        m = self.model
        self.object_body = m.body_names.index("object")
        self.obj_qa = int(m.q_adr[self.object_body])
        self.obj_va = int(m.v_adr[self.object_body])
        # per-env cuboid-dimension randomization: the reference generates one
        # URDF per size (allegro_kuka/generate_cuboids.py:38-81) and assigns
        # them round-robin over envs (allegro_kuka_base.py:414-428); here the
        # per-axis scales are per-env PhysScales.shape leaves consumed by the
        # engine's narrowphase/inertia, so geometry stays a static XLA shape.
        self.randomize_object_dims = bool(
            e.get("randomizeObjectDimensions", True))
        if self.randomize_object_dims:
            cat = self._cuboid_scale_catalog(
                small=bool(e.get("withSmallCuboids", True)),
                big=bool(e.get("withBigCuboids", True)),
                sticks=bool(e.get("withSticks", True)))
            rng = np.random.default_rng(42)
            rng.shuffle(cat)
            idx = np.arange(self.num_envs) % len(cat)
            self.object_scales_np = np.asarray(cat, np.float32)[idx]
        else:
            self.object_scales_np = np.ones((self.num_envs, 3), np.float32)
        self.object_scales = jnp.asarray(self.object_scales_np)
        self.palm_bodies = np.asarray(
            [i for i, n in enumerate(m.body_names) if n.endswith(PALM_BODY)],
            np.int32)
        ft = []
        for i, n in enumerate(m.body_names):
            if any(n.endswith(f) for f in FINGERTIPS):
                ft.append(i)
        self.fingertip_bodies = np.asarray(ft, np.int32)
        sd = self.engine.scalar_dofs
        self.ctl_dofs = np.asarray(sd[: self.nd])
        dl = np.asarray(m.dof_lower)[self.ctl_dofs]
        du = np.asarray(m.dof_upper)[self.ctl_dofs]
        self.dof_lower = jnp.asarray(dl)
        self.dof_upper = jnp.asarray(du)
        dd = np.tile(np.concatenate([KUKA_DEFAULT, np.zeros(16, np.float32)]),
                     self.num_arms)
        self.default_dof = jnp.asarray(np.clip(dd, dl, du))
        # per-arm index masks into the nd control dofs
        na = self.num_arm_dofs + self.num_hand_dofs
        self.arm_slices = [np.arange(a * na, a * na + 7)
                           for a in range(self.num_arms)]
        self.hand_slices = [np.arange(a * na + 7, (a + 1) * na)
                            for a in range(self.num_arms)]

    # ------------------------------------------------------------------
    @staticmethod
    def _cuboid_scale_catalog(small=True, big=True, sticks=True):
        """Per-axis scale catalog mirroring the reference's procedural cuboid
        sweep (generate_cuboids.py:96-131): percent scales filtered by
        relative volume and the thin-plate / non-elongated aspect rules."""
        def thin(s):
            s = sorted(s)
            return s[0] * 3 <= s[1]

        def not_elongated(s):
            s = sorted(s)
            return s[2] <= s[0] * 3 or s[2] <= s[1] * 3

        def gen(scales, vmin, vmax, filters):
            out = []
            for x in scales:
                for y in scales:
                    for z in scales:
                        v = x * y * z / 1e6
                        if v < vmin or v > vmax:
                            continue
                        if any(f([x, y, z]) for f in filters):
                            continue
                        out.append((x / 100.0, y / 100.0, z / 100.0))
            return out

        cat = [(1.0, 1.0, 1.0)]
        if small:
            cat += gen([100, 50, 66, 75, 90, 110, 125, 150, 175, 200, 250,
                        300], 1.0, 2.5, [])
        if big:
            cat += gen([100, 125, 150, 200, 250, 300, 350], 2.5, 15.0, [thin])
        if sticks:
            cat += gen([100, 50, 75, 200, 300, 400, 500, 600], 2.5, 6.0,
                       [thin, not_elongated])
        return cat

    def initial_phys(self, key=None):
        phys = super().initial_phys(key)
        if not self.randomize_object_dims:
            return phys
        from ..utils.domain_rand import PhysScales
        if phys is None:
            phys = PhysScales.ones(self.num_envs)
        shape = np.ones((self.num_envs, self.model.nb, 3), np.float32)
        shape[:, self.object_body] = self.object_scales_np
        return phys._replace(shape=jnp.asarray(shape))

    def _arm_poses(self):
        return [(ARM_POS, (0.0, 0.0, 0.0, 1.0))]

    def create_model(self):
        import copy
        from ..models.specs.kuka_allegro import SPEC
        e = self.cfg["env"]
        arms = []
        for ai, (pos, quat) in enumerate(self._arm_poses()):
            arm = model_from_spec(copy.deepcopy(SPEC))
            if self.num_arms > 1:
                arm.body_names = [f"arm{ai}_{n}" for n in arm.body_names]
            for d in range(arm.nv):
                arm.dof_drive_mode[d] = DRIVE_POS
                is_arm = d < self.num_arm_dofs
                arm.dof_stiffness[d] = float(
                    e.get("kukaStiffness", 40.0) if is_arm
                    else e.get("allegroStiffness", 40.0))
                arm.dof_drive_damping[d] = float(
                    e.get("kukaDamping", 5.0) if is_arm
                    else e.get("allegroDamping", 5.0))
            # fingertip + palm contact spheres (mesh collisions approximated)
            for f, off in zip(FINGERTIPS, FINGERTIP_OFFSETS):
                b = arm.body_names.index(
                    f"arm{ai}_{f}" if self.num_arms > 1 else f)
                arm.geoms.append(Geom(
                    body=b, gtype=GEOM_SPHERE, size=np.array([0.012, 0, 0]),
                    pos=off.copy(), quat=np.array([0.0, 0, 0, 1]),
                    friction=1.0, contact=True, name=f"tip{ai}_{f}"))
            pb = arm.body_names.index(
                f"arm{ai}_{PALM_BODY}" if self.num_arms > 1 else PALM_BODY)
            arm.geoms.append(Geom(
                body=pb, gtype=GEOM_SPHERE, size=np.array([0.04, 0, 0]),
                pos=PALM_OFFSET.copy(), quat=np.array([0.0, 0, 0, 1]),
                friction=1.0, contact=True, name=f"palm{ai}"))
            arms.append((arm, tuple(pos), tuple(quat)))
        tb = ModelBuilder()
        tb.begin_actor()
        tbody = tb.add_body("table", -1, FIXED, body_pos=TABLE_POS)
        tb.add_geom(tbody, GEOM_BOX, TABLE_SIZE / 2, name="table_top")
        ob = ModelBuilder()
        ob.begin_actor()
        obj = ob.add_body("object", -1, FREE, body_pos=self._object_start())
        # cube_multicolor 0.05 m
        ob.add_geom(obj, GEOM_BOX, np.full(3, self.object_size / 2),
                    density=400.0, name="object_geom")
        model = compose_scene(
            arms + [(tb.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                    (ob.finalize(), (0, 0, 0), (0, 0, 0, 1))])
        return model, True

    def _object_start(self):
        return OBJ_START

    def build_engine(self, model, ground):
        names = [g.name for g in model.geoms]
        obj_geom = names.index("object_geom")
        pairs = [(i, obj_geom) for i, n in enumerate(names)
                 if n.startswith("tip") or n.startswith("palm")]
        pairs.append((obj_geom, names.index("table_top")))
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs)

    # ------------------------------------------------------------------
    def initial_task_state(self):
        n = self.num_envs
        F = self.num_fingertips * self.num_arms
        return KukaTaskState(
            goal_pose=jnp.tile(
                jnp.asarray(list(TARGET_ORIGIN) + [0, 0, 0, 1.0], jnp.float32),
                (n, 1)),
            successes=jnp.zeros(n, jnp.float32),
            prev_episode_successes=jnp.zeros(n, jnp.float32),
            near_goal_steps=jnp.zeros(n, jnp.int32),
            goal_reset=jnp.zeros(n, jnp.int32),
            lifted_object=jnp.zeros(n, bool),
            closest_keypoint_max_dist=-jnp.ones(n, jnp.float32),
            closest_fingertip_dist=-jnp.ones((n, F), jnp.float32),
            furthest_hand_dist=-jnp.ones(n, jnp.float32),
            prev_targets=jnp.tile(self.default_dof, (n, 1)),
            rb_force=jnp.zeros((n, 3), jnp.float32),
            force_prob=jnp.full((n,), 0.01, jnp.float32),
            success_tolerance=jnp.asarray(self.initial_tolerance, jnp.float32),
            last_curriculum_update=jnp.asarray(0.0, jnp.float32),
            frames=jnp.asarray(0.0, jnp.float32),
            prev_rew=jnp.zeros(n, jnp.float32))

    def _random_quat(self, key, n):
        u = jax.random.uniform(key, (n, 3))
        return jnp.stack([
            jnp.sqrt(1 - u[:, 0]) * jnp.cos(2 * np.pi * u[:, 1]),
            jnp.sqrt(u[:, 0]) * jnp.sin(2 * np.pi * u[:, 2]),
            jnp.sqrt(u[:, 0]) * jnp.cos(2 * np.pi * u[:, 2]),
            jnp.sqrt(1 - u[:, 0]) * jnp.sin(2 * np.pi * u[:, 1])], -1)

    def _sample_target(self, key, n, task):
        """Default: random pose in the target volume (reorientation rules)."""
        k1, k2 = jax.random.split(key)
        lo = TARGET_ORIGIN + TARGET_EXTENT[:, 0]
        size = TARGET_EXTENT[:, 1] - TARGET_EXTENT[:, 0]
        pos = jnp.asarray(lo) + jax.random.uniform(k1, (n, 3)) * jnp.asarray(size)
        return jnp.concatenate([pos, self._random_quat(k2, n)], -1)

    # subtask hook: whether a goal reset also puts the object back on the table
    reset_object_on_goal_reset = False

    def reset_idx(self, sim: SimState, task: KukaTaskState, mask, key):
        n = self.num_envs
        ks = jax.random.split(key, 8)
        # goal-only resets (deferred from last step's success, ref :1363-1367)
        goal_mask = (task.goal_reset > 0) | mask
        new_goal = self._sample_target(ks[0], n, task)
        goal_pose = masked_update(goal_mask, new_goal, task.goal_pose)

        # full env reset: arm+hand dofs default + noise
        nd = self.nd
        u = jax.random.uniform(ks[1], (n, nd))
        delta_min = self.dof_lower - self.default_dof
        delta_max = self.dof_upper - self.default_dof
        noise_coeff = np.zeros(nd, np.float32)
        for s in self.arm_slices:
            noise_coeff[s] = self.reset_noise_arm
        for s in self.hand_slices:
            noise_coeff[s] = self.reset_noise_fingers
        dof = self.default_dof + jnp.asarray(noise_coeff) * (
            delta_min + (delta_max - delta_min) * u)
        dvel = self.reset_vel_noise * jax.random.uniform(
            ks[2], (n, nd), minval=-1.0, maxval=1.0)
        full_pos = self.engine.dof_pos(sim)
        full_pos = full_pos.at[:, :nd].set(
            masked_update(mask, dof, full_pos[:, :nd]))
        sim = self.engine.set_dof_pos(sim, full_pos)
        full_vel = self.engine.dof_vel(sim)
        full_vel = full_vel.at[:, :nd].set(
            masked_update(mask, dvel, full_vel[:, :nd]))
        sim = self.engine.set_dof_vel(sim, full_vel)

        # object pose: start + noise (also on goal reset for some subtasks)
        obj_mask = mask | (goal_mask if self.reset_object_on_goal_reset
                           else jnp.zeros_like(mask))
        pos = jnp.asarray(self._object_start(), jnp.float32) + \
            jnp.asarray(self.reset_pos_noise) * jax.random.uniform(
                ks[3], (n, 3), minval=-1.0, maxval=1.0)
        quat = self._random_quat(ks[4], n)
        opose = jnp.concatenate([pos, quat], -1)
        qa, va = self.obj_qa, self.obj_va
        q = sim.q.at[:, qa: qa + 7].set(
            masked_update(obj_mask, opose, sim.q[:, qa: qa + 7]))
        qd = sim.qd.at[:, va: va + 6].set(
            masked_update(obj_mask, jnp.zeros((n, 6)),
                          sim.qd[:, va: va + 6]))
        sim = SimState(q, qd)

        lo, hi = np.log(self.force_prob_range[0]), np.log(self.force_prob_range[1])
        fp = jnp.exp((lo - hi) * jax.random.uniform(ks[5], (n,)) + hi)
        F = self.num_fingertips * self.num_arms
        task = task._replace(
            goal_pose=goal_pose,
            prev_episode_successes=jnp.where(mask, task.successes,
                                             task.prev_episode_successes),
            successes=jnp.where(mask, 0.0, task.successes),
            near_goal_steps=jnp.where(goal_mask, 0, task.near_goal_steps),
            goal_reset=jnp.zeros_like(task.goal_reset),
            lifted_object=jnp.where(
                obj_mask, False, task.lifted_object),
            closest_keypoint_max_dist=jnp.where(
                goal_mask, -1.0, task.closest_keypoint_max_dist),
            closest_fingertip_dist=jnp.where(
                mask[:, None], -1.0, task.closest_fingertip_dist),
            furthest_hand_dist=jnp.where(mask, -1.0, task.furthest_hand_dist),
            prev_targets=masked_update(mask, dof, task.prev_targets),
            rb_force=jnp.where(mask[:, None], 0.0, task.rb_force),
            force_prob=jnp.where(mask, fp, task.force_prob),
            prev_rew=jnp.where(mask, 0.0, task.prev_rew))
        return sim, task

    def pre_physics(self, state: EnvState, actions: jax.Array) -> Control:
        n = self.num_envs
        task: KukaTaskState = state.task
        if self.privileged_actions:
            torque_actions = actions[:, :3] * self.privileged_torque
            actions = actions[:, 3:]
        else:
            torque_actions = None
        nd = self.nd
        prev = task.prev_targets
        cur = prev
        for s in self.hand_slices:
            t = maths.scale(actions[:, s], self.dof_lower[s], self.dof_upper[s])
            t = self.act_avg * t + (1.0 - self.act_avg) * prev[:, s]
            cur = cur.at[:, s].set(jnp.clip(t, self.dof_lower[s],
                                            self.dof_upper[s]))
        for s in self.arm_slices:
            t = prev[:, s] + self.dof_speed_scale * self.dt * actions[:, s]
            cur = cur.at[:, s].set(jnp.clip(t, self.dof_lower[s],
                                            self.dof_upper[s]))
        self._new_targets = cur
        pos_target = jnp.zeros((n, self.engine.nv), jnp.float32)
        pos_target = pos_target.at[:, self.ctl_dofs].set(cur)

        # random decaying object forces (ref :1402-1415) + privileged torques
        f_ext = None
        if self.force_scale > 0.0 or torque_actions is not None:
            key = jax.random.fold_in(state.rng, 23)
            k1, k2 = jax.random.split(key)
            force = task.rb_force * self.force_decay ** (
                self.dt / self.force_decay_interval)
            obj_mass = float(np.asarray(self.model.mass)[self.object_body])
            fire = jax.random.uniform(k1, (n,)) < task.force_prob
            new_force = jax.random.normal(k2, (n, 3)) * obj_mass * \
                self.force_scale
            force = jnp.where(fire[:, None], new_force, force)
            self._task_force = force
            f_ext = jnp.zeros((n, self.model.nb, 6), jnp.float32)
            f_ext = f_ext.at[:, self.object_body, 3:6].set(force)
            if torque_actions is not None:
                f_ext = f_ext.at[:, self.object_body, 0:3].set(torque_actions)
        else:
            self._task_force = task.rb_force
        return Control(tau=jnp.zeros((n, self.engine.nv), jnp.float32),
                       pos_target=pos_target,
                       vel_target=jnp.zeros((n, self.engine.nv), jnp.float32),
                       f_ext=f_ext)

    def _true_objective(self, task, successes):
        """tolerance_successes_objective (allegro_kuka_utils.py:128-158)."""
        span = self.initial_tolerance - self.target_tolerance
        tol_obj = (self.initial_tolerance - task.success_tolerance) / span \
            if span > 0 else 1.0
        above = task.success_tolerance > self.target_tolerance
        return jnp.where(above, successes * 0.01 + tol_obj,
                         successes + tol_obj)

    def post_physics(self, state: EnvState, out, actions):
        n = self.num_envs
        task: KukaTaskState = state.task
        obj = out.root_states[:, self.num_arms + 1]
        obj_pos, obj_rot = obj[:, 0:3], obj[:, 3:7]

        palm_pos = out.body_pos[:, self.palm_bodies]      # (N, A, 3)
        palm_rot = out.body_quat[:, self.palm_bodies]
        palm_center = palm_pos + maths.quat_apply(palm_rot,
                                                  jnp.asarray(PALM_OFFSET))
        ft_pos = out.body_pos[:, self.fingertip_bodies]
        ft_rot = out.body_quat[:, self.fingertip_bodies]
        ft_off = jnp.asarray(np.tile(FINGERTIP_OFFSETS, (self.num_arms, 1)))
        ft_tip = ft_pos + maths.quat_apply(ft_rot, ft_off)
        curr_ft_dist = jnp.linalg.norm(ft_tip - obj_pos[:, None, :], axis=-1)
        closest_ft = jnp.where(task.closest_fingertip_dist < 0.0,
                               curr_ft_dist, task.closest_fingertip_dist)
        furthest_hand = jnp.where(task.furthest_hand_dist < 0.0,
                                  curr_ft_dist[:, 0], task.furthest_hand_dist)

        kp_off = jnp.asarray(self.keypoint_offsets)
        if self.randomize_object_dims:
            # keypoints live on the object's (per-env scaled) surface
            kp_off = kp_off[None] * self.object_scales[:, None, :]
        kp_obj = obj_pos[:, None, :] + maths.quat_apply(
            obj_rot[:, None, :], kp_off)
        kp_goal = task.goal_pose[:, None, 0:3] + maths.quat_apply(
            task.goal_pose[:, None, 3:7], kp_off)
        kp_rel_goal = kp_obj - kp_goal
        kp_dist = jnp.linalg.norm(kp_rel_goal, axis=-1)
        kp_max_dist = kp_dist.max(-1)
        closest_kp = jnp.where(task.closest_keypoint_max_dist < 0.0,
                               kp_max_dist, task.closest_keypoint_max_dist)

        # ---- reward (ref compute_kuka_reward :854-930) ----
        z_lift = 0.05 + obj_pos[:, 2] - jnp.asarray(
            self._object_start(), jnp.float32)[2]
        lifting_rew = jnp.clip(z_lift, 0.0, 0.5)
        lifted = (z_lift > self.lifting_threshold) | task.lifted_object
        just_lifted = lifted & ~task.lifted_object
        lift_bonus = self.lifting_bonus * just_lifted.astype(jnp.float32)
        lifting_rew = lifting_rew * (~lifted).astype(jnp.float32)

        ft_deltas = jnp.clip(closest_ft - curr_ft_dist, 0.0, 10.0)
        closest_ft = jnp.minimum(closest_ft, curr_ft_dist)
        ft_delta_rew = jnp.sum(ft_deltas, -1) * (~lifted).astype(jnp.float32)
        furthest_hand = jnp.maximum(furthest_hand, curr_ft_dist[:, 0])

        kp_deltas = jnp.clip(closest_kp - kp_max_dist, 0.0, 100.0)
        closest_kp = jnp.minimum(closest_kp, kp_max_dist)
        keypoint_rew = kp_deltas * lifted.astype(jnp.float32)

        dof_vel = self.engine.dof_vel(state.sim)[:, : self.nd]
        arm_idx = np.concatenate(self.arm_slices)
        hand_idx = np.concatenate(self.hand_slices)
        kuka_pen = -jnp.sum(jnp.abs(dof_vel[:, arm_idx]), -1) * self.kuka_pen
        allegro_pen = -jnp.sum(jnp.abs(dof_vel[:, hand_idx]), -1) \
            * self.allegro_pen

        tol = task.success_tolerance * self.kp_scale
        near_goal = kp_max_dist <= tol
        near_goal_steps = task.near_goal_steps + near_goal.astype(jnp.int32)
        is_success = near_goal_steps >= self.success_steps
        successes = task.successes + is_success.astype(jnp.float32)
        bonus_rew = near_goal.astype(jnp.float32) * (
            self.reach_goal_bonus / self.success_steps)

        reward = (self.dist_delta_scale * ft_delta_rew
                  + self.lifting_rew_scale * lifting_rew + lift_bonus
                  + self.keypoint_rew_scale * keypoint_rew
                  + kuka_pen + allegro_pen + bonus_rew)

        # ---- resets (ref _compute_resets :841-849); success resets the
        # episode clock (episode extension) via the base-step hook ----
        fell = obj_pos[:, 2] < 0.1
        progress = jnp.where(is_success, 0, state.progress)
        reset = fell | (successes >= self.max_consecutive) | (
            progress >= self.max_episode_length - 1)
        reset = reset | self._extra_reset_rules(curr_ft_dist)
        reset = reset.astype(jnp.int32)

        # ---- curriculum (allegro_kuka_utils.py tolerance_curriculum) ----
        frames = task.frames + 1.0
        due = (frames - task.last_curriculum_update) >= self.tol_interval
        good = jnp.mean(task.prev_episode_successes) >= 3.0
        upd = due & good
        new_tol = jnp.clip(task.success_tolerance * self.tol_increment,
                           self.target_tolerance, self.initial_tolerance)
        success_tolerance = jnp.where(upd, new_tol, task.success_tolerance)
        last_update = jnp.where(upd, frames, task.last_curriculum_update)

        # ---- full_state obs (ref compute_full_state :1091-1172) ----
        dof_pos = self.engine.dof_pos(state.sim)[:, : self.nd]
        palm_states = jnp.concatenate([
            palm_rot, out.body_vel[:, self.palm_bodies]], -1)  # (N, A, 10)
        ft_rel_palm = (ft_tip.reshape(n, self.num_arms, self.num_fingertips, 3)
                       - palm_center[:, :, None, :]).reshape(n, -1)
        kp_rel_palm = (kp_obj[:, None, :, :]
                       - palm_center[:, :, None, :]).reshape(n, -1)
        obs = jnp.concatenate([
            maths.unscale(dof_pos, self.dof_lower, self.dof_upper),
            dof_vel,
            palm_center.reshape(n, -1),
            palm_states.reshape(n, -1),
            jnp.concatenate([obj_rot, obj[:, 7:13]], -1),
            ft_rel_palm,
            kp_rel_palm,
            kp_rel_goal.reshape(n, -1),
            jnp.broadcast_to(self.object_scales, (n, 3)),  # object scales
            closest_kp[:, None],
            closest_ft,
            lifted.astype(jnp.float32)[:, None],
            jnp.log(progress[:, None] / 10.0 + 1.0),
            jnp.log(successes[:, None] + 1.0),
            task.prev_rew[:, None] * 1.0,
        ], -1)

        true_obj = self._true_objective(task, successes)
        task = task._replace(
            successes=successes, near_goal_steps=near_goal_steps,
            goal_reset=is_success.astype(jnp.int32),
            lifted_object=lifted,
            closest_keypoint_max_dist=closest_kp,
            closest_fingertip_dist=closest_ft,
            furthest_hand_dist=furthest_hand,
            prev_targets=self._new_targets,
            rb_force=self._task_force,
            success_tolerance=success_tolerance,
            last_curriculum_update=last_update, frames=frames,
            prev_rew=reward * 0.01)
        extras = {
            "successes": jnp.mean(task.prev_episode_successes),
            "true_objective": true_obj,
            "true_objective_mean": jnp.mean(true_obj),
            "consecutive_successes": jnp.mean(task.prev_episode_successes),
            "_reset_progress_mask": is_success,
        }
        return obs, None, reward, reset, task, extras

    def _extra_reset_rules(self, curr_ft_dist):
        return jnp.zeros(curr_ft_dist.shape[0], bool)

    def get_env_state(self, state: EnvState):
        """Curriculum state persists into checkpoints (ref :472-493)."""
        return {"success_tolerance": state.task.success_tolerance}

    def set_env_state(self, state: EnvState, env_state):
        if env_state and "success_tolerance" in env_state:
            task = state.task._replace(
                success_tolerance=jnp.asarray(env_state["success_tolerance"],
                                              jnp.float32))
            return state._replace(task=task)
        return state

    def set_train_info(self, state: EnvState, env_frames):
        return state


class AllegroKukaReorientation(AllegroKukaBase):
    """Match the goal cube pose in the air (allegro_kuka_reorientation.py)."""

    def _keypoint_offsets_unit(self):
        return [[1, 1, 1], [1, 1, -1], [-1, -1, 1], [-1, -1, -1]]

    def _extra_reset_rules(self, curr_ft_dist):
        # hand far from the object (ref :152-156)
        return curr_ft_dist.max(-1) > 1.5


class AllegroKukaRegrasping(AllegroKukaBase):
    """Lift and hold at a target point; object re-spawns per goal
    (allegro_kuka_regrasping.py — single centroid keypoint)."""

    reset_object_on_goal_reset = True

    def _keypoint_offsets_unit(self):
        return [[0, 0, 0]]

    def _sample_target(self, key, n, task):
        k1, _ = jax.random.split(key)
        lo = TARGET_ORIGIN + TARGET_EXTENT[:, 0]
        size = TARGET_EXTENT[:, 1] - TARGET_EXTENT[:, 0]
        pos = jnp.asarray(lo) + jax.random.uniform(k1, (n, 3)) * jnp.asarray(size)
        ident = jnp.tile(jnp.asarray([0.0, 0, 0, 1.0]), (n, 1))
        return jnp.concatenate([pos, ident], -1)


class AllegroKukaThrow(AllegroKukaBase):
    """Throw the cube into a bucket placed beside the table
    (allegro_kuka_throw.py — goal sampled at the bucket mouth)."""

    reset_object_on_goal_reset = True

    def _keypoint_offsets_unit(self):
        return [[0, 0, 0]]

    def _sample_target(self, key, n, task):
        ks = jax.random.split(key, 4)
        lr = jax.random.uniform(ks[0], (n, 1), minval=-1.0, maxval=1.0)
        x = jnp.where(lr > 0, 0.5, -0.5) + jnp.sign(lr) * \
            jax.random.uniform(ks[1], (n, 1), minval=0.0, maxval=0.4)
        y = jax.random.uniform(ks[2], (n, 1), minval=-1.0, maxval=0.7)
        z = jax.random.uniform(ks[3], (n, 1), minval=0.0, maxval=1.0) + 0.05
        ident = jnp.tile(jnp.asarray([0.0, 0, 0, 1.0]), (n, 1))
        return jnp.concatenate([x, y, z, ident], -1)


# ---------------------------------------------------------------------------
class AllegroKukaTwoArmsBase(AllegroKukaBase):
    """Two mirrored arms around the table (allegro_kuka_two_arms.py)."""

    num_arms = 2

    def _arm_poses(self):
        # armXOfs=1.1 armYOfs=0.15: arms straddle the table, facing each other
        # (allegro_kuka_two_arms.py arm placement)
        x, y = 1.1 / 2, 0.15

        def qz(a):
            return (0.0, 0.0, float(np.sin(a / 2)), float(np.cos(a / 2)))

        table_xy = ARM_POS + np.array([0.0, -0.8, 0.0], np.float32)
        return [(table_xy + np.array([-x, y, 0.0], np.float32), qz(-np.pi / 2)),
                (table_xy + np.array([x, y, 0.0], np.float32), qz(np.pi / 2))]

    def _object_start(self):
        return TABLE_POS + np.array([0.0, 0.0, 0.25], np.float32)


class AllegroKukaTwoArmsReorientation(AllegroKukaTwoArmsBase,
                                      AllegroKukaReorientation):
    pass


class AllegroKukaTwoArmsRegrasping(AllegroKukaTwoArmsBase,
                                   AllegroKukaRegrasping):
    pass


SUBTASKS = dict(reorientation=AllegroKukaReorientation,
                regrasping=AllegroKukaRegrasping,
                throw=AllegroKukaThrow)
TWO_ARMS_SUBTASKS = dict(reorientation=AllegroKukaTwoArmsReorientation,
                         regrasping=AllegroKukaTwoArmsRegrasping)


def resolve_allegro_kuka(cfg):
    """Subtask dispatch (reference tasks/__init__.py:65-77)."""
    return SUBTASKS[cfg["env"].get("subtask", "reorientation")](cfg)


def resolve_allegro_kuka_two_arms(cfg):
    return TWO_ARMS_SUBTASKS[cfg["env"].get("subtask", "reorientation")](cfg)
