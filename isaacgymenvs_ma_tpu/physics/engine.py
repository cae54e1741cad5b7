"""Batched reduced-coordinate rigid-body physics core (the PhysX replacement).

This module replaces the reference's external L0 physics layer (PhysX GPU via
the ``isaacgym`` binary, imported at ``tasks/base/vec_task.py:37``) with a
batched JAX design:

* **World-frame joint-space dynamics.**  All spatial quantities (velocities,
  inertias, joint motion subspaces) are expressed about the world origin, so
  the tree algorithms (CRBA mass matrix, RNEA bias force, subtree force sums)
  become *ancestor-mask einsums* batched over the env axis — no per-body 6x6
  frame transforms, no gather/scatter.  The only sequential parts are forward
  kinematics (unrolled over <= ~20 bodies) and one batched small-matrix
  factorization per substep.
* **Implicit joint springs / damping / PD drives** folded into the mass-matrix
  diagonal, so stiff position drives (Franka kp, BallBalance kp 4000 —
  ``tasks/ball_balance.py:289-299``) are stable at the reference's 1/120 s
  substep.
* **Velocity-level contact solve** (unilateral plane/terrain contacts + joint
  limits) by projected Jacobi iteration with relaxation over a *static*
  contact-candidate set — the analog of PhysX's TGS iterations
  (``cfg/task/Ant.yaml:58`` ``num_position_iterations``) with the fixed-shape
  guarantees XLA needs.  Friction is a per-axis box clamp at mu * lambda_n.
* One factorized inverse serves smooth dynamics, the contact Delassus
  operator, and (later) OSC / mass-matrix readouts for the MA tasks
  (``franka_reach_MA.py:770-802, 891-911``).

State is a tiny pytree ``SimState(q, qd)``; everything else is recomputed —
the reference's acquire/refresh/set tensor dance (``tasks/ant.py:77-95``)
collapses into pure-function state threading.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import model as md
from ..ops import maths
from .fk_kernel import fk_motion

# Matmul precision tiers.  The inertia -> CRBA -> inverse -> Delassus chain
# must keep the mass matrix positive definite: at a 1-pass bfloat16 tier it
# lost definiteness and diverged Ant training.  On an H100, DEFAULT runs
# float32 products in TF32 (about 11 good bits measured) while HIGH and
# HIGHEST both give full float32 (about 22 bits) at the same end-to-end
# speed, so the chain runs at HIGHEST.  The contact-solver matvecs stay at
# DEFAULT: the sim-health safety net bounds solver drift, while an
# indefinite mass matrix poisons everything.  PERF.md has the measurement.
# Override with IGMA_MATMUL_PRECISION / IGMA_SOLVER_PRECISION =
# default|high|highest.
import os as _os

_PREC = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}
_HI = _PREC[_os.environ.get("IGMA_MATMUL_PRECISION", "highest")]
_SOLVER = _PREC[_os.environ.get("IGMA_SOLVER_PRECISION", "default")]


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


class SimParams(NamedTuple):
    """Mirror of the reference's sim-param schema (vec_task.py:516-564)."""

    dt: float = 1.0 / 60.0
    substeps: int = 2
    gravity: tuple = (0.0, 0.0, -9.81)
    num_iterations: int = 8         # contact solver iterations per substep
    relaxation: float = 0.35        # Jacobi relaxation
    baumgarte: float = 0.2          # error-correction fraction per substep
    contact_slop: float = 0.001     # penetration tolerance (m)
    max_depenetration_velocity: float = 10.0  # physx cfg parity
    # speculative contact margin (PhysX contact_offset): rows activate at
    # phi < margin with target normal velocity -phi/h, so an approaching
    # surface decelerates BEFORE penetrating.  Essential for thin features
    # (a hex-nut wall is 3.5 mm: a pad crossing >1.75 mm/substep lands past
    # the SDF ridge where the gradient points through the part — the solver
    # then ejects it out the far side).  0.0 = activate on penetration only.
    contact_margin: float = 0.0
    # Terrain contact frames from the heightfield surface normal (lateral
    # wall support on steep features).  Default OFF: bilinear interpolation
    # blurs stair risers into one-cell steep ramps, and tilted normals
    # there turn the old ramp-assist into constant lateral shoves near
    # every step edge — a measured terrain-curriculum regression
    # (curriculum level 2.6 at 1040 epochs vs ~4.0 without it; stairs
    # 2.2 vs 4.8).  Kept as an opt-in for stepping-stones experiments.
    terrain_normal_frames: bool = False
    plane_friction: float = 1.0
    plane_restitution: float = 0.0
    # impacts slower than this along the contact normal don't bounce
    # (physx bounce_threshold_velocity); restitution itself is per-env/body
    # via PhysScales.restitution
    bounce_threshold_velocity: float = 0.2
    # evaluate the articulation inertia/mass-matrix chain once per control
    # step and reuse across substeps (PhysX evaluates articulation inertia
    # once per step the same way); the chain drifts O(h*qd) within a step.
    # On the previous accelerator it was both faster and gave the best Ant
    # training curve of the precision sweep; not yet re-measured on the GPU
    reuse_mass_matrix: bool = True
    # PhysX-style mass splitting for the Jacobi iteration: scale each contact
    # row's correction by 1/(active rows sharing its movable bodies).  Plain
    # projected Jacobi diverges once R coincident rows satisfy R*relaxation
    # > 2 (e.g. a mesh contact cloud resting face-down); splitting restores
    # the single-row effective step.  Off by default (sparse-contact
    # locomotion scenes converge faster without it); enabled by the
    # mesh-cloud tasks (Factory/IndustReal) via sim.physx.mass_splitting
    mass_splitting: bool = False
    # store the loop-invariant contact-row matrices (J, H^-1 J, H^-1) in
    # bfloat16 inside the solver iteration scan; accumulation stays f32.
    # None = auto: on when rows*nv >= 1024, where the loop is bound by
    # memory traffic (dense hand contacts), off for small scenes.  The
    # threshold was chosen on the previous accelerator and is not yet
    # re-measured on the GPU.
    solver_rows_bf16: Optional[bool] = None
    # iterate only the K deepest contact rows per env (active-set compaction,
    # the PhysX contact-buffer analog).  None = all candidate rows.  Exact
    # while #active <= K; see _contact_solve.  Set from the task sim config
    # (sim.physx.contact_capacity).
    contact_capacity: Optional[int] = None
    # build the contact row set (narrowphase, active-set selection, Jacobians,
    # Delassus diagonals, frames) once per control step and reuse it across
    # substeps — the PhysX model exactly: contact generation runs once per
    # step and TGS substeps iterate on the same contact set with penetration
    # tracked geometrically.  Penetrations advance by h * (relative normal
    # velocity) through the cached Jacobian (terrain rows re-sample the
    # heightfield at advanced positions), and each substep's impulses warm
    # the next.  O(h*qd) row drift, same order as reuse_mass_matrix.
    # Default OFF: on Ant it cost training quality (reward 3763/6279 ->
    # ~2300/5767 at 150 epochs over two seeds, found on the previous
    # accelerator — locomotion foot strikes are sensitive to
    # one-substep-stale row geometry).  Manipulation scenes (persistent
    # grasps, tiny relative velocities) enable it per task via
    # sim.physx.reuse_contact_rows (ShadowHand, Trifinger, FrankaReachMA),
    # where it was faster on the previous accelerator.  It loses without
    # active-set compaction when the full-row Jacobian cache is large
    # (materializing the cache across the substep boundary costs more
    # memory traffic than the fused rebuild).  None of these speed choices
    # is re-measured on the GPU yet.
    reuse_contact_rows: bool = False
    # with reuse_contact_rows: seed each later substep's iteration from the
    # previous substep's converged impulses (the PhysX persistent-contact
    # warm start within a step).  Ant quality evidence is mixed; grasping
    # scenes keep it on.
    contact_continuation: bool = True
    # contact warm starting (the PhysX persistent-contact warm-start analog):
    # seed each substep's Jacobi solve with this fraction of the previous
    # substep's converged impulses, carried in SimState.lam and zeroed on env
    # reset.  Persistent contacts (a standing Ant's feet) then need far fewer
    # iterations to reconverge, so num_iterations can drop.  0.0 = cold start
    # (bitwise-identical to the pre-warm-start build).
    warm_start: float = 0.0


class Control(NamedTuple):
    """Per-step actuation inputs (the set_dof_actuation/set_target tensors).

    ``tau``: direct dof-space torque/force (DOF_MODE_EFFORT path,
    ``gym.set_dof_actuation_force_tensor`` — tasks/cartpole.py:159-163).
    ``pos_target``/``vel_target``: PD drive targets (DOF_MODE_POS/VEL).
    ``f_ext``: optional world-frame spatial wrench per body ``[torque, force]``
    about the body origin (rigid-body force application, e.g. Ingenuity).
    """

    tau: jax.Array
    pos_target: Optional[jax.Array] = None
    vel_target: Optional[jax.Array] = None
    f_ext: Optional[jax.Array] = None
    grab_active: Optional[jax.Array] = None  # (N, n_grabs) bool/float mask


class SimState(NamedTuple):
    q: jax.Array    # (N, nq)
    qd: jax.Array   # (N, nv)
    # contact warm-start impulses (SimParams.warm_start > 0):
    # (lam_rows (N, P, 3) row-frame, lam_lo (N, nv), lam_hi (N, nv)).
    # None when warm starting is off or the scene has no contact rows; tasks
    # that rebuild SimState(q, qd) drop it, and VecTaskBase.step restores it
    # (zeroed for resetting envs) so the carried pytree structure is stable.
    lam: Any = None


class SimOutput(NamedTuple):
    """Derived per-step readouts (the refresh_* tensor family)."""

    body_pos: jax.Array        # (N, nb, 3)
    body_quat: jax.Array       # (N, nb, 4)
    body_vel: jax.Array        # (N, nb, 6) [linvel at origin point of body, angvel]
    root_states: jax.Array     # (N, num_actors, 13) pos quat linvel angvel
    contact_force: jax.Array   # (N, nb, 3) net contact force per body (world)
    sensor_forces: jax.Array   # (N, n_sensors, 6) [force, torque] in body frame
    qdd: jax.Array             # (N, nv) smooth accelerations (pre-contact)
    dof_force: jax.Array       # (N, nv) applied + constraint generalized force
                               # (the acquire_dof_force_tensor readout)


def _cross(a, b):
    return jnp.cross(a, b)


def _sweep_inverse_batchlast(M: jax.Array) -> jax.Array:
    """In-place Gauss-Jordan (sweep-operator) inverse on a batch-last matrix
    stack ``M (n, n, B)``.

    Every op is an elementwise mul/sub/select over the batch dimension — no
    matmuls, no scatters — so it runs in full float32 whatever the matmul
    precision, and XLA fuses the unrolled sweep.  No pivoting: mass
    matrices are SPD, so diagonal pivots never vanish."""
    n = M.shape[0]
    i_n1 = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)
    i_1n1 = jax.lax.broadcasted_iota(jnp.int32, (1, n, 1), 1)
    i_n11 = jax.lax.broadcasted_iota(jnp.int32, (n, 1, 1), 0)
    for k in range(n):
        mk = i_n1 == k
        inv_d = 1.0 / M[k, k]
        row = M[k] * inv_d                              # (n, B)
        col = jnp.where(mk, 0.0, M[:, k])               # (n, B), row k zeroed
        M = M - col[:, None, :] * row[None, :, :]
        new_col = jnp.where(mk, inv_d, -col * inv_d)
        new_row = jnp.where(mk, inv_d, row)
        M = jnp.where(i_1n1 == k, new_col[:, None, :], M)
        M = jnp.where(i_n11 == k, new_row[None, :, :], M)
    return M


def spd_inverse(H: jax.Array) -> jax.Array:
    """Batched inverse of symmetric positive definite matrices (..., n, n).

    The Gauss-Jordan sweep with the batch moved last.  Chosen on an H100
    over the recursive Schur-complement form, batched LU and Cholesky: the
    end-to-end Ant step was fastest with it, and it needs no matmul
    precision setting (PERF.md has the numbers)."""
    n = H.shape[-1]
    if n == 1:
        return 1.0 / H
    M = jnp.moveaxis(H.reshape((-1, n, n)), 0, -1)          # (n, n, B)
    return jnp.moveaxis(_sweep_inverse_batchlast(M), -1, 0).reshape(H.shape)


class PhysicsEngine:
    """Compiled-once physics stepper for one scene replicated over N envs."""

    def __init__(self, model: md.SceneModel, params: SimParams,
                 ground: bool = True, pair_specs=None, attractors=None,
                 grabs=None):
        """``pair_specs``: list of (geom_a, geom_b) collision pairs — candidate
        points of geom_a against the SDF of geom_b (ball-vs-tray, cube-vs-hand,
        corner-vs-table...).  Static, fixed-shape narrowphase."""
        self.model = model
        self.params = params
        self.ground = ground
        f32 = lambda x: jnp.asarray(x, jnp.float32)
        i32 = lambda x: jnp.asarray(x, jnp.int32)

        m = model
        self.nb, self.nq, self.nv = m.nb, m.nq, m.nv
        self.parent = np.asarray(m.parent)
        self.jnt_type_np = np.asarray(m.jnt_type)
        self.q_adr = np.asarray(m.q_adr)
        self.v_adr = np.asarray(m.v_adr)

        self.body_pos = f32(m.body_pos)
        self.body_quat = f32(m.body_quat)
        self.jnt_axis = f32(m.jnt_axis)
        self.jnt_pos = f32(m.jnt_pos)
        self.jnt_pitch_np = (np.asarray(m.jnt_pitch)
                             if len(m.jnt_pitch) == m.nb
                             else np.zeros(m.nb))
        self.grav_mask = f32(np.asarray(m.body_gravity)
                             if len(getattr(m, "body_gravity", [])) == m.nb
                             else np.ones(m.nb))
        # per-body rigid damping (PhysX asset_options.linear/angular_damping
        # — the Factory franka sets 1.0/5.0 "to improve stability",
        # factory_base.py:122-125): dissipative wrench -d_lin*m*v_com /
        # -d_ang*(R I R^T) w, the stabilizer for task axes the factory OSC
        # leaves uncontrolled
        bld = np.asarray(getattr(m, "body_lin_damping", np.zeros(0)))
        bad = np.asarray(getattr(m, "body_ang_damping", np.zeros(0)))
        self.body_damp_lin = f32(bld if len(bld) == m.nb else np.zeros(m.nb))
        self.body_damp_ang = f32(bad if len(bad) == m.nb else np.zeros(m.nb))
        self.has_body_damping = bool((len(bld) == m.nb and bld.any())
                                     or (len(bad) == m.nb and bad.any()))
        self.mass = f32(m.mass)
        self.com = f32(m.com)
        self.inertia = f32(m.inertia)
        self.dof_body = i32(m.dof_body)
        self.dof_damping = f32(m.dof_damping)
        self.dof_spring = f32(m.dof_spring)
        self.dof_armature = f32(m.dof_armature)
        self.dof_lower = f32(m.dof_lower)
        self.dof_upper = f32(m.dof_upper)
        self.dof_has_limit = jnp.asarray(m.dof_has_limit)
        self.dof_effort_limit = f32(m.dof_effort_limit)
        self.dof_velocity_limit = f32(m.dof_velocity_limit)
        # per-dof Coulomb friction torque (PhysX dof_properties['friction'])
        dfr = np.asarray(getattr(m, "dof_friction", np.zeros(0)))
        if len(dfr) != m.nv:
            dfr = np.zeros(m.nv)
        self.dof_friction = f32(dfr)
        self.has_dof_friction = bool(np.any(dfr > 0.0))
        self.dof_stiffness = f32(m.dof_stiffness)
        self.dof_drive_damping = f32(m.dof_drive_damping)
        self.dof_drive_mode = np.asarray(m.dof_drive_mode)

        # structure masks as f32 for einsum contractions
        self.body_anc_f = f32(m.body_ancestor)          # (nb, nb)
        self.dof_body_mask_f = f32(m.dof_body_mask)     # (nv, nb)
        # CRBA mask: count each (i, j) pair once — strict ancestor body, or
        # same body with i <= j (multi-dof free joints would otherwise get
        # their off-diagonal block double-counted by the symmetrization)
        dof_body_np = np.asarray(m.dof_body)
        same_body = dof_body_np[:, None] == dof_body_np[None, :]
        iu = np.arange(m.nv)
        upper_tri = iu[:, None] <= iu[None, :]
        anc = np.asarray(m.dof_ancestor)
        self.dof_anc = jnp.asarray((anc & ~same_body) | (same_body & upper_tri))

        # dof bookkeeping: which q index each 1-dof joint reads
        jq = []
        jv = []
        dof_is_angular = np.zeros(m.nv, bool)
        for b in range(m.nb):
            t = int(m.jnt_type[b])
            if t in (md.HINGE, md.SLIDE, md.SCREW):
                jq.append(m.q_adr[b])
                jv.append(m.v_adr[b])
                dof_is_angular[m.v_adr[b]] = t in (md.HINGE, md.SCREW)
            elif t == md.FREE:
                dof_is_angular[m.v_adr[b] + 3: m.v_adr[b] + 6] = True
        # map (nv,) -> scalar joint coordinate where applicable
        self.dof_qid = np.full(m.nv, -1, np.int32)
        for b in range(m.nb):
            t = int(m.jnt_type[b])
            if t in (md.HINGE, md.SLIDE, md.SCREW):
                self.dof_qid[m.v_adr[b]] = m.q_adr[b]
        self.scalar_dofs = np.nonzero(self.dof_qid >= 0)[0]
        self.scalar_qids = self.dof_qid[self.scalar_dofs]
        self.dof_is_angular = dof_is_angular

        # contact candidate points from geoms: (body, offset(3) body frame, radius)
        pts_body, pts_off, pts_rad, pts_mu = [], [], [], []
        geom_pts = {}
        for gi, g in enumerate(m.geoms):
            if not g.contact:
                continue
            Rg = md._quat_to_mat_np(g.quat)
            if getattr(g, "contact_points", None) is not None:
                # explicit candidate cloud (mesh surface samples etc.)
                cands = [np.asarray(c, np.float64)
                         for c in g.contact_points]
                r = float(g.size[0]) if g.gtype == md.GEOM_SPHERE else 0.0
            elif g.gtype == md.GEOM_SPHERE:
                cands = [np.zeros(3)]
                r = g.size[0]
            elif g.gtype == md.GEOM_CAPSULE:
                hl = g.size[1]
                cands = [np.array([0, 0, -hl]), np.array([0, 0, hl])]
                r = g.size[0]
            elif g.gtype == md.GEOM_BOX:
                hx, hy, hz = g.size
                cands = [np.array([sx * hx, sy * hy, sz * hz])
                         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
                r = 0.0
            else:
                continue
            geom_pts[gi] = list(range(len(pts_body), len(pts_body) + len(cands)))
            for c in cands:
                pts_body.append(g.body)
                pts_off.append(g.pos + Rg @ c)
                pts_rad.append(r)
                pts_mu.append(g.friction)
        self.n_pts = len(pts_body)
        self.geom_pts = geom_pts
        if self.n_pts:
            self.pts_body = np.array(pts_body, np.int32)
            self.pts_off = f32(np.stack(pts_off))
            self.pts_rad = f32(np.array(pts_rad))
            self.pts_mu = f32(np.array(pts_mu))
            # (nv, n_pts) dof-ancestor mask for contact jacobians
            self.pts_dof_mask = f32(np.asarray(m.dof_body_mask)[:, self.pts_body])
        # Ground-row subset: candidates on fixed-base trees that provably can
        # never reach the ground plane are pruned at build time (PhysX's
        # broadphase culls these dynamically; our static-shape analog is a
        # sound kinematic reach bound).  ShadowHand: 80 -> 16 rows.
        if self.n_pts:
            keep = np.nonzero(self._ground_reachable(m))[0]
            self.gnd_idx = keep.astype(np.int32)
            self.n_ground = len(keep)
            self.gnd_body = self.pts_body[keep]
            self.gnd_off = self.pts_off[keep]
            self.gnd_rad = self.pts_rad[keep]
            self.gnd_mu = self.pts_mu[keep]
            self.gnd_dof_mask = self.pts_dof_mask[:, keep]
        else:
            self.n_ground = 0
        self.sensor_body = np.asarray(m.sensor_body)
        sp = np.asarray(m.sensor_pos)
        if sp.shape != (len(self.sensor_body), 3):
            sp = np.zeros((len(self.sensor_body), 3))
        self.sensor_pos = f32(sp)
        self.actor_root_body = np.asarray(m.actor_root_body)

        # body-pair contacts: points of geom A vs SDF of geom B
        self.pairs = []
        dbm = np.asarray(m.dof_body_mask, np.float32)  # (nv, nb)
        for (ga, gb) in (pair_specs or []):
            gA, gB = m.geoms[ga], m.geoms[gb]
            idx = np.asarray(geom_pts[ga], np.int32)
            row_mask = dbm[:, self.pts_body[idx]].T - dbm[:, gB.body][None, :]
            pair = dict(
                pt_idx=idx,
                tgt_body=int(gB.body),
                tgt_type=int(gB.gtype),
                tgt_size=f32(gB.size),
                tgt_pos=f32(gB.pos),
                tgt_quat=f32(gB.quat),
                mu=float(0.5 * (gA.friction + gB.friction)),
                row_mask=f32(row_mask),          # (k, nv) signed
            )
            if gB.gtype == md.GEOM_SDF:
                # baked mesh target: narrowphase samples the voxel grid
                from . import sdf_grid as _sg
                pair["grid"] = _sg.SDFGrid(
                    values=f32(gB.sdf_values),
                    origin=f32(gB.sdf_origin),
                    spacing=f32(gB.sdf_spacing))
            self.pairs.append(pair)
        self.n_pair_rows = sum(len(p["pt_idx"]) for p in self.pairs)
        # static contact-row body attribution (A gets +f, B gets -f; -1 = world)
        ra, rb = [], []
        if ground and self.n_ground:
            ra.extend(self.gnd_body.tolist())
            rb.extend([-1] * self.n_ground)
        for p_ in self.pairs:
            ra.extend(self.pts_body[p_["pt_idx"]].tolist())
            rb.extend([p_["tgt_body"]] * len(p_["pt_idx"]))
        self.row_body_a = np.asarray(ra, np.int32)
        self.row_body_b = np.asarray(rb, np.int32)
        # mass-splitting support: per-row one-hot over the MOVABLE bodies the
        # row pushes on (world/-1 and dof-less fixed structure excluded) —
        # used to count active rows per body (SimParams.mass_splitting)
        movable = np.asarray(m.dof_body_mask).any(axis=0)       # (nb,)
        oh = np.zeros((len(ra), m.nb), np.float32)
        for r, (ba, bb) in enumerate(zip(ra, rb)):
            if ba >= 0 and movable[ba]:
                oh[r, ba] = 1.0
            if bb >= 0 and movable[bb]:
                oh[r, bb] = 1.0
        self._row_body_oh = jnp.asarray(oh)                     # (P_all, nb)

        # grab constraints: conditional bilateral body<->body point pins used
        # to model grasping (gripper suction) — activation per env via
        # Control.grab_active
        self.grabs = []
        for (ba, offa, bb, offb) in (grabs or []):
            self.grabs.append(dict(
                body_a=int(ba), off_a=f32(offa),
                body_b=int(bb), off_b=f32(offb),
                mask=f32(dbm[:, int(ba)] - dbm[:, int(bb)]),
            ))

        # attractors: soft-pin a body point to a world point (translation axes)
        # — gymapi.create_rigid_body_attractor, solved as bilateral rows
        self.attractors = []
        for (ab, offset, target) in (attractors or []):
            self.attractors.append(dict(
                body=int(ab),
                offset=f32(offset),
                target=f32(target),
                mask=f32(dbm[:, ab]),
            ))

        self.gravity = f32(params.gravity)
        self.h = params.dt / params.substeps

        # precomputed one-hot selection matrices (dof -> body, q -> dof)
        eye_nb = np.eye(m.nb, dtype=np.float32)
        self.oh_dof_body = jnp.asarray(eye_nb[np.asarray(m.dof_body)])   # (nv, nb)
        q2d = np.zeros((m.nv, m.nq), np.float32)
        for d, qid in zip(self.scalar_dofs, self.scalar_qids):
            q2d[d, qid] = 1.0
        self.q_to_dof = jnp.asarray(q2d)                                  # (nv, nq)

    # ------------------------------------------------------------------
    # kinematics
    def fk(self, q: jax.Array):
        """Forward kinematics: world body poses.  Batched over leading axes."""
        m = self.model
        xs, qs = [], []
        for b in range(self.nb):
            t = int(self.jnt_type_np[b])
            qa = int(self.q_adr[b])
            if self.parent[b] == -1:
                xp = jnp.zeros(q.shape[:-1] + (3,), q.dtype)
                qp = jnp.broadcast_to(
                    jnp.array([0, 0, 0, 1], q.dtype), q.shape[:-1] + (4,))
            else:
                xp, qp = xs[self.parent[b]], qs[self.parent[b]]
            if t == md.FREE:
                xb = q[..., qa: qa + 3]
                qb = q[..., qa + 3: qa + 7]
            else:
                bp, bq = self.body_pos[b], self.body_quat[b]
                if t in (md.HINGE, md.SCREW):
                    qj = maths.quat_from_angle_axis(q[..., qa], self.jnt_axis[b])
                    ql = maths.quat_mul(jnp.broadcast_to(bq, qj.shape), qj)
                    anchor = self.jnt_pos[b]
                    tl = bp + maths.quat_apply(bq, anchor) - maths.quat_apply(ql, anchor)
                    if t == md.SCREW:
                        # helical coupling: axis translation pitch/(2*pi)*q
                        pitch = float(self.jnt_pitch_np[b]) / (2.0 * np.pi)
                        tl = tl + maths.quat_apply(bq, self.jnt_axis[b]) \
                            * (pitch * q[..., qa: qa + 1])
                elif t == md.SLIDE:
                    ql = jnp.broadcast_to(bq, qp.shape)
                    tl = bp + maths.quat_apply(bq, self.jnt_axis[b]) * q[..., qa: qa + 1]
                else:  # FIXED
                    ql = jnp.broadcast_to(bq, qp.shape)
                    tl = jnp.broadcast_to(bp, xp.shape)
                xb = xp + maths.quat_apply(qp, tl)
                qb = maths.quat_mul(qp, ql)
            xs.append(xb)
            qs.append(qb)
        return jnp.stack(xs, axis=-2), jnp.stack(qs, axis=-2)

    def dof_motion(self, body_x, body_q):
        """Motion subspace S (N, nv, 6) about the world origin: [ang, lin].

        Built as a single stack of per-dof columns in dof order — no
        scatters; the concatenations fuse."""
        N = body_x.shape[0]
        dt = body_x.dtype
        zero3 = jnp.zeros((N, 3), dt)
        cols = []
        for b in range(self.nb):
            t = int(self.jnt_type_np[b])
            if t == md.FREE:
                e = jnp.eye(3, dtype=dt)
                p = body_x[:, b]
                for i in range(3):  # linear dofs
                    ei = jnp.broadcast_to(e[i], (N, 3))
                    cols.append(jnp.concatenate([zero3, ei], -1))
                for i in range(3):  # angular dofs about the body origin
                    ei = jnp.broadcast_to(e[i], (N, 3))
                    cols.append(jnp.concatenate([ei, _cross(p, ei)], -1))
            elif t == md.HINGE:
                a_w = maths.quat_apply(body_q[:, b], self.jnt_axis[b])
                anchor = body_x[:, b] + maths.quat_apply(body_q[:, b], self.jnt_pos[b])
                cols.append(jnp.concatenate([a_w, _cross(anchor, a_w)], -1))
            elif t == md.SLIDE:
                a_w = maths.quat_apply(body_q[:, b], self.jnt_axis[b])
                cols.append(jnp.concatenate([zero3, a_w], -1))
            elif t == md.SCREW:
                a_w = maths.quat_apply(body_q[:, b], self.jnt_axis[b])
                anchor = body_x[:, b] + maths.quat_apply(body_q[:, b], self.jnt_pos[b])
                pitch = float(self.jnt_pitch_np[b]) / (2.0 * np.pi)
                cols.append(jnp.concatenate(
                    [a_w, _cross(anchor, a_w) + pitch * a_w], -1))
        return jnp.stack(cols, axis=1)

    def body_velocities(self, S, qd):
        """Spatial velocity [ang, lin@origin] per body: V (N, nb, 6)."""
        Sqd = S * qd[..., None]
        return jnp.matmul(self.dof_body_mask_f.T, Sqd)

    # ------------------------------------------------------------------
    # dynamics pieces
    def spatial_inertia(self, body_x, body_q, mass_scale=None,
                        shape_scale=None):
        """World spatial inertia about the origin, (N, nb, 6, 6).

        ``mass_scale``: optional per-env factor (N, 1|nb) — DR mass scaling
        (scales inertia proportionally, like PhysX density scaling).
        ``shape_scale``: optional per-env anisotropic geometry scale
        (N, nb, 3) in the body frame — per-env object-dimension
        randomization (reference generates one URDF per cuboid size,
        allegro_kuka/generate_cuboids.py:38-81; here sizes are per-env
        leaves).  Mass scales by sx*sy*sz; the local inertia transforms
        exactly for uniform density via the second-moment matrix
        C = tr(I)/2·1 − I,  C' = (sx sy sz)·S C S,  I' = tr(C')·1 − C'."""
        R = maths.quat_to_rotmat(body_q)                       # (N, nb, 3, 3)
        I_loc = jnp.broadcast_to(self.inertia.astype(body_x.dtype), R.shape)
        com = self.com
        m = self.mass[None, :, None, None]
        if shape_scale is not None:
            s = shape_scale.astype(body_x.dtype)               # (N, nb, 3)
            svol = jnp.prod(s, axis=-1)[..., None, None]       # (N, nb, 1, 1)
            tr = jnp.einsum("...ii->...", I_loc)[..., None, None]
            Cm = 0.5 * tr * jnp.eye(3, dtype=body_x.dtype) - I_loc
            Cm = svol * (s[..., :, None] * Cm * s[..., None, :])
            trc = jnp.einsum("...ii->...", Cm)[..., None, None]
            I_loc = trc * jnp.eye(3, dtype=body_x.dtype) - Cm
            m = m * svol
            com = com * s
        Ic = _mm(_mm(R, I_loc), jnp.swapaxes(R, -1, -2))
        c = body_x + maths.quat_apply(body_q, com)             # world com
        if mass_scale is not None:
            m = m * mass_scale[:, :, None, None]
            Ic = Ic * mass_scale[:, :, None, None]
        cx = self._skew(c)                                     # (N, nb, 3, 3)
        mcx = m * cx
        top_left = Ic - m * _mm(cx, cx)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=body_x.dtype), cx.shape)
        I = jnp.concatenate(
            [
                jnp.concatenate([top_left, mcx], axis=-1),
                jnp.concatenate([-mcx, m * eye], axis=-1),
            ],
            axis=-2,
        )
        return I, c

    @staticmethod
    def _skew(v):
        zeros = jnp.zeros_like(v[..., 0])
        return jnp.stack(
            [
                jnp.stack([zeros, -v[..., 2], v[..., 1]], axis=-1),
                jnp.stack([v[..., 2], zeros, -v[..., 0]], axis=-1),
                jnp.stack([-v[..., 1], v[..., 0], zeros], axis=-1),
            ],
            axis=-2,
        )

    @staticmethod
    def _cross_motion(a, b):
        """Spatial motion cross product: a x b for [ang, lin] vectors."""
        aw, av = a[..., :3], a[..., 3:]
        bw, bv = b[..., :3], b[..., 3:]
        return jnp.concatenate([_cross(aw, bw), _cross(aw, bv) + _cross(av, bw)], axis=-1)

    @staticmethod
    def _cross_force(v, f):
        """Spatial force cross product: v x* f; v=[ang,lin] motion, f=[n,f]."""
        w, vl = v[..., :3], v[..., 3:]
        n, fl = f[..., :3], f[..., 3:]
        return jnp.concatenate([_cross(w, n) + _cross(vl, fl), _cross(w, fl)], axis=-1)

    def mass_matrix(self, S, I_O):
        """CRBA in world coordinates via ancestor-mask einsums: (N, nv, nv)."""
        # composite inertia: sum of descendants-or-self, as explicit
        # dot_generals over the static ancestor mask.
        N = I_O.shape[0]
        I_flat = I_O.reshape(N, self.nb, 36)
        # anc[b, j] I[n, j, :] -> (nb, N, 36) -> (N, nb, 36)
        comb = _mm(self.oh_dof_body @ self.body_anc_f, I_flat)
        IcC_dof = comb.reshape(N, self.nv, 6, 6)
        F = _mm(IcC_dof, S[..., None])[..., 0]                 # (N, nv, 6)
        G = _mm(S, jnp.swapaxes(F, -1, -2))                    # (N, nv, nv)
        upper = jnp.where(self.dof_anc, G, 0.0)
        diag = jnp.einsum("nii->ni", upper)
        M = upper + jnp.swapaxes(upper, -1, -2) - self._diag_embed(diag)
        return M

    @staticmethod
    def _diag_embed(d):
        return jnp.einsum("ni,ij->nij", d, jnp.eye(d.shape[-1], dtype=d.dtype))

    def gravity_wrench(self, body_x, body_q, mass_scale=None,
                       shape_scale=None):
        """Per-body gravity spatial force about the world origin, from
        FRESH kinematics, in the RNEA a0 = -g sign convention (N, nb, 6).

        Exists for the mass-matrix-reuse path: pushing gravity through a
        CACHED I_O pairs a stale com with the fresh motion subspace, which
        leaves a residual torque of |g|*h*v per substep on every
        translating floating base (a sliding sphere visibly spins up;
        round-3 regression tests/test_physics_core.py pin this)."""
        m = jnp.broadcast_to(self.mass[None, :], body_x.shape[:2])
        com = self.com
        if shape_scale is not None:
            s = shape_scale.astype(body_x.dtype)
            m = m * jnp.prod(s, axis=-1)
            com = com[None] * s
        c = body_x + maths.quat_apply(
            body_q, jnp.broadcast_to(com, body_x.shape))
        if mass_scale is not None:
            m = m * mass_scale
        f_lin = (m * self.grav_mask[None, :])[..., None] \
            * (-self.gravity)[None, None, :]
        return jnp.concatenate([jnp.cross(c, f_lin), f_lin], -1)

    def bias_force(self, S, qd, V, I_O, f_grav=None):
        """RNEA with qdd = 0 and a0 = -g: returns C (N, nv).

        ``f_grav``: fresh per-body gravity wrench (gravity_wrench) — REQUIRED
        whenever I_O is reused from an earlier substep, so gravity torque is
        taken about the current com, not the cached one.  When None (fresh
        I_O), gravity rides the a0 trick bit-identically to the original."""
        N = S.shape[0]
        V_dof = jnp.matmul(self.oh_dof_body, V)                # (N, nv, 6)
        xi = self._cross_motion(V_dof, S * qd[..., None])      # (N, nv, 6)
        a = jnp.matmul(self.dof_body_mask_f.T, xi)             # (N, nb, 6)
        if f_grav is None:
            # per-body gravity mask (asset_options.disable_gravity)
            a0 = jnp.concatenate(
                [jnp.zeros(3, S.dtype), -self.gravity]).astype(S.dtype)
            a = a + a0 * self.grav_mask[:, None]
        Iv = jnp.matmul(I_O, V[..., None])[..., 0]
        f = jnp.matmul(I_O, a[..., None])[..., 0] + self._cross_force(V, Iv)
        if f_grav is not None:
            f = f + f_grav
        f_sub_dof = jnp.matmul(self.oh_dof_body @ self.body_anc_f, f)
        C = jnp.sum(S * f_sub_dof, axis=-1)
        return C

    # ------------------------------------------------------------------
    # substep
    def substep(self, q, qd, ctrl: Control, terrain=None, phys=None,
                dyn_cache=None, warm=None, contact_cache=None):
        # dyn_cache: optional (I_O, M, Hinv) from an earlier substep of the
        # same control step.  The mass-matrix chain varies O(h*qd) within a
        # control step, so reusing it (PhysX evaluates articulation inertia
        # once per step too) halves the mass-matrix matmul volume;
        # FK / contact geometry / bias force always refresh.
        h = self.h
        N = q.shape[0]
        f32 = q.dtype

        body_x, body_q, S = fk_motion(self, q)
        shape_scale = None if phys is None else getattr(phys, "shape", None)

        V = self.body_velocities(S, qd)
        if dyn_cache is None:
            I_O, _ = self.spatial_inertia(
                body_x, body_q, None if phys is None else phys.mass,
                shape_scale)
            M = self.mass_matrix(S, I_O)
            C = self.bias_force(S, qd, V, I_O)
        else:
            # reused I_O: gravity must come from the FRESH com or every
            # translating floating base picks up |g|*h*v of torque
            I_O, M, _ = dyn_cache
            C = self.bias_force(
                S, qd, V, I_O,
                f_grav=self.gravity_wrench(
                    body_x, body_q,
                    None if phys is None else phys.mass, shape_scale))

        # scalar joint coordinates (hinge/slide) for springs, limits, drives
        qpos_dof = q @ self.q_to_dof.T

        kp_drive = jnp.where(
            jnp.asarray(self.dof_drive_mode == md.DRIVE_POS), self.dof_stiffness, 0.0
        ).astype(f32)
        kd_drive = jnp.where(
            jnp.asarray(self.dof_drive_mode != md.DRIVE_NONE), self.dof_drive_damping, 0.0
        ).astype(f32)
        k_spring = self.dof_spring
        d_damp = self.dof_damping
        armature = self.dof_armature
        eff_lim = self.dof_effort_limit
        jfric = self.dof_friction
        lo_shift = hi_shift = restitution = None
        if phys is not None:  # DR dof-property scaling (dr_utils.py:148-208)
            kp_drive = kp_drive * phys.stiffness
            kd_drive = kd_drive * phys.damping
            d_damp = d_damp * phys.damping
            # dextreme-ADR dof-property families (dof_properties.{armature,
            # effort,friction,lower,upper}.range + shape restitution)
            a_s = getattr(phys, "armature", None)
            if a_s is not None:
                armature = armature * a_s
            e_s = getattr(phys, "effort", None)
            if e_s is not None:
                eff_lim = eff_lim * e_s
            jf_s = getattr(phys, "joint_friction", None)
            if jf_s is not None:
                jfric = jfric * jf_s
            lo_shift = getattr(phys, "dof_lower_shift", None)
            hi_shift = getattr(phys, "dof_upper_shift", None)
            restitution = getattr(phys, "restitution", None)

        tau = ctrl.tau
        # clamp applied efforts like PhysX does
        tau = jnp.clip(tau, -eff_lim, eff_lim)
        rhs = tau - C
        rhs = rhs - k_spring * (qpos_dof + h * qd) - d_damp * qd
        if self.has_dof_friction or jfric is not self.dof_friction:
            # joint dry friction: smooth Coulomb (mu * tanh(qd/v0)); the
            # linearization at qd=0 (mu/v0) joins the implicit diagonal so
            # the stiction band is stable at any mu
            v0 = 0.05
            rhs = rhs - jfric * jnp.tanh(qd / v0)
        # PD drive force with PhysX's per-dof drive-force limit
        # (dof_props['effort'] clamps the DRIVE, not just applied forces —
        # the reference relies on this: AllegroHand kp=3 position drives are
        # clamped to 0.5 N*m, allegro_hand.py:263-266; unclamped they are
        # ~12x stronger and slap the cube instead of manipulating it).
        # Saturated dofs switch from the implicit PD formulation to an
        # explicit clamped force and drop their kp/kd stiffening from the
        # solve diagonal (an implicit drive pinned at its force limit no
        # longer stiffens the joint).
        drive = jnp.zeros_like(rhs)
        if ctrl.pos_target is not None:
            drive = drive + kp_drive * (ctrl.pos_target - qpos_dof - h * qd)
        if ctrl.vel_target is not None:
            drive = drive + kd_drive * (ctrl.vel_target - qd)
        else:
            drive = drive - kd_drive * qd
        drive_sat = jnp.abs(drive) > eff_lim
        rhs = rhs + jnp.clip(drive, -eff_lim, eff_lim)
        imp = jnp.where(drive_sat, 0.0, 1.0)
        # external body wrenches -> generalized forces
        if ctrl.f_ext is not None:
            # f_ext per body about its own origin -> about world origin
            n_b, f_b = ctrl.f_ext[..., :3], ctrl.f_ext[..., 3:]
            n_o = n_b + _cross(body_x, f_b)
            f_o = jnp.concatenate([n_o, f_b], axis=-1)         # (N, nb, 6)
            rhs = rhs + jnp.einsum("nvd,vb,nbd->nv", S, self.dof_body_mask_f, f_o)

        if self.has_body_damping:
            # per-body rigid damping (PhysX linear/angular_damping): force
            # -d_lin*m*v_com at the COM, torque -d_ang*L_world.  Explicit is
            # stable here: max(d)*h ~ 5/120 per substep.
            w_b, v_O = V[..., 0:3], V[..., 3:6]
            com_w = body_x + maths.quat_apply(body_q, self.com[None])
            v_com = v_O + jnp.cross(w_b, com_w)
            F = -(self.body_damp_lin * self.mass)[None, :, None] * v_com
            w_loc = maths.quat_apply(maths.quat_conjugate(body_q), w_b)
            L_w = maths.quat_apply(
                body_q, jnp.einsum("bij,nbj->nbi", self.inertia, w_loc))
            tau_com = -self.body_damp_ang[None, :, None] * L_w
            n_O = tau_com + jnp.cross(com_w, F)
            f_damp = jnp.concatenate([n_O, F], axis=-1)
            rhs = rhs + jnp.einsum("nvd,vb,nbd->nv", S,
                                   self.dof_body_mask_f, f_damp)

        diag = (armature + h * d_damp + h * h * k_spring
                + imp * (h * kd_drive + h * h * kp_drive))
        if self.has_dof_friction or jfric is not self.dof_friction:
            diag = diag + h * jfric / 0.05
        if dyn_cache is None:
            H = M + self._diag_embed(
                jnp.broadcast_to(diag, (N, self.nv)).astype(f32))
            Hinv = spd_inverse(H)
        else:
            Hinv = dyn_cache[2]
        qdd = jnp.einsum("nij,nj->ni", Hinv, rhs, precision=_HI)
        cache_out = (I_O, M, Hinv)
        qd_new = qd + h * qdd

        # ---------------- unilateral constraints (contacts + joint limits)
        impulse_pts = None
        imp_dof = jnp.zeros_like(qd_new)
        warm_out = None
        ccache_out = None
        if (self.ground and self.n_ground) or self.pairs or self.grabs:
            (qd_new, impulse_pts, p_w, imp_dof, warm_out,
             ccache_out) = self._contact_solve(
                qd_new, body_x, body_q, S, Hinv, qpos_dof, terrain,
                None if phys is None else phys.friction,
                grab_active=ctrl.grab_active, shape_scale=shape_scale,
                warm=warm,
                ccache=contact_cache, qd_geom=qd,
                lo_shift=lo_shift, hi_shift=hi_shift, restitution=restitution)
        else:
            qd_new = self._limit_solve(qd_new, Hinv, qpos_dof,
                                       lo_shift=lo_shift, hi_shift=hi_shift)
            p_w = None

        # velocity limits (PhysX clamps dof velocities)
        vel_lim = self.dof_velocity_limit
        qd_new = jnp.clip(qd_new, -vel_lim, vel_lim)

        # ---------------- integrate
        q_new = self._integrate(q, qd_new)
        return q_new, qd_new, (body_x, body_q, V, qdd, impulse_pts, p_w,
                               imp_dof, cache_out, warm_out, ccache_out)

    @staticmethod
    def _sdf_local(gtype: int, size, p):
        """Signed distance + outward normal of a primitive at local point(s) p.

        ``size`` is either a static (3,) vector or a per-env batch
        broadcastable against p (e.g. (N, 1, 3) under per-env shape DR)."""
        eps = 1e-9
        size = jnp.asarray(size)
        if gtype == md.GEOM_SPHERE:
            r = jnp.linalg.norm(p, axis=-1, keepdims=True)
            n = p / jnp.maximum(r, eps)
            return r[..., 0] - size[..., 0], n
        if gtype == md.GEOM_CAPSULE:
            hl = size[..., 1:2]
            z = jnp.clip(p[..., 2:3], -hl, hl)
            d = p - jnp.concatenate([jnp.zeros_like(z), jnp.zeros_like(z), z], -1)
            r = jnp.linalg.norm(d, axis=-1, keepdims=True)
            n = d / jnp.maximum(r, eps)
            return r[..., 0] - size[..., 0], n
        if gtype == md.GEOM_CYLINDER:
            rad = jnp.linalg.norm(p[..., :2], axis=-1)
            a = rad - size[..., 0]                 # radial distance to side
            b = jnp.abs(p[..., 2]) - size[..., 1]  # axial distance to cap
            outside = jnp.sqrt(jnp.square(jnp.maximum(a, 0)) + jnp.square(jnp.maximum(b, 0)))
            dist = jnp.minimum(jnp.maximum(a, b), 0.0) + outside
            radial_n = p[..., :2] / jnp.maximum(rad, eps)[..., None]
            cap_n = jnp.sign(p[..., 2])
            use_cap = b > a
            n = jnp.where(
                use_cap[..., None],
                jnp.concatenate([jnp.zeros_like(radial_n),
                                 cap_n[..., None]], -1),
                jnp.concatenate([radial_n, jnp.zeros_like(cap_n)[..., None]], -1))
            return dist, n
        if gtype == md.GEOM_BOX:
            qv = jnp.abs(p) - size
            outside = jnp.linalg.norm(jnp.maximum(qv, 0.0), axis=-1)
            inside = jnp.minimum(jnp.max(qv, axis=-1), 0.0)
            dist = outside + inside
            # gradient: positive part outside; deepest face inside
            n_out = jnp.maximum(qv, 0.0) * jnp.sign(p)
            face = jax.nn.one_hot(jnp.argmax(qv, axis=-1), 3, dtype=p.dtype)
            n_in = face * jnp.sign(p)
            n = jnp.where((outside > 0)[..., None],
                          n_out / jnp.maximum(outside, eps)[..., None], n_in)
            return dist, n
        raise ValueError(f"no SDF for geom type {gtype}")

    @staticmethod
    def _tangent_frame(n):
        """Build (t1, t2, n) columns (..., 3, 3) from normals (..., 3)."""
        ref = jnp.where(jnp.abs(n[..., 2:3]) < 0.9,
                        jnp.broadcast_to(jnp.array([0.0, 0, 1], n.dtype), n.shape),
                        jnp.broadcast_to(jnp.array([1.0, 0, 0], n.dtype), n.shape))
        t1 = jnp.cross(n, ref)
        t1 = t1 / jnp.maximum(jnp.linalg.norm(t1, axis=-1, keepdims=True), 1e-9)
        t2 = jnp.cross(n, t1)
        return jnp.stack([t1, t2, n], axis=-1)

    def _pair_rows(self, body_x, body_q, shape_scale=None):
        """Narrowphase for body-pair contacts: (p, phi, mu, row_mask, n).

        ``shape_scale`` (N, nb, 3): per-env body-frame geometry scale — scales
        the candidate-point offsets/radii of geom A and the SDF extents/offset
        of geom B (per-env object-dimension DR)."""
        ps, phis, mus, masks, ns = [], [], [], [], []
        for pr_ in self.pairs:
            idx = pr_["pt_idx"]
            xb = body_x[:, self.pts_body[idx]]
            qb = body_q[:, self.pts_body[idx]]
            off = self.pts_off[idx]
            rad = self.pts_rad[idx]
            tgt_size = pr_["tgt_size"]
            tgt_pos = pr_["tgt_pos"]
            if shape_scale is not None:
                sp = shape_scale[:, self.pts_body[idx]]        # (N, k, 3)
                off = off * sp
                # sphere/capsule radii only scale meaningfully when uniform
                rad = rad * jnp.mean(sp, axis=-1)
                st = shape_scale[:, pr_["tgt_body"], None, :]  # (N, 1, 3)
                tgt_size = tgt_size * st
                tgt_pos = tgt_pos * st[:, 0]
            p = xb + maths.quat_apply(qb, off)
            tb = pr_["tgt_body"]
            x_t = body_x[:, tb, None, :] + maths.quat_apply(
                body_q[:, tb, None, :],
                tgt_pos if shape_scale is None else tgt_pos[:, None, :])
            q_t = maths.quat_mul(body_q[:, tb, None, :],
                                 jnp.broadcast_to(pr_["tgt_quat"], qb.shape))
            lp = maths.quat_rotate_inverse(q_t, p - x_t)
            if pr_["tgt_type"] == md.GEOM_SDF:
                from . import sdf_grid as _sg
                if shape_scale is not None:
                    # uniform-scale approximation: d_s(p) = s * d(p / s)
                    st_ = shape_scale[:, pr_["tgt_body"], None, :]
                    d, n_l = _sg.sample_with_normal(pr_["grid"], lp / st_)
                    d = d * jnp.mean(st_, -1)
                else:
                    d, n_l = _sg.sample_with_normal(pr_["grid"], lp)
            else:
                d, n_l = self._sdf_local(pr_["tgt_type"], tgt_size, lp)
            n_w = maths.quat_apply(q_t, n_l)
            phi = d - rad
            p_c = p - rad[..., None] * n_w
            ps.append(p_c)
            phis.append(phi)
            mus.append(jnp.full((len(idx),), pr_["mu"], body_x.dtype))
            masks.append(pr_["row_mask"])
            ns.append(n_w)
        return (jnp.concatenate(ps, 1), jnp.concatenate(phis, 1),
                jnp.concatenate(mus, 0), jnp.concatenate(masks, 0),
                jnp.concatenate(ns, 1))

    def _row_masks_np(self):
        """Static (rows, nv) dof mask for all contact rows: ground candidate
        points (ancestor 0/1 masks) then pair rows (signed relative masks)."""
        cached = getattr(self, "_row_masks_cache", None)
        if cached is None:
            parts = []
            if self.ground and self.n_ground:
                parts.append(np.asarray(self.gnd_dof_mask).T)
            for p_ in self.pairs:
                parts.append(np.asarray(p_["row_mask"]))
            cached = np.concatenate(parts, 0).astype(np.float32)
            self._row_masks_cache = cached
        return cached

    def _ground_reachable(self, m) -> np.ndarray:
        """Static reachability of the ground plane per candidate point.

        For a point on body ``b`` whose kinematic tree has a non-FREE root,
        walk the path root -> b composing EXACT forward kinematics through
        the leading run of FIXED joints (composed scene mounts carry
        arbitrary base rotations — norm-ball bounds through them are
        needlessly loose; round 2's self-aligning hand scenes regressed the
        prune exactly this way).  From the first movable joint L onward,
        world z is bounded below by

            z_anchor(L) - |jnt_pos(L)| - range(L)
                        - sum_{links below L} (|body_pos| + joint_trans)
                        - |pt_off| - rad

        where ``z_anchor(L)`` is the exact world z of L's joint anchor (it
        depends only on the rigid prefix, so it is constant; |R v| = |v|
        bounds any hinge orientation below L; slide/screw joints add
        their limit range, unlimited ones make the bound -inf).  A point
        whose bound stays above the plane with margin can never generate a
        ground row.  The margin doubles the point-offset term (object-dim DR
        scales pts_off per env, vec_task.py:612-842 analog) and adds 0.1 m
        absolute.  Trees with a FREE root (floating bases, loose objects)
        are always reachable — which also keeps this sound for terrain
        tasks, whose robots are floating-base (heightfields can rise above
        z=0; fixed-base tasks have no terrain)."""
        parent = np.asarray(m.parent)
        jnt = np.asarray(m.jnt_type)
        body_pos = np.asarray(m.body_pos, np.float64)
        body_quat = np.asarray(m.body_quat, np.float64)
        jnt_pos = np.asarray(m.jnt_pos, np.float64)
        v_adr = np.asarray(m.v_adr)
        lo = np.asarray(m.dof_lower, np.float64)
        hi = np.asarray(m.dof_upper, np.float64)
        has_lim = np.asarray(m.dof_has_limit, bool)

        def joint_trans(link):
            """Upper bound on |origin displacement| this link's joint adds
            beyond |body_pos|: hinge/screw anchors move the origin by
            bp + R(bq)a - R(ql)a (fk, engine.py:480-489) -> up to 2|a|;
            slide/screw axis translation is bounded by the dof limits
            (None = unbounded -> tree is always reachable)."""
            t = int(jnt[link])
            d = 0.0
            if t in (md.HINGE, md.SCREW):
                d += 2.0 * float(np.linalg.norm(jnt_pos[link]))
            if t in (md.SLIDE, md.SCREW):
                v = int(v_adr[link])
                if not has_lim[v]:
                    return None
                d += max(abs(lo[v]), abs(hi[v]))
            return d

        min_z = np.full(m.nb, -np.inf)
        for b in range(m.nb):
            path = []                         # root .. b inclusive
            a = b
            while a != -1:
                path.append(a)
                a = int(parent[a])
            path.reverse()
            # exact FK through the leading FIXED run (rigid w.r.t. world)
            pos = np.zeros(3)
            R = np.eye(3)
            i = 0
            while i < len(path) and jnt[path[i]] == md.FIXED:
                link = path[i]
                pos = pos + R @ body_pos[link]
                R = R @ md._quat_to_mat_np(body_quat[link])
                i += 1
            if i == len(path):                # fully rigid: exact z
                min_z[b] = float(pos[2])
                continue
            L = path[i]
            if jnt[L] == md.FREE:
                continue                      # floating tree: reachable
            # L's joint anchor is constant (depends only on the rigid prefix)
            anchor = pos + R @ body_pos[L] + \
                R @ md._quat_to_mat_np(body_quat[L]) @ jnt_pos[L]
            bound = float(anchor[2]) - float(np.linalg.norm(jnt_pos[L]))
            ok = True
            if jnt[L] in (md.SLIDE, md.SCREW):
                v = int(v_adr[L])
                if not has_lim[v]:
                    ok = False
                else:
                    bound -= max(abs(lo[v]), abs(hi[v]))
            for link in (path[i + 1:] if ok else ()):
                if jnt[link] == md.FREE:      # free joint mid-tree
                    ok = False
                    break
                d = joint_trans(link)
                if d is None:
                    ok = False
                    break
                bound -= float(np.linalg.norm(body_pos[link])) + d
            if ok:
                min_z[b] = bound
        pt_term = 2.0 * (np.linalg.norm(np.asarray(self.pts_off, np.float64),
                                        axis=-1)
                         + np.asarray(self.pts_rad, np.float64))
        return min_z[self.pts_body] - pt_term - 0.1 <= 0.0

    def _contact_points(self, body_x, body_q, shape_scale=None):
        """World ground-candidate positions p (N, n_ground, 3)."""
        xb = body_x[:, self.gnd_body]                          # (N, P, 3)
        qb = body_q[:, self.gnd_body]
        off = self.gnd_off
        if shape_scale is not None:
            off = off * shape_scale[:, self.gnd_body]          # (N, P, 3)
        return xb + maths.quat_apply(qb, off)

    def _contact_point_jacobian(self, body_x, body_q, S, shape_scale=None):
        """World positions p (N, n_ground, 3) and J (N, n_ground, nv, 3)."""
        p = self._contact_points(body_x, body_q, shape_scale)
        S_ang = S[:, None, :, 0:3]                             # (N, 1, nv, 3)
        S_lin = S[:, None, :, 3:6]
        J = S_lin + _cross(S_ang, p[:, :, None, :])            # (N, P, nv, 3)
        J = J * self.gnd_dof_mask.T[None, :, :, None]          # mask non-ancestor dofs
        return p, J

    @staticmethod
    def _w_diag(J_flat, HinvJ_flat, N, R_rows, nv):
        """Per-axis Delassus diagonal (N, R, 3) in row coordinates.

        Rows arrive already projected into their contact frames
        (``_build_J_flat(..., frames)``), so this is one minor-dim reduction
        over the flat layout: w_l = Jf_l . (Hinv Jf_l)."""
        return jnp.maximum(
            jnp.sum(J_flat * HinvJ_flat, axis=-1).reshape(N, R_rows, 3),
            1e-8)

    def _contact_solve(self, qd, body_x, body_q, S, Hinv, qpos_dof, terrain,
                       friction_scale=None, grab_active=None,
                       shape_scale=None, warm=None,
                       ccache=None, qd_geom=None,
                       lo_shift=None, hi_shift=None, restitution=None):
        """Projected-Jacobi impulse solve for plane contacts + joint limits.

        ``warm``: optional ``(lam_rows (N, P, 3), lam_lo (N, nv),
        lam_hi (N, nv))`` from the previous step (SimParams.warm_start).
        The iteration starts from these impulses (masked to currently-active
        rows) with the matching velocity offset applied once up front, so the
        fixed point is unchanged but persistent contacts reconverge in far
        fewer iterations.  A fifth return value carries the new warm tuple.

        ``ccache``: contact-row cache from an earlier substep of the same
        control step (SimParams.reuse_contact_rows — the PhysX
        narrowphase-once-per-step model).  When present, the row set
        (selection, Jacobians, Delassus diagonals, frames) is reused;
        penetrations advance by ``h * J qd_geom`` (``qd_geom`` is the
        velocity the previous substep integrated with) and the previous
        substep's impulses seed the iteration.  A sixth return value carries
        the cache."""
        pr = self.params
        h = self.h
        n_ground = self.n_ground if self.ground else 0
        # (substeps == 1: nothing to reuse — skip the cache-only gathers)
        reuse_rows = pr.reuse_contact_rows and pr.substeps > 1
        if ccache is None:
            # ---- ground rows (positions/phis only; Jacobians are built
            # *after* active-set compaction so only the surviving K rows pay
            # the J cost)
            if terrain is not None and self.n_ground != self.n_pts:
                raise ValueError(
                    "ground-candidate pruning assumed a flat z=0 plane, but "
                    "this scene steps with a terrain heightfield and has "
                    "pruned candidates on a fixed-base tree; rebuild the "
                    "engine without fixed-base trees or disable pruning for "
                    "this scene")
            n_terr = None
            if self.ground and n_ground:
                p = self._contact_points(body_x, body_q, shape_scale)
                if terrain is None:
                    ground_z = jnp.zeros(p.shape[:-1], p.dtype)
                elif pr.terrain_normal_frames:
                    ground_z, n_terr = terrain.height_and_normal(
                        p[..., 0], p[..., 1])
                else:
                    ground_z = terrain.height_at(p[..., 0], p[..., 1])
                rad = self.gnd_rad
                if shape_scale is not None:
                    rad = rad * jnp.mean(shape_scale[:, self.gnd_body], axis=-1)
                if n_terr is None:
                    phi = p[..., 2] - rad - ground_z               # (N, P)
                else:
                    # gap measured along the surface normal: vertical gap
                    # projected by n_z (exact for a planar slope); radius
                    # applies along the normal.  On near-vertical gap walls
                    # (n_z ~ 0) this reads a shallow lateral penetration
                    # instead of a meters-deep vertical one, and the row
                    # frame below pushes the foot OUT of the wall.
                    phi = (p[..., 2] - ground_z) * n_terr[..., 2] - rad
                mu = self.gnd_mu * jnp.asarray(self.params.plane_friction, phi.dtype)
                if friction_scale is not None:
                    # (N, nb) per-body scale: gather at each row's body;
                    # (N, 1) legacy global scale broadcasts as before
                    if friction_scale.shape[-1] == self.nb:
                        mu = mu * friction_scale[:, self.gnd_body]
                    else:
                        mu = mu * friction_scale
            else:
                p = phi = mu = rad = None
            # ---- body-pair rows: contact frames stay separate from J — the
            # loop rotates 3-vectors into the row frame each iteration
            # instead of frame-projecting whole (nv, 3) Jacobians once (the
            # einsum lowers to ~1M tiny (nv,3)x(3,3) matmuls and dominated
            # the hand-scene substep)
            frames_all = None
            if self.pairs:
                pp, pphi, pmu, pmask, pn = self._pair_rows(body_x, body_q,
                                                           shape_scale)
                if friction_scale is not None:
                    if friction_scale.shape[-1] == self.nb:
                        # combine endpoint-body scales (PhysX average mode)
                        pa = self.row_body_a[n_ground:]
                        pb = self.row_body_b[n_ground:]
                        pmu = pmu * 0.5 * (friction_scale[:, pa]
                                           + friction_scale[:, pb])
                    else:
                        pmu = pmu * friction_scale  # per-env DR friction
                frame = self._tangent_frame(pn)                # (N, K, 3, 3)
                if phi is None:
                    p, phi, mu = pp, pphi, pmu
                    frames_all = frame
                else:
                    p = jnp.concatenate([p, pp], 1)
                    # mu is (rows,) normally but per-env (N, rows) when DR
                    # scales friction — normalize both before concatenating
                    mu_g = jnp.broadcast_to(mu, phi.shape) if mu.ndim == 1 else mu
                    mu_p = jnp.broadcast_to(pmu, pphi.shape) if pmu.ndim == 1 else pmu
                    phi = jnp.concatenate([phi, pphi], 1)
                    mu = jnp.concatenate([mu_g, mu_p], -1)
                    # flat-ground rows are world-aligned (identity frames);
                    # terrain rows carry the heightfield surface normal
                    if n_terr is None:
                        eye_g = jnp.broadcast_to(
                            jnp.eye(3, dtype=phi.dtype),
                            (phi.shape[0], n_ground, 3, 3))
                    else:
                        eye_g = self._tangent_frame(n_terr)
                    frames_all = jnp.concatenate([eye_g, frame], 1)
            elif self.ground and n_ground and n_terr is not None:
                frames_all = self._tangent_frame(n_terr)
            if phi is None:
                # grabs/attractors-only scene (every ground candidate pruned,
                # no pairs): run the loop with an empty contact-row set
                N0 = qd.shape[0]
                p = jnp.zeros((N0, 0, 3), qd.dtype)
                phi = jnp.zeros((N0, 0), qd.dtype)
                mu = jnp.zeros((N0, 0), qd.dtype)
            active = phi < pr.contact_margin

            b_n = -pr.baumgarte / h * jnp.minimum(phi + pr.contact_slop, 0.0)
            if pr.contact_margin > 0.0:
                # speculative rows (0 <= phi < margin): cap approach speed at
                # phi/h — touch this substep, never tunnel
                b_n = jnp.where(phi >= 0.0, -phi / h, b_n)
            # cap the push-out velocity (PhysX max_depenetration_velocity)
            b_n = jnp.minimum(b_n, pr.max_depenetration_velocity)
            # per-row restitution (PhysX average combine; plane rows combine
            # with the plane's restitution).  The bounce target itself needs
            # the pre-solve normal velocity, added after J is built.
            e_rows = None
            if restitution is not None and phi.shape[1]:
                if restitution.shape[-1] == self.nb:
                    rb = jnp.asarray(self.row_body_b)
                    ea = restitution[:, self.row_body_a]
                    eb = jnp.where(
                        rb[None, :] >= 0,
                        restitution[:, np.maximum(self.row_body_b, 0)],
                        jnp.asarray(pr.plane_restitution, phi.dtype))
                    e_rows = 0.5 * (ea + eb)
                else:
                    e_rows = jnp.broadcast_to(restitution, phi.shape)

        # joint limit rows (per-env additive limit shifts: dextreme-ADR
        # dof_properties.lower/upper ranges)
        lo_lim = (self.dof_lower if lo_shift is None
                  else self.dof_lower + lo_shift)
        hi_lim = (self.dof_upper if hi_shift is None
                  else self.dof_upper + hi_shift)
        lo_gap = qpos_dof - lo_lim                             # >= 0 when inside
        hi_gap = hi_lim - qpos_dof
        lim_mask = jnp.asarray(self.dof_has_limit)
        b_lo = -pr.baumgarte / h * jnp.minimum(lo_gap, 0.0)
        b_hi = -pr.baumgarte / h * jnp.minimum(hi_gap, 0.0)
        act_lo = lim_mask & (lo_gap < 0.0)
        act_hi = lim_mask & (hi_gap < 0.0)

        hinv_diag = jnp.maximum(jnp.einsum("nvv->nv", Hinv), 1e-8)
        N = qd.shape[0]
        nv = self.nv
        if ccache is None:
            P_all = phi.shape[1]
            masks_static = (jnp.asarray(self._row_masks_np())
                            if P_all else jnp.zeros((0, nv), qd.dtype))

        def _build_J_flat(p_rows, mk, frames=None):
            """Contact Jacobian, built directly in the flat (N, 3R, nv)
            layout the solver consumes: the three components are built as
            (N, R, nv) planes rather than an (N, R, nv, 3) stack with a tiny
            minor axis.
            ``mk``: dof mask, static (R, nv) or per-env (N, R, nv).
            ``frames``: optional (N, R, 3, 3) row frames (t1, t2, n columns).
            When given, the world planes are combined into ROW-FRAME planes
            right here — pure elementwise combos that fuse into the plane
            build.  Projecting at build time removes the per-iteration
            3-vector rotations and the (N, R, 3, nv) w_diag reduction."""
            if mk.ndim == 2:
                mk = mk[None]
            Sa = S[:, :, 0:3]                                  # (N, nv, 3)
            Sl = S[:, :, 3:6]
            px = p_rows[..., 0][:, :, None]                    # (N, R, 1)
            py = p_rows[..., 1][:, :, None]
            pz = p_rows[..., 2][:, :, None]
            sax = Sa[..., 0][:, None, :]                       # (N, 1, nv)
            say = Sa[..., 1][:, None, :]
            saz = Sa[..., 2][:, None, :]
            # (S_ang x p) per world axis
            Jx = (Sl[..., 0][:, None, :] + say * pz - saz * py) * mk
            Jy = (Sl[..., 1][:, None, :] + saz * px - sax * pz) * mk
            Jz = (Sl[..., 2][:, None, :] + sax * py - say * px) * mk
            R = p_rows.shape[1]
            if frames is None:
                return jnp.stack([Jx, Jy, Jz], axis=2).reshape(N, 3 * R, nv)
            planes = [frames[..., 0, l][:, :, None] * Jx
                      + frames[..., 1, l][:, :, None] * Jy
                      + frames[..., 2, l][:, :, None] * Jz
                      for l in range(3)]
            return jnp.stack(planes, axis=2).reshape(N, 3 * R, nv)

        if ccache is None:
            # Active-set compaction (the PhysX generated-contacts /
            # max_gpu_contact_pairs analog, cfg/task/Ant.yaml:58): the
            # candidate row set is static for XLA, but only rows near contact
            # carry impulses.  Gather the K deepest rows per env *before any
            # Jacobian exists* — row positions/frames/masks are small
            # (N, P, <=9) arrays — then build J, the GEMMs, and the whole
            # iteration loop at (N, K, ...) instead of (N, P, ...).  Exactly
            # equivalent whenever #active <= K (inactive rows contribute
            # zero), deepest-K capping beyond, like PhysX's contact buffer.
            sel = None
            frames_rows = frames_all
            p_rows = p
            masks_rows = masks_static
            phi_rows = phi
            is_gnd = jnp.asarray(
                np.concatenate([np.ones(n_ground, np.float32),
                                np.zeros(self.n_pair_rows, np.float32)])
                if P_all else np.zeros(0, np.float32))
            if reuse_rows and rad is not None:
                rad_rows = jnp.concatenate([
                    jnp.broadcast_to(rad, (N, n_ground)),
                    jnp.zeros((N, self.n_pair_rows), qd.dtype)], 1)
            else:
                rad_rows = jnp.zeros((N, P_all), qd.dtype) if reuse_rows else None
            K = pr.contact_capacity
            if K is not None and P_all > K:
                _, idx = jax.lax.top_k(-phi, K)                # (N, K)
                # gather as one-hot (K, P) selection GEMMs rather than
                # take_along_axis (kept from the previous accelerator, where
                # batched gathers lowered to slow loops; not yet re-measured
                # against a native gather)
                sel = (idx[:, :, None] ==
                       jnp.arange(P_all)[None, None, :]).astype(qd.dtype)
                # HIGHEST: selection by an exact one-hot must not round the
                # selected f32 values (DEFAULT precision may run the product
                # in reduced-mantissa arithmetic)
                take = lambda x: jax.lax.dot_general(
                    sel, x, (((2,), (1,)), ((0,), (0,))),
                    precision=jax.lax.Precision.HIGHEST)
                b_n = take(b_n)
                if e_rows is not None:
                    e_rows = take(e_rows)
                mu = take(jnp.broadcast_to(mu, phi.shape))
                active = take(active.astype(qd.dtype)) > 0.5
                p_rows = take(p.reshape(N, P_all, 3))
                # mask values are exactly 0/+-1 and sel is one-hot: the
                # gather is exact even with reduced-mantissa operands, so the
                # (N, K, P)x(N, P, nv) GEMM can run single-pass DEFAULT
                masks_rows = jax.lax.dot_general(
                    sel, jnp.broadcast_to(masks_static[None], (N, P_all, nv)),
                    (((2,), (1,)), ((0,), (0,))),
                    preferred_element_type=qd.dtype)
                phi_rows = take(phi)
                if reuse_rows:
                    is_gnd = take(jnp.broadcast_to(is_gnd, phi.shape))
                    rad_rows = take(rad_rows)
                if frames_rows is not None:
                    frames_rows = take(
                        frames_rows.reshape(N, P_all, 9)).reshape(N, K, 3, 3)

            R_rows = p_rows.shape[1]
            # rows are built pre-projected into their contact frames
            # (identity for ground rows), so the iteration loop below
            # needs no per-iteration rotations and w_diag is a clean
            # minor-dim reduction over the flat layout
            J_flat = _build_J_flat(p_rows, masks_rows,
                                   frames_rows)             # (N, 3R, nv)
            HinvJ_flat = jax.lax.dot_general(
                J_flat, Hinv, (((2,), (1,)), ((0,), (0,))),
                precision=_SOLVER)                          # (N, 3R, nv)
            w_diag = self._w_diag(J_flat, HinvJ_flat, N, R_rows, nv)
            if e_rows is not None:
                # restitution bounce target: outgoing normal velocity at
                # least e * (impact speed - bounce threshold)
                v_n_pre = jax.lax.dot_general(
                    J_flat, qd, (((2,), (1,)), ((0,), (0,))),
                    precision=_SOLVER).reshape(N, R_rows, 3)[..., 2]
                b_n = jnp.maximum(
                    b_n, e_rows * jnp.maximum(
                        -v_n_pre - pr.bounce_threshold_velocity, 0.0))
            lam = jnp.zeros((N, R_rows, 3), qd.dtype)
            lam_lo = jnp.zeros_like(qd)
            lam_hi = jnp.zeros_like(qd)
        else:
            # ---- cached row set (later substeps of the same control step):
            # reuse selection/Jacobians/Delassus/frames from the first
            # substep; advance penetrations geometrically by the velocity the
            # previous substep integrated with (qd_geom), and seed the
            # iteration from its converged impulses.
            cc = ccache
            sel = cc["sel"]
            J_flat = cc["J_flat"]
            HinvJ_flat = cc["HinvJ_flat"]
            w_diag = cc["w_diag"]
            frames_rows = cc["frames_rows"]
            mu = cc["mu"]
            p = cc["p_full"]
            p_rows = cc["p_rows"]
            is_gnd = cc["is_gnd"]
            rad_rows = cc["rad_rows"]
            R_rows = p_rows.shape[1]
            # relative row-frame velocity of each row through the cached
            # (pre-projected) Jacobian; component 2 is the normal velocity
            v3 = jax.lax.dot_general(
                J_flat, qd_geom, (((2,), (1,)), ((0,), (0,))),
                precision=_SOLVER).reshape(N, R_rows, 3)
            v_n = v3[..., 2]
            phi_rows = cc["phi_rows"] + h * v_n
            if terrain is not None:
                # terrain rows re-sample the heightfield at the advanced
                # positions (the normal-velocity advance misses slope
                # advection under horizontal motion); the advance needs the
                # WORLD velocity, so rotate v3 back through the row frames
                if frames_rows is None:
                    v3_w = v3
                else:
                    v3_w = (frames_rows[..., :, 0] * v3[..., 0, None]
                            + frames_rows[..., :, 1] * v3[..., 1, None]
                            + frames_rows[..., :, 2] * v3[..., 2, None])
                p_rows = p_rows + h * v3_w
                gz = terrain.height_at(p_rows[..., 0], p_rows[..., 1])
                # vertical gap projected onto the row normal (frames carry
                # the heightfield surface normal under terrain)
                nz_rows = (frames_rows[..., 2, 2] if frames_rows is not None
                           else 1.0)
                phi_g = (p_rows[..., 2] - gz) * nz_rows - rad_rows
                phi_rows = jnp.where(is_gnd > 0.5, phi_g, phi_rows)
            active = phi_rows < pr.contact_margin
            b_n = -pr.baumgarte / h * jnp.minimum(
                phi_rows + pr.contact_slop, 0.0)
            if pr.contact_margin > 0.0:
                b_n = jnp.where(phi_rows >= 0.0, -phi_rows / h, b_n)
            b_n = jnp.minimum(b_n, pr.max_depenetration_velocity)
            e_rows = cc.get("e_rows")
            if e_rows is not None:
                v_n_pre = jax.lax.dot_general(
                    J_flat, qd, (((2,), (1,)), ((0,), (0,))),
                    precision=_SOLVER).reshape(N, R_rows, 3)[..., 2]
                b_n = jnp.maximum(
                    b_n, e_rows * jnp.maximum(
                        -v_n_pre - pr.bounce_threshold_velocity, 0.0))
            # impulse continuation from the previous substep (masked to
            # still-active rows; velocity offset applied after the loop
            # helpers are defined below)
            if pr.contact_continuation:
                lam = jnp.where(active[..., None], cc["lam"], 0.0)
                lam_lo = jnp.where(act_lo, cc["lam_lo"], 0.0)
                lam_hi = jnp.where(act_hi, cc["lam_hi"], 0.0)
            else:
                lam = jnp.zeros((N, R_rows, 3), qd.dtype)
                lam_lo = jnp.zeros_like(qd)
                lam_hi = jnp.zeros_like(qd)

        if self.grabs:
            g_J, g_b = [], []
            S_ang_g = S[:, None, :, 0:3]
            S_lin_g = S[:, None, :, 3:6]
            for g in self.grabs:
                pa = (body_x[:, g["body_a"]]
                      + maths.quat_apply(body_q[:, g["body_a"]], g["off_a"]))[:, None]
                pb = (body_x[:, g["body_b"]]
                      + maths.quat_apply(body_q[:, g["body_b"]], g["off_b"]))[:, None]
                pm = 0.5 * (pa + pb)
                Jg = (S_lin_g + _cross(S_ang_g, pm[:, :, None, :])) \
                    * g["mask"][None, None, :, None]
                g_J.append(Jg)
                g_b.append(-pr.baumgarte / h * (pa - pb))
            g_J = jnp.concatenate(g_J, 1)                      # (N, G, nv, 3)
            g_b = jnp.concatenate(g_b, 1)
            Ng, Gg = g_J.shape[0], g_J.shape[1]
            gJ_rows = jnp.swapaxes(g_J, 2, 3).reshape(Ng, Gg * 3, self.nv)
            gHJ_rows = jax.lax.dot_general(
                gJ_rows, Hinv, (((2,), (1,)), ((0,), (0,))), precision=_SOLVER)
            g_HJ = jnp.swapaxes(gHJ_rows.reshape(Ng, Gg, 3, self.nv), 2, 3)
            g_W = jnp.maximum(jnp.sum(g_J * g_HJ, axis=2), 1e-8)
            if grab_active is None:
                g_act = jnp.zeros(g_b.shape[:2], qd.dtype)
            else:
                g_act = grab_active.astype(qd.dtype)
            lam_g = jnp.zeros(g_b.shape, qd.dtype)
        else:
            g_J = g_HJ = g_W = g_b = g_act = lam_g = None

        if self.attractors:
            att_J, att_b = [], []
            S_ang = S[:, None, :, 0:3]
            S_lin = S[:, None, :, 3:6]
            for a in self.attractors:
                pa = (body_x[:, a["body"]]
                      + maths.quat_apply(body_q[:, a["body"]], a["offset"]))[:, None]
                Ja = (S_lin + _cross(S_ang, pa[:, :, None, :])) * a["mask"][None, None, :, None]
                att_J.append(Ja)
                att_b.append(-pr.baumgarte / h * (pa - a["target"]))
            att_J = jnp.concatenate(att_J, 1)                  # (N, A, nv, 3)
            att_b = jnp.concatenate(att_b, 1)                  # (N, A, 3)
            Na, Aa = att_J.shape[0], att_J.shape[1]
            aJ_rows = jnp.swapaxes(att_J, 2, 3).reshape(Na, Aa * 3, self.nv)
            aHJ_rows = jax.lax.dot_general(
                aJ_rows, Hinv, (((2,), (1,)), ((0,), (0,))), precision=_SOLVER)
            att_HJ = jnp.swapaxes(aHJ_rows.reshape(Na, Aa, 3, self.nv), 2, 3)
            att_W = jnp.maximum(jnp.sum(att_J * att_HJ, axis=2), 1e-8)
            lam_att = jnp.zeros(att_b.shape, qd.dtype)
        else:
            att_J = att_HJ = att_W = att_b = lam_att = None

        relax = pr.relaxation

        # Mass splitting (SimParams.mass_splitting): projected Jacobi
        # diverges once R coincident active rows push the same body with
        # R*relaxation > 2 (mesh contact clouds resting face-down).  Scale
        # each row's correction by 1/(active rows sharing its movable
        # bodies) — the active set is fixed across iterations, so the scale
        # is computed once per solve.  Conservative (sum over both bodies
        # >= max), which only slows convergence, never destabilizes.
        row_scale = None
        if pr.mass_splitting and R_rows > 0:
            ohab = self._row_body_oh                        # (P_all, nb)
            if sel is not None:
                oh_rows = jax.lax.dot_general(
                    sel, jnp.broadcast_to(ohab[None],
                                          (N,) + ohab.shape),
                    (((2,), (1,)), ((0,), (0,))),
                    precision=jax.lax.Precision.HIGHEST)    # (N, R, nb)
            else:
                oh_rows = jnp.broadcast_to(ohab[None], (N,) + ohab.shape)
            af = active.astype(qd.dtype)
            # Direction-aware splitting: only rows pushing the same body
            # along similar world axes destabilize each other (a vertical
            # resting cloud cannot amplify a horizontal gripper squeeze —
            # raw per-body counts throttled the squeeze impulse by the
            # resting-row count and the fingerpads sailed through the nut).
            # Weight by the full normal outer-product per body:
            # counts_b = sum_r active * oh * n_r n_r^T (N, nb, 3, 3);
            # per-row effective count = sum_b oh * n^T counts_b n.  This is
            # sum_i (n . n_i)^2 over coincident rows — exact for ANY shared
            # direction (R identical rows give exactly R, axis-aligned or
            # oblique; the earlier squared-COMPONENT weighting undercounted
            # a diagonal normal 3x, which capped the stability guarantee at
            # relaxation < 2/3 — advisor r4 finding), and still direction-
            # aware (orthogonal resting rows cannot throttle a gripper
            # squeeze).
            if frames_rows is not None:
                n_w = frames_rows[..., :, 2]                # (N, R, 3) world n
            else:
                n_w = jnp.broadcast_to(
                    jnp.asarray([0.0, 0.0, 1.0], qd.dtype), (N, R_rows, 3))
            counts = jnp.einsum("nr,nrb,nrk,nrl->nbkl", af, oh_rows,
                                n_w, n_w)
            n_r = jnp.einsum("nbkl,nrb,nrk,nrl->nr", counts, oh_rows,
                             n_w, n_w)
            row_scale = 1.0 / jnp.maximum(n_r, 1.0)

        # Row Jacobians live in the flat (N, C*3, nv) layout so the
        # per-iteration matvecs lower as batched dot_generals — einsum over
        # (npvk, nv) otherwise materializes (N, P, nv, 3) broadcast
        # intermediates every iteration (the dominant memory traffic of the
        # whole substep).
        P = R_rows

        def flat_rows(x):  # (N, C, nv, 3) -> (N, C*3, nv)
            return jnp.swapaxes(x, 2, 3).reshape(N, -1, nv)

        # Optionally store the loop-invariant row matrices bf16 inside the
        # scan (SimParams.solver_rows_bf16); accumulation stays f32 via
        # preferred_element_type.
        rows_bf16 = pr.solver_rows_bf16
        if rows_bf16 is None:
            # auto: bf16 pays once the (post-compaction) row working set makes
            # the iteration loop bound by memory traffic
            rows_bf16 = R_rows * self.nv >= 1024
        row_t = jnp.bfloat16 if rows_bf16 else qd.dtype

        def matvec(A, x):  # (N, R, nv) x (N, nv) -> (N, R)
            return jax.lax.dot_general(
                A, x.astype(A.dtype), (((2,), (1,)), ((0,), (0,))),
                precision=_SOLVER, preferred_element_type=qd.dtype)

        def matvec_T(x, A):  # (N, R) x (N, R, nv) -> (N, nv)
            return jax.lax.dot_general(
                x.astype(A.dtype), A, (((1,), (1,)), ((0,), (0,))),
                precision=_SOLVER, preferred_element_type=qd.dtype)

        Jr = J_flat.astype(row_t)
        HJr = HinvJ_flat.astype(row_t)
        Hinv_r = Hinv.astype(row_t)
        if g_J is not None:
            gJr, gHJr = flat_rows(g_J).astype(row_t), flat_rows(g_HJ).astype(row_t)
        if att_J is not None:
            aJr, aHJr = flat_rows(att_J).astype(row_t), flat_rows(att_HJ).astype(row_t)

        # lam is carried in row-frame coordinates AND the J/HinvJ rows are
        # pre-projected into those frames at build time, so every transfer in
        # the loop pairs row-frame vectors with row-frame rows directly — no
        # per-iteration rotations.  to_world survives only for the final
        # world-frame impulse readout (force sensors / contact reporting).
        if frames_rows is None:
            to_world = lambda v: v
        else:
            def to_world(v):   # v (N, P, 3) row-frame -> world
                return (frames_rows[..., :, 0] * v[..., 0, None]
                        + frames_rows[..., :, 1] * v[..., 1, None]
                        + frames_rows[..., :, 2] * v[..., 2, None])

        ws = float(pr.warm_start)
        if ccache is not None and pr.contact_continuation:
            # in-step impulse continuation (seeds set in the cached branch):
            # apply their velocity contribution once up front — the loop then
            # only has to correct the substep-to-substep change
            qd = qd + matvec_T(lam.reshape(N, -1), HJr) \
                + matvec(Hinv_r, lam_lo - lam_hi)
        elif warm is not None and ws > 0.0:
            # cross-step warm start (SimParams.warm_start): seed from the
            # previous step's impulses on still-active rows, velocity offset
            # applied the same way
            w_rows, w_lo, w_hi = warm
            if sel is not None:
                w_rows = jax.lax.dot_general(
                    sel, w_rows, (((2,), (1,)), ((0,), (0,))),
                    precision=jax.lax.Precision.HIGHEST)
            lam = jnp.where(active[..., None], ws * w_rows.astype(qd.dtype), 0.0)
            lam_lo = jnp.where(act_lo, ws * w_lo, 0.0)
            lam_hi = jnp.where(act_hi, ws * w_hi, 0.0)
            qd = qd + matvec_T(lam.reshape(N, -1), HJr) \
                + matvec(Hinv_r, lam_lo - lam_hi)

        def body_fn(carry, _):
            qd_c, lam, lam_lo, lam_hi, lam_att, lam_g = carry
            if lam_g is not None:
                v_g = matvec(gJr, qd_c).reshape(lam_g.shape)
                dl_g = relax * (g_b - v_g) / g_W * g_act[..., None]
                lam_g = lam_g + dl_g
                qd_c = qd_c + matvec_T(dl_g.reshape(N, -1), gHJr)
            if lam_att is not None:
                v_att = matvec(aJr, qd_c).reshape(lam_att.shape)
                dl_att = relax * (att_b - v_att) / att_W
                lam_att = lam_att + dl_att
                qd_c = qd_c + matvec_T(dl_att.reshape(N, -1), aHJr)
            v_c = matvec(Jr, qd_c).reshape(N, P, 3)   # row-frame directly
            rs = relax if row_scale is None else relax * row_scale
            # normal
            dv_n = b_n - v_c[..., 2]
            lam_n_new = jnp.maximum(lam[..., 2] + rs * dv_n / w_diag[..., 2], 0.0)
            lam_n_new = jnp.where(active, lam_n_new, 0.0)
            # friction box clamp vs the *new* normal impulse
            max_f = mu * lam_n_new
            lam_t1 = jnp.clip(lam[..., 0] + rs * (-v_c[..., 0]) / w_diag[..., 0], -max_f, max_f)
            lam_t2 = jnp.clip(lam[..., 1] + rs * (-v_c[..., 1]) / w_diag[..., 1], -max_f, max_f)
            lam_new = jnp.stack([lam_t1, lam_t2, lam_n_new], axis=-1)
            lam_new = jnp.where(active[..., None], lam_new, 0.0)
            dlam = lam_new - lam                       # row-frame, like HJr
            dqd = matvec_T(dlam.reshape(N, -1), HJr)
            # joint limits (J = e_i): lower pushes +, upper pushes -
            qd_c2 = qd_c + dqd
            lam_lo_new = jnp.where(
                act_lo, jnp.maximum(lam_lo + relax * (b_lo - qd_c2) / hinv_diag, 0.0), 0.0)
            lam_hi_new = jnp.where(
                act_hi, jnp.maximum(lam_hi + relax * (b_hi + qd_c2) / hinv_diag, 0.0), 0.0)
            dlim = (lam_lo_new - lam_lo) - (lam_hi_new - lam_hi)
            qd_c2 = qd_c2 + matvec(Hinv_r, dlim)
            return (qd_c2, lam_new, lam_lo_new, lam_hi_new, lam_att, lam_g), None

        (qd, lam, lam_lo, lam_hi, lam_att, lam_g), _ = jax.lax.scan(
            body_fn, (qd, lam, lam_lo, lam_hi, lam_att, lam_g), None,
            length=self.params.num_iterations)
        lam_w = to_world(lam)                  # world-frame impulse vectors
        # J^T lam: row-frame lam pairs with the row-frame rows (J^T R^T R l)
        imp_dof = matvec_T(lam.reshape(N, -1), Jr) + (lam_lo - lam_hi)
        ccache_out = None
        if reuse_rows:
            if ccache is None:
                ccache_out = dict(
                    sel=sel, J_flat=J_flat, HinvJ_flat=HinvJ_flat,
                    w_diag=w_diag, frames_rows=frames_rows, mu=mu,
                    p_full=p, p_rows=p_rows, phi_rows=phi_rows,
                    rad_rows=rad_rows, is_gnd=is_gnd, e_rows=e_rows)
            else:
                ccache_out = dict(ccache, p_rows=p_rows, phi_rows=phi_rows)
            ccache_out.update(lam=lam, lam_lo=lam_lo, lam_hi=lam_hi)
        if sel is not None:
            # scatter compacted impulses back to the static row set via the
            # transposed selection matmul (top_k rows are unique one-hots)
            scatter = lambda x: jax.lax.dot_general(
                sel, x, (((1,), (1,)), ((0,), (0,))),
                precision=jax.lax.Precision.HIGHEST)
            lam = scatter(lam)
            imp_world = scatter(lam_w)
        else:
            imp_world = lam_w
        warm_out = None
        if warm is not None and ws > 0.0:
            # row-frame impulses at full candidate rows (post scatter-back)
            warm_out = (lam, lam_lo, lam_hi)
        return qd, imp_world, p, imp_dof, warm_out, ccache_out

    def _limit_solve(self, qd, Hinv, qpos_dof, lo_shift=None, hi_shift=None):
        """Joint-limit-only solve for contact-free scenes (e.g. Cartpole)."""
        if not bool(np.any(np.asarray(self.model.dof_has_limit))):
            return qd
        pr = self.params
        h = self.h
        lim_mask = jnp.asarray(self.dof_has_limit)
        lo = self.dof_lower if lo_shift is None else self.dof_lower + lo_shift
        hi = self.dof_upper if hi_shift is None else self.dof_upper + hi_shift
        lo_gap = qpos_dof - lo
        hi_gap = hi - qpos_dof
        hinv_diag = jnp.maximum(jnp.einsum("nvv->nv", Hinv), 1e-8)
        b_lo = -pr.baumgarte / h * jnp.minimum(lo_gap, 0.0)
        b_hi = -pr.baumgarte / h * jnp.minimum(hi_gap, 0.0)
        act_lo = lim_mask & (lo_gap < 0.0)
        act_hi = lim_mask & (hi_gap < 0.0)

        lam_lo = jnp.zeros_like(qd)
        lam_hi = jnp.zeros_like(qd)

        def body_fn(carry, _):
            qd_c, lam_lo, lam_hi = carry
            lam_lo_new = jnp.where(
                act_lo, jnp.maximum(lam_lo + (b_lo - qd_c) / hinv_diag, 0.0), 0.0)
            lam_hi_new = jnp.where(
                act_hi, jnp.maximum(lam_hi + (b_hi + qd_c) / hinv_diag, 0.0), 0.0)
            dlim = (lam_lo_new - lam_lo) - (lam_hi_new - lam_hi)
            qd_c = qd_c + jnp.einsum("nvw,nw->nv", Hinv, dlim, precision=_SOLVER)
            return (qd_c, lam_lo_new, lam_hi_new), None

        (qd, _, _), _ = jax.lax.scan(
            body_fn, (qd, lam_lo, lam_hi), None, length=4)
        return qd

    def _integrate(self, q, qd):
        h = self.h
        segs = []
        for b in range(self.nb):
            t = int(self.jnt_type_np[b])
            qa, va = int(self.q_adr[b]), int(self.v_adr[b])
            if t == md.FREE:
                pos = q[:, qa: qa + 3] + h * qd[:, va: va + 3]
                quat = q[:, qa + 3: qa + 7]
                w = qd[:, va + 3: va + 6]
                wn = jnp.linalg.norm(w, axis=-1, keepdims=True)
                angle = wn[..., 0] * h
                axis = jnp.where(wn > 1e-9, w / jnp.maximum(wn, 1e-9),
                                 jnp.array([0.0, 0, 1], q.dtype))
                dq = maths.quat_from_angle_axis(angle, axis)
                quat_new = maths.normalize(maths.quat_mul(dq, quat))
                segs.append(pos)
                segs.append(quat_new)
            elif t in (md.HINGE, md.SLIDE, md.SCREW):
                segs.append(q[:, qa: qa + 1] + h * qd[:, va: va + 1])
        return jnp.concatenate(segs, axis=-1) if segs else q

    # ------------------------------------------------------------------
    # full control step
    def step(self, state: SimState, ctrl: Control, terrain=None, phys=None):
        """Advance one control step (= ``substeps`` physics substeps).

        Mirrors the hot loop ``control_freq_inv x gym.simulate``
        (vec_task.py:381-384), with actuation held across substeps like
        PhysX's dof actuation tensors.
        """
        q, qd = state.q, state.qd
        impulse_accum = None
        imp_dof_accum = jnp.zeros_like(qd)
        aux = None
        cache = None
        ccache = None
        warm = state.lam if self.params.warm_start > 0 else None
        for _ in range(self.params.substeps):
            q, qd, aux = self.substep(q, qd, ctrl, terrain, phys,
                                      dyn_cache=cache, warm=warm,
                                      contact_cache=ccache)
            if self.params.reuse_mass_matrix:
                cache = aux[7]
            if self.params.reuse_contact_rows:
                ccache = aux[9]
            if aux[8] is not None:
                warm = aux[8]
            if aux[4] is not None:
                impulse_accum = aux[4] if impulse_accum is None else impulse_accum + aux[4]
            imp_dof_accum = imp_dof_accum + aux[6]
        body_x, body_q, V, qdd, _, p_w, _, _, _, _ = aux
        # refresh kinematic outputs at the *new* state
        body_x, body_q = self.fk(q)
        S = self.dof_motion(body_x, body_q)
        V = self.body_velocities(S, qd)
        dof_force = ctrl.tau + imp_dof_accum / self.params.dt
        out = self._outputs(q, qd, body_x, body_q, V, qdd, impulse_accum, p_w,
                            dof_force)
        lam_out = warm if self.params.warm_start > 0 else state.lam
        return SimState(q, qd, lam_out), out

    def _outputs(self, q, qd, body_x, body_q, V, qdd, impulses, p_w, dof_force=None):
        N = q.shape[0]
        f32 = q.dtype
        # per-body linear velocity at body origin: v_o + w x x_b
        w = V[..., 0:3]
        v_lin = V[..., 3:6] + _cross(w, body_x)
        # net contact force per body (sum impulses / dt; +f on A, -f on B)
        contact_force = jnp.zeros((N, self.nb, 3), f32)
        sensor_forces = jnp.zeros((N, len(self.sensor_body), 6), f32)
        if impulses is not None and len(self.row_body_a):
            force_rows = impulses / self.params.dt              # world frame
            seg_a = jax.nn.one_hot(self.row_body_a, self.nb, dtype=f32)  # (C, nb)
            seg_b = jax.nn.one_hot(jnp.where(self.row_body_b >= 0,
                                             self.row_body_b, self.nb),
                                   self.nb + 1, dtype=f32)[:, : self.nb]
            seg = seg_a - seg_b
            contact_force = jnp.einsum("npk,pb->nbk", force_rows, seg)
            if len(self.sensor_body):
                # wrench about each sensor point, rotated into body frame.
                # torque about sensor = torque about body origin
                #                      - (p_sensor - origin) x F_total
                xa = body_x[:, self.row_body_a]
                xb2 = body_x[:, jnp.maximum(self.row_body_b, 0)]
                tq_a = _cross(p_w - xa, force_rows)
                tq_b = _cross(p_w - xb2, force_rows)
                sens_a = seg_a[:, self.sensor_body]
                sens_b = seg_b[:, self.sensor_body]
                f_b = jnp.einsum("npk,ps->nsk", force_rows, sens_a) \
                    - jnp.einsum("npk,ps->nsk", force_rows, sens_b)
                n_o = jnp.einsum("npk,ps->nsk", tq_a, sens_a) \
                    - jnp.einsum("npk,ps->nsk", tq_b, sens_b)
                qs = body_q[:, self.sensor_body]
                r_s = maths.quat_apply(qs, self.sensor_pos)
                n_b = n_o - _cross(r_s, f_b)
                f_loc = maths.quat_rotate_inverse(qs, f_b)
                n_loc = maths.quat_rotate_inverse(qs, n_b)
                sensor_forces = jnp.concatenate([f_loc, n_loc], axis=-1)
        # root states
        rb = self.actor_root_body
        root_states = jnp.concatenate(
            [
                body_x[:, rb],
                body_q[:, rb],
                v_lin[:, rb],
                w[:, rb],
            ],
            axis=-1,
        )
        return SimOutput(
            body_pos=body_x,
            body_quat=body_q,
            body_vel=jnp.concatenate([v_lin, w], axis=-1),
            root_states=root_states,
            contact_force=contact_force,
            sensor_forces=sensor_forces,
            qdd=qdd,
            dof_force=dof_force if dof_force is not None else jnp.zeros_like(qd),
        )

    def dynamics_readout(self, state: SimState):
        """Mass matrix + kinematic quantities for task-level controllers.

        The acquire_mass_matrix_tensor / acquire_jacobian_tensor replacement
        (used by OSC — franka_reach_MA.py:891-911).  Returns
        (M (N, nv, nv), body_x, body_q, S, V).
        """
        body_x, body_q = self.fk(state.q)
        S = self.dof_motion(body_x, body_q)
        V = self.body_velocities(S, state.qd)
        I_O, _ = self.spatial_inertia(body_x, body_q)
        M = self.mass_matrix(S, I_O)
        return M, body_x, body_q, S, V

    def point_jacobian(self, S, body_x, body: int, point=None):
        """End-effector jacobian rows [lin(3), ang(3)] per dof: (N, nv, 6).

        ``point``: world application point (defaults to the body origin).
        Caller slices the relevant dof columns (e.g. one arm's 7 dofs).
        """
        p = body_x[:, body] if point is None else point
        S_ang = S[..., 0:3]
        S_lin = S[..., 3:6]
        J_lin = S_lin + _cross(S_ang, p[:, None, :])
        mask = self.dof_body_mask_f[:, body][None, :, None]
        return jnp.concatenate([J_lin, S_ang], axis=-1) * mask

    def forward(self, state: SimState, prev_out: Optional[SimOutput] = None) -> SimOutput:
        """Kinematics-only readout refresh (the ``gym.refresh_*`` family).

        Used after masked resets to recompute poses/velocities without
        advancing dynamics.  Contact/sensor readouts carry over from
        ``prev_out`` when given (PhysX sensors also hold their last-simulated
        values until the next ``gym.simulate``).
        """
        q, qd = state.q, state.qd
        body_x, body_q = self.fk(q)
        S = self.dof_motion(body_x, body_q)
        V = self.body_velocities(S, qd)
        N = q.shape[0]
        w = V[..., 0:3]
        v_lin = V[..., 3:6] + _cross(w, body_x)
        rb = self.actor_root_body
        root_states = jnp.concatenate(
            [body_x[:, rb], body_q[:, rb], v_lin[:, rb], w[:, rb]], axis=-1)
        zeros_cf = jnp.zeros((N, self.nb, 3), q.dtype)
        zeros_sf = jnp.zeros((N, len(self.sensor_body), 6), q.dtype)
        return SimOutput(
            body_pos=body_x,
            body_quat=body_q,
            body_vel=jnp.concatenate([v_lin, w], axis=-1),
            root_states=root_states,
            contact_force=prev_out.contact_force if prev_out is not None else zeros_cf,
            sensor_forces=prev_out.sensor_forces if prev_out is not None else zeros_sf,
            qdd=prev_out.qdd if prev_out is not None else jnp.zeros((N, self.nv), q.dtype),
            dof_force=prev_out.dof_force if prev_out is not None else jnp.zeros((N, self.nv), q.dtype),
        )

    # ------------------------------------------------------------------
    # state helpers (the set_*_tensor family)
    def default_state(self, num_envs: int) -> SimState:
        q0 = jnp.asarray(md.default_qpos(self.model), jnp.float32)
        q = jnp.tile(q0[None], (num_envs, 1))
        qd = jnp.zeros((num_envs, self.nv), jnp.float32)
        return SimState(q, qd, self.zero_warm(num_envs))

    def zero_warm(self, num_envs: int):
        """Cold-start warm-start impulses (SimState.lam) — zeros when
        SimParams.warm_start is enabled and the scene has contact rows."""
        n_rows = (self.n_ground if self.ground else 0) + self.n_pair_rows
        if self.params.warm_start <= 0 or n_rows == 0:
            return None
        return (jnp.zeros((num_envs, n_rows, 3), jnp.float32),
                jnp.zeros((num_envs, self.nv), jnp.float32),
                jnp.zeros((num_envs, self.nv), jnp.float32))

    def dof_pos(self, state: SimState):
        """Scalar-dof positions (N, n_scalar_dofs) — the dof_state pos view."""
        return state.q[:, self.scalar_qids]

    def dof_vel(self, state: SimState):
        return state.qd[:, self.scalar_dofs]

    def set_dof_pos(self, state: SimState, pos):
        return state._replace(q=state.q.at[:, self.scalar_qids].set(pos))

    def set_dof_vel(self, state: SimState, vel):
        return state._replace(qd=state.qd.at[:, self.scalar_dofs].set(vel))

    def set_root_state(self, state: SimState, actor: int, root13):
        """Set a free root body's 13-dim root state (masked callers use where)."""
        b = int(self.actor_root_body[actor])
        qa, va = int(self.q_adr[b]), int(self.v_adr[b])
        q = state.q.at[:, qa: qa + 7].set(root13[:, 0:7])
        qd = state.qd.at[:, va: va + 6].set(root13[:, 7:13])
        return SimState(q, qd)
