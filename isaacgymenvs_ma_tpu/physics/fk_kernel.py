"""Forward kinematics + joint motion subspace in one GPU kernel (Pallas,
Triton route).

``PhysicsEngine.fk`` and ``dof_motion`` walk the kinematic tree body by body:
a chain of tiny elementwise ops per body with parent dependencies, which XLA
splits into many small fusions.  Here the whole unrolled tree runs in one
Triton program per block of envs.  Every coordinate is a ``(BLOCK,)`` row
held in registers, and every tree constant (joint types, axes, anchors,
offsets) is a Python float baked into the kernel.  Measured on an H100 at
Ant@4096 and ShadowHand@16384, the kernel takes 0.4x and 0.2x of the XLA
path's time and lifts Ant end to end; ``PERF.md`` has the numbers.

:func:`fk_motion` is what the engine calls.  It stages out both versions
with ``lax.platform_dependent``: the kernel where the program is lowered for
CUDA, the XLA reference (:func:`fk_motion_xla`) everywhere else.  Under a
mesh with the ``env`` axis the kernel runs per shard through ``shard_map``.
Tests run the kernel in interpret mode against the reference.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from ..models import model as md

BLOCK = 128       # envs per program: fastest of 128/256 at Ant and ShadowHand
NUM_WARPS = 4
ENV_AXIS = "env"


def _qmul(a, b):
    """Hamilton product of xyzw quaternions given as 4 rows (or floats)."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return [aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _qapply(q, v):
    """Rotate a 3-row vector by a 4-row quaternion (maths.quat_apply)."""
    t = [2.0 * c for c in _cross(q[:3], v)]
    u = _cross(q[:3], t)
    return [v[i] + q[3] * t[i] + u[i] for i in range(3)]


def _add(a, b):
    return [x + y for x, y in zip(a, b)]


def _floats(v):
    return [float(x) for x in np.asarray(v, np.float32)]


def tree_rows(engine, rows):
    """FK and motion subspace over per-coordinate rows.

    ``rows``: the nq joint coordinates, each a ``(B,)`` array.  Returns
    per-body positions (nb lists of 3), quaternions (nb lists of 4) and
    per-dof motion columns (nv lists of 6, [ang, lin] about the world
    origin); an entry is a ``(B,)`` array or a Python float.  Same formulas
    as ``PhysicsEngine.fk`` / ``dof_motion``: the joint rotation uses the
    normalized axis, motion columns and slides the model's axis as given."""
    m = engine.model
    xs, qs, cols = [], [], []
    for b in range(engine.nb):
        t = int(engine.jnt_type_np[b])
        qa = int(engine.q_adr[b])
        if engine.parent[b] == -1:
            xp, qp = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]
        else:
            xp, qp = xs[int(engine.parent[b])], qs[int(engine.parent[b])]
        bp, bq = _floats(m.body_pos[b]), _floats(m.body_quat[b])
        axis = _floats(m.jnt_axis[b])
        nrm = float(np.linalg.norm(axis))
        axis_n = [a / nrm for a in axis] if nrm > 0 else axis
        anchor = _floats(m.jnt_pos[b])
        pitch = float(engine.jnt_pitch_np[b]) / (2.0 * np.pi)
        if t == md.FREE:
            xb, qb = rows[qa: qa + 3], rows[qa + 3: qa + 7]
        else:
            if t in (md.HINGE, md.SCREW):
                half = 0.5 * rows[qa]
                s = jnp.sin(half)
                ql = _qmul(bq, [axis_n[0] * s, axis_n[1] * s, axis_n[2] * s,
                                jnp.cos(half)])
                tl = [p + a - c for p, a, c in zip(
                    bp, _qapply(bq, anchor), _qapply(ql, anchor))]
                if t == md.SCREW:
                    tl = _add(tl, [a * (pitch * rows[qa])
                                   for a in _qapply(bq, axis)])
            elif t == md.SLIDE:
                ql = bq
                tl = _add(bp, [a * rows[qa] for a in _qapply(bq, axis)])
            else:  # FIXED
                ql, tl = bq, bp
            xb = _add(xp, _qapply(qp, tl))
            qb = _qmul(qp, ql)
        xs.append(xb)
        qs.append(qb)
        if t == md.FREE:
            for i in range(3):                      # linear dofs
                cols.append([0.0] * 3 + [float(i == j) for j in range(3)])
            for i in range(3):                      # angular, about origin
                e = [float(i == j) for j in range(3)]
                cols.append(e + _cross(xb, e))
        elif t == md.SLIDE:
            cols.append([0.0] * 3 + _qapply(qb, axis))
        elif t in (md.HINGE, md.SCREW):
            a_w = _qapply(qb, axis)
            lin = _cross(_add(xb, _qapply(qb, anchor)), a_w)
            if t == md.SCREW:
                lin = _add(lin, [pitch * a for a in a_w])
            cols.append(a_w + lin)
    return xs, qs, cols


def fk_motion_xla(engine, q):
    """The XLA reference: ``(body_x, body_q, S)``."""
    body_x, body_q = engine.fk(q)
    return body_x, body_q, engine.dof_motion(body_x, body_q)


def fk_motion_pallas(engine, q, interpret: bool = False):
    """The kernel: ``(body_x (N, nb, 3), body_q (N, nb, 4), S (N, nv, 6))``.

    The env axis is padded to a multiple of ``BLOCK``; padded envs compute
    finite garbage that is sliced off."""
    from jax.experimental.pallas import triton as pltr

    N, nq = q.shape
    nb, nv = engine.nb, engine.nv
    n_pad = -N % BLOCK
    qt = jnp.pad(q, ((0, n_pad), (0, 0))).T                  # (nq, Np)
    Np = N + n_pad
    dt = q.dtype

    def kernel(q_ref, bx_ref, bq_ref, s_ref):
        xs, qs, cols = tree_rows(engine, [q_ref[i, :] for i in range(nq)])

        def put(ref, i, v):
            ref[i, :] = (jnp.full((BLOCK,), v, dt) if isinstance(v, float)
                         else v.astype(dt))
        for b in range(nb):
            for k in range(3):
                put(bx_ref, 3 * b + k, xs[b][k])
            for k in range(4):
                put(bq_ref, 4 * b + k, qs[b][k])
        for v in range(nv):
            for k in range(6):
                put(s_ref, 6 * v + k, cols[v][k])

    rows = lambda r: pl.BlockSpec((r, BLOCK), lambda i: (0, i))
    bx, bq, S = pl.pallas_call(
        kernel, grid=(Np // BLOCK,), in_specs=[rows(nq)],
        out_specs=[rows(3 * nb), rows(4 * nb), rows(6 * nv)],
        out_shape=[jax.ShapeDtypeStruct((3 * nb, Np), dt),
                   jax.ShapeDtypeStruct((4 * nb, Np), dt),
                   jax.ShapeDtypeStruct((6 * nv, Np), dt)],
        backend="triton", interpret=interpret, name="fk_motion",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS,
                                            num_stages=1),
    )(qt)
    return (bx.T[:N].reshape(N, nb, 3), bq.T[:N].reshape(N, nb, 4),
            S.T[:N].reshape(N, nv, 6))


def fk_motion_kernel(engine, q, interpret: bool = False):
    """The kernel, run once per shard under a mesh with the ``env`` axis
    (a custom call is not split by XLA's partitioner)."""
    run = lambda x: fk_motion_pallas(engine, x, interpret)
    mesh = jax.sharding.get_abstract_mesh()
    if ENV_AXIS not in mesh.axis_names:
        return run(q)
    spec = jax.sharding.PartitionSpec(ENV_AXIS)
    return jax.shard_map(run, mesh=mesh, in_specs=spec,
                         out_specs=(spec, spec, spec), check_vma=False)(q)


def fk_motion(engine, q):
    """FK + motion subspace: the kernel on CUDA, the XLA reference
    elsewhere (chosen when the program is lowered)."""
    return jax.lax.platform_dependent(
        q, cuda=lambda q: fk_motion_kernel(engine, q),
        default=lambda q: fk_motion_xla(engine, q))
