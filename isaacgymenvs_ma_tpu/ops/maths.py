"""Batched quaternion / transform / scaling math kernels (JAX).

Batched JAX re-implementation of the math-kernel surface of the reference's
``isaacgymenvs/utils/torch_jit_utils.py`` (quaternion algebra :42-174, euler
conversions :176-214, scaling :234-246, locomotion helpers :248-290,
manipulation helpers :292-351, ``quat_diff_rad`` :354).  Same conventions:

* quaternions are ``(x, y, z, w)`` (Isaac Gym order), stored in the last axis,
* all functions broadcast over arbitrary leading batch axes,
* float32 throughout (physics runs in f32; bf16 is reserved for NN matmuls).

Everything here is pure jnp — safe inside ``jit`` / ``vmap`` / pallas callers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# basics


def normalize(x: jax.Array, eps: float = 1e-9) -> jax.Array:
    """Unit-normalize along the last axis (ref torch_jit_utils.py:66)."""
    n = jnp.linalg.norm(x, axis=-1, keepdims=True)
    return x / jnp.maximum(n, eps)


def tensor_clamp(t, lo, hi):
    return jnp.maximum(jnp.minimum(t, hi), lo)


saturate = tensor_clamp  # ref :338-351


def scale(x, lower, upper):
    """[-1,1] -> [lower,upper] (ref :234)."""
    return 0.5 * (x + 1.0) * (upper - lower) + lower


def unscale(x, lower, upper):
    """[lower,upper] -> [-1,1] (ref :239)."""
    return (2.0 * x - upper - lower) / (upper - lower)


def scale_transform(x, lower, upper):
    """Normalize to [-1,1] with broadcasting (ref :292-311)."""
    offset = (lower + upper) * 0.5
    return 2.0 * (x - offset) / (upper - lower)


def unscale_transform(x, lower, upper):
    """Denormalize from [-1,1] (ref :313-333)."""
    offset = (lower + upper) * 0.5
    return x * (upper - lower) * 0.5 + offset


def normalize_angle(x):
    """Wrap angle to (-pi, pi] (ref :130)."""
    return jnp.arctan2(jnp.sin(x), jnp.cos(x))


# ---------------------------------------------------------------------------
# quaternions (xyzw)


def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamilton product, xyzw layout (ref :42-63)."""
    x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    return jnp.stack([x, y, z, w], axis=-1)


def quat_conjugate(a: jax.Array) -> jax.Array:
    """(ref :107)."""
    return jnp.concatenate([-a[..., :3], a[..., 3:4]], axis=-1)


def quat_unit(a):
    return normalize(a)


def quat_apply(a: jax.Array, b: jax.Array) -> jax.Array:
    """Rotate vector(s) b by quaternion(s) a (ref :71-79)."""
    xyz = a[..., :3]
    w = a[..., 3:4]
    t = 2.0 * jnp.cross(xyz, b)
    return b + w * t + jnp.cross(xyz, t)


# quat_rotate / quat_rotate_inverse (ref :81-105) are the same rotation as
# quat_apply, just a different evaluation order; we keep one implementation.
quat_rotate = quat_apply
tf_vector = quat_apply
get_basis_vector = quat_apply


def quat_rotate_inverse(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate v by q^-1 (ref :95-105)."""
    return quat_apply(quat_conjugate(q), v)


def quat_from_angle_axis(angle: jax.Array, axis: jax.Array) -> jax.Array:
    """(ref :119-124)."""
    theta = (angle / 2)[..., None]
    xyz = normalize(axis) * jnp.sin(theta)
    w = jnp.cos(theta)
    return quat_unit(jnp.concatenate([xyz, w], axis=-1))


def quat_axis(q: jax.Array, axis: int = 0) -> jax.Array:
    """Basis vector of rotated frame (ref :293-297)."""
    v = jnp.zeros(q.shape[:-1] + (3,), q.dtype).at[..., axis].set(1.0)
    return quat_apply(q, v)


def quat_to_rotmat(q: jax.Array) -> jax.Array:
    """xyzw quaternion -> 3x3 rotation matrix (batched)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_diff_rad(a: jax.Array, b: jax.Array) -> jax.Array:
    """Rotation angle between two quaternions (ref :354-375)."""
    mul = quat_mul(a, quat_conjugate(b))
    sin_half = jnp.linalg.norm(mul[..., :3], axis=-1)
    return 2.0 * jnp.arcsin(jnp.clip(sin_half, -1.0, 1.0))


def axisangle2quat(vec: jax.Array, eps: float = 1e-6) -> jax.Array:
    """Exponential-map rotation vector -> xyzw quaternion.

    Mirrors the helper exported by the fork's ``tasks/franka_reach.py`` and
    reused by all MA tasks (``tasks/franka_reach_MA.py:16``).
    """
    angle = jnp.linalg.norm(vec, axis=-1, keepdims=True)
    small = angle < eps
    safe_angle = jnp.where(small, 1.0, angle)
    xyz = vec * jnp.where(small, 0.5, jnp.sin(safe_angle / 2) / safe_angle)
    w = jnp.cos(angle / 2)
    return jnp.concatenate([xyz, w], axis=-1)


# ---------------------------------------------------------------------------
# euler


def copysign_scalar(a: float, b: jax.Array) -> jax.Array:
    """|a| with sign of b (ref :169-173)."""
    return jnp.abs(a) * jnp.sign(b)


def get_euler_xyz(q: jax.Array):
    """Quaternion -> (roll, pitch, yaw), each wrapped to [0, 2pi) (ref :176-198)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (qw * qx + qy * qz)
    cosr_cosp = qw * qw - qx * qx - qy * qy + qz * qz
    roll = jnp.arctan2(sinr_cosp, cosr_cosp)

    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = jnp.where(
        jnp.abs(sinp) >= 1.0, copysign_scalar(np.pi / 2.0, sinp), jnp.arcsin(jnp.clip(sinp, -1.0, 1.0))
    )

    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = qw * qw + qx * qx - qy * qy - qz * qz
    yaw = jnp.arctan2(siny_cosp, cosy_cosp)

    two_pi = 2 * np.pi
    return roll % two_pi, pitch % two_pi, yaw % two_pi


def quat_from_euler_xyz(roll, pitch, yaw):
    """(ref :201-214)."""
    cy, sy = jnp.cos(yaw * 0.5), jnp.sin(yaw * 0.5)
    cr, sr = jnp.cos(roll * 0.5), jnp.sin(roll * 0.5)
    cp, sp = jnp.cos(pitch * 0.5), jnp.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return jnp.stack([qx, qy, qz, qw], axis=-1)


# ---------------------------------------------------------------------------
# transforms (quat, trans) pairs


def tf_inverse(q, t):
    """(ref :133-136)."""
    q_inv = quat_conjugate(q)
    return q_inv, -quat_apply(q_inv, t)


def tf_apply(q, t, v):
    """(ref :138-141)."""
    return quat_apply(q, v) + t


def tf_combine(q1, t1, q2, t2):
    """(ref :148-151)."""
    return quat_mul(q1, q2), quat_apply(q1, t2) + t1


def get_axis_params(value, axis_idx, x_value=0.0, n_dims=3):
    """Axis-aligned parameter vector (ref :156-165)."""
    zs = np.zeros(n_dims)
    zs[axis_idx] = 1.0
    params = np.where(zs == 1.0, value, zs)
    params[0] = x_value
    return list(params)


# ---------------------------------------------------------------------------
# locomotion helpers (Ant/Humanoid family)


def compute_heading_and_up(torso_rotation, inv_start_rot, to_target, vec0, vec1, up_idx):
    """(ref :248-263)."""
    target_dirs = normalize(to_target)
    torso_quat = quat_mul(torso_rotation, inv_start_rot)
    up_vec = quat_apply(torso_quat, vec1)
    heading_vec = quat_apply(torso_quat, vec0)
    up_proj = up_vec[..., up_idx]
    heading_proj = jnp.sum(heading_vec * target_dirs, axis=-1)
    return torso_quat, up_proj, heading_proj, up_vec, heading_vec


def compute_rot(torso_quat, velocity, ang_velocity, targets, torso_positions):
    """(ref :266-277)."""
    vel_loc = quat_rotate_inverse(torso_quat, velocity)
    angvel_loc = quat_rotate_inverse(torso_quat, ang_velocity)
    roll, pitch, yaw = get_euler_xyz(torso_quat)
    walk_target_angle = jnp.arctan2(
        targets[..., 2] - torso_positions[..., 2], targets[..., 0] - torso_positions[..., 0]
    )
    angle_to_target = walk_target_angle - yaw
    return vel_loc, angvel_loc, roll, pitch, yaw, angle_to_target


# ---------------------------------------------------------------------------
# AMP rotation conversions (reference utils/torch_jit_utils.py:377-567)


def quat_to_tan_norm(q: jax.Array) -> jax.Array:
    """Quaternion -> 6d tangent/normal rotation representation (ref :380-394)."""
    ref_tan = jnp.zeros(q.shape[:-1] + (3,), q.dtype).at[..., 0].set(1.0)
    tan = quat_apply(q, ref_tan)
    ref_norm = jnp.zeros(q.shape[:-1] + (3,), q.dtype).at[..., 2].set(1.0)
    norm = quat_apply(q, ref_norm)
    return jnp.concatenate([tan, norm], axis=-1)


def quat_to_exp_map(q: jax.Array) -> jax.Array:
    """Quaternion -> exponential map (ref :425-434 via angle-axis)."""
    # angle-axis (ref :397-422)
    sin_half = jnp.linalg.norm(q[..., 0:3], axis=-1)
    angle = 2.0 * jnp.arctan2(sin_half, q[..., 3])
    angle = normalize_angle(angle)
    axis = q[..., 0:3] / jnp.maximum(sin_half, 1e-9)[..., None]
    default_axis = jnp.zeros_like(axis).at[..., 2].set(1.0)
    mask = (sin_half > 1e-5)[..., None]
    axis = jnp.where(mask, axis, default_axis)
    return angle[..., None] * axis


def exp_map_to_quat(exp_map: jax.Array) -> jax.Array:
    """Exponential map -> quaternion (ref :437-451)."""
    angle = jnp.linalg.norm(exp_map, axis=-1)
    axis = exp_map / jnp.maximum(angle, 1e-9)[..., None]
    default_axis = jnp.zeros_like(axis).at[..., 2].set(1.0)
    mask = (angle > 1e-5)[..., None]
    axis = jnp.where(mask, axis, default_axis)
    return quat_from_angle_axis(angle, axis)


def calc_heading(q: jax.Array) -> jax.Array:
    """Heading angle about z of the rotated x-axis (ref :533-540)."""
    ref_dir = jnp.zeros(q.shape[:-1] + (3,), q.dtype).at[..., 0].set(1.0)
    rot_dir = quat_apply(q, ref_dir)
    return jnp.arctan2(rot_dir[..., 1], rot_dir[..., 0])


def calc_heading_quat(q: jax.Array) -> jax.Array:
    heading = calc_heading(q)
    axis = jnp.zeros(q.shape[:-1] + (3,), q.dtype).at[..., 2].set(1.0)
    return quat_from_angle_axis(heading, axis)


def calc_heading_quat_inv(q: jax.Array) -> jax.Array:
    """(ref :556-566)."""
    heading = calc_heading(q)
    axis = jnp.zeros(q.shape[:-1] + (3,), q.dtype).at[..., 2].set(1.0)
    return quat_from_angle_axis(-heading, axis)


def slerp(q0, q1, t):
    """Quaternion slerp (batched, ref poselib semantics)."""
    cos_half = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(cos_half < 0, -q1, q1)
    cos_half = jnp.abs(cos_half)
    half = jnp.arccos(jnp.clip(cos_half, -1.0, 1.0))
    sin_half = jnp.sqrt(jnp.maximum(1.0 - cos_half * cos_half, 1e-12))
    ratio_a = jnp.where(sin_half > 1e-5, jnp.sin((1 - t) * half) / sin_half, 1 - t)
    ratio_b = jnp.where(sin_half > 1e-5, jnp.sin(t * half) / sin_half, t)
    return normalize(ratio_a * q0 + ratio_b * q1)
