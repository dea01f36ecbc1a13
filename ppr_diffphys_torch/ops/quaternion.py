"""Quaternion / rotation math (PyTorch), counterpart of
``ppr_diffphys_tpu/ops/quaternion.py``.

Conventions
-----------
- Quaternions are stored **xyzw** (scalar last), matching the body state
  layout ``body_q = [x, y, z, qx, qy, qz, qw]``.
- All functions broadcast over arbitrary leading batch dimensions and are
  safe-guarded at their singularities exactly like the JAX versions.
- fp32 throughout: the stiff attachment springs (ke=16e3 at dt=5e-4) do not
  survive lower precision.
"""

from __future__ import annotations

import torch

from . import kernel_math

_EPS = 1e-9


def _vec(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------

def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity quaternion(s) xyzw, shape ``shape + (4,)``."""
    shape = tuple(shape)
    return torch.cat(
        [torch.zeros(shape + (3,), dtype=dtype, device=device),
         torch.ones(shape + (1,), dtype=dtype, device=device)], -1
    )


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both xyzw. Rotation by (a*b) applies b first."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions), xyzw."""
    return q * _vec([-1.0, -1.0, -1.0, 1.0], q)


quat_inverse = quat_conjugate


def quat_normalize(q: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Safe normalize; the zero quaternion maps to identity."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    qn = q / torch.clamp(n, min=eps)
    ident = quat_identity(q.shape[:-1], q.dtype, q.device)
    return torch.where(n > eps, qn, ident)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product on the last axis with broadcasting."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q (xyzw)."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q."""
    return quat_rotate(quat_conjugate(q), v)


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------

def quat_from_axis_angle(axis: torch.Tensor, angle) -> torch.Tensor:
    """Unit axis + angle -> quat xyzw. `axis` (...,3), `angle` (...)."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    half = 0.5 * angle
    s = torch.sin(half)
    xyz = axis * s[..., None]
    w = torch.cos(half)[..., None].expand(xyz.shape[:-1] + (1,))
    return torch.cat([xyz, w], dim=-1)


def axis_angle_to_quat(rotvec: torch.Tensor) -> torch.Tensor:
    """Rotation-vector (axis*angle) -> quat xyzw, Taylor-safe at 0."""
    sq = torch.sum(rotvec * rotvec, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(sq, min=_EPS))
    half = 0.5 * angle
    small = sq < 1e-12
    # sin(x/2)/x  ~  1/2 - x^2/48
    sin_half_over = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    xyz = rotvec * sin_half_over
    w = torch.where(small[..., 0], 1.0 - sq[..., 0] / 8.0, torch.cos(half[..., 0]))
    return torch.cat([xyz, w[..., None]], dim=-1)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Quat xyzw -> rotation vector, Taylor-safe at identity."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    sq = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    is_zero = sq < 1e-12
    norms = torch.where(
        is_zero, torch.zeros_like(sq),
        torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq)),
    )
    half = kernel_math.atan2(norms, w)
    angles = 2.0 * half
    small = torch.abs(angles) < 1e-6
    sin_half_over = torch.where(
        small, 0.5 - angles * angles / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angles), angles),
    )
    return xyz / sin_half_over


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quat xyzw -> rotation matrix (...,3,3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> quat xyzw (branch-free Shepperd-style:
    all four candidates, the best pivot selected by argmax)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    w_w = _safe_sqrt(qw2) * 0.5
    cand_w = torch.stack(
        [(m21 - m12) / (4 * w_w), (m02 - m20) / (4 * w_w), (m10 - m01) / (4 * w_w), w_w],
        dim=-1,
    )
    x_x = _safe_sqrt(qx2) * 0.5
    cand_x = torch.stack(
        [x_x, (m01 + m10) / (4 * x_x), (m02 + m20) / (4 * x_x), (m21 - m12) / (4 * x_x)],
        dim=-1,
    )
    y_y = _safe_sqrt(qy2) * 0.5
    cand_y = torch.stack(
        [(m01 + m10) / (4 * y_y), y_y, (m12 + m21) / (4 * y_y), (m02 - m20) / (4 * y_y)],
        dim=-1,
    )
    z_z = _safe_sqrt(qz2) * 0.5
    cand_z = torch.stack(
        [(m02 + m20) / (4 * z_z), (m12 + m21) / (4 * z_z), z_z, (m10 - m01) / (4 * z_z)],
        dim=-1,
    )

    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # (...,4,4)
    scores = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    # first maximal index on ties, like jnp.argmax
    best = torch.argmax(scores, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    sign = torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    return quat_normalize(q * sign)


def quat_rpy(roll, pitch, yaw) -> torch.Tensor:
    """URDF fixed-axis roll-pitch-yaw -> quat xyzw (R = Rz(yaw) Ry(pitch) Rx(roll)),
    as wp.quat_rpy of the reference URDF importer (diffphys/import_urdf.py:31)."""
    roll, pitch, yaw = (torch.as_tensor(a, dtype=torch.float32) for a in (roll, pitch, yaw))
    qx = quat_from_axis_angle(_vec([1.0, 0.0, 0.0], roll), roll)
    qy = quat_from_axis_angle(_vec([0.0, 1.0, 0.0], pitch), pitch)
    qz = quat_from_axis_angle(_vec([0.0, 0.0, 1.0], yaw), yaw)
    return quat_mul(qz, quat_mul(qy, qx))


# ---------------------------------------------------------------------------
# compound (ball) joint angles — intrinsic X-Y'-Z'' (M = Rx(a) Ry(b) Rz(c))
# ---------------------------------------------------------------------------

def compound_to_quat(angles: torch.Tensor) -> torch.Tensor:
    """(...,3) intrinsic XYZ angles -> quat xyzw with M = Rx(a) Ry(b) Rz(c)."""
    a, b, c = angles[..., 0], angles[..., 1], angles[..., 2]
    ex = _vec([1.0, 0.0, 0.0], angles).expand(angles.shape)
    ey = _vec([0.0, 1.0, 0.0], angles).expand(angles.shape)
    ez = _vec([0.0, 0.0, 1.0], angles).expand(angles.shape)
    qx = quat_from_axis_angle(ex, a)
    qy = quat_from_axis_angle(ey, b)
    qz = quat_from_axis_angle(ez, c)
    return quat_mul(qx, quat_mul(qy, qz))


def quat_to_compound(q: torch.Tensor) -> torch.Tensor:
    """Inverse of compound_to_quat, safe at the gimbal singularity."""
    m = quat_to_matrix(q)
    a = kernel_math.atan2(-m[..., 1, 2], m[..., 2, 2])
    b = kernel_math.asin(torch.clamp(m[..., 0, 2], -1.0 + 1e-7, 1.0 - 1e-7))
    c = kernel_math.atan2(-m[..., 0, 1], m[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def quat_twist(axis: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Twist component of q about ``axis`` (swing-twist decomposition;
    reference diffphys/integrator_euler.py:234-241)."""
    proj = torch.sum(q[..., :3] * axis, dim=-1, keepdim=True) * axis
    return quat_normalize(torch.cat([proj, q[..., 3:4]], dim=-1))


def quat_twist_angle(axis: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Signed rotation angle of q about ``axis`` via swing-twist, in the
    atan2 form (smooth at zero twist, unlike the reference's acos form,
    diffphys/integrator_euler.py:397-400)."""
    s = torch.sum(q[..., :3] * axis, dim=-1)
    return 2.0 * kernel_math.atan2(s, q[..., 3])


def rot_angle(m: torch.Tensor) -> torch.Tensor:
    """Rotation angle of rotation matrix(es), clamped like the reference
    (diffphys/geom_utils.py:37-46)."""
    eps = 1e-4
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) * 0.5
    cos = torch.clamp(cos, -1.0 + eps, 1.0 - eps)
    return torch.arccos(cos)
