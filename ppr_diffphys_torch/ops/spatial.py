"""SE(3) transforms and spatial vectors (PyTorch), counterpart of
``ppr_diffphys_tpu/ops/spatial.py``.

A *transform* is a 7-vector ``[x, y, z, qx, qy, qz, qw]`` (translation +
quat xyzw). A *spatial vector* is a 6-vector in one of two layouts:
- **warp layout** ``[angular, linear]`` inside the simulator
  (``body_qd``, ``body_f``), and
- **ppr layout** ``[linear, angular]`` at the model/data API.
``swap_lin_ang`` converts between them (it is an involution).
"""

from __future__ import annotations

import torch

from .quaternion import (
    axis_angle_to_quat,
    matrix_to_quat,
    quat_inverse,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_axis_angle,
    quat_to_matrix,
)


# ---------------------------------------------------------------------------
# transforms (7-vectors)
# ---------------------------------------------------------------------------

def transform_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    t = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    t[..., 6] = 1.0
    return t


def make_transform(p, q) -> torch.Tensor:
    return torch.cat([torch.as_tensor(p), torch.as_tensor(q)], dim=-1)


def transform_p(t: torch.Tensor) -> torch.Tensor:
    return t[..., 0:3]


def transform_q(t: torch.Tensor) -> torch.Tensor:
    return t[..., 3:7]


def transform_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose transforms: (a*b) applies b first, then a."""
    p = transform_p(a) + quat_rotate(transform_q(a), transform_p(b))
    q = quat_mul(transform_q(a), transform_q(b))
    return torch.cat([p, q], dim=-1)


def transform_point(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply full transform (rotation + translation) to point(s)."""
    return transform_p(t) + quat_rotate(transform_q(t), p)


def transform_inverse(t: torch.Tensor) -> torch.Tensor:
    qi = quat_inverse(transform_q(t))
    return torch.cat([-quat_rotate(qi, transform_p(t)), qi], dim=-1)


def transform_vector(t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation of the transform to vector(s)."""
    return quat_rotate(transform_q(t), v)


# ---------------------------------------------------------------------------
# se3 vec <-> 4x4 matrix
# ---------------------------------------------------------------------------

def se3_vec2mat(vec: torch.Tensor) -> torch.Tensor:
    """[x,y,z,qx,qy,qz,qw] (7) or [x,y,z, axis-angle] (6) -> (...,4,4)."""
    if vec.shape[-1] == 6:
        rmat = quat_to_matrix(axis_angle_to_quat(vec[..., 3:6]))
    else:
        rmat = quat_to_matrix(quat_normalize(vec[..., 3:7]))
    mat = torch.zeros(vec.shape[:-1] + (4, 4), dtype=vec.dtype, device=vec.device)
    mat[..., :3, :3] = rmat
    mat[..., :3, 3] = vec[..., :3]
    mat[..., 3, 3] = 1.0
    return mat


def se3_mat2vec(mat: torch.Tensor, outdim: int = 7) -> torch.Tensor:
    """(...,4,4) -> 7-vec (quat xyzw) or 6-vec (axis-angle)."""
    t = mat[..., :3, 3]
    q = matrix_to_quat(mat[..., :3, :3])
    if outdim == 7:
        rot = q
    elif outdim == 6:
        rot = quat_to_axis_angle(q)
    else:
        raise ValueError("outdim must be 6 or 7")
    return torch.cat([t, rot], dim=-1)


def compose_delta(target_q: torch.Tensor, delta_root: torch.Tensor) -> torch.Tensor:
    """delta (6-vec: trans+axis-angle) composed on the left of target (7-vec)."""
    return se3_mat2vec(se3_vec2mat(delta_root) @ se3_vec2mat(target_q))


def rotate_frame(global_q: torch.Tensor, target_q: torch.Tensor) -> torch.Tensor:
    """Left-compose a global SE(3) onto root pose(s)."""
    gmat = se3_vec2mat(global_q)
    gmat = gmat.reshape((1,) * (target_q.ndim - global_q.ndim) + gmat.shape)
    return se3_mat2vec(gmat @ se3_vec2mat(target_q), outdim=target_q.shape[-1])


def rotate_frame_vel(global_q: torch.Tensor, target_qd: torch.Tensor) -> torch.Tensor:
    """Rotate root velocity [lin, ang] by the rotation part of global_q."""
    rot_only = global_q.clone()
    rot_only[..., :3] = 0.0
    lin = rotate_frame(rot_only, target_qd)[..., :3]
    ang = rotate_frame(
        rot_only, torch.cat([target_qd[..., 3:], target_qd[..., :3]], -1)
    )[..., :3]
    return torch.cat([lin, ang], dim=-1)


# ---------------------------------------------------------------------------
# spatial vectors
# ---------------------------------------------------------------------------

def swap_lin_ang(v: torch.Tensor) -> torch.Tensor:
    """[a,b,rest] -> [b,a,rest] on the last axis: ppr<->warp layout swap."""
    return torch.cat([v[..., 3:6], v[..., 0:3], v[..., 6:]], dim=-1)


def spatial_top(v: torch.Tensor) -> torch.Tensor:
    return v[..., 0:3]


def spatial_bottom(v: torch.Tensor) -> torch.Tensor:
    return v[..., 3:6]


def make_spatial(top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    return torch.cat([top, bottom], dim=-1)
