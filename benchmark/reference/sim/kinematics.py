"""Forward kinematics: reduced coords -> maximal coords (PyTorch),
counterpart of ``ppr_diffphys_tpu/sim/kinematics.py``.

Batched over arbitrary leading dims. Per-joint local transforms and joint
rates are computed for all bodies at once; only the parent composition
walks the tree, one depth level at a time.

State conventions (identical to the integrator):
- ``body_q``  (..., B, 7): world transform of the body origin, quat xyzw;
- ``body_qd`` (..., B, 6): warp layout [angular(world), linear(world, at the
  body COM)].

Generalized coordinates:
- ``joint_q``  (..., n_q): root [x,y,z,qx,qy,qz,qw] then per-joint angles;
- ``joint_qd`` (..., n_qd): root [wx,wy,wz,vx,vy,vz] then joint rates.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import (
    compound_to_quat,
    cross,
    quat_from_axis_angle,
    quat_identity,
    quat_mul,
    quat_normalize,
    quat_rotate,
    transform_mul,
    transform_point,
)
from .integrator import _const as _cached
from .builder import (
    ArticulationModel,
    JOINT_COMPOUND,
    JOINT_FREE,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
)


def _const(x, like, dtype=None):
    t = _cached(x, np.float32, like.device)
    return t.to(dtype or like.dtype)


def _idx(x, like):
    return _cached(x, np.int64, like.device)


def _mask(model, jtype, like):
    return _const((model.joint_type == jtype).astype(np.float32), like)[:, None]


def _local_joint_quats(model: ArticulationModel, joint_q: torch.Tensor):
    """Local joint rotations (..., B, 4) + prismatic offsets (..., B, 3)."""
    batch = joint_q.shape[:-1]
    B = model.n_links
    jt = model.joint_type

    q_idx = np.clip(
        model.joint_q_start[:, None] + np.arange(3)[None, :], 0, model.n_q - 1
    )
    ang3 = joint_q[..., _idx(q_idx, joint_q)]  # (..., B, 3)
    axis = _const(model.joint_axis, joint_q)  # (B, 3)

    q_rev = quat_from_axis_angle(axis, ang3[..., 0])  # (..., B, 4)
    m_rev = _mask(model, JOINT_REVOLUTE, joint_q)
    q_local = quat_identity((B,), joint_q.dtype, joint_q.device)
    q_local = q_rev * m_rev + q_local * (1.0 - m_rev)

    if (jt == JOINT_COMPOUND).any():
        q_off = _const(model.joint_X_c[:, 3:7], joint_q)  # (B, 4)
        q_off_inv = q_off * _const([-1.0, -1, -1, 1], joint_q)
        q_cmp = quat_mul(q_off, quat_mul(compound_to_quat(ang3), q_off_inv))
        m_cmp = _mask(model, JOINT_COMPOUND, joint_q)
        q_local = q_cmp * m_cmp + q_local * (1.0 - m_cmp)

    p_local = torch.zeros(batch + (B, 3), dtype=joint_q.dtype, device=joint_q.device)
    if (jt == JOINT_PRISMATIC).any():
        m_pri = _mask(model, JOINT_PRISMATIC, joint_q)
        p_local = axis * ang3[..., 0:1] * m_pri

    return q_local, p_local


def _local_joint_rates(model: ArticulationModel, joint_q, joint_qd):
    """Relative angular velocity of each joint in its parent-joint frame
    (..., B, 3); compound joints use the instantaneous intrinsic-XYZ axes."""
    batch = joint_q.shape[:-1]
    B = model.n_links
    jt = model.joint_type

    q_idx = np.clip(
        model.joint_q_start[:, None] + np.arange(3)[None, :], 0, model.n_q - 1
    )
    qd_idx = np.clip(
        model.joint_qd_start[:, None] + np.arange(3)[None, :], 0, model.n_qd - 1
    )
    ang3 = joint_q[..., _idx(q_idx, joint_q)]
    rate3 = joint_qd[..., _idx(qd_idx, joint_q)]
    axis = _const(model.joint_axis, joint_q)

    w_local = torch.zeros(batch + (B, 3), dtype=joint_q.dtype, device=joint_q.device)
    m_rev = _mask(model, JOINT_REVOLUTE, joint_q)
    w_local = w_local + axis * rate3[..., 0:1] * m_rev

    if (jt == JOINT_COMPOUND).any():
        a, b = ang3[..., 0], ang3[..., 1]
        ex = _const([1.0, 0, 0], joint_q).expand(batch + (B, 3))
        q0 = quat_from_axis_angle(ex, a)
        ax1 = quat_rotate(q0, _const([0.0, 1.0, 0.0], joint_q))
        q1 = quat_from_axis_angle(ax1, b)
        ax2 = quat_rotate(quat_mul(q1, q0), _const([0.0, 0.0, 1.0], joint_q))
        w_cmp = ex * rate3[..., 0:1] + ax1 * rate3[..., 1:2] + ax2 * rate3[..., 2:3]
        q_off = _const(model.joint_X_c[:, 3:7], joint_q)
        w_cmp = quat_rotate(q_off.expand(batch + (B, 4)), w_cmp)
        m_cmp = _mask(model, JOINT_COMPOUND, joint_q)
        w_local = w_local + w_cmp * m_cmp

    return w_local


def eval_fk(
    model: ArticulationModel,
    joint_q: torch.Tensor,
    joint_qd: Optional[torch.Tensor] = None,
    joint_X_p: Optional[torch.Tensor] = None,
    body_com: Optional[torch.Tensor] = None,
):
    """Maximal-coordinate body states from generalized coordinates.

    Args:
      joint_q: (..., n_q)
      joint_qd: (..., n_qd) or None (velocities all zero)
      joint_X_p: optional override of per-joint parent anchor transforms,
        (B, 7) or batch-broadcastable (..., B, 7)
      body_com: optional override of body COM (B, 3)
    Returns:
      body_q (..., B, 7), body_qd (..., B, 6)
    """
    batch = joint_q.shape[:-1]
    if joint_qd is None:
        joint_qd = torch.zeros(
            batch + (model.n_qd,), dtype=joint_q.dtype, device=joint_q.device
        )

    X_p_all = _const(model.joint_X_p, joint_q) if joint_X_p is None else joint_X_p
    if X_p_all.shape[:-2] != batch:  # (B,7) or a broadcastable (..., B, 7)
        X_p_all = X_p_all.expand(batch + X_p_all.shape[-2:])
    com_all = _const(model.body_com, joint_q) if body_com is None else body_com

    q_local, p_local = _local_joint_quats(model, joint_q)
    w_rate = _local_joint_rates(model, joint_q, joint_qd)
    p_local = p_local.expand(q_local.shape[:-1] + (3,))
    X_jc_all = torch.cat([p_local, q_local], -1)  # (..., B, 7)

    # tree levels: all bodies at one depth compose together
    parent = model.joint_parent
    depth = np.zeros(model.n_links, np.int32)
    for i in range(model.n_links):
        depth[i] = 0 if parent[i] < 0 else depth[parent[i]] + 1
    levels = [np.nonzero(depth == d)[0] for d in range(depth.max() + 1)]

    zeros3 = torch.zeros(batch + (3,), dtype=joint_q.dtype, device=joint_q.device)

    order = np.concatenate([np.asarray(l, np.int64) for l in levels])
    pos_in_order = np.zeros(model.n_links, np.int64)
    pos_in_order[order] = np.arange(model.n_links)

    root_q, root_w, root_v = [], [], []
    for i in levels[0]:
        i = int(i)
        jtype = int(model.joint_type[i])
        qs = int(model.joint_q_start[i])
        qds = int(model.joint_qd_start[i])
        X_pj = X_p_all[..., i, :]
        if jtype == JOINT_FREE:
            xq = joint_q[..., qs : qs + 7]
            xq = torch.cat([xq[..., 0:3], quat_normalize(xq[..., 3:7])], -1)
            root_q.append(transform_mul(X_pj, xq))
            root_w.append(joint_qd[..., qds : qds + 3])
            root_v.append(joint_qd[..., qds + 3 : qds + 6])
        else:
            root_q.append(transform_mul(X_pj, X_jc_all[..., i, :]))
            root_w.append(zeros3)
            root_v.append(zeros3)
    done_q = torch.stack(root_q, dim=-2)  # (..., L0, 7)
    done_w = torch.stack(root_w, dim=-2)
    done_v = torch.stack(root_v, dim=-2)

    for level in levels[1:]:
        lvl = _idx(level, joint_q)
        par = parent[np.asarray(level)]
        par_pos = _idx(pos_in_order[par], joint_q)
        pq = done_q[..., par_pos, :]  # (..., L, 7)
        pw = done_w[..., par_pos, :]
        pv = done_v[..., par_pos, :]
        com_p_w = transform_point(pq, com_all[_idx(par, joint_q)])

        X_wj = transform_mul(pq, X_p_all[..., lvl, :])
        X_wc = transform_mul(X_wj, X_jc_all[..., lvl, :])
        w_rel = quat_rotate(X_wj[..., 3:7], w_rate[..., lvl, :])

        w_c = pw + w_rel
        com_c_w = transform_point(X_wc, com_all[lvl])
        v_c = (
            pv
            + cross(pw, com_c_w - com_p_w)
            + cross(w_rel, com_c_w - X_wj[..., 0:3])
        )
        done_q = torch.cat([done_q, X_wc], dim=-2)
        done_w = torch.cat([done_w, w_c], dim=-2)
        done_v = torch.cat([done_v, v_c], dim=-2)

    pos = _idx(pos_in_order, joint_q)
    body_q = done_q[..., pos, :]
    body_qd = torch.cat([done_w[..., pos, :], done_v[..., pos, :]], dim=-1)
    return body_q, body_qd
