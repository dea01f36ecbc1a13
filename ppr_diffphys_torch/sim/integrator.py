"""Semi-implicit (symplectic) Euler integrator in plain PyTorch, counterpart
of ``ppr_diffphys_tpu/sim/integrator.py`` (forward only).

This is the **plain version** of the port's kernels: ``rollout`` of the
serving window (``csrc/soa_window.cu``, wrapped by ``sim/soa.py``),
``rollout_substeps`` of the bench rollout (``csrc/soa_rollout.cu``, also
wrapped there) and ``interval`` of the training interval pair
(``csrc/soa_interval.cu``, wrapped by ``sim/soa_grad.py``; its gradients
are autograd's). CPU tensors
run through it, and on the card it is what the kernels are checked against.
Quantities are batched over (env E, body B); gathers are plain indexing and
the contact/parent scatters are ``index_add_``. Every function is
differentiable end to end with autograd.

Numerical-safety clamps of the reference are kept: body velocity ±10,
contact force ±500, compound torque/attach ±10000, 0.1/s angular damping,
and a safe Coulomb-friction direction (|vt| floored by 1e-12 under the
square root).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import (
    cross,
    kernel_math,
    quat_from_axis_angle,
    quat_inverse,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_rotate_inv,
    quat_to_axis_angle,
    quat_to_compound,
    transform_mul,
    transform_point,
)
from .builder import (
    ArticulationModel,
    JOINT_COMPOUND,
    JOINT_FIXED,
    JOINT_REVOLUTE,
)


class SimState(NamedTuple):
    """Maximal-coordinate state, batched over envs."""

    body_q: torch.Tensor  # (E, B, 7) world transform of body origin, quat xyzw
    body_qd: torch.Tensor  # (E, B, 6) [angular(world), linear(world @ COM)]


class SimParams(NamedTuple):
    """Simulation parameters the caller supplies per call: per-body mass and
    inertia, per-dof PD gains — shared ((B,), (n_qd,)) or per-env ((E, B),
    (E, n_qd), (E, B, 3, 3))."""

    body_mass: torch.Tensor  # (B,)
    body_inv_mass: torch.Tensor  # (B,)
    body_inertia: torch.Tensor  # (B, 3, 3) body-frame, about COM
    body_inv_inertia: torch.Tensor  # (B, 3, 3)
    joint_target_ke: torch.Tensor  # (n_qd,)
    joint_target_kd: torch.Tensor  # (n_qd,)
    joint_X_p: Optional[torch.Tensor] = None  # (B, 7) override or None
    body_com: Optional[torch.Tensor] = None  # (B, 3) override or None


def _f32(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _i64(x, device):
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def default_sim_params(model: ArticulationModel, device="cpu") -> SimParams:
    inertia = _f32(model.body_inertia, device)
    return SimParams(
        body_mass=_f32(model.body_mass, device),
        body_inv_mass=1.0 / _f32(model.body_mass, device),
        body_inertia=inertia,
        body_inv_inertia=torch.linalg.inv(inertia),
        joint_target_ke=_f32(model.joint_target_ke, device),
        joint_target_kd=_f32(model.joint_target_kd, device),
    )


def dof_index(model) -> np.ndarray:
    """(B, 3) dof read by each joint's up-to-3 angles (clipped)."""
    return np.clip(
        model.joint_qd_start[:, None] + np.arange(3)[None, :], 0, model.n_qd - 1
    )


# ---------------------------------------------------------------------------
# force evaluation
# ---------------------------------------------------------------------------

def _eval_joint_force(q, qd, target, ke, kd, act, lo, hi, limit_ke, limit_kd):
    """Scalar PD + limit law (reference integrator_euler.py:261-286)."""
    zero = torch.zeros_like(q)
    below = q < lo
    above = q > hi
    limit_f = torch.where(
        below, limit_ke * (lo - q) - limit_kd * torch.clamp(qd, max=0.0), zero
    )
    limit_f = torch.where(
        above, limit_ke * (hi - q) - limit_kd * torch.clamp(qd, min=0.0), limit_f
    )
    return ke * (q - target) + kd * qd + act - limit_f


def eval_body_contacts(model: ArticulationModel, params: SimParams, state: SimState):
    """Penalty ground contact over (E, C), summed onto bodies with the
    *minus* sign of the reference's atomic_sub. Returns (E, B, 6)
    [torque, force]."""
    dev = state.body_q.device
    cbody = _i64(model.contact_body, dev)
    cpoint = _f32(model.contact_point, dev)  # (C, 3)
    cdist = _f32(model.contact_dist, dev)  # (C,)
    cmat = _f32(model.contact_material, dev)  # (C, 4) ke kd kf mu
    com = params.body_com if params.body_com is not None else _f32(model.body_com, dev)

    X = state.body_q[:, cbody]  # (E, C, 7)
    wv = state.body_qd[:, cbody]
    w = wv[..., 0:3]
    v = wv[..., 3:6]

    n = _f32([0.0, 1.0, 0.0], dev)
    cp = transform_point(X, cpoint) - n * cdist[..., None]
    r = cp - transform_point(X, com[cbody])
    dpdt = v + cross(w, r)

    c = cp[..., 1]
    active = (c < 0.0).to(cp.dtype)[..., None]

    ke, kd, kf, mu = cmat[..., 0], cmat[..., 1], cmat[..., 2], cmat[..., 3]
    vn = dpdt[..., 1]
    vt = dpdt - n * vn[..., None]

    fn = c * ke
    fd = torch.clamp(vn, max=0.0) * kd

    vt_len = torch.sqrt(torch.sum(vt * vt, -1) + 1e-12)
    ft_mag = torch.minimum(kf * vt_len, -mu * (fn + fd))
    ft = vt / vt_len[..., None] * ft_mag[..., None]

    f_total = (n * (fn + fd)[..., None] + ft) * active
    f_total = torch.clamp(f_total, -500.0, 500.0)
    t_total = cross(r, f_total)

    tf = -torch.cat([t_total, f_total], dim=-1)  # atomic_sub sign
    E = state.body_q.shape[0]
    out = torch.zeros((E, model.n_links, 6), dtype=tf.dtype, device=dev)
    return out.index_add_(1, cbody, tf)


def eval_body_joints(model: ArticulationModel, params: SimParams, state: SimState,
                     joint_target: torch.Tensor,
                     joint_act: Optional[torch.Tensor], gains3=None, rp_local=None):
    """Joint PD + limit + attachment-spring forces over (E, B). Joint i
    connects parent[i] -> body i; FREE roots contribute nothing.

    joint_target/joint_act: (E, n_qd); joint_act None means zero.
    gains3: optional (ke, kd) per joint angle, (B, 3) or (E, B, 3), in place
    of ``params.joint_target_ke/kd`` (the kernels' gains plane layout).
    rp_local: optional (B, 3) or (E, B, 3) anchor arm from the parent's COM
    (the interval kernels' ``rp_local`` plane); the parent arm is then
    ``quat_rotate(parent rotation, rp_local)`` instead of the anchor's world
    point less the parent's world COM.
    Returns (E, B, 6) accumulated [torque, force]."""
    dev = state.body_q.device
    E, B = state.body_q.shape[0], model.n_links
    jt = model.joint_type
    parent = model.joint_parent
    com = params.body_com if params.body_com is not None else _f32(model.body_com, dev)
    X_p_all = params.joint_X_p if params.joint_X_p is not None else _f32(model.joint_X_p, dev)

    parent_safe = np.where(parent >= 0, parent, 0)
    ps = _i64(parent_safe, dev)
    has_parent = _f32((parent >= 0).astype(np.float32), dev)[None, :, None]

    pq = state.body_q[:, ps]
    pqd = state.body_qd[:, ps]

    X_p_b = X_p_all if X_p_all.ndim == 3 else X_p_all[None, :, :]
    X_wp = transform_mul(pq, X_p_b)
    # bodies with no parent: X_wp = X_pj alone
    X_wp = has_parent * X_wp + (1.0 - has_parent) * X_p_b.expand(E, B, 7)

    if rp_local is None:
        com_p = com[ps]
        r_p = X_wp[..., 0:3] - transform_point(pq, com_p)
    else:
        r_p = quat_rotate(pq[..., 3:7], rp_local if rp_local.ndim == 3 else rp_local[None])
    r_p = r_p * has_parent
    w_p = pqd[..., 0:3] * has_parent
    v_p = pqd[..., 3:6] * has_parent

    X_wc = state.body_q
    r_c = X_wc[..., 0:3] - transform_point(state.body_q, com)
    w_c = state.body_qd[..., 0:3]
    v_c = state.body_qd[..., 3:6]

    x_err = X_wc[..., 0:3] - X_wp[..., 0:3]
    q_p = X_wp[..., 3:7]
    q_c = X_wc[..., 3:7]
    r_err = quat_mul(quat_inverse(q_p), q_c)
    v_err = v_c - v_p
    w_err = w_c - w_p

    attach_ke = model.joint_attach_ke
    attach_kd = model.joint_attach_kd
    ang_damp = 0.01  # angular_damping_scale (reference :379)

    dof_np = dof_index(model)
    didx = _i64(dof_np, dev)  # (B, 3)
    tgt = joint_target[:, didx]  # (E, B, 3)
    act = joint_act[:, didx] if joint_act is not None else torch.zeros_like(tgt)
    # gains may be (n_qd,) shared or (E, n_qd) per-env
    if gains3 is None:
        ke3 = params.joint_target_ke[..., didx]  # (B,3) or (E,B,3)
        kd3 = params.joint_target_kd[..., didx]
    else:
        ke3, kd3 = gains3
    lo3 = _f32(model.joint_limit_lower[dof_np], dev)
    hi3 = _f32(model.joint_limit_upper[dof_np], dev)
    lke3 = _f32(model.joint_limit_ke[dof_np], dev)
    lkd3 = _f32(model.joint_limit_kd[dof_np], dev)

    t_total = torch.zeros((E, B, 3), dtype=torch.float32, device=dev)
    f_total = torch.zeros((E, B, 3), dtype=torch.float32, device=dev)

    def mask(jtype):
        return _f32((jt == jtype).astype(np.float32), dev)[None, :, None]

    def force(k, q_ang, qd_ang):
        return _eval_joint_force(
            q_ang, qd_ang, tgt[..., k], ke3[..., k], kd3[..., k], act[..., k],
            lo3[:, k], hi3[:, k], lke3[:, k], lkd3[:, k],
        )

    # ---- FIXED (Taylor-safe axis-angle)
    if (jt == JOINT_FIXED).any():
        ang_err = quat_to_axis_angle(r_err)
        f_fix = x_err * attach_ke + v_err * attach_kd
        t_fix = quat_rotate(q_p, ang_err) * attach_ke + w_err * attach_kd * ang_damp
        f_total = f_total + mask(JOINT_FIXED) * f_fix
        t_total = t_total + mask(JOINT_FIXED) * t_fix

    # ---- REVOLUTE (swing-twist angle, atan2 form)
    if (jt == JOINT_REVOLUTE).any():
        axis = _f32(model.joint_axis, dev)  # (B, 3)
        axis_p = quat_rotate(q_p, axis[None])
        axis_c = quat_rotate(q_c, axis[None])
        s_tw = torch.sum(r_err[..., :3] * axis[None], -1)
        q_ang = 2.0 * kernel_math.atan2(s_tw, r_err[..., 3])
        qd_ang = torch.sum(w_err * axis_p, -1)
        fmag = force(0, q_ang, qd_ang)
        t_rev = fmag[..., None] * axis_p
        swing_err = cross(axis_p, axis_c)
        f_rev = x_err * attach_ke + v_err * attach_kd
        t_rev = t_rev + swing_err * attach_ke + (
            w_err - qd_ang[..., None] * axis_p
        ) * attach_kd * ang_damp
        f_total = f_total + mask(JOINT_REVOLUTE) * f_rev
        t_total = t_total + mask(JOINT_REVOLUTE) * t_rev

    # ---- COMPOUND (intrinsic-XYZ split, ±10000 clamps)
    if (jt == JOINT_COMPOUND).any():
        q_off = _f32(model.joint_X_c, dev)[None, :, 3:7]  # (1, B, 4)
        q_pc = quat_mul(
            quat_mul(quat_inverse(q_off), quat_mul(quat_inverse(q_p), q_c)), q_off
        )
        angles = quat_to_compound(q_pc)  # (E, B, 3)

        ex = _f32([1.0, 0.0, 0.0], dev).expand(angles.shape)
        q0 = quat_from_axis_angle(ex, angles[..., 0])
        ax1 = quat_rotate(q0, _f32([0.0, 1.0, 0.0], dev))
        q1 = quat_from_axis_angle(ax1, angles[..., 1])
        ax2 = quat_rotate(quat_mul(q1, q0), _f32([0.0, 0.0, 1.0], dev))

        q_w = quat_mul(q_p, q_off)
        t_cmp = torch.zeros_like(t_total)
        for k, ax in enumerate([ex, ax1, ax2]):
            ax_w = quat_rotate(q_w, ax)
            fmag = force(k, angles[..., k], torch.sum(ax_w * w_err, -1))
            t_cmp = t_cmp + fmag[..., None] * ax_w
        t_cmp = torch.clamp(t_cmp, -10000.0, 10000.0)
        f_cmp = torch.clamp(x_err * attach_ke + v_err * attach_kd, -10000.0, 10000.0)
        f_total = f_total + mask(JOINT_COMPOUND) * f_cmp
        t_total = t_total + mask(JOINT_COMPOUND) * t_cmp

    # ---- scatter to bodies: child -= (t + r_c x f, f); parent += (t + r_p x f, f)
    child_tf = -torch.cat([t_total + cross(r_c, f_total), f_total], -1)
    parent_tf = torch.cat([t_total + cross(r_p, f_total), f_total], -1)
    has = np.nonzero(parent >= 0)[0]
    return child_tf.index_add_(
        1, _i64(parent[has], dev), parent_tf[:, _i64(has, dev)]
    )


def integrate_bodies(model: ArticulationModel, params: SimParams, state: SimState,
                     body_f: torch.Tensor, dt: float) -> SimState:
    """Symplectic Euler update (reference integrator_euler.py:21-91)."""
    dev = state.body_q.device
    com = params.body_com if params.body_com is not None else _f32(model.body_com, dev)
    x0 = state.body_q[..., 0:3]
    r0 = state.body_q[..., 3:7]
    w0 = state.body_qd[..., 0:3]
    v0 = state.body_qd[..., 3:6]
    t0 = body_f[..., 0:3]
    f0 = body_f[..., 3:6]

    # (B,) shared or (E, B) per-env
    inv_m = params.body_inv_mass[..., None]
    if inv_m.ndim == 2:
        inv_m = inv_m[None]
    gravity = _f32(model.gravity, dev)

    x_com = x0 + quat_rotate(r0, com[None])

    # linear part (gravity gated on finite mass)
    v1 = v0 + (f0 * inv_m + gravity * torch.sign(inv_m)) * dt
    x1 = x_com + v1 * dt

    def _matvec33(M, x):  # (B,3,3) or (E,B,3,3) @ (E,B,3) -> (E,B,3)
        if M.ndim == 3:
            M = M[None]
        return torch.sum(M * x[:, :, None, :], dim=-1)

    # angular part in the body frame with the gyroscopic term
    wb = quat_rotate_inv(r0, w0)
    tb = quat_rotate_inv(r0, t0) - cross(wb, _matvec33(params.body_inertia, wb))
    w1 = quat_rotate(r0, wb + _matvec33(params.body_inv_inertia, tb) * dt)
    # dr = 0.5*dt * quat(w1, 0) * r0 with the pre-damping w1
    w1_quat = torch.cat([w1, torch.zeros_like(w1[..., :1])], -1)
    r1 = quat_normalize(r0 + 0.5 * dt * quat_mul(w1_quat, r0))

    w1 = w1 * (1.0 - 0.1 * dt)
    w1 = torch.clamp(w1, -10.0, 10.0)
    v1 = torch.clamp(v1, -10.0, 10.0)

    body_q_new = torch.cat([x1 - quat_rotate(r1, com[None]), r1], -1)
    body_qd_new = torch.cat([w1, v1], -1)
    return SimState(body_q_new, body_qd_new)


# ---------------------------------------------------------------------------
# the step + rollout
# ---------------------------------------------------------------------------

class SemiImplicitIntegrator:
    """Named counterpart of the reference integrator class
    (integrator_euler.py:553-620)."""

    def __init__(self, model: ArticulationModel):
        self.model = model

    def compute_forces(self, params, state, joint_target, joint_act, res_f,
                       gains3=None, rp_local=None):
        """Returns (body_f, grf, jaf): grf is the accumulated force after
        contacts (incl. residual forces), jaf the joint-only increment."""
        model = self.model
        body_f = res_f
        if body_f is None:
            body_f = torch.zeros_like(state.body_qd)
        if model.contact_count > 0 and model.ground:
            body_f = body_f + eval_body_contacts(model, params, state)
        grf = body_f
        body_f = body_f + eval_body_joints(model, params, state, joint_target, joint_act,
                                           gains3, rp_local)
        jaf = body_f - grf
        return body_f, grf, jaf

    def simulate(self, params, state, joint_target, joint_act, res_f, dt):
        """One substep: forces + integration, with the observables."""
        body_f, grf, jaf = self.compute_forces(
            params, state, joint_target, joint_act, res_f
        )
        return integrate_bodies(self.model, params, state, body_f, dt), grf, jaf

    def step_only(self, params, state, joint_target, joint_act, res_f, dt, gains3=None,
                  rp_local=None):
        """Substep without observables."""
        body_f, _, _ = self.compute_forces(
            params, state, joint_target, joint_act, res_f, gains3, rp_local
        )
        return integrate_bodies(self.model, params, state, body_f, dt)


def rollout(
    integrator: SemiImplicitIntegrator,
    params: SimParams,
    state0: SimState,
    joint_targets: torch.Tensor,  # (S, E, n_qd)
    joint_acts: Optional[torch.Tensor],  # (S, E, n_qd) or None (zero)
    res_f: Optional[torch.Tensor],  # (S, E, B, 6) warp layout or None (zero)
    dt: float,
    substeps_per_frame: int,
):
    """Simulate S = substeps_per_frame*(F-1)+1 substeps, collecting state and
    force observables at the F frame boundaries: the state entering each
    interval and the grf/jaf of that interval's first substep; the final row
    applies the last substep's inputs to the final state (which is kept).

    Returns (body_q (F,E,B,7), body_qd (F,E,B,6), grf (F,E,B,6), jaf (F,E,B,6)).
    """
    S = joint_targets.shape[0]
    sub = substeps_per_frame
    n_intervals = (S - 1) // sub
    if S != n_intervals * sub + 1:
        raise ValueError("joint_targets has %d rows, not sub*(F-1)+1 (sub=%d)" % (S, sub))
    act = (lambda i: None) if joint_acts is None else (lambda i: joint_acts[i])
    res = (lambda i: None) if res_f is None else (lambda i: res_f[i])

    qs, qds, grfs, jafs = [], [], [], []
    state = state0
    for f in range(n_intervals):
        s0 = f * sub
        qs.append(state.body_q)
        qds.append(state.body_qd)
        state, grf, jaf = integrator.simulate(
            params, state, joint_targets[s0], act(s0), res(s0), dt
        )
        grfs.append(grf)
        jafs.append(jaf)
        for i in range(s0 + 1, s0 + sub):
            state = integrator.step_only(
                params, state, joint_targets[i], act(i), res(i), dt
            )
    _, grf_l, jaf_l = integrator.simulate(
        params, state, joint_targets[-1], act(S - 1), res(S - 1), dt
    )
    qs.append(state.body_q)
    qds.append(state.body_qd)
    grfs.append(grf_l)
    jafs.append(jaf_l)
    return (torch.stack(qs, 0), torch.stack(qds, 0),
            torch.stack(grfs, 0), torch.stack(jafs, 0))


def rollout_substeps(integrator: SemiImplicitIntegrator, params: SimParams,
                     state0: SimState, joint_targets: torch.Tensor,
                     joint_acts: Optional[torch.Tensor], dt: float) -> SimState:
    """S = len(joint_targets) substeps with zero residual forces, final state
    only: the plain version of ``csrc/soa_rollout.cu`` (the bench rollout,
    ``sim/soa.py:SoaRollout``), the loop ``tests/test_pallas.py`` holds the
    TPU kernel against. joint_targets/joint_acts (S,E,n_qd), acts may be
    None (zero)."""
    state = state0
    for i in range(joint_targets.shape[0]):
        state = integrator.step_only(
            params, state, joint_targets[i], None if joint_acts is None else joint_acts[i],
            None, dt)
    return state


def _plane_aos(p, E: int):
    """A (k,B,L) plane as (E,B,k) per-env or (B,k) shared."""
    return p.permute(2, 1, 0) if p.shape[-1] == E and E > 1 else p[..., 0].T


def plane_params(gains, inv_m, inertia, inv_inertia, E: int, xp_t=None, xp_q=None):
    """The traced parameter planes (``sim/soa.py:traced_planes`` layout,
    lane 1 shared or lane E per-env) as the arguments the plain substep
    takes: (SimParams with inverse mass and inertias, (ke, kd) per joint
    angle). With the anchor planes xp_t and xp_q the SimParams carry
    ``joint_X_p`` (B,7) or (E,B,7). Differentiable."""
    def per_env(p):
        return p.shape[-1] == E and E > 1

    if per_env(gains):  # (2,3,B,E) -> (E,B,3)
        ke3, kd3 = gains[0].permute(2, 1, 0), gains[1].permute(2, 1, 0)
    else:
        ke3, kd3 = gains[0, ..., 0].T, gains[1, ..., 0].T
    im = inv_m.T if per_env(inv_m) else inv_m[:, 0]

    def mat(p):  # (3,3,B,L) -> (E,B,3,3) | (B,3,3)
        return p.permute(3, 2, 0, 1) if per_env(p) else p[..., 0].permute(2, 0, 1)

    xp = None if xp_t is None else torch.cat([_plane_aos(xp_t, E), _plane_aos(xp_q, E)], -1)
    params = SimParams(
        body_mass=None, body_inv_mass=im, body_inertia=mat(inertia),
        body_inv_inertia=mat(inv_inertia), joint_target_ke=None, joint_target_kd=None,
        joint_X_p=xp,
    )
    return params, (ke3, kd3)


def interval(integrator: SemiImplicitIntegrator, dt: float, bq, bqd, tgt, act, res,
             gains, inv_m, inertia, inv_inertia, xp_t=None, xp_q=None, rp_local=None,
             export: bool = False):
    """One frame interval of S substeps in the kernels' plane layout: the
    plain version of ``csrc/soa_interval.cu`` (K2 forward; autograd through
    it is K3's plain version).

    bq (7,B,E), bqd (6,B,E), tgt (S,n_qd,E), act (S,n_qd,E) or None (zero),
    res (S,6,B,E) [torque, force] or None (zero), the four parameter
    planes and, for live joint anchors (the kernels' ``with_xp``), the three
    anchor planes xp_t, xp_q, rp_local. Returns (bq', bqd'); with
    ``export``, also the state entering each substep, detached, in K2's
    export layout (S,E,13,B): q then qd, each [k][b]."""
    E = bq.shape[-1]
    params, gains3 = plane_params(gains, inv_m, inertia, inv_inertia, E, xp_t, xp_q)
    rpl = None if rp_local is None else _plane_aos(rp_local, E)
    state = SimState(bq.permute(2, 1, 0), bqd.permute(2, 1, 0))
    entries = []
    for i in range(tgt.shape[0]):
        if export:
            entries.append(torch.cat([state.body_q, state.body_qd], -1).detach().transpose(1, 2))
        state = integrator.step_only(
            params, state, tgt[i].T,
            None if act is None else act[i].T,
            None if res is None else res[i].permute(2, 1, 0),
            dt, gains3, rpl,
        )
    out = state.body_q.permute(2, 1, 0), state.body_qd.permute(2, 1, 0)
    return out + (torch.stack(entries, 0).contiguous(),) if export else out
