"""The differentiable training rollout: frame intervals on the CUDA interval
kernels, counterpart of ``ppr_diffphys_tpu/sim/pallas_soa_grad.py``
(``make_diff_interval``, ``rollout_soa``).

- :func:`make_diff_interval` returns a :class:`DiffInterval`:
  ``interval(bq, bqd, tgt, act, res, *planes) -> (bq', bqd')`` in the plane
  layout (env innermost), differentiable in every input. CPU tensors run
  the plain version (``integrator.interval``, autograd); CUDA tensors run
  ``csrc/soa_interval.cu`` under one ``torch.autograd.Function``: the
  forward kernel K2 (which exports the state entering each substep when a
  gradient is needed) and the backward kernel K3 (the substep adjoint) plus
  its fixed-order env reduction for shared planes. It never falls back.
  ``with_xp=True`` adds the three live joint-anchor planes (``XP_NAMES``:
  ``xp_t``, ``xp_q``, ``rp_local``) as inputs with gradients, the lab4d
  coupling's per-env ``joint_X_p``.
- :func:`rollout_soa` chains the intervals of a window, with the
  frame-boundary observables from the plain force pipeline under
  ``torch.no_grad()`` when the caller asks for them. A live
  ``params.joint_X_p`` goes through the anchor planes (the interval must
  be built ``with_xp``); a live ``params.body_com`` raises, as no kernel
  takes a COM plane.

The TPU package's VMEM planners (residuals modes, ``plan_chunks``,
``pick_e_tile``, ``make_diff_chain``'s chunking) only size TPU memory and
have no counterpart: K2 always exports the per-substep states and K3 reads
them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..csrc import build as kbuild
from ..utils import spans
from .integrator import SemiImplicitIntegrator, SimParams, SimState, interval
from .soa import (TRACED_NAMES, XP_NAMES, check_device, envs_per_cta, per_env, ptr, sim_args,
                  traced_planes, warp_consts, window_work)

KERNEL = "soa_interval"
KERNEL_FWD, KERNEL_BWD, KERNEL_REDUCE = (
    "soa_interval_fwd", "soa_interval_bwd", "soa_interval_reduce")
# rows per body of each traced plane, in the kernel's gradient layout
PLANE_ROWS = dict(gains=6, inv_m=1, inertia=9, inv_inertia=9, xp_t=3, xp_q=4, rp_local=3)
REDUCE_WARPS_PER_CTA = 8  # the env reduction: one warp per plane row


def _kernel_lib():
    """The built soa_interval library with its C signatures declared."""
    lib = kbuild.load(KERNEL)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    consts = [P] * 4  # body_i body_f cbody cf
    lists = [P] * 3 + [I]  # adj_off adj c_off, len(adj)
    # gains inv_m inertia inv_inertia, each with its per-env flag; the anchor
    # planes xp_t xp_q rp_local (null: body_f's) and their per-env flag
    planes = [P, I] * 4 + [P] * 3 + [I]
    # E B n_qd C S; dt ang_decay g attach; envs per CTA, stream
    tail = [I] * 5 + [Fl] * 7 + [I, P]
    lib.soa_interval_plane_rows.argtypes = [I]
    lib.soa_interval_plane_rows.restype = I
    lib.soa_interval_max_bodies.argtypes = []
    lib.soa_interval_max_bodies.restype = I
    lib.soa_interval_fwd_launch.argtypes = (  # bq0 bqd0 tgt act res | out_q out_qd sstate
        [P] * 5 + consts + lists + planes + [P] * 3 + tail)
    lib.soa_interval_fwd_launch.restype = I
    lib.soa_interval_bwd_launch.argtypes = (
        [P] * 4 + consts + lists + planes + [P] * 8 + tail)  # sstate tgt act res | dq dqd dbq0 dbqd0 dtgt dact dres dplanes
    lib.soa_interval_bwd_launch.restype = I
    lib.soa_interval_reduce_launch.argtypes = [P, P, I, I, I, P]
    lib.soa_interval_reduce_launch.restype = I
    return lib


class _IntervalFn(torch.autograd.Function):
    """K2 forward, K3 backward (pallas_soa_grad.py:537-565 custom_vjp)."""

    @staticmethod
    def forward(ctx, runner, bq, bqd, tgt, act, res, *planes):
        export = any(ctx.needs_input_grad[1:])
        q, qd, sstate = runner._forward(bq, bqd, tgt, act, res, planes, export)
        ctx.runner = runner
        if export:
            ctx.save_for_backward(sstate, tgt, act, res, *planes)
        return q, qd

    @staticmethod
    def backward(ctx, dq, dqd):
        sstate, tgt, act, res, *planes = ctx.saved_tensors
        E, B = sstate.shape[1], sstate.shape[3]
        with spans.span("backward.interval"):
            if dq is None:
                dq = sstate.new_zeros((7, B, E))
            if dqd is None:
                dqd = sstate.new_zeros((6, B, E))
            dbq, dbqd, dtgt, dact, dres, dplanes = ctx.runner._backward(
                sstate, tgt, act, res, planes, dq, dqd)
        return (None, dbq, dbqd, dtgt, dact, dres, *dplanes)


class DiffInterval:
    """A differentiable frame interval of ``substeps`` substeps
    (pallas_soa_grad.py:90-572 make_diff_interval).

    ``interval(bq (7,B,E), bqd (6,B,E), tgt (S,n_qd,E), act (S,n_qd,E),
    res (S,6,B,E), gains, inv_m, inertia, inv_inertia[, xp_t, xp_q,
    rp_local]) -> (bq', bqd')``: the anchor planes exactly when
    ``with_xp``. ``with_act=False`` / ``with_res=False`` (the training
    default, as the reference multiplies torques and residual forces by 0)
    treat act / res as zero and give them no gradient. Kernel launches are
    counted in ``self.launches``; while the profiler records, each call is
    the span ``rollout.interval`` and K3 counts the (env, substep, contact)
    triples it processes (``k3.contact_triples``) and those that penetrate
    (``k3.active_contacts``). With ``count_sink`` set (a
    :class:`ContactCounts`), K3 adds both counts there instead, whether the
    profiler records or not: a captured CUDA graph replays that sum
    (``models/step_graph.py``)."""

    def __init__(self, integrator: SemiImplicitIntegrator, dt: float, substeps: int,
                 with_res: bool = False, with_act: bool = False, with_xp: bool = False):
        self.integrator = integrator
        self.model = integrator.model
        self.dt = float(dt)
        self.S = int(substeps)
        self.with_res = bool(with_res)
        self.with_act = bool(with_act)
        self.with_xp = bool(with_xp)
        self.names = TRACED_NAMES + (XP_NAMES if self.with_xp else ())
        self.count_sink = None
        self.launches = {KERNEL_FWD: 0, KERNEL_BWD: 0, KERNEL_REDUCE: 0}

    def __call__(self, bq, bqd, tgt, act, res, *planes):
        with spans.span("rollout.interval"):
            if len(planes) != len(self.names):
                raise ValueError("need the %d planes %s" % (len(self.names), self.names))
            if tgt.shape[0] != self.S:
                raise ValueError("tgt has %d substep rows; the interval has %d"
                                 % (tgt.shape[0], self.S))
            act = act if self.with_act else None
            res = res if self.with_res else None
            dev = bq.device
            if dev.type == "cpu":
                return interval(self.integrator, self.dt, bq, bqd, tgt, act, res, *planes)
            if dev.type != "cuda":
                raise ValueError("the interval runs on cpu or cuda tensors, not %s" % dev)
            return _IntervalFn.apply(self, bq, bqd, tgt, act, res, *planes)

    # ---- kernel launches ---------------------------------------------------
    def _common(self, tgt, act, res, planes, E):
        """Checked, contiguous inputs and the argument groups shared by K2
        and K3 (the tail stops before the envs per CTA and the stream)."""
        model = self.model
        B, n_qd, S = model.n_links, model.n_qd, self.S
        dev = tgt.device
        check_device(KERNEL, dev)
        want = {"tgt": (tgt, (S, n_qd, E)), "act": (act, (S, n_qd, E)),
                "res": (res, (S, 6, B, E))}
        out = {}
        for n, (t, shape) in want.items():
            if t is None:
                out[n] = None
                continue
            if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
                raise ValueError("%s must be float32 %s on %s, got %s %s on %s"
                                 % (n, shape, dev, t.dtype, tuple(t.shape), t.device))
            out[n] = t.contiguous()
        pl = []
        for n, p in zip(self.names, planes):
            if p.device != dev or p.dtype != torch.float32 or p.shape[-1] not in (1, E):
                raise ValueError("parameter plane %s must be float32 on %s with lane 1 or E=%d"
                                 % (n, dev, E))
            pl.append(p.contiguous())
        plane_args = []
        for p in pl[:len(TRACED_NAMES)]:
            plane_args += [ptr(p), per_env(p, E)]
        xp = pl[len(TRACED_NAMES):]
        if xp and len({p.shape[-1] for p in xp}) != 1:
            raise ValueError("the anchor planes must share one lane width")
        plane_args += [ptr(p) for p in xp] + [per_env(xp[0], E)] if xp else [None, None, None, 0]
        tail = [E, B, n_qd, model.contact_count, S] + sim_args(model, self.dt)
        return out, pl, plane_args, tail

    def _forward(self, bq, bqd, tgt, act, res, planes, export):
        """K2 (one warp per env, ``envs_per_cta(E)`` envs per CTA) on the
        state (7,B,E)/(6,B,E), targets/acts (S,n_qd,E) and residual forces
        (S,6,B,E) (acts and res may be None: zero): returns the final state
        and, with ``export``, the (S,E,13,B) state entering each substep
        that K3 reads (else None)."""
        B = self.model.n_links
        E = bq.shape[-1]
        dev = bq.device
        if bq.shape != (7, B, E) or bqd.shape != (6, B, E):
            raise ValueError("state must be (7,B,E)/(6,B,E), got %s/%s"
                             % (tuple(bq.shape), tuple(bqd.shape)))
        if bq.dtype != torch.float32 or bqd.dtype != torch.float32 or bqd.device != dev:
            raise ValueError("state must be float32 on one device")
        lib = _kernel_lib()
        if B > lib.soa_interval_max_bodies():
            raise ValueError("soa_interval supports at most %d bodies, got %d"
                             % (lib.soa_interval_max_bodies(), B))
        seq, _, plane_args, tail = self._common(tgt, act, res, planes, E)
        bq, bqd = bq.contiguous(), bqd.contiguous()
        out_q = torch.empty((7, B, E), dtype=torch.float32, device=dev)
        out_qd = torch.empty((6, B, E), dtype=torch.float32, device=dev)
        sstate = (torch.empty((self.S, E, 13, B), dtype=torch.float32, device=dev)
                  if export else None)
        status = lib.soa_interval_fwd_launch(
            ptr(bq), ptr(bqd), ptr(seq["tgt"]), ptr(seq["act"]), ptr(seq["res"]),
            *warp_consts(self.model, dev), *plane_args, ptr(out_q), ptr(out_qd), ptr(sstate),
            *tail, envs_per_cta(E), torch.cuda.current_stream(dev).cuda_stream)
        kbuild.check(status, KERNEL_FWD)
        self.launches[KERNEL_FWD] += 1
        return out_q, out_qd, sstate

    def _backward(self, sstate, tgt, act, res, planes, dq, dqd):
        """K3 (one warp per env, ``envs_per_cta(E)`` envs per CTA) on the
        (S,E,13,B) export and the cotangents dq (7,B,E), dqd (6,B,E), then,
        for shared planes, the env reduction (one warp per plane row).
        Returns (dbq, dbqd, dtgt, dact or None, dres or None, [the plane
        gradients in the planes' shapes])."""
        E, B = sstate.shape[1], sstate.shape[3]
        dev = sstate.device
        lib = _kernel_lib()
        seq, pl, plane_args, tail = self._common(tgt, act, res, planes, E)
        stream = torch.cuda.current_stream(dev).cuda_stream
        dq, dqd = dq.to(torch.float32).contiguous(), dqd.to(torch.float32).contiguous()
        f32 = dict(dtype=torch.float32, device=dev)
        dbq = torch.empty((7, B, E), **f32)
        dbqd = torch.empty((6, B, E), **f32)
        dtgt = torch.empty((self.S, self.model.n_qd, E), **f32)
        dact = torch.empty_like(seq["act"]) if seq["act"] is not None else None
        dres = torch.empty_like(seq["res"]) if seq["res"] is not None else None
        rows = lib.soa_interval_plane_rows(int(self.with_xp))
        want = sum(PLANE_ROWS[n] for n in self.names)
        if rows != want:
            raise RuntimeError("soa_interval library has %d plane rows, the wrapper %d"
                               % (rows, want))
        dplanes = torch.empty((rows, B, E), **f32)
        status = lib.soa_interval_bwd_launch(
            ptr(sstate), ptr(seq["tgt"]), ptr(seq["act"]), ptr(seq["res"]),
            *warp_consts(self.model, dev), *plane_args, ptr(dq), ptr(dqd), ptr(dbq), ptr(dbqd),
            ptr(dtgt), ptr(dact), ptr(dres), ptr(dplanes), *tail, envs_per_cta(E), stream)
        kbuild.check(status, KERNEL_BWD)
        self.launches[KERNEL_BWD] += 1
        sink = self.count_sink
        if sink is not None or spans.recording():
            triples = self.S * E * self.model.contact_count
            active = active_contact_count(self.model, sstate)
            if sink is not None:
                sink.add(triples, active)
            else:
                spans.count("k3.contact_triples", triples)
                spans.count("k3.active_contacts", active)

        shared = [not per_env(p, E) for p in pl]
        summed = None
        if any(shared):
            summed = torch.empty((rows, B), **f32)
            status = lib.soa_interval_reduce_launch(
                ptr(dplanes), ptr(summed), rows * B, E, REDUCE_WARPS_PER_CTA, stream)
            kbuild.check(status, KERNEL_REDUCE)
            self.launches[KERNEL_REDUCE] += 1
        grads, o = [], 0
        for n, p, sh in zip(self.names, pl, shared):
            r = PLANE_ROWS[n]
            g = summed[o:o + r, :, None] if sh else dplanes[o:o + r]
            grads.append(g.reshape(p.shape))
            o += r
        return dbq, dbqd, dtgt, dact, dres, grads


class ContactCounts:
    """K3's contact counters summed where no profiler has to record
    (``DiffInterval.count_sink``): ``triples`` on the host, ``active`` a 0-d
    int64 tensor on the device."""

    def __init__(self, device):
        self.triples = 0
        self.active = torch.zeros((), dtype=torch.int64, device=device)

    def reset(self):
        self.triples = 0
        self.active.zero_()

    def add(self, triples: int, active: torch.Tensor):
        self.triples += triples
        self.active += active


def make_diff_interval(integrator: SemiImplicitIntegrator, dt: float, substeps: int,
                       with_res: bool = False, with_act: bool = False,
                       with_xp: bool = False) -> DiffInterval:
    return DiffInterval(integrator, dt, substeps, with_res=with_res, with_act=with_act,
                        with_xp=with_xp)


def _detached(params: SimParams) -> SimParams:
    return SimParams(*(None if x is None else x.detach() for x in params))


def rollout_soa(integrator: SemiImplicitIntegrator, params: SimParams, state0: SimState,
                joint_targets, joint_acts, res_f, dt: float, substeps_per_frame: int,
                interval_fn: DiffInterval = None, observables: bool = True):
    """The windowed rollout on frame intervals (pallas_soa_grad.py:765-862),
    with ``integrator.rollout``'s contract: states recorded at frame
    boundaries, grf/jaf from each boundary substep (evaluated by the plain
    force pipeline without gradient: they feed visualization only).

    joint_targets/joint_acts (S,E,n_qd) (acts may be None), res_f (S,E,B,6)
    or None; without ``interval_fn`` the rollout builds an interval that
    takes the acts and residual forces given. Returns (body_q (F,E,B,7),
    body_qd (F,E,B,6), grf, jaf (F,E,B,6)); gradients flow to state0, the
    targets, acts, residual forces and params, a live ``joint_X_p`` ((B,7)
    or (E,B,7)) included, through the interval kernels.
    ``observables=False`` skips the F boundary force evaluations and returns
    None for grf and jaf; the states and gradients are the same, since the
    observables neither feed them nor draw random numbers."""
    if params.body_com is not None:
        raise ValueError("rollout_soa takes body_com from the model: no interval kernel "
                         "has a COM plane")
    with_xp = params.joint_X_p is not None
    S = joint_targets.shape[0]
    sub = int(substeps_per_frame)
    n_intervals = (S - 1) // sub
    if S != n_intervals * sub + 1:
        raise ValueError("joint_targets has %d rows, not sub*(F-1)+1 (sub=%d)" % (S, sub))
    if interval_fn is None:
        interval_fn = make_diff_interval(integrator, dt, sub, with_res=res_f is not None,
                                         with_act=joint_acts is not None, with_xp=with_xp)
    elif interval_fn.S != sub:
        raise ValueError("interval_fn has %d substeps, the window %d" % (interval_fn.S, sub))
    elif interval_fn.with_xp != with_xp:
        raise ValueError("interval_fn built with with_xp=%s but params.joint_X_p is %s"
                         % (interval_fn.with_xp, "live" if with_xp else "None"))
    planes = traced_planes(integrator.model, params)
    tr = tuple(planes[n] for n in interval_fn.names)
    tgt_p = joint_targets.permute(0, 2, 1).contiguous()  # (S, n_qd, E)
    act_p = None if joint_acts is None else joint_acts.permute(0, 2, 1).contiguous()
    res_p = None if res_f is None else res_f.permute(0, 3, 2, 1).contiguous()  # (S,6,B,E)
    sg_params = _detached(params)
    grfs, jafs = [], []

    def observe(bq, bqd, i):
        if not observables:
            return
        with spans.span("rollout.observables"), torch.no_grad():
            _, grf, jaf = integrator.compute_forces(
                sg_params, SimState(bq.detach().permute(2, 1, 0), bqd.detach().permute(2, 1, 0)),
                joint_targets[i].detach(),
                None if joint_acts is None else joint_acts[i].detach(),
                None if res_f is None else res_f[i].detach(),
            )
        grfs.append(grf)
        jafs.append(jaf)

    bq = state0.body_q.permute(2, 1, 0)
    bqd = state0.body_qd.permute(2, 1, 0)
    qs, qds = [], []
    for f in range(n_intervals):
        s0 = f * sub
        qs.append(bq)
        qds.append(bqd)
        observe(bq, bqd, s0)
        sl = slice(s0, s0 + sub)
        bq, bqd = interval_fn(
            bq, bqd, tgt_p[sl], None if act_p is None else act_p[sl],
            None if res_p is None else res_p[sl], *tr)
    observe(bq, bqd, S - 1)
    qs.append(bq)
    qds.append(bqd)
    aos = lambda xs: torch.stack(xs, 0).permute(0, 3, 2, 1)  # (F,·,B,E) -> (F,E,B,·)
    if not observables:
        spans.count("rollout.observables_skipped", n_intervals + 1)
        return aos(qs), aos(qds), None, None
    return aos(qs), aos(qds), torch.stack(grfs, 0), torch.stack(jafs, 0)


def interval_work(model, E: int, substeps: int, n_active_contacts: float = None,
                  xp_lanes: int = 0) -> dict:
    """Bytes each interval kernel must move and fp32 operations it must do,
    for the roofline bound (each input read once, each output written once;
    shared planes, no acts or residual forces, as training calls them).

    K2 (with the per-substep state export): the state, targets, planes and
    constants in; the state and the (S,E,13,B) export out. Operations: the
    forward substep count of ``window_work``.

    K3: the export, targets, cotangents, planes and constants in; d(state),
    dtgt and the (25,B,E) plane partials out, plus the reduction's read and
    write. Operations, counted by hand from csrc/soa_interval.cu with
    window_work's units (an FMA counts 2; qrot 30, qmul 28, cross 9, katan2
    20; their adjoints qrot 73, qmul 64, cross 24, katan2 42, kasin 52):
    per env-substep the force recompute (the substep less integration), per
    body integrate_adj 809 (199 forward recompute + 610 adjoint), per joint
    joint_adj's common frame 632 plus FIXED 185, REVOLUTE 363 or COMPOUND
    1360, per contact 67 to find it inactive, and per active (penetrating)
    contact-substep 296 more; then the E-reduction, 25*B adds per env.
    ``n_active_contacts`` is the number of (env, substep, contact) triples
    that penetrate in this run's data (default: every contact, always).
    ``xp_lanes`` (0: none, 1: shared, E: per env) adds the live anchor
    planes: 10 rows per body and lane read by both kernels, and K3's 10 more
    rows of per-env partials (with their reduction for shared anchors). The
    anchor adjoint's operations are those of the parent transform's adjoint
    that joint_adj already counts."""
    from .builder import JOINT_COMPOUND, JOINT_FIXED, JOINT_REVOLUTE

    B, C, n_qd = model.n_links, model.contact_count, model.n_qd
    S = int(substeps)
    f4 = 4
    per = window_work(model, E, S, 2)["per_env_substep"]
    integ = 287
    planes_b = (25 * B + 10 * B * xp_lanes) * f4
    rows = 35 if xp_lanes else 25
    consts_b = (B * (5 + 32) + C * 9) * f4
    fwd_bytes = (13 * B * E + S * n_qd * E) * f4 + planes_b + consts_b + (
        13 * B * E + S * 13 * B * E) * f4
    fwd_ops = E * S * per
    per_joint = {JOINT_FIXED: 632 + 185, JOINT_REVOLUTE: 632 + 363,
                 JOINT_COMPOUND: 632 + 1360}
    joints = sum(per_joint.get(int(t), 0) for t in model.joint_type)
    if n_active_contacts is None:
        n_active_contacts = float(E) * S * C
    bwd_ops = E * S * (per - integ * B + 809 * B + joints + 67 * C) \
        + 296 * n_active_contacts + rows * B * E
    bwd_bytes = (S * 13 * B * E + S * n_qd * E + 13 * B * E) * f4 + planes_b + consts_b + (
        13 * B * E + S * n_qd * E + rows * B * E) * f4 + (rows * B * E + rows * B) * f4
    return dict(fwd_bytes=fwd_bytes, fwd_ops=fwd_ops, bwd_bytes=bwd_bytes, bwd_ops=bwd_ops)


def active_contacts(model, sstate) -> float:
    """Number of (substep, env, contact) triples whose contact point is below
    the ground in a K2 state export (S,E,13,B): the contacts K3's adjoint
    does work for."""
    return float(active_contact_count(model, sstate))


def contact_tables(model, device) -> tuple:
    """The contacts' body index, body-frame point and distance on
    ``device``, made once per contact set and kept on the model
    (``model.device_table``)."""
    return model.device_table(("contact_tables", model.contact_generation), device, lambda: (
        torch.as_tensor(np.asarray(model.contact_body, np.int64), device=device),
        torch.as_tensor(np.asarray(model.contact_point, np.float32), device=device),
        torch.as_tensor(np.asarray(model.contact_dist, np.float32), device=device)))


def active_contact_count(model, sstate) -> torch.Tensor:
    """``active_contacts`` as a 0-d int64 tensor on the export's device,
    read without making the host wait once the device holds the contact
    set's ``contact_tables``."""
    cb, pt, dist = contact_tables(model, sstate.device)
    with torch.no_grad():
        t = sstate[:, :, 0:3][..., cb]  # (S,E,3,C)
        q = sstate[:, :, 3:7][..., cb]
        u, w = q[:, :, 0:3], q[:, :, 3:4]
        v = pt.T[None, None]
        uv = torch.linalg.cross(u, v.expand_as(u), dim=2)
        rot = v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=2))
        y = rot[:, :, 1] + t[:, :, 1] - dist
        return (y < 0).sum()
