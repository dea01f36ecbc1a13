"""The plain stand-ins that the frozen ``models/phys_model.py`` takes where
the port calls its kernels and its multi-GPU layer: the whole-window
rollout (``integrator.rollout``), the differentiable frame interval
(``integrator.interval`` under autograd), the chained training rollout,
and a one-process ``sharding``.

``rollout_soa`` follows the port's ``sim/soa_grad.py:rollout_soa``
(frame-boundary states, observables from the plain force pipeline without
gradient). While autograd records, each interval keeps only its inputs and
recomputes its forward in the backward pass, so that a step at 512 envs x
759 substeps holds one interval's graph at a time: the values and
gradients are those of the plain interval.
"""

from __future__ import annotations

import types

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .sim.integrator import (
    SemiImplicitIntegrator,
    SimParams,
    SimState,
    dof_index,
    interval,
    rollout,
)

TRACED_NAMES = ("gains", "inv_m", "inertia", "inv_inertia")
XP_NAMES = ("xp_t", "xp_q", "rp_local")


def default_device(device=None) -> torch.device:
    return torch.device("cuda" if device is None else device)


# one process: every env on this process, no collective
class _EnvSharding:
    def rows(self, n: int) -> slice:
        return slice(0, n)

    def gather(self, x):
        return x


sharding = types.SimpleNamespace(
    world_size=lambda: 1,
    rank=lambda: 0,
    mesh_budget=lambda ngpu, mesh_shape, world: (1, 1, None),
    mesh_dims=lambda num_envs, budget, tp, dp_cap=None: None,
    make_mesh=None,
    env_sharding=lambda mesh: _EnvSharding(),
    shard_train_step=lambda fn, mesh, named: (lambda *a: fn(_EnvSharding(), *a)),
    broadcast_from_rank0=lambda values: values,
    tp_linear=lambda x, w, b=None: F.linear(x, w, b),
)


class SoaWindow:
    """The no-gradient whole-window rollout, plain."""

    def __init__(self, integrator: SemiImplicitIntegrator, dt: float, substeps: int,
                 n_frames: int):
        self.integrator = integrator
        self.dt = float(dt)
        self.sub = int(substeps)
        self.F = int(n_frames)

    def __call__(self, state: SimState, joint_targets, joint_acts, params: SimParams):
        return rollout(self.integrator, params, state, joint_targets, joint_acts, None,
                       self.dt, self.sub)


class _IntervalGraphs:
    """Two CUDA graphs of one interval at one set of input shapes: the
    forward without autograd, and the forward again with the gradient of
    every input for given output cotangents. Replaying a graph launches the
    same plain operations as calling the function, without the host's
    per-operation cost."""

    def __init__(self, fn, args):
        self.static_in = [a.detach().clone() for a in args]
        self.static_gout = None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up, as capture asks
            for _ in range(2):
                self._grads(fn)
        torch.cuda.current_stream().wait_stream(side)
        self.fwd = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(self.fwd):
            self.static_out = fn(*self.static_in)
        self.bwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.bwd):
            self.static_gin = self._grads(fn)

    def forward(self, args):
        """The forward graph on ``args``: fresh copies of its outputs."""
        with torch.no_grad():
            for s, a in zip(self.static_in, args):
                s.copy_(a)
        self.fwd.replay()
        return tuple(o.clone() for o in self.static_out)

    def _grads(self, fn):
        leaves = [x.requires_grad_(True) for x in self.static_in]
        out = fn(*leaves)
        if self.static_gout is None:
            self.static_gout = [torch.ones_like(o) for o in out]
        grads = torch.autograd.grad(out, leaves, self.static_gout, allow_unused=True)
        for x in leaves:
            x.requires_grad_(False)
        return [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]


class _GraphedInterval(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graphs, *args):
        ctx.graphs = graphs
        ctx.save_for_backward(*args)
        return graphs.forward(args)

    @staticmethod
    def backward(ctx, *gouts):
        g = ctx.graphs
        with torch.no_grad():
            for s, a in zip(g.static_in, ctx.saved_tensors):
                s.copy_(a)
            for s, a in zip(g.static_gout, gouts):
                s.copy_(a) if a is not None else s.zero_()
        g.bwd.replay()
        return (None,) + tuple(x.clone() for x in g.static_gin)


class PlainInterval:
    """A differentiable frame interval of ``substeps`` substeps in the plane
    layout, plain (``integrator.interval``). On the CPU it is recomputed in
    the backward pass (activation checkpointing); on a CUDA device it runs
    as two CUDA graphs of the same operations (``_IntervalGraphs``), the
    forward and, in the backward pass, the forward again with its
    gradients, so that one interval's graph is kept at a time."""

    def __init__(self, integrator: SemiImplicitIntegrator, dt: float, substeps: int,
                 with_res: bool = False, with_act: bool = False, with_xp: bool = False):
        self.integrator = integrator
        self.dt = float(dt)
        self.S = int(substeps)
        self.with_res = bool(with_res)
        self.with_act = bool(with_act)
        self.with_xp = bool(with_xp)
        self.names = TRACED_NAMES + (XP_NAMES if self.with_xp else ())
        self._graphs = {}

    def __call__(self, bq, bqd, tgt, act, res, *planes):
        act = act if self.with_act else None
        res = res if self.with_res else None

        def run(bq, bqd, tgt, *planes):
            return interval(self.integrator, self.dt, bq, bqd, tgt, act, res, *planes)

        args = (bq, bqd, tgt) + tuple(planes)
        if bq.device.type == "cuda":
            key = tuple((tuple(a.shape), a.dtype) for a in args)
            if key not in self._graphs:
                self._graphs[key] = _IntervalGraphs(run, args)
            if torch.is_grad_enabled():
                return _GraphedInterval.apply(self._graphs[key], *args)
            return self._graphs[key].forward(args)
        if torch.is_grad_enabled():
            return checkpoint(run, *args, use_reentrant=False)
        return run(*args)


def make_diff_interval(integrator, dt, substeps, with_res=False, with_act=False,
                       with_xp=False) -> PlainInterval:
    return PlainInterval(integrator, dt, substeps, with_res, with_act, with_xp)


def xp_planes(model, joint_X_p) -> dict:
    """Plane layout of a joint-anchor override: (B,7) lane 1, (E,B,7) lane E."""
    parent = model.joint_parent
    parent_safe = np.where(parent >= 0, parent, 0)
    com_parent = torch.as_tensor(np.ascontiguousarray(model.body_com[parent_safe].T[:, :, None]),
                                 dtype=torch.float32, device=joint_X_p.device)
    xp = joint_X_p.to(torch.float32)
    if xp.ndim == 2:
        xp_t, xp_q = xp[:, 0:3].T[:, :, None], xp[:, 3:7].T[:, :, None]
    else:
        xp_t, xp_q = xp[..., 0:3].permute(2, 1, 0), xp[..., 3:7].permute(2, 1, 0)
    planes = dict(xp_t=xp_t, xp_q=xp_q, rp_local=xp_t - com_parent)
    return {n: t.contiguous() for n, t in planes.items()}


def traced_planes(model, params: SimParams) -> dict:
    """Per-call parameters in plane layout: gains (2,3,B,1|E), inv_m
    (B,1|E), inertia and inv_inertia (3,3,B,1|E), and the anchor planes for
    a live ``joint_X_p``."""
    didx = torch.as_tensor(dof_index(model), dtype=torch.long,
                           device=params.joint_target_ke.device)
    ke, kd = params.joint_target_ke, params.joint_target_kd
    if ke.ndim == 1:
        gains = torch.stack([ke[didx].T, kd[didx].T])[..., None]
    else:
        gains = torch.stack([ke[:, didx].permute(2, 1, 0), kd[:, didx].permute(2, 1, 0)])
    im = params.body_inv_mass
    inv_m = im[:, None] if im.ndim == 1 else im.T
    if params.body_inertia.ndim == 3:
        inertia = params.body_inertia.permute(1, 2, 0)[..., None]
        inv_inertia = params.body_inv_inertia.permute(1, 2, 0)[..., None]
    else:
        inertia = params.body_inertia.permute(2, 3, 1, 0)
        inv_inertia = params.body_inv_inertia.permute(2, 3, 1, 0)
    planes = {n: t.to(torch.float32).contiguous()
              for n, t in zip(TRACED_NAMES, (gains, inv_m, inertia, inv_inertia))}
    if params.joint_X_p is not None:
        planes.update(xp_planes(model, params.joint_X_p))
    return planes


def _detached(params: SimParams) -> SimParams:
    return SimParams(*(None if x is None else x.detach() for x in params))


def rollout_soa(integrator: SemiImplicitIntegrator, params: SimParams, state0: SimState,
                joint_targets, joint_acts, res_f, dt: float, substeps_per_frame: int,
                interval_fn: PlainInterval = None, with_res: bool = False,
                with_act: bool = False):
    """The windowed rollout on frame intervals: (body_q (F,E,B,7), body_qd
    (F,E,B,6), grf, jaf (F,E,B,6)), gradients through the plain intervals."""
    S = joint_targets.shape[0]
    sub = int(substeps_per_frame)
    n_intervals = (S - 1) // sub
    if S != n_intervals * sub + 1:
        raise ValueError("joint_targets has %d rows, not sub*(F-1)+1 (sub=%d)" % (S, sub))
    if interval_fn is None:
        interval_fn = make_diff_interval(integrator, dt, sub, with_res=with_res,
                                         with_act=with_act,
                                         with_xp=params.joint_X_p is not None)
    planes = traced_planes(integrator.model, params)
    tr = tuple(planes[n] for n in interval_fn.names)
    tgt_p = joint_targets.permute(0, 2, 1).contiguous()
    act_p = None if joint_acts is None else joint_acts.permute(0, 2, 1).contiguous()
    res_p = None if res_f is None else res_f.permute(0, 3, 2, 1).contiguous()
    sg_params = _detached(params)

    def observables(bq, bqd, i):
        with torch.no_grad():
            _, grf, jaf = integrator.compute_forces(
                sg_params, SimState(bq.detach().permute(2, 1, 0), bqd.detach().permute(2, 1, 0)),
                joint_targets[i].detach(),
                None if joint_acts is None else joint_acts[i].detach(),
                None if res_f is None else res_f[i].detach(),
            )
        return grf, jaf

    bq = state0.body_q.permute(2, 1, 0)
    bqd = state0.body_qd.permute(2, 1, 0)
    qs, qds, grfs, jafs = [], [], [], []
    for f in range(n_intervals):
        s0 = f * sub
        qs.append(bq)
        qds.append(bqd)
        grf, jaf = observables(bq, bqd, s0)
        grfs.append(grf)
        jafs.append(jaf)
        sl = slice(s0, s0 + sub)
        bq, bqd = interval_fn(
            bq, bqd, tgt_p[sl], None if act_p is None else act_p[sl],
            None if res_p is None else res_p[sl], *tr)
    grf, jaf = observables(bq, bqd, S - 1)
    qs.append(bq)
    qds.append(bqd)
    grfs.append(grf)
    jafs.append(jaf)
    aos = lambda xs: torch.stack(xs, 0).permute(0, 3, 2, 1)
    return aos(qs), aos(qds), torch.stack(grfs, 0), torch.stack(jafs, 0)
