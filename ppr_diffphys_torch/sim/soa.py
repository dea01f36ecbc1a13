"""The serving window (the whole forward window of frame intervals in one
CUDA launch) and the bench rollout (S substeps, final state only),
counterpart of ``ppr_diffphys_tpu/sim/pallas_soa.py`` (``build_soa_static``,
``traced_planes``, ``xp_planes``, ``build_soa_window``, ``build_soa_rollout``).

- :func:`soa_static` builds the per-model constant tensors once. The
  plane-layout arrays keep the JAX names and shapes (``axis_c``, ``xp_q``,
  ``lim``, ``cpt``, ...); gathers, scatters and joint-type masks are index
  tables (``parent``, ``joint_type``, ``dof_idx``, ``contact_body``)
  instead of the TPU kernel's one-hot matrices.
- :func:`traced_planes` lays the per-call parameters out as planes,
  shared (lane 1) or per-env (lane E), exactly as the JAX function does,
  with the live joint-anchor planes of :func:`xp_planes` when
  ``params.joint_X_p`` is set (the interval kernels' ``with_xp``).
- :class:`SoaWindow` is the wrapper: CPU tensors take the plain PyTorch
  version (``integrator.rollout``); CUDA tensors launch
  ``csrc/soa_window.cu`` or raise. It never falls back. Like the JAX K1 it
  takes no anchor or COM planes: a live ``joint_X_p`` or ``body_com``
  raises on either device.
- :class:`SoaRollout` (:func:`build_soa_rollout`) is the bench rollout's
  wrapper, with the parameters baked in as lane-1 planes: CPU tensors take
  ``integrator.rollout_substeps``; CUDA tensors launch
  ``csrc/soa_rollout.cu`` or raise.
- :func:`envs_per_cta` sizes the CTAs of the kernels, which all run one
  warp per env (``csrc/substep_warp.cuh``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..csrc import build as kbuild
from ..utils import spans
from .builder import JOINT_COMPOUND, JOINT_FIXED, JOINT_REVOLUTE
from .integrator import (
    SemiImplicitIntegrator,
    SimParams,
    SimState,
    dof_index,
    rollout,
    rollout_substeps,
)

KERNEL = "soa_window"
KERNEL_ROLLOUT = "soa_rollout"
TRACED_NAMES = ("gains", "inv_m", "inertia", "inv_inertia")
# the live joint-anchor planes (pallas_soa.py:328 XP_NAMES)
XP_NAMES = ("xp_t", "xp_q", "rp_local")
# The kernels hold 1, 2, 4 or 8 consecutive envs per CTA, one per warp.
# MIN_CTAS is the largest power of two not above the H100's 132 SMs, so
# that power-of-two widths (512, 4096) give whole CTAs.
ENVS_PER_CTA = (8, 4, 2, 1)
MIN_CTAS = 128


def soa_static(model, device="cpu") -> dict:
    """Static per-model constants (pallas_soa.py:409-588 build_soa_static).

    Plane-layout float arrays carry the JAX names; the one-hot gather and
    scatter matrices and the joint-type masks become the int32 index tables
    ``parent`` (B,), ``joint_type`` (B,), ``dof_idx`` (B, 3) and
    ``contact_body`` (C,)."""
    jt = model.joint_type
    parent = model.joint_parent
    parent_safe = np.where(parent >= 0, parent, 0)
    dof_idx = dof_index(model)

    xp_t = model.joint_X_p[:, 0:3].T[:, :, None]
    com_parent = model.body_com[parent_safe].T[:, :, None]
    lim = np.stack(
        [
            model.joint_limit_lower[dof_idx],
            model.joint_limit_upper[dof_idx],
            model.joint_limit_ke[dof_idx],
            model.joint_limit_kd[dof_idx],
        ],
        0,
    ).transpose(0, 2, 1)[..., None]  # (4,3,B,1)
    cb = np.asarray(model.contact_body)
    if (np.diff(cb) < 0).any():
        raise ValueError("contacts must be body-sorted")

    f = dict(
        axis_c=model.joint_axis.T[:, :, None],
        xp_t=xp_t,
        xp_q=model.joint_X_p[:, 3:7].T[:, :, None],
        xc_q=model.joint_X_c[:, 3:7].T[:, :, None],
        com=model.body_com.T[:, :, None],
        rp_local=xp_t - com_parent,
        lim=lim,
        cpt=model.contact_point.T[:, :, None],  # (3,C,1)
        cdist=model.contact_dist[:, None],  # (C,1)
        cmat=model.contact_material.T[:, :, None],  # (4,C,1) ke kd kf mu
    )
    out = {
        k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32, device=device)
        for k, v in f.items()
    }
    i = dict(parent=parent, joint_type=jt, dof_idx=dof_idx, contact_body=cb)
    out.update({
        k: torch.as_tensor(np.ascontiguousarray(v, np.int32), device=device)
        for k, v in i.items()
    })
    return out


def pack_static(static: dict) -> dict:
    """The kernels' packed constant buffers (see csrc/substep.cuh):
    ``body_i`` (B,5) int32 = parent, joint type, 3 dof indices;
    ``body_f`` (B,32) f32 = axis, xp_t, xp_q, xc_q, com, rp_local, limit
    lower/upper/ke/kd; ``cbody`` (C,) int32; ``cf`` (C,8) f32 = point,
    dist, ke, kd, kf, mu.

    The per-body lists each body's lane sums in a fixed order
    (csrc/substep_warp.cuh): ``c_off`` (B+1,) int32, body b's contacts are
    c_off[b] .. c_off[b+1] (cbody is body-sorted); ``adj_off`` (B+1,) and
    ``adj`` int32, body b's joint wrenches are adj[adj_off[b] ..
    adj_off[b+1]], joints in body order, 2j for joint j's child part (body
    b is its child) and 2j+1 for its parent part."""
    body_i = torch.cat(
        [static["parent"][:, None], static["joint_type"][:, None], static["dof_idx"]], 1
    )
    body_f = torch.cat(
        [static[n][..., 0] for n in ("axis_c", "xp_t", "xp_q", "xc_q", "com", "rp_local")]
        + [static["lim"][..., 0].reshape(12, -1)],  # (4,3,B) lower, upper, ke, kd
        0,
    ).T
    cf = torch.cat(
        [static["cpt"][..., 0], static["cdist"].T, static["cmat"][..., 0]], 0
    ).T
    parent = static["parent"].cpu().numpy()
    jt = static["joint_type"].cpu().numpy()
    B = len(parent)
    lists = [[] for _ in range(B)]
    for j in range(B):
        if jt[j] in (JOINT_FIXED, JOINT_REVOLUTE, JOINT_COMPOUND):
            lists[j].append(2 * j)
            if parent[j] >= 0:
                lists[parent[j]].append(2 * j + 1)
    adj_off = np.cumsum([0] + [len(x) for x in lists])
    adj = np.array([x for lst in lists for x in lst], np.int64)
    c_off = np.searchsorted(static["contact_body"].cpu().numpy(), np.arange(B + 1), "left")
    as_i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=body_i.device)
    return dict(
        body_i=body_i.contiguous(), body_f=body_f.contiguous(),
        cbody=static["contact_body"].contiguous(), cf=cf.contiguous(),
        adj_off=as_i32(adj_off), adj=as_i32(adj), c_off=as_i32(c_off),
    )


def xp_planes(model, joint_X_p) -> dict:
    """Plane layout of a joint-anchor override (pallas_soa.py:331-346):
    ``joint_X_p`` (B,7) gives lane-1 planes, (E,B,7) lane-E planes:
    ``xp_t`` (3,B,L), ``xp_q`` (4,B,L) and ``rp_local = xp_t - com_parent``
    (3,B,L), the arm from the parent's centre of mass that the joint sweep
    rotates into the world frame. Differentiable in ``joint_X_p``;
    ``com_parent`` is the model's, a constant."""
    parent = model.joint_parent
    parent_safe = np.where(parent >= 0, parent, 0)
    com_parent = torch.as_tensor(np.ascontiguousarray(model.body_com[parent_safe].T[:, :, None]),
                                 dtype=torch.float32, device=joint_X_p.device)
    xp = joint_X_p.to(torch.float32)
    if xp.ndim == 2:  # (B,7) -> lane 1
        xp_t, xp_q = xp[:, 0:3].T[:, :, None], xp[:, 3:7].T[:, :, None]
    else:  # (E,B,7) -> lane E
        xp_t, xp_q = xp[..., 0:3].permute(2, 1, 0), xp[..., 3:7].permute(2, 1, 0)
    planes = dict(xp_t=xp_t, xp_q=xp_q, rp_local=xp_t - com_parent)
    return {n: t.contiguous() for n, t in planes.items()}


def traced_planes(model, params: SimParams, didx=None) -> dict:
    """Per-call parameters in plane layout (pallas_soa.py:349-389):
    ``gains`` (2,3,B,1|E), ``inv_m`` (B,1|E), ``inertia`` and
    ``inv_inertia`` (3,3,B,1|E), plus the ``XP_NAMES`` anchor planes when
    ``params.joint_X_p`` is set. Shared params (``joint_target_ke`` (n_qd,))
    give lane-1 planes, per-env params ((E, n_qd)) lane-E planes. ``didx``:
    ``dof_index(model)`` on the parameters' device (``PackedConsts.dof_index``);
    built here when None, by a host-to-device copy that waits for the
    stream."""
    if didx is None:
        didx = torch.as_tensor(dof_index(model), dtype=torch.long,
                               device=params.joint_target_ke.device)
    ke, kd = params.joint_target_ke, params.joint_target_kd
    if ke.ndim == 1:
        gains = torch.stack([ke[didx].T, kd[didx].T])[..., None]  # (2,3,B,1)
    else:  # (E, n_qd)
        gains = torch.stack([ke[:, didx].permute(2, 1, 0), kd[:, didx].permute(2, 1, 0)])
    im = params.body_inv_mass
    inv_m = im[:, None] if im.ndim == 1 else im.T  # (B,1) | (B,E)
    if params.body_inertia.ndim == 3:
        inertia = params.body_inertia.permute(1, 2, 0)[..., None]  # (3,3,B,1)
        inv_inertia = params.body_inv_inertia.permute(1, 2, 0)[..., None]
    else:  # (E,B,3,3)
        inertia = params.body_inertia.permute(2, 3, 1, 0)  # (3,3,B,E)
        inv_inertia = params.body_inv_inertia.permute(2, 3, 1, 0)
    planes = {
        n: t.to(torch.float32).contiguous()
        for n, t in zip(TRACED_NAMES, (gains, inv_m, inertia, inv_inertia))
    }
    if params.joint_X_p is not None:
        planes.update(xp_planes(model, params.joint_X_p))
    return planes


def window_work(model, E: int, substeps: int, n_frames: int) -> dict:
    """Bytes the window must move and fp32 operations it must do, for the
    roofline bound of the kernel (each input read once, each output written
    once; shared parameter planes, no acts, as serving calls it). Operation
    counts per unit are counted by hand from csrc/substep.cuh (an FMA
    counts 2; sqrt, division, sin and cos count 1 each, a lower bound on
    their cost)."""
    B, C, n_qd = model.n_links, model.contact_count, model.n_qd
    jt = model.joint_type
    S = substeps * (n_frames - 1) + 1
    f4 = 4
    bytes_in = (13 * B * E + S * n_qd * E) * f4 + (
        2 * 3 * B + B + 2 * 9 * B) * f4 + (B * (5 + 32) + C * 9) * f4
    bytes_out = n_frames * (7 + 6 + 6 + 6) * B * E * f4
    # per unit, from the source (qrot 30, qmul 28, cross 9, katan2 20):
    # contact 128; joint frame (parent transform, errors, attach) 170;
    # FIXED +76, REVOLUTE +133, COMPOUND +430; scatter 36; integrate 287
    common, scatter, integ = 170, 36, 287
    per_joint = {JOINT_FIXED: common + 76 + scatter,
                 JOINT_REVOLUTE: common + 133 + scatter,
                 JOINT_COMPOUND: common + 430 + scatter}
    joints = sum(per_joint.get(int(t), 0) for t in jt)
    per_substep = 128 * C + joints + integ * B
    # the final row evaluates forces once more without integrating
    ops = E * (S * per_substep - integ * B)
    return dict(bytes=bytes_in + bytes_out, ops=ops, per_env_substep=per_substep)


def ptr(t):
    return None if t is None else t.data_ptr()


class PackedConsts:
    """A wrapper's packed per-model constants (``pack_static(soa_static(
    model))``), built once per device and kept alive here, with their
    argument list. ``warp_ptrs(dev)`` gives the kernels' constant
    arguments: body_i, body_f, cbody, cf, the per-body lists adj_off, adj,
    c_off and the length of adj."""

    def __init__(self, model):
        self.model = model
        self._by_dev = {}  # str(dev) -> (packed tensors, pointer list)

    def warp_ptrs(self, dev) -> list:
        key = str(dev)
        if key not in self._by_dev:
            c = pack_static(soa_static(self.model, dev))
            args = [ptr(c[n]) for n in ("body_i", "body_f", "cbody", "cf", "adj_off", "adj",
                                        "c_off")] + [int(c["adj"].numel())]
            self._by_dev[key] = (c, args)
        return self._by_dev[key][1]

    def dof_index(self, dev) -> torch.Tensor:
        """``dof_index(model)`` as a long tensor on ``dev``, copied once."""
        key = "dof_index " + str(dev)
        if key not in self._by_dev:
            self._by_dev[key] = torch.as_tensor(dof_index(self.model), dtype=torch.long,
                                                device=dev)
        return self._by_dev[key]


def envs_per_cta(E: int) -> int:
    """Envs (warps) per CTA of the kernels: the largest of
    ``ENVS_PER_CTA`` whose grid of ceil(E / k) CTAs still has at least
    ``MIN_CTAS`` CTAs, else 1 (512 envs: 4, 128 CTAs; 4096: 8, 512 CTAs).
    The last CTA of a ragged E holds the remaining envs."""
    for k in ENVS_PER_CTA:
        if -(-int(E) // k) >= MIN_CTAS:
            return k
    return 1


def sim_args(model, dt: float) -> list:
    """dt, the angular decay, gravity and the attach gains, as every launch
    entry point takes them."""
    g = model.gravity
    return [float(dt), 1.0 - 0.1 * float(dt), float(g[0]), float(g[1]), float(g[2]),
            float(model.joint_attach_ke), float(model.joint_attach_kd)]


def launch_tail(model, dt: float, dev, E: int) -> list:
    """The arguments every launch entry point ends with: ``sim_args``, the
    envs per CTA for E envs and the stream."""
    return sim_args(model, dt) + [envs_per_cta(E), torch.cuda.current_stream(dev).cuda_stream]


def check_bodies(name: str, B: int, max_b: int):
    if B > max_b:
        raise ValueError("%s supports at most %d bodies, got %d" % (name, max_b, B))


def check_device(name: str, dev: torch.device):
    """A kernel launches on the current CUDA device (one process per card):
    tensors on another card raise."""
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        raise ValueError("%s got tensors on %s but the current device is cuda:%d"
                         % (name, dev, torch.cuda.current_device()))


def check_inputs(name: str, model, state: SimState, joint_targets, joint_acts, S: int,
                 planes):
    """Checks a launch's inputs: float32 on the state's device, which is the
    current CUDA device, state (E,B,7)/(E,B,6), targets and acts
    (S,E,n_qd), parameter planes of lane 1 or E."""
    dev = state.body_q.device
    check_device(name, dev)
    E, B, n_qd = state.body_q.shape[0], model.n_links, model.n_qd
    tensors = [state.body_q, state.body_qd, joint_targets] + list(planes)
    if joint_acts is not None:
        tensors.append(joint_acts)
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("%s takes float32 tensors and parameters on %s" % (name, dev))
    if state.body_q.shape != (E, B, 7) or state.body_qd.shape != (E, B, 6):
        raise ValueError("state must be (E,B,7)/(E,B,6), got %s/%s"
                         % (tuple(state.body_q.shape), tuple(state.body_qd.shape)))
    if joint_targets.shape != (S, E, n_qd) or (
            joint_acts is not None and joint_acts.shape != joint_targets.shape):
        raise ValueError("joint targets/acts must be (S, E, n_qd) = (%d, %d, %d)" % (S, E, n_qd))
    for p in planes:
        if p.shape[-1] not in (1, E):
            raise ValueError("a parameter plane has lane width %d, not 1 or E=%d"
                             % (p.shape[-1], E))


def _kernel_lib():
    """The built soa_window library with its C signatures declared."""
    lib = kbuild.load(KERNEL)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.soa_window_max_bodies.argtypes = []
    lib.soa_window_max_bodies.restype = I
    lib.soa_window_launch.argtypes = (
        [P] * 8  # bq0 bqd0 tgt act body_i body_f cbody cf
        + [P] * 3 + [I]  # adj_off adj c_off, len(adj)
        + [P, I] * 4  # gains inv_m inertia inv_inertia, each with its per-env flag
        + [P] * 4  # out_q out_qd out_grf out_jaf
        + [I] * 6  # E B n_qd C F sub
        + [Fl] * 7  # dt ang_decay gx gy gz attach_ke attach_kd
        + [I, P]  # envs per CTA, stream
    )
    lib.soa_window_launch.restype = I
    return lib


class SoaWindow:
    """Whole-window forward rollout (pallas_soa.py:1094-1269 build_soa_window).

    ``run(state, joint_targets (S,E,n_qd), joint_acts (S,E,n_qd) or None,
    params) -> (body_q (F,E,B,7), body_qd (F,E,B,6), grf (F,E,B,6),
    jaf (F,E,B,6))`` with S = substeps*(F-1)+1. Rows 0..F-2 are the states
    entering each interval and the grf/jaf of its first substep; row F-1 is
    the final state with the last substep's observables. ``params`` is a
    per-call input, so swapping a checkpoint needs no rebuild.

    CPU tensors run the plain version (``integrator.rollout``); CUDA tensors
    launch ``csrc/soa_window.cu``, counted in ``self.launches``, or raise.
    While the profiler records, each call is the span ``window``.
    The kernel runs one warp per env, ``envs_per_cta(E)`` envs per CTA,
    reads the state and the targets/acts in the caller's layout and writes
    the four (F,E,B,·) outputs directly: the wrapper copies nothing
    (``.contiguous()`` is a no-op on the server's and the eval's
    tensors)."""

    def __init__(self, integrator: SemiImplicitIntegrator, dt: float,
                 substeps: int, n_frames: int):
        self.integrator = integrator
        self.model = integrator.model
        self.dt = float(dt)
        self.sub = int(substeps)
        self.F = int(n_frames)
        if self.F < 2 or self.sub < 1:
            raise ValueError("need n_frames >= 2 and substeps >= 1")
        self._consts = PackedConsts(self.model)
        self.launches = 0  # kernel launches of this wrapper

    def __call__(self, state: SimState, joint_targets, joint_acts, params: SimParams):
        with spans.span("window"):
            if params.joint_X_p is not None or params.body_com is not None:
                raise ValueError("SoaWindow takes joint_X_p and body_com from the model (K1 has "
                                 "no anchor or COM planes); live anchors go through the "
                                 "with_xp interval kernels")
            dev = state.body_q.device
            S = self.sub * (self.F - 1) + 1
            if joint_targets.shape[0] != S:
                raise ValueError(
                    "joint_targets has %d rows; the window needs %d" % (joint_targets.shape[0], S)
                )
            if dev.type == "cpu":
                return rollout(self.integrator, params, state, joint_targets,
                               joint_acts, None, self.dt, self.sub)
            if dev.type != "cuda":
                raise ValueError("SoaWindow runs on cpu or cuda tensors, not %s" % dev)
            return self._launch(state, joint_targets, joint_acts, params)

    def _launch(self, state, joint_targets, joint_acts, params):
        model = self.model
        E, B, F = state.body_q.shape[0], model.n_links, self.F
        lib = _kernel_lib()
        check_bodies(KERNEL, B, lib.soa_window_max_bodies())
        planes = traced_planes(model, params,
                               self._consts.dof_index(params.joint_target_ke.device))
        check_inputs(KERNEL, model, state, joint_targets, joint_acts, joint_targets.shape[0],
                     planes.values())
        bq, bqd = state.body_q.contiguous(), state.body_qd.contiguous()
        tgt = joint_targets.contiguous()
        act = None if joint_acts is None else joint_acts.contiguous()
        dev = bq.device
        f32 = dict(dtype=torch.float32, device=dev)
        out_q = torch.empty((F, E, B, 7), **f32)
        out_qd, out_grf, out_jaf = (torch.empty((F, E, B, 6), **f32) for _ in range(3))

        pe = lambda n: int(planes[n].shape[-1] == E and E > 1)
        status = lib.soa_window_launch(
            ptr(bq), ptr(bqd), ptr(tgt), ptr(act), *self._consts.warp_ptrs(dev),
            ptr(planes["gains"]), pe("gains"), ptr(planes["inv_m"]), pe("inv_m"),
            ptr(planes["inertia"]), pe("inertia"),
            ptr(planes["inv_inertia"]), pe("inv_inertia"),
            ptr(out_q), ptr(out_qd), ptr(out_grf), ptr(out_jaf),
            E, B, model.n_qd, model.contact_count, F, self.sub,
            *launch_tail(model, self.dt, dev, E),
        )
        kbuild.check(status, KERNEL)
        self.launches += 1
        return out_q, out_qd, out_grf, out_jaf


def rollout_work(model, E: int, substeps: int) -> dict:
    """Bytes one bench-rollout launch must move and fp32 operations it must
    do, for the kernel's roofline bound: the state, targets, acts (the bench
    passes zeros, as bench.py does), shared planes and constants read once,
    the final state written once; ``window_work``'s operation count per
    env-substep, S full substeps."""
    B, C, n_qd = model.n_links, model.contact_count, model.n_qd
    S = int(substeps)
    f4 = 4
    per = window_work(model, E, S, 2)["per_env_substep"]
    seq = 2 * S * n_qd * E
    bytes_in = (13 * B * E + seq) * f4 + (2 * 3 * B + B + 2 * 9 * B) * f4 + (
        B * (5 + 32) + C * 9) * f4
    bytes_out = 13 * B * E * f4
    return dict(bytes=bytes_in + bytes_out, ops=E * S * per, per_env_substep=per)


def _rollout_lib():
    """The built soa_rollout library with its C signatures declared."""
    lib = kbuild.load(KERNEL_ROLLOUT)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.soa_rollout_max_bodies.argtypes = []
    lib.soa_rollout_max_bodies.restype = I
    lib.soa_rollout_launch.argtypes = (
        [P] * 4  # bq0 bqd0 tgt act
        + [P] * 4  # body_i body_f cbody cf
        + [P] * 3 + [I]  # adj_off adj c_off, len(adj)
        + [P] * 4  # gains inv_m inertia inv_inertia (lane 1)
        + [P] * 2  # out_q out_qd
        + [I] * 5  # E B n_qd C S
        + [Fl] * 7  # dt ang_decay gx gy gz attach_ke attach_kd
        + [I, P]  # envs per CTA, stream
    )
    lib.soa_rollout_launch.restype = I
    return lib


class SoaRollout:
    """S forward substeps, final state only (pallas_soa.py:1272-1351
    build_soa_rollout): the bench's rollout kernel.

    ``run(state (E,B,7)/(E,B,6), joint_targets (S,E,n_qd), joint_acts
    (S,E,n_qd) or None) -> SimState`` after S substeps, residual forces
    zero. The parameters are baked in at construction as lane-1 planes.

    CPU tensors run the plain version (``integrator.rollout_substeps``);
    CUDA tensors launch ``csrc/soa_rollout.cu``, counted in
    ``self.launches``, or raise. The kernel runs one warp per env,
    ``envs_per_cta(E)`` envs per CTA, and reads the state and the
    targets/acts in the caller's layout and writes the final (E,B,7)/(E,B,6)
    state directly: the wrapper copies nothing (``.contiguous()`` is a no-op
    on the bench's tensors)."""

    def __init__(self, integrator: SemiImplicitIntegrator, params: SimParams, dt: float,
                 substeps: int):
        if (params.joint_target_ke.ndim != 1 or params.joint_target_kd.ndim != 1
                or params.body_inv_mass.ndim != 1 or params.body_inertia.ndim != 3):
            raise ValueError("build_soa_rollout bakes in shared parameters; per-env "
                             "gains, masses or inertias are not supported")
        if params.joint_X_p is not None or params.body_com is not None:
            raise ValueError("build_soa_rollout takes joint_X_p and body_com from the model")
        self.integrator = integrator
        self.model = integrator.model
        self.params = SimParams(*(None if x is None else x.detach() for x in params))
        self.dt = float(dt)
        self.S = int(substeps)
        if self.S < 1:
            raise ValueError("need substeps >= 1")
        self.planes = {n: p.detach() for n, p in traced_planes(self.model, self.params).items()}
        self._consts = PackedConsts(self.model)
        self.launches = 0  # kernel launches of this wrapper

    def __call__(self, state: SimState, joint_targets, joint_acts=None) -> SimState:
        dev = state.body_q.device
        if joint_targets.shape[0] != self.S:
            raise ValueError("joint_targets has %d rows; the rollout runs %d substeps"
                             % (joint_targets.shape[0], self.S))
        if dev.type == "cpu":
            return rollout_substeps(self.integrator, self.params, state, joint_targets,
                                    joint_acts, self.dt)
        if dev.type != "cuda":
            raise ValueError("SoaRollout runs on cpu or cuda tensors, not %s" % dev)
        return self._launch(state, joint_targets, joint_acts)

    def _launch(self, state, joint_targets, joint_acts):
        model = self.model
        E, B = state.body_q.shape[0], model.n_links
        lib = _rollout_lib()
        check_bodies(KERNEL_ROLLOUT, B, lib.soa_rollout_max_bodies())
        pl = self.planes
        check_inputs(KERNEL_ROLLOUT, model, state, joint_targets, joint_acts, self.S,
                     pl.values())
        bq, bqd = state.body_q.contiguous(), state.body_qd.contiguous()
        tgt = joint_targets.contiguous()
        act = None if joint_acts is None else joint_acts.contiguous()
        dev = bq.device
        out_q = torch.empty((E, B, 7), dtype=torch.float32, device=dev)
        out_qd = torch.empty((E, B, 6), dtype=torch.float32, device=dev)
        status = lib.soa_rollout_launch(
            ptr(bq), ptr(bqd), ptr(tgt), ptr(act), *self._consts.warp_ptrs(dev),
            ptr(pl["gains"]), ptr(pl["inv_m"]), ptr(pl["inertia"]), ptr(pl["inv_inertia"]),
            ptr(out_q), ptr(out_qd),
            E, B, model.n_qd, model.contact_count, self.S,
            *launch_tail(model, self.dt, dev, E),
        )
        kbuild.check(status, KERNEL_ROLLOUT)
        self.launches += 1
        return SimState(out_q, out_qd)


def build_soa_rollout(integrator: SemiImplicitIntegrator, params: SimParams, dt: float,
                      substeps: int) -> SoaRollout:
    """The bench rollout (pallas_soa.py:1272 build_soa_rollout, without the
    TPU-only ``e_tile`` and ``interpret``)."""
    return SoaRollout(integrator, params, dt, substeps)
