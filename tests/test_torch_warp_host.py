"""The port's CUDA kernels (K1 in csrc/soa_window.cu, K2 and K3 in
csrc/soa_interval.cu, K4 in csrc/soa_rollout.cu), all one warp per env,
compiled as host C++ and checked on the CPU.

The kernels are written as phases of per-lane functions separated by
__syncwarp() (csrc/substep_warp.cuh). The stub header below stands in for
cuda_runtime.h: it defines SOA_HOST_WARP and the warp macros so that one
host thread runs a warp's 32 lanes one after another, phase by phase, and
each launch runs its CTAs and their warps in turn. g++ builds the sources
with -ffp-contract=off; the wrappers (``SoaWindow._launch``,
``DiffInterval._forward``/``_backward``, ``SoaRollout._launch``) then call
the host library on CPU tensors.

Held against the plain PyTorch versions on a1, the FIXED/COMPOUND/REVOLUTE
chain and the chain with 45 contacts (two chunks of 32 lanes), E=5 envs
from grounded states (penetrating contacts; on the 45-contact chain,
contacts 31 and 32 on either side of the chunk boundary penetrate), with 1
and 2 envs per CTA (the second leaves the last CTA one env short):

- K4 after 33 substeps: q within 1e-6, qd within 2e-4 (2e-5 of its
  largest entries, 10 at the velocity clamp; two fp32 orders of the same
  arithmetic, measured up to 1.2e-7 and 1.1e-4), and equal bit for bit to
  K2 without export (soa_interval_fwd): both run the same warp substep.
- K1 over a window of F=3 frames (67 substeps): every frame row of q
  within 1e-6 and qd within 2e-4; grf and jaf (N, N m; up to ~550 N) within
  FORCE_TOL of the plain window's, where they carry the two trajectories'
  rounding (jaf holds ke=16000 times a ~1e-7 q difference; measured up to
  2.9e-4 and 3.8e-3), and within OWN_TOL of the plain force pipeline
  evaluated at the kernel's own frame states (measured up to 6.1e-5 and
  5.1e-4: the arithmetic of the observables alone); its frame states equal
  bit for bit to K2 chained over the window's intervals.
- K2 with and without its (S,E,13,B) export, with acts and residual forces,
  shared and per-env planes: the final state and the export against the
  plain ``interval(export=True)`` within K4's limits (q rows 1e-6, qd rows
  2e-4).
- K3 at the plain forward's linearization (it reads the plain interval's
  own substep states): every gradient, per-env plane partials included,
  within 1e-5 of its largest entry; for shared planes the env reduction
  within 1e-5 of the plain gradient's env sum.
- K2/K3 with live joint anchors (``with_xp``: the xp_t, xp_q and rp_local
  planes, per env and shared) against the plain interval with the same
  planes, as above, the anchor planes' gradients within ANCHOR_TOL; and at
  the model's own anchors, K2's states and K3's other gradients equal to
  the baked kernels' bit for bit.

Skips without a host C++ compiler.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ppr_diffphys_torch.sim.builder as tbuilder
import ppr_diffphys_torch.sim.import_urdf as timport
from ppr_diffphys_torch.csrc import build as kbuild
from ppr_diffphys_torch.sim import integrator as tint
from ppr_diffphys_torch.sim import soa, soa_grad, synthetic
from ppr_diffphys_torch.sim.kinematics import eval_fk

import port_helpers as H

DT, SUB, E = 5e-4, 33, 5
FORCE_TOL = dict(grf=2e-3, jaf=2e-2)
# K3's anchor-plane gradients against autograd of the plain interval, as a
# share of each gradient's largest entry: the plain version composes the
# parent transform with transform_mul and its arm with quat_rotate of
# rp_local, the kernel with qmul/qrot in another order, and xp_q's
# cotangent collects every term of the joint law (measured up to 1.1e-5 on
# the 45-contact chain)
ANCHOR_TOL = 5e-5
OWN_TOL = dict(grf=2e-4, jaf=2e-3)

STUB = r"""
#pragma once
#include <math.h>
#include <stddef.h>
#define SOA_HOST_WARP 1
struct HostDim { unsigned x = 0, y = 0, z = 0; };
static HostDim threadIdx, blockIdx, blockDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __syncthreads()
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
static inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 232448; return cudaSuccess;
}
template <class F>
static inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
// a warp program: one host thread runs the 32 lanes, phase by phase
#define LANES Lane* lanes_
#define LANES_ARG lanes_
#define WARP_LANES Lane lanes_[32]; for (int l_ = 0; l_ < 32; ++l_) lanes_[l_].lane = l_
#define PHASE(...) for (int l_ = 0; l_ < 32; ++l_) { Lane& L = lanes_[l_]; __VA_ARGS__; }
#define WARP_XOR_ADD(field, off) do { float t_[32]; \
  for (int l_ = 0; l_ < 32; ++l_) t_[l_] = lanes_[l_].field; \
  for (int l_ = 0; l_ < 32; ++l_) lanes_[l_].field = t_[l_] + t_[l_ ^ (off)]; } while (0)
// every warp of a CTA stages all of the CTA's constants (warps run in turn)
#define CTA_FOR(i, n) for (int i = 0; i < (n); ++i)
#define DYN_SHARED(name) static float name[1 << 18]
#define cp_async4(dst, src) (*(dst) = *(src))
#define cp_async_commit()
#define cp_async_wait(n)
// a launch: CTAs in turn, and in each its warps in turn
template <class K> struct HostLaunch {
  K k; unsigned grid, block;
  template <class... A> void operator()(A... args) const {
    blockDim.x = block;
    for (blockIdx.x = 0; blockIdx.x < grid; ++blockIdx.x)
      for (threadIdx.x = 0; threadIdx.x < block; threadIdx.x += 32) k(args...);
  }
};
#define LAUNCH_WARPS(kernel, grid, warps, smem, stream) \
  HostLaunch<decltype(&kernel)>{&kernel, (unsigned)(grid), 32u * (unsigned)(warps)}
"""


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) to build the CUDA sources as C++")
    d = tmp_path_factory.mktemp("warp_host")
    (d / "cuda_runtime.h").write_text(STUB)
    libs = {}
    for name in (soa.KERNEL, soa_grad.KERNEL, soa.KERNEL_ROLLOUT):
        out = d / ("lib%s.so" % name)
        cmd = [cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-x", "c++",
               "-I", str(d), "-o", str(out), str(kbuild.SRC_DIR / (name + ".cu"))]
        res = subprocess.run(cmd, capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        libs[name] = ctypes.CDLL(str(out))
    return libs


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """The wrappers' kernel libraries are the host builds; the stream is 0."""
    monkeypatch.setattr(kbuild, "load", lambda name: host_libs[name])

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())

    def envs_per_cta(k):
        monkeypatch.setattr(soa, "envs_per_cta", lambda E: k)
        monkeypatch.setattr(soa_grad, "envs_per_cta", lambda E: k)

    return envs_per_cta


def _model(name):
    if name == "a1":
        return H.a1_model(tbuilder, timport)
    if name == "chain45":
        return synthetic.chain_model(extra_boxes=True)
    return synthetic.chain_model()


def _problem(model, per_env, seed=11, rows=SUB):
    """A grounded state of E envs, ``rows`` substeps of targets and acts
    (S,E,n_qd), and shared or per-env parameters."""
    F = 2 if rows <= SUB + 1 else (rows - 2) // SUB + 2
    q, qd, tgt, act = synthetic.window_problem(model, E, SUB, F, seed)
    bq, bqd = eval_fk(model, torch.as_tensor(q), torch.as_tensor(qd))
    bq = synthetic.grounded(model, bq.numpy(), seed)
    cb = model.contact_body
    y = (bq[:, cb, 1] + synthetic._qrot_np(bq[:, cb, 3:7], model.contact_point[None])[..., 1]
         - model.contact_dist[None])
    assert (y < 0).any(), "no contact penetrates"
    if model.contact_count > 32:
        assert (y[:, 31] < 0).any() and (y[:, 32] < 0).any(), "the chunk boundary is idle"
    ke, kd, mass, norm_I = synthetic.sim_params_np(model, E if per_env else None, seed)
    t = torch.as_tensor
    I = t(norm_I) * t(mass)[..., None, None]
    params = tint.SimParams(t(mass), 1.0 / t(mass), I, torch.linalg.inv(I), t(ke), t(kd))
    return tint.SimState(t(bq), bqd), t(tgt[:rows]), t(act[:rows]), params


def test_envs_per_cta_geometry():
    """The grid covers every env, the last CTA holds the remainder, and the
    training (512) and bench (4096) widths get 4 and 8 envs per CTA."""
    assert soa.envs_per_cta(512) == 4 and -(-512 // 4) == 128
    assert soa.envs_per_cta(4096) == 8 and -(-4096 // 8) == 512
    for n in (1, 3, 37, 127, 128, 255, 256, 257, 511, 1027, 4095, 4096, 10000):
        k = soa.envs_per_cta(n)
        assert k in soa.ENVS_PER_CTA
        grid = -(-n // k)
        assert grid * k >= n and (grid - 1) * k < n  # covers E; the tail CTA is not empty
        assert grid >= soa.MIN_CTAS or k == 1  # fewer envs per CTA before too few CTAs
        bigger = [j for j in soa.ENVS_PER_CTA if j > k]
        assert all(-(-n // j) < soa.MIN_CTAS for j in bigger)


def test_contribution_lists():
    """pack_static's per-body lists: contacts as contiguous ranges of the
    body-sorted cbody, joint wrenches in body order (child 2j, parent
    2j+1), exactly the thread loop's scatter."""
    for name in ("a1", "chain", "chain45"):
        model = _model(name)
        pk = soa.pack_static(soa.soa_static(model))
        cb = np.asarray(model.contact_body)
        c_off = pk["c_off"].numpy()
        for b in range(model.n_links):
            assert (cb[c_off[b]:c_off[b + 1]] == b).all()
        assert c_off[0] == 0 and c_off[-1] == model.contact_count
        adj_off, adj = pk["adj_off"].numpy(), pk["adj"].numpy()
        for b in range(model.n_links):
            want = []
            for j in range(model.n_links):
                if model.joint_type[j] not in (1, 3, 4):  # REVOLUTE, FIXED, COMPOUND
                    continue
                if j == b:
                    want.append(2 * j)
                if model.joint_parent[j] == b:
                    want.append(2 * j + 1)
            assert list(adj[adj_off[b]:adj_off[b + 1]]) == want


@pytest.mark.parametrize("epc", [1, 2])
@pytest.mark.parametrize("name", ["a1", "chain", "chain45"])
def test_host_rollout_kernel(on_host, name, epc):
    on_host(epc)
    model = _model(name)
    state, tgt, act, params = _problem(model, False)
    integ = tint.SemiImplicitIntegrator(model)
    k4 = soa.build_soa_rollout(integ, params, DT, SUB)
    planes = soa.traced_planes(model, params)
    di = soa_grad.DiffInterval(integ, DT, SUB, with_act=True)
    for acts in (act, None):
        out = k4._launch(state, tgt, acts)
        ref = tint.rollout_substeps(integ, params, state, tgt, acts, DT)
        with torch.no_grad():
            cf = tint.eval_body_contacts(model, params, state)
        assert float(cf[..., 3:].abs().max()) > 1.0  # contacts push
        assert torch.isfinite(out.body_q).all() and torch.isfinite(out.body_qd).all()
        torch.testing.assert_close(out.body_q, ref.body_q, rtol=0, atol=1e-6)
        torch.testing.assert_close(out.body_qd, ref.body_qd, rtol=0, atol=2e-4)
        zeros = torch.zeros_like(tgt)
        bq, bqd, _ = di._forward(
            state.body_q.permute(2, 1, 0), state.body_qd.permute(2, 1, 0),
            tgt.permute(0, 2, 1), (zeros if acts is None else acts).permute(0, 2, 1),
            None, [planes[n] for n in soa.TRACED_NAMES], False)
        assert torch.equal(bq.permute(2, 1, 0), out.body_q)
        assert torch.equal(bqd.permute(2, 1, 0), out.body_qd)
    assert k4.launches == 2


def _plane_list(model, params):
    planes = soa.traced_planes(model, params)
    return [planes[n] for n in soa.TRACED_NAMES]


def _inner(state, tgt, act):
    """The state, targets and acts in the interval kernels' env-innermost
    layout: (7,B,E), (6,B,E), (S,n_qd,E)."""
    return (state.body_q.permute(2, 1, 0).contiguous(),
            state.body_qd.permute(2, 1, 0).contiguous(),
            tgt.permute(0, 2, 1).contiguous(), act.permute(0, 2, 1).contiguous())


@pytest.mark.parametrize("epc", [1, 2])
@pytest.mark.parametrize("name", ["a1", "chain", "chain45"])
def test_host_window_kernel(on_host, name, epc):
    """K1 over F=3 frames against the plain window, shared (1 env per CTA)
    and per-env (2) planes, random and no acts; its frame states equal K2
    chained over the window's intervals bit for bit."""
    on_host(epc)
    model = _model(name)
    F = 3
    state, tgt, act, params = _problem(model, epc == 2, rows=SUB * (F - 1) + 1)
    integ = tint.SemiImplicitIntegrator(model)
    window = soa.SoaWindow(integ, DT, SUB, F)
    di = soa_grad.DiffInterval(integ, DT, SUB, with_act=True)
    pl = _plane_list(model, params)
    for acts in (act, None):
        out = window._launch(state, tgt, acts, params)
        ref = tint.rollout(integ, params, state, tgt, acts, None, DT, SUB)
        assert all(bool(torch.isfinite(x).all()) for x in out)
        assert float(out[2][..., 3:].abs().max()) > 1.0  # contacts push
        for x, y, tol in zip(out, ref, (1e-6, 2e-4, FORCE_TOL["grf"], FORCE_TOL["jaf"])):
            torch.testing.assert_close(x, y, rtol=0, atol=tol)
        for f in range(F):
            s = f * SUB
            with torch.no_grad():
                _, grf, jaf = integ.compute_forces(
                    params, tint.SimState(out[0][f], out[1][f]), tgt[s],
                    None if acts is None else acts[s], None)
            torch.testing.assert_close(out[2][f], grf, rtol=0, atol=OWN_TOL["grf"])
            torch.testing.assert_close(out[3][f], jaf, rtol=0, atol=OWN_TOL["jaf"])
        bq, bqd, tp, ap = _inner(state, tgt, torch.zeros_like(tgt) if acts is None else acts)
        for f in range(F - 1):
            sl = slice(f * SUB, (f + 1) * SUB)
            bq, bqd, _ = di._forward(bq, bqd, tp[sl], ap[sl], None, pl, False)
            assert torch.equal(bq.permute(2, 1, 0), out[0][f + 1])
            assert torch.equal(bqd.permute(2, 1, 0), out[1][f + 1])
    assert window.launches == 2


@pytest.mark.parametrize("case", [
    ("a1", 1, True, True, False),
    ("a1", 2, False, False, True),
    ("chain", 2, True, False, True),
    ("chain45", 1, False, True, True),
    ("chain45", 2, True, True, False),
], ids=lambda c: "%s-epc%d-%s%s-%s" % (c[0], c[1], "act" if c[2] else "noact",
                                       "-res" if c[3] else "", "per_env" if c[4] else "shared"))
def test_host_interval_forward(on_host, case):
    """K2 with and without its export against the plain
    ``interval(export=True)``: the final state and every exported substep
    entry state."""
    name, epc, with_act, with_res, per_env = case
    on_host(epc)
    model = _model(name)
    state, tgt, act, params = _problem(model, per_env)
    res = torch.as_tensor(np.random.RandomState(3).randn(SUB, 6, model.n_links, E)
                          .astype(np.float32) * 0.1)
    integ = tint.SemiImplicitIntegrator(model)
    di = soa_grad.DiffInterval(integ, DT, SUB, with_res=with_res, with_act=with_act)
    pl = _plane_list(model, params)
    bq, bqd, tp, ap = _inner(state, tgt, act)
    a_in, r_in = (ap if with_act else None), (res if with_res else None)
    rq, rqd, rs = tint.interval(integ, DT, bq, bqd, tp, a_in, r_in, *pl, export=True)
    q, qd, sst = di._forward(bq, bqd, tp, a_in, r_in, pl, True)
    for x, y, tol in ((q, rq, 1e-6), (qd, rqd, 2e-4), (sst[:, :, :7], rs[:, :, :7], 1e-6),
                      (sst[:, :, 7:], rs[:, :, 7:], 2e-4)):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=0, atol=tol)
    q2, qd2, none = di._forward(bq, bqd, tp, a_in, r_in, pl, False)
    assert none is None and torch.equal(q2, q) and torch.equal(qd2, qd)
    assert di.launches[soa_grad.KERNEL_FWD] == 2


def _grads(model, params, state, tgt, act, res, with_act, with_res, shared):
    """(plain, kernel) gradients of sum(w * outputs) at the plain
    linearization: bq0, bqd0, tgt, [act], [res], then the four planes (per
    env), then for shared planes the env sums (plain) and K3's reduction."""
    integ = tint.SemiImplicitIntegrator(model)
    di = soa_grad.DiffInterval(integ, DT, SUB, with_res=with_res, with_act=with_act)
    rng = np.random.RandomState(11)
    B = model.n_links
    w = (torch.as_tensor(rng.randn(7, B, E).astype(np.float32)),
         torch.as_tensor(rng.randn(6, B, E).astype(np.float32)))
    planes = soa.traced_planes(model, params)
    pl = [planes[n] for n in soa.TRACED_NAMES]
    wide = [p.expand(*p.shape[:-1], E).contiguous().requires_grad_() for p in pl]
    seq = [tgt.permute(0, 2, 1).contiguous(), act.permute(0, 2, 1).contiguous(), res]
    ins = [state.body_q.permute(2, 1, 0).contiguous().requires_grad_(),
           state.body_qd.permute(2, 1, 0).contiguous().requires_grad_()] + [
        x.clone().requires_grad_() for x in seq]
    a_in = ins[3] if with_act else None
    r_in = ins[4] if with_res else None
    q, qd, sst = tint.interval(integ, DT, ins[0], ins[1], ins[2], a_in, r_in, *wide, export=True)
    used = ins[:3] + ([ins[3]] if with_act else []) + ([ins[4]] if with_res else [])
    plain = list(torch.autograd.grad((q * w[0]).sum() + (qd * w[1]).sum(), used + wide))
    sq = [x.detach() for x in seq]
    dbq, dbqd, dtgt, dact, dres, dwide = di._backward(
        sst, sq[0], sq[1] if with_act else None, sq[2] if with_res else None,
        [x.detach() for x in wide], w[0], w[1])
    got = [dbq, dbqd, dtgt] + ([dact] if with_act else []) + ([dres] if with_res else []) + list(
        dwide)
    if shared:
        red = di._backward(sst, sq[0], sq[1] if with_act else None, sq[2] if with_res else None,
                           pl, w[0], w[1])[5]
        plain += [g.sum(-1, keepdim=True) for g in plain[-4:]]
        got += list(red)
    assert di.launches[soa_grad.KERNEL_BWD] == (2 if shared else 1)
    assert di.launches[soa_grad.KERNEL_REDUCE] == (1 if shared else 0)
    return plain, got


@pytest.mark.parametrize("case", [
    ("a1", 1, False, False, True),  # the training configuration: no act, no res, shared
    ("a1", 2, True, True, True),
    ("chain", 2, True, True, False),
    ("chain45", 1, True, False, False),
    ("chain45", 2, False, True, True),
], ids=lambda c: "%s-epc%d-%s%s-%s" % (c[0], c[1], "act" if c[2] else "noact",
                                       "-res" if c[3] else "", "shared" if c[4] else "per_env"))
def test_host_interval_backward(on_host, case):
    name, epc, with_act, with_res, shared = case
    on_host(epc)
    model = _model(name)
    state, tgt, act, params = _problem(model, not shared)
    res = torch.as_tensor(np.random.RandomState(3).randn(SUB, 6, model.n_links, E)
                          .astype(np.float32) * 0.1)
    plain, got = _grads(model, params, state, tgt, act, res, with_act, with_res, shared)
    assert len(plain) == len(got)
    for i, (a, b) in enumerate(zip(plain, got)):
        assert a.shape == b.shape, i
        assert torch.isfinite(b).all(), i
        err = float((a - b).abs().max()) / (float(a.abs().max()) + 1e-30)
        assert err <= 1e-5, (i, err)


def _xp_planes(model, per_env, seed=5):
    """Live anchors near the model's as lane-E (per env) or lane-1 planes."""
    xp = synthetic.perturbed_anchors(model, E if per_env else None, seed)
    planes = soa.xp_planes(model, torch.as_tensor(xp))
    return [planes[n] for n in soa.XP_NAMES]


@pytest.mark.parametrize("case", [
    ("a1", 1, False, True),
    ("a1", 2, True, False),
    ("chain", 2, True, True),
    ("chain45", 1, True, False),
    ("chain45", 2, False, True),
], ids=lambda c: "%s-epc%d-%s-%s" % (c[0], c[1], "act" if c[2] else "noact",
                                     "per_env" if c[3] else "shared"))
def test_host_interval_live_anchors(on_host, case):
    """K2/K3 with live joint anchors (``with_xp``): K2's final state and
    export against the plain interval with the anchor planes (K4's limits),
    and K3 at the plain linearization against autograd of the plain
    interval, every gradient within 1e-5 of its largest entry and the three
    anchor planes' (per env) within ANCHOR_TOL; shared planes' env
    reduction within the same limits of the plain env sum."""
    name, epc, with_act, per_env = case
    on_host(epc)
    model = _model(name)
    state, tgt, act, params = _problem(model, False)
    integ = tint.SemiImplicitIntegrator(model)
    di = soa_grad.DiffInterval(integ, DT, SUB, with_act=with_act, with_xp=True)
    pl = _plane_list(model, params) + _xp_planes(model, per_env)
    bq, bqd, tp, ap = _inner(state, tgt, act)
    a_in = ap if with_act else None
    rq, rqd, rs = tint.interval(integ, DT, bq, bqd, tp, a_in, None, *pl, export=True)
    q, qd, sst = di._forward(bq, bqd, tp, a_in, None, pl, True)
    for x, y, tol in ((q, rq, 1e-6), (qd, rqd, 2e-4), (sst[:, :, :7], rs[:, :, :7], 1e-6),
                      (sst[:, :, 7:], rs[:, :, 7:], 2e-4)):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=0, atol=tol)
    # the anchors moved the trajectory: the check is not the baked one
    base = di._forward(bq, bqd, tp, a_in, None, _plane_list(model, params)
                       + [soa.xp_planes(model, torch.as_tensor(model.joint_X_p))[n]
                          for n in soa.XP_NAMES], False)
    assert float((base[0] - q).abs().max()) > 1e-4

    rng = np.random.RandomState(11)
    B = model.n_links
    w = (torch.as_tensor(rng.randn(7, B, E).astype(np.float32)),
         torch.as_tensor(rng.randn(6, B, E).astype(np.float32)))
    wide = [p.expand(*p.shape[:-1], E).contiguous().requires_grad_() for p in pl]
    ins = [bq.clone().requires_grad_(), bqd.clone().requires_grad_(), tp.clone().requires_grad_()]
    if with_act:
        ins.append(ap.clone().requires_grad_())
    pq, pqd, psst = tint.interval(integ, DT, ins[0], ins[1], ins[2],
                                  ins[3] if with_act else None, None, *wide, export=True)
    plain = list(torch.autograd.grad((pq * w[0]).sum() + (pqd * w[1]).sum(), ins + wide))
    dbq, dbqd, dtgt, dact, _, dwide = di._backward(
        psst, tp, a_in, None, [x.detach() for x in wide], w[0], w[1])
    got = [dbq, dbqd, dtgt] + ([dact] if with_act else []) + list(dwide)
    red = di._backward(psst, tp, a_in, None, pl, w[0], w[1])[5]
    shared = [i for i, p in enumerate(pl) if p.shape[-1] == 1]
    plain += [plain[len(ins) + i].sum(-1, keepdim=True) for i in shared]
    got += [red[i] for i in shared]
    anchor = {len(ins) + i for i in range(4, 7)} | {
        len(ins) + len(pl) + k for k, i in enumerate(shared) if i >= 4}
    assert len(plain) == len(got)
    for i, (a, b) in enumerate(zip(plain, got)):
        assert a.shape == b.shape, i
        assert torch.isfinite(b).all(), i
        err = float((a - b).abs().max()) / (float(a.abs().max()) + 1e-30)
        assert err <= (ANCHOR_TOL if i in anchor else 1e-5), (i, err)
    assert float(dwide[-3].abs().max()) > 0  # the anchor's arm has a gradient
    assert di.launches[soa_grad.KERNEL_REDUCE] == 1


@pytest.mark.parametrize("name", ["a1", "chain45"])
def test_host_model_anchors_live_equal_baked(on_host, name):
    """The model's own anchors passed as lane-1 planes (``with_xp``) give
    K2's states and every other K3 gradient of the baked kernels bit for
    bit: only where the anchors are read from differs."""
    on_host(2)
    model = _model(name)
    state, tgt, act, params = _problem(model, True)
    integ = tint.SemiImplicitIntegrator(model)
    baked = soa_grad.DiffInterval(integ, DT, SUB, with_act=True)
    live = soa_grad.DiffInterval(integ, DT, SUB, with_act=True, with_xp=True)
    pl = _plane_list(model, params)
    xp = soa.xp_planes(model, torch.as_tensor(model.joint_X_p))
    static = soa.soa_static(model)
    for n in soa.XP_NAMES:
        assert torch.equal(xp[n], static[n])
    bq, bqd, tp, ap = _inner(state, tgt, act)
    q0, qd0, s0 = baked._forward(bq, bqd, tp, ap, None, pl, True)
    q1, qd1, s1 = live._forward(bq, bqd, tp, ap, None, pl + [xp[n] for n in soa.XP_NAMES], True)
    assert torch.equal(q0, q1) and torch.equal(qd0, qd1) and torch.equal(s0, s1)
    rng = np.random.RandomState(2)
    dq = torch.as_tensor(rng.randn(7, model.n_links, E).astype(np.float32))
    dqd = torch.as_tensor(rng.randn(6, model.n_links, E).astype(np.float32))
    g0 = baked._backward(s0, tp, ap, None, pl, dq, dqd)
    g1 = live._backward(s1, tp, ap, None, pl + [xp[n] for n in soa.XP_NAMES], dq, dqd)
    for a, b in zip(g0[:4] + tuple(g0[5]), g1[:4] + tuple(g1[5][:4])):
        assert torch.equal(a, b)
