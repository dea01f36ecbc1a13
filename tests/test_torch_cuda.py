"""The port's CUDA kernels on the card (marked ``cuda``; they skip on a
machine without a GPU, since a CUDA kernel has no CPU mode). This file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which configures jax.)
"""

import numpy as np
import pytest
import torch

from ppr_diffphys_torch.csrc import build as kbuild
from ppr_diffphys_torch.sim import integrator as tint
from ppr_diffphys_torch.sim import soa, soa_grad, synthetic
import ppr_diffphys_torch.sim.builder as tbuilder
import ppr_diffphys_torch.sim.import_urdf as timport
from ppr_diffphys_torch.sim.kinematics import eval_fk

import port_helpers as H

DT, SUB = 5e-4, 33


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no CPU mode")


def _model(name):
    if name == "chain":
        return synthetic.chain_model()
    if name == "chain45":
        return synthetic.chain_model(extra_boxes=True)
    return H.a1_model(tbuilder, timport)


def _inputs(model, E, F, per_env, dev, seed=5):
    q, qd, tgt, act = synthetic.window_problem(model, E, SUB, F, seed)
    bq, bqd = eval_fk(model, torch.as_tensor(q), torch.as_tensor(qd))
    bq = synthetic.grounded(model, bq.numpy(), seed)
    ke, kd, mass, norm_I = synthetic.sim_params_np(model, E if per_env else None, seed)
    t = lambda x: torch.as_tensor(x, device=dev)
    I = t(norm_I) * t(mass)[..., None, None]
    params = tint.SimParams(t(mass), 1.0 / t(mass), I, torch.linalg.inv(I), t(ke), t(kd))
    state = tint.SimState(t(bq), bqd.to(dev))
    return state, t(tgt), t(act), params


def test_library_path_tracks_the_source():
    """The built library's name carries a hash of the source and flags, in
    the package's git-ignored build directory."""
    for name in (soa.KERNEL, soa_grad.KERNEL, soa.KERNEL_ROLLOUT):
        p = kbuild.library_path(name)
        assert p.parent == kbuild.BUILD_DIR
        assert p.name.startswith("lib%s-" % name) and p.suffix == ".so"
    assert "--use_fast_math" not in kbuild.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kbuild.NVCC_FLAGS


def test_library_path_tracks_the_shared_header(tmp_path, monkeypatch):
    """An edit to a shared header (csrc/substep.cuh, or csrc/substep_warp.cuh,
    which every kernel's source includes) renames (so rebuilds) every
    library."""
    for f in kbuild.SRC_DIR.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kbuild, "SRC_DIR", tmp_path)
    names = (soa.KERNEL, soa_grad.KERNEL, soa.KERNEL_ROLLOUT)
    for header in ("substep.cuh", "substep_warp.cuh"):
        before = {n: kbuild.library_path(n) for n in names}
        with open(tmp_path / header, "a") as f:
            f.write("\n// edited\n")
        for n, p in before.items():
            assert kbuild.library_path(n) != p, (header, n)


@pytest.mark.cuda
@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
@pytest.mark.parametrize("name", ["a1", "chain"])
def test_window_kernel_matches_plain(name, per_env):
    """Kernel vs plain on the card, 66 substeps with penetrating contacts.
    Tolerance: fp32 in another order (FMA contraction) drifts ~linearly with
    the substeps; measured q ~5e-7 after 99 substeps on an H100."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model(name)
    F = 3
    state, tgt, act, params = _inputs(model, 64, F, per_env, dev)
    integ = tint.SemiImplicitIntegrator(model)
    window = soa.SoaWindow(integ, DT, SUB, F)
    for acts in (act, None):
        out = window(state, tgt, acts, params)
        ref = tint.rollout(integ, params, state, tgt, acts, None, DT, SUB)
        torch.cuda.synchronize()
        for a, b, tol in zip(out, ref, (1e-5, 5e-3, 0.1, 0.5)):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=0, atol=tol)
    assert window.launches == 2


@pytest.mark.cuda
def test_server_on_cuda_runs_the_kernel():
    _need_gpu()
    from ppr_diffphys_torch.models.serve import RolloutServer

    server = RolloutServer(H.serve_opts(), num_envs=32, frames=4, device="cuda")
    out = server.rollout(np.arange(32) % 10)
    torch.cuda.synchronize()
    assert server.window.launches == 1
    assert out.is_cuda and out.shape == (4, 32, 13, 7)
    assert torch.isfinite(out).all()


def _interval_case(model, E, per_env, dev, seed=7):
    """Seeded inputs of one 33-substep interval in plane layout, with
    penetrating contacts, plus loss weights."""
    state, tgt, act, params = _inputs(model, E, 2, per_env, dev, seed)
    rng = np.random.RandomState(seed)
    B = model.n_links
    t = lambda x: torch.as_tensor(x.astype(np.float32), device=dev)
    res = t(rng.randn(SUB, 6, B, E) * 0.1)
    w = (t(rng.randn(7, B, E)), t(rng.randn(6, B, E)))
    return state, tgt, act, res, params, w


def _planes(model, params):
    """Leaves (ke, kd, mass) and the four traced planes built from them."""
    ke = params.joint_target_ke.clone().requires_grad_()
    kd = params.joint_target_kd.clone().requires_grad_()
    mass = params.body_mass.clone().requires_grad_()
    I = params.body_inertia / params.body_mass[..., None, None] * mass[..., None, None]
    p = tint.SimParams(mass, 1.0 / mass, I, torch.linalg.inv(I), ke, kd)
    planes = soa.traced_planes(model, p)
    return [ke, kd, mass], [planes[n] for n in soa.TRACED_NAMES]


def _state_inputs(state, tgt, act, res):
    return [state.body_q.permute(2, 1, 0).contiguous().requires_grad_(),
            state.body_qd.permute(2, 1, 0).contiguous().requires_grad_(),
            tgt[:SUB].permute(0, 2, 1).contiguous().requires_grad_(),
            act[:SUB].permute(0, 2, 1).contiguous().requires_grad_(),
            res.clone().requires_grad_()]


def _interval_grads(model, fn, state, tgt, act, res, params, w):
    leaves, planes = _planes(model, params)
    ins = _state_inputs(state, tgt, act, res)
    q, qd = fn(*ins, *planes)
    loss = (q * w[0]).sum() + (qd * w[1]).sum()
    return q, qd, torch.autograd.grad(loss, ins + leaves)


def _linearized_grads(model, di, state, tgt, act, res, params, w):
    """Gradients of sum(w * outputs) by autograd of the plain interval and
    by K3 fed the plain forward's own substep entry states, with the planes
    widened to one lane per env: (plain, kernel) lists over bq0, bqd0, tgt,
    act, res and the four planes (per env). Shared planes also go through
    K3's env reduction, which must match the float64 sum of the per-env
    partials within twice the bound of recursive fp32 summation."""
    _, planes = _planes(model, params)
    ins = _state_inputs(state, tgt, act, res)
    E = ins[0].shape[-1]
    wide = [p.detach().expand(*p.shape[:-1], E).contiguous().requires_grad_() for p in planes]
    q, qd, sst = tint.interval(di.integrator, DT, *ins, *wide, export=True)
    plain = torch.autograd.grad((q * w[0]).sum() + (qd * w[1]).sum(), ins + wide)
    seq = [x.detach() for x in ins[2:]]
    *kern, dwide = di._backward(sst, *seq, [x.detach() for x in wide], w[0], w[1])
    if all(p.shape[-1] == E for p in planes):
        return plain, kern + list(dwide)
    reduced = di._backward(sst, *seq, [p.detach() for p in planes], w[0], w[1])[5]
    for p, s, g in zip(planes, reduced, dwide):
        if p.shape[-1] == 1:
            g64 = g.double()
            bound = 2 * (E - 1) * 2.0 ** -24 * g64.abs().sum(-1, keepdim=True)
            assert ((s.double() - g64.sum(-1, keepdim=True)).abs() <= bound).all()
    return plain, kern + list(dwide)


@pytest.mark.cuda
@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
@pytest.mark.parametrize("name", ["a1", "chain"])
def test_interval_kernels_match_plain(name, per_env):
    """K2 values and K3 gradients against autograd of the plain interval on
    the card, one 33-substep interval with acts and residual forces.
    Tolerance: values as the window's. Gradients as in chip_smoke.py:
    (a) K3 on the plain forward's own substep states: every entry of every
    gradient, per-env plane partials included, within 1e-4 of the
    gradient's largest entry; (b) end to end, where each side differentiates
    its own forward and FMA rounding can carry one env across a contact kink
    (its adjoint then jumps; measured ~1e-6 elsewhere): per env within 1e-3,
    except at most 2 of the 64 envs, every entry within 0.1, and gradients
    summed over the envs (shared ke, kd, mass) within 1e-3."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model(name)
    case = _interval_case(model, 64, per_env, dev)
    integ = tint.SemiImplicitIntegrator(model)
    di = soa_grad.DiffInterval(integ, DT, SUB, with_res=True, with_act=True)
    qa, qda, ga = _interval_grads(
        model, lambda *a: tint.interval(integ, DT, *a), *case)
    qb, qdb, gb = _interval_grads(model, di, *case)
    torch.cuda.synchronize()
    assert di.launches["soa_interval_fwd"] == 1 and di.launches["soa_interval_bwd"] == 1
    assert di.launches["soa_interval_reduce"] == (0 if per_env else 1)
    torch.testing.assert_close(qb, qa, rtol=0, atol=1e-5)
    torch.testing.assert_close(qdb, qda, rtol=0, atol=5e-3)
    rel = lambda a, b: (a - b).abs() / (float(a.abs().max()) + 1e-12)
    E = qa.shape[-1]
    names = ["bq0", "bqd0", "tgt", "act", "res"] + list(soa.TRACED_NAMES)
    for n, a, b in zip(names, *_linearized_grads(model, di, *case)):
        assert torch.isfinite(b).all(), n
        assert float(rel(a, b).max()) <= 1e-4, n
    for n, a, b in zip(["bq0", "bqd0", "tgt", "act", "res", "ke", "kd", "mass"], ga, gb):
        assert torch.isfinite(b).all(), n
        d = rel(a, b)
        if n in ("ke", "kd", "mass") and not per_env:
            assert float(d.max()) <= 1e-3, n  # summed over the envs
            continue
        assert float(d.max()) <= 0.1, n
        env_err = d.reshape(E, -1).amax(1) if n in ("ke", "kd", "mass") else d.reshape(
            -1, E).amax(0)
        assert int((env_err > 1e-3).sum()) <= 2, n


@pytest.mark.cuda
def test_interval_chain_equals_window_bitwise():
    """K2 chained over the intervals of a window gives K1's frame states bit
    for bit: both run the warp substep (csrc/substep_warp.cuh)."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model("a1")
    F = 3
    state, tgt, act, params = _inputs(model, 64, F, False, dev)
    integ = tint.SemiImplicitIntegrator(model)
    ref = soa.SoaWindow(integ, DT, SUB, F)(state, tgt, None, params)
    di = soa_grad.DiffInterval(integ, DT, SUB)
    planes = soa.traced_planes(model, params)
    bq, bqd = state.body_q.permute(2, 1, 0), state.body_qd.permute(2, 1, 0)
    tp = tgt.permute(0, 2, 1).contiguous()
    with torch.no_grad():
        for f in range(F - 1):
            bq, bqd = di(bq, bqd, tp[f * SUB:(f + 1) * SUB], None, None,
                         *(planes[n] for n in soa.TRACED_NAMES))
            assert torch.equal(bq.permute(2, 1, 0), ref[0][f + 1])
            assert torch.equal(bqd.permute(2, 1, 0), ref[1][f + 1])


@pytest.mark.cuda
def test_cuda_interval_raises_without_its_library(monkeypatch):
    """A CUDA tensor never takes the plain path: a missing library raises."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model("chain")
    state, tgt, _, params = _inputs(model, 8, 2, False, dev)

    def missing(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kbuild, "load", missing)
    di = soa_grad.DiffInterval(tint.SemiImplicitIntegrator(model), DT, SUB)
    planes = soa.traced_planes(model, params)
    with pytest.raises(RuntimeError, match="nvcc"):
        di(state.body_q.permute(2, 1, 0), state.body_qd.permute(2, 1, 0),
           tgt[:SUB].permute(0, 2, 1), None, None, *(planes[n] for n in soa.TRACED_NAMES))
    # the with_xp launch too
    live = soa_grad.DiffInterval(tint.SemiImplicitIntegrator(model), DT, SUB, with_xp=True)
    xp = soa.xp_planes(model, torch.as_tensor(model.joint_X_p, device=dev))
    with pytest.raises(RuntimeError, match="nvcc"):
        live(state.body_q.permute(2, 1, 0), state.body_qd.permute(2, 1, 0),
             tgt[:SUB].permute(0, 2, 1), None, None,
             *(planes[n] for n in soa.TRACED_NAMES), *(xp[n] for n in soa.XP_NAMES))


@pytest.mark.cuda
@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
@pytest.mark.parametrize("name", ["a1", "chain45"])
def test_interval_kernels_with_live_anchors_match_plain(name, per_env):
    """K2/K3 with live joint anchors (with_xp) against the plain interval
    with the anchor planes, 64 envs (the 45-contact chain: 1027 envs, a
    ragged last CTA), anchors moved ~1e-2 m and ~0.05 rad from the
    model's, per env or shared: values as the window's; K3 at the plain
    linearization, every gradient (the three anchor planes included) within
    1e-4 of its largest entry, shared planes through the env reduction."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model(name)
    E = 64 if name == "a1" else E_RAGGED
    state, tgt, act, res, params, w = _interval_case(model, E, False, dev)
    integ = tint.SemiImplicitIntegrator(model)
    di = soa_grad.DiffInterval(integ, DT, SUB, with_res=True, with_act=True, with_xp=True)
    xp = synthetic.perturbed_anchors(model, E if per_env else None, seed=5)
    xpl = soa.xp_planes(model, torch.as_tensor(xp, device=dev))
    _, planes = _planes(model, params)
    pl = [p.detach() for p in planes] + [xpl[n] for n in soa.XP_NAMES]
    ins = [x.detach() for x in _state_inputs(state, tgt, act, res)]
    with torch.no_grad():
        qa, qda = tint.interval(integ, DT, *ins, *pl)
        qb, qdb = di(*ins, *pl)
    torch.cuda.synchronize()
    torch.testing.assert_close(qb, qa, rtol=0, atol=1e-5)
    torch.testing.assert_close(qdb, qda, rtol=0, atol=5e-3)
    wide = [p.expand(*p.shape[:-1], E).contiguous().requires_grad_() for p in pl]
    ins = [x.clone().requires_grad_() for x in ins]
    q, qd, sst = tint.interval(integ, DT, *ins, *wide, export=True)
    plain = torch.autograd.grad((q * w[0]).sum() + (qd * w[1]).sum(), ins + wide)
    seq = [x.detach() for x in ins[2:]]
    *kern, dwide = di._backward(sst, *seq, [x.detach() for x in wide], w[0], w[1])
    names = ["bq0", "bqd0", "tgt", "act", "res"] + list(di.names)
    for n, a, b in zip(names, plain, kern + list(dwide)):
        assert torch.isfinite(b).all(), n
        assert float((a - b).abs().max()) <= 1e-4 * (float(a.abs().max()) + 1e-12), n
    red = di._backward(sst, *seq, pl, w[0], w[1])[5]
    for n, p, s, g in zip(di.names, pl, red, plain[5:]):
        if p.shape[-1] == 1:
            want = g.sum(-1, keepdim=True)
            assert float((s - want).abs().max()) <= 1e-3 * (float(want.abs().max()) + 1e-12), n


@pytest.mark.cuda
def test_model_anchors_live_equal_baked_on_the_card():
    """The model's own anchors as lane-1 planes: K2's states and K3's other
    gradients equal the baked kernels' bit for bit."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model("a1")
    state, tgt, act, res, params, w = _interval_case(model, 256, True, dev)
    integ = tint.SemiImplicitIntegrator(model)
    baked = soa_grad.DiffInterval(integ, DT, SUB, with_act=True)
    live = soa_grad.DiffInterval(integ, DT, SUB, with_act=True, with_xp=True)
    _, planes = _planes(model, params)
    pl = [p.detach() for p in planes]
    xp = soa.xp_planes(model, torch.as_tensor(model.joint_X_p, device=dev))
    ins = [x.detach() for x in _state_inputs(state, tgt, act, res)]
    q0, qd0, s0 = baked._forward(ins[0], ins[1], ins[2], ins[3], None, pl, True)
    q1, qd1, s1 = live._forward(ins[0], ins[1], ins[2], ins[3], None,
                                pl + [xp[n] for n in soa.XP_NAMES], True)
    assert torch.equal(q0, q1) and torch.equal(qd0, qd1) and torch.equal(s0, s1)
    g0 = baked._backward(s0, ins[2], ins[3], None, pl, w[0], w[1])
    g1 = live._backward(s1, ins[2], ins[3], None, pl + [xp[n] for n in soa.XP_NAMES],
                        w[0], w[1])
    for a, b in zip(g0[:4] + tuple(g0[5]), g1[:4] + tuple(g1[5][:4])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_window_rejects_anchor_and_com_overrides_on_cuda():
    """On CUDA tensors too the window raises on a live joint_X_p or body_com
    (K1 has no anchor or COM planes) instead of dropping it."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model("a1")
    state, tgt, _, params = _inputs(model, 8, 2, False, dev)
    window = soa.SoaWindow(tint.SemiImplicitIntegrator(model), DT, SUB, 2)
    for bad in (params._replace(joint_X_p=torch.as_tensor(model.joint_X_p, device=dev)),
                params._replace(body_com=torch.as_tensor(model.body_com, device=dev))):
        with pytest.raises(ValueError, match="joint_X_p and body_com"):
            window(state, tgt, None, bad)
    assert window.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["a1", "chain"])
def test_rollout_kernel_matches_plain(name):
    """K4 against its plain version (integrator.rollout_substeps) on the
    card, 33 substeps with penetrating contacts, random and no acts; its
    final state equals K2's without export bit for bit (both run the warp
    substep).
    Tolerance as the window's after 33 substeps."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model(name)
    state, tgt, act, params = _inputs(model, 64, 2, False, dev)
    tgt, act = tgt[:SUB].contiguous(), act[:SUB].contiguous()
    integ = tint.SemiImplicitIntegrator(model)
    k4 = soa.build_soa_rollout(integ, params, DT, SUB)
    planes = soa.traced_planes(model, params)
    for acts in (act, None):
        out = k4(state, tgt, acts)
        ref = tint.rollout_substeps(integ, params, state, tgt, acts, DT)
        torch.cuda.synchronize()
        assert torch.isfinite(out.body_q).all() and torch.isfinite(out.body_qd).all()
        torch.testing.assert_close(out.body_q, ref.body_q, rtol=0, atol=1e-5)
        torch.testing.assert_close(out.body_qd, ref.body_qd, rtol=0, atol=5e-3)
        di = soa_grad.DiffInterval(integ, DT, SUB, with_act=acts is not None)
        with torch.no_grad():
            bq, bqd = di(state.body_q.permute(2, 1, 0), state.body_qd.permute(2, 1, 0),
                         tgt.permute(0, 2, 1), None if acts is None else acts.permute(0, 2, 1),
                         None, *(planes[n] for n in soa.TRACED_NAMES))
        assert torch.equal(bq.permute(2, 1, 0), out.body_q)
        assert torch.equal(bqd.permute(2, 1, 0), out.body_qd)
    assert k4.launches == 2


@pytest.mark.cuda
def test_cuda_rollout_raises_without_its_library(monkeypatch):
    """A CUDA tensor never takes K4's plain path: a missing library raises."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model("chain")
    state, tgt, _, params = _inputs(model, 8, 2, False, dev)

    def missing(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kbuild, "load", missing)
    k4 = soa.build_soa_rollout(tint.SemiImplicitIntegrator(model), params, DT, SUB)
    with pytest.raises(RuntimeError, match="nvcc"):
        k4(state, tgt[:SUB].contiguous(), None)
    assert k4.launches == 0


@pytest.mark.cuda
def test_rollout_rejects_per_env_params_on_cuda():
    """The TPU kernel bakes in shared parameters; so does K4's wrapper."""
    _need_gpu()
    model = _model("a1")
    _, _, _, params = _inputs(model, 8, 2, True, torch.device("cuda"))
    with pytest.raises(ValueError, match="per-env"):
        soa.build_soa_rollout(tint.SemiImplicitIntegrator(model), params, DT, SUB)


E_RAGGED = 1027  # 8 envs per CTA in the warp-per-env kernels, the last CTA holding 3


@pytest.mark.cuda
def test_rollout_kernel_many_contacts_ragged():
    """K4 with 45 contacts (two chunks of 32 lanes) at 1027 envs (a ragged
    last CTA) against its plain version and K2, as
    test_rollout_kernel_matches_plain."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model("chain45")
    assert model.contact_count > 32 and E_RAGGED % soa.envs_per_cta(E_RAGGED) != 0
    state, tgt, act, params = _inputs(model, E_RAGGED, 2, False, dev)
    tgt, act = tgt[:SUB].contiguous(), act[:SUB].contiguous()
    integ = tint.SemiImplicitIntegrator(model)
    k4 = soa.build_soa_rollout(integ, params, DT, SUB)
    planes = soa.traced_planes(model, params)
    out = k4(state, tgt, act)
    ref = tint.rollout_substeps(integ, params, state, tgt, act, DT)
    torch.testing.assert_close(out.body_q, ref.body_q, rtol=0, atol=1e-5)
    torch.testing.assert_close(out.body_qd, ref.body_qd, rtol=0, atol=5e-3)
    di = soa_grad.DiffInterval(integ, DT, SUB, with_act=True)
    with torch.no_grad():
        bq, bqd = di(state.body_q.permute(2, 1, 0), state.body_qd.permute(2, 1, 0),
                     tgt.permute(0, 2, 1), act.permute(0, 2, 1), None,
                     *(planes[n] for n in soa.TRACED_NAMES))
    torch.testing.assert_close(bq.permute(2, 1, 0), out.body_q, rtol=0, atol=1e-5)
    torch.testing.assert_close(bqd.permute(2, 1, 0), out.body_qd, rtol=0, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_interval_backward_many_contacts_ragged(per_env):
    """K3 with 45 contacts at 1027 envs, acts and residual forces, at the
    plain linearization (every gradient, per-env plane partials included,
    within 1e-4 of its max; shared planes also through the env reduction,
    held to the fp32 summation bound)."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model("chain45")
    case = _interval_case(model, E_RAGGED, per_env, dev)
    di = soa_grad.DiffInterval(tint.SemiImplicitIntegrator(model), DT, SUB, with_res=True,
                               with_act=True)
    rel = lambda a, b: (a - b).abs() / (float(a.abs().max()) + 1e-12)
    names = ["bq0", "bqd0", "tgt", "act", "res"] + list(soa.TRACED_NAMES)
    for n, a, b in zip(names, *_linearized_grads(model, di, *case)):
        assert torch.isfinite(b).all(), n
        assert float(rel(a, b).max()) <= 1e-4, n
    assert di.launches["soa_interval_reduce"] == (0 if per_env else 1)


@pytest.mark.cuda
def test_window_kernel_many_contacts_ragged():
    """K1 with 45 contacts (two chunks of 32 lanes) at 1027 envs (a ragged
    last CTA) over F=3 frames against its plain version, tolerances as
    test_window_kernel_matches_plain; its frame states equal K2 chained
    over the window's intervals bit for bit."""
    _need_gpu()
    dev = torch.device("cuda")
    model = _model("chain45")
    F = 3
    state, tgt, act, params = _inputs(model, E_RAGGED, F, True, dev)
    integ = tint.SemiImplicitIntegrator(model)
    window = soa.SoaWindow(integ, DT, SUB, F)
    out = window(state, tgt, act, params)
    ref = tint.rollout(integ, params, state, tgt, act, None, DT, SUB)
    for a, b, tol in zip(out, ref, (1e-5, 5e-3, 0.1, 0.5)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=tol)
    di = soa_grad.DiffInterval(integ, DT, SUB, with_act=True)
    planes = soa.traced_planes(model, params)
    bq, bqd = state.body_q.permute(2, 1, 0), state.body_qd.permute(2, 1, 0)
    tp, ap = tgt.permute(0, 2, 1).contiguous(), act.permute(0, 2, 1).contiguous()
    with torch.no_grad():
        for f in range(F - 1):
            sl = slice(f * SUB, (f + 1) * SUB)
            bq, bqd = di(bq, bqd, tp[sl], ap[sl], None, *(planes[n] for n in soa.TRACED_NAMES))
            assert torch.equal(bq.permute(2, 1, 0), out[0][f + 1])
            assert torch.equal(bqd.permute(2, 1, 0), out[1][f + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("a1", 64, False), ("chain45", E_RAGGED, True)],
                         ids=["a1-shared", "chain45-ragged-per_env"])
def test_interval_forward_export_matches_plain(case):
    """K2 with acts and residual forces against the plain
    ``interval(export=True)``: the final state and every exported substep
    entry state (q rows within 1e-5, qd rows within 5e-3, as the window's
    values); without the export the final state is the same bit for bit."""
    _need_gpu()
    name, E, per_env = case
    dev = torch.device("cuda")
    model = _model(name)
    state, tgt, act, res, params, _ = _interval_case(model, E, per_env, dev)
    integ = tint.SemiImplicitIntegrator(model)
    di = soa_grad.DiffInterval(integ, DT, SUB, with_res=True, with_act=True)
    planes = soa.traced_planes(model, params)
    pl = [planes[n] for n in soa.TRACED_NAMES]
    bq, bqd, tp, ap, _ = (x.detach() for x in _state_inputs(state, tgt, act, res))
    rq, rqd, rs = tint.interval(integ, DT, bq, bqd, tp, ap, res, *pl, export=True)
    q, qd, sst = di._forward(bq, bqd, tp, ap, res, pl, True)
    for x, y, tol in ((q, rq, 1e-5), (qd, rqd, 5e-3), (sst[:, :, :7], rs[:, :, :7], 1e-5),
                      (sst[:, :, 7:], rs[:, :, 7:], 5e-3)):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=0, atol=tol)
    q2, qd2, none = di._forward(bq, bqd, tp, ap, res, pl, False)
    assert none is None and torch.equal(q2, q) and torch.equal(qd2, qd)


@pytest.mark.cuda
def test_wrappers_raise_on_another_cards_tensors():
    """One process per card: every kernel wrapper raises when its tensors
    lie on another card than the current device, before it launches."""
    _need_gpu()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices: with one card no tensor can lie on another")
    model = _model("a1")
    other = torch.device("cuda", 1)
    state, tgt, act, params = _inputs(model, 8, 2, False, other)
    integ = tint.SemiImplicitIntegrator(model)
    torch.cuda.set_device(0)
    window = soa.SoaWindow(integ, DT, SUB, 2)
    with pytest.raises(ValueError, match="current device"):
        window(state, tgt, None, params)
    roll = soa.SoaRollout(integ, params, DT, SUB)
    with pytest.raises(ValueError, match="current device"):
        roll(state, tgt[:SUB], None)
    di = soa_grad.DiffInterval(integ, DT, SUB)
    bq, bqd = (x.permute(2, 1, 0).contiguous() for x in state)
    _, planes = _planes(model, params)
    with pytest.raises(ValueError, match="current device"):
        di(bq, bqd, tgt[:SUB].permute(0, 2, 1).contiguous(), None, None, *planes)
    assert window.launches == 0 and roll.launches == 0
    assert not any(di.launches.values())


@pytest.mark.cuda
def test_comm_helpers_under_nccl(tmp_path):
    """gather_envs (values and its slice-only backward), sum_grads and
    replicas_agree on CUDA tensors under a world-1 NCCL group."""
    _need_gpu()
    import torch.distributed as dist
    from ppr_diffphys_torch.parallel import sharding

    dist.init_process_group("nccl", init_method="file://" + str(tmp_path / "store"),
                            rank=0, world_size=1)
    try:
        assert dist.get_backend() == "nccl"
        mesh = sharding.make_mesh({"dp": 1})
        x = torch.randn(4, 3, device="cuda", requires_grad=True)
        full = sharding.gather_envs(x, mesh)
        (g,) = torch.autograd.grad((full * 2.0).sum(), x)
        assert torch.equal(full, x) and torch.equal(g, torch.full_like(x, 2.0))
        grads = [torch.randn(5, 2, device="cuda"), torch.randn(3, device="cuda")]
        out = sharding.sum_grads(mesh, grads, [None, None])
        assert all(torch.equal(a, b) for a, b in zip(out, grads))
        assert sharding.replicas_agree(grads)
        assert sharding.broadcast_from_rank0([1.5, -2.0]) == [1.5, -2.0]
    finally:
        dist.destroy_process_group()
        sharding._mesh_cache.clear()
