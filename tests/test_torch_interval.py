"""The training rollout of the port (sim/soa_grad.py: the plain interval
that CPU tensors run, chained by rollout_soa) against the JAX package:
values and gradients with respect to the initial state, joint targets,
activations, residual forces, PD gains and masses (through the parameter
planes), on a1 and on the FIXED/COMPOUND/REVOLUTE chain, with shared and
per-env parameters and penetrating contacts. The references are jax.grad
of the XLA scan (integrator.rollout) and of the Pallas interval pair in
interpret mode (pallas_soa_grad.rollout_soa(interpret=True), the TPU
kernels K2/K3 this slice ports), also with a live joint_X_p (the with_xp
planes of the lab4d coupling).

Tolerances are the JAX package's own between its two engines
(tests/test_pallas_grad.py): the loss to rtol 1e-4, each gradient within
5e-4 of its largest entry.

The CUDA kernels run only on a GPU: tests/test_torch_cuda.py holds them
against this plain version there, and chip_smoke.py does so at training
shapes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ppr_diffphys_tpu.sim.builder as jbuilder
import ppr_diffphys_tpu.sim.import_urdf as jimport
from ppr_diffphys_tpu.sim import integrator as jint
from ppr_diffphys_tpu.sim.kinematics import eval_fk as jeval_fk
from ppr_diffphys_tpu.sim.pallas_soa_grad import rollout_soa as jrollout_soa

import ppr_diffphys_torch.sim.builder as tbuilder
import ppr_diffphys_torch.sim.import_urdf as timport
from ppr_diffphys_torch.sim import integrator as tint
from ppr_diffphys_torch.sim import soa as tsoa
from ppr_diffphys_torch.sim import soa_grad
from ppr_diffphys_torch.sim.synthetic import chain_model, perturbed_anchors

import port_helpers as H

DT = 5e-4
E, SUB, F = 2, 3, 3
NAMES = ["ke", "kd", "mass", "tgt", "act", "res", "bq0", "bqd0"]


def _models(name):
    if name == "a1":
        return H.a1_model(jbuilder, jimport), H.a1_model(tbuilder, timport)
    return chain_model(jbuilder.ModelBuilder), chain_model(tbuilder.ModelBuilder)


@pytest.fixture(scope="module", params=["a1", "chain"])
def models(request):
    return request.param, _models(request.param)


def _problem(jm, per_env, seed=9):
    q, qd, tgt, act = H.window_problem(jm, E, SUB, F, seed)
    bq, bqd = jeval_fk(jm, jnp.asarray(q), jnp.asarray(qd))
    bq = H.grounded(jm, np.asarray(bq), seed)
    rng = np.random.RandomState(seed)
    S = tgt.shape[0]
    res = (rng.randn(S, E, jm.n_links, 6) * 0.1).astype(np.float32)
    wq = rng.randn(F, E, jm.n_links, 7).astype(np.float32)
    wqd = rng.randn(F, E, jm.n_links, 6).astype(np.float32)
    ke, kd, mass, norm_I = H.sim_params_np(jm, E if per_env else None, seed=3)
    args = (ke, kd, mass, tgt, act, res, np.asarray(bq), np.asarray(bqd))
    return args, norm_I, wq, wqd


def _jax_loss(jm, norm_I, wq, wqd, roll):
    def f(ke, kd, mass, tgt, act, res, bq0, bqd0):
        I = norm_I * mass[..., None, None]
        p = jint.SimParams(
            body_mass=mass, body_inv_mass=1.0 / mass, body_inertia=I,
            body_inv_inertia=jnp.linalg.inv(I), joint_target_ke=ke, joint_target_kd=kd,
        )
        q, qd, _, _ = roll(p, jint.SimState(bq0, bqd0), tgt, act, res)
        return jnp.sum(q * wq) + jnp.sum(qd * wqd)
    return f


def _port_value_and_grads(tm, norm_I, wq, wqd, args, interval_fn=None):
    ts = [torch.as_tensor(a).requires_grad_() for a in args]
    ke, kd, mass, tgt, act, res, bq0, bqd0 = ts
    I = torch.as_tensor(norm_I) * mass[..., None, None]
    p = tint.SimParams(mass, 1.0 / mass, I, torch.linalg.inv(I), ke, kd)
    integ = tint.SemiImplicitIntegrator(tm)
    if interval_fn is None:
        interval_fn = soa_grad.make_diff_interval(integ, DT, SUB, with_res=True, with_act=True)
    q, qd, grf, jaf = soa_grad.rollout_soa(
        integ, p, tint.SimState(bq0, bqd0), tgt, act, res, DT, SUB, interval_fn=interval_fn)
    loss = (q * torch.as_tensor(wq)).sum() + (qd * torch.as_tensor(wqd)).sum()
    return loss, torch.autograd.grad(loss, ts, allow_unused=True), (q, qd, grf, jaf)


def _check_grads(ref, got, names):
    for n, a, b in zip(names, ref, got):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=5e-4, rtol=0,
                                   err_msg="grad mismatch: " + n)


@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_rollout_soa_matches_jax_values_and_grads(models, per_env):
    name, (jm, tm) = models
    args, norm_I, wq, wqd = _problem(jm, per_env)
    jinteg = jint.SemiImplicitIntegrator(jm)
    xla = _jax_loss(jm, norm_I, wq, wqd,
                    lambda p, s, t, a, r: jint.rollout(jinteg, p, s, t, a, r, DT, SUB))
    jargs = tuple(jnp.asarray(a) for a in args)
    v_x, g_x = jax.value_and_grad(xla, argnums=tuple(range(8)))(*jargs)
    loss, g_t, outs = _port_value_and_grads(tm, norm_I, wq, wqd, args)
    # the contact law was exercised
    assert float(torch.abs(outs[2][..., 3:]).max()) > 1.0
    np.testing.assert_allclose(float(loss.detach()), float(v_x), rtol=1e-4)
    _check_grads(g_x, g_t, NAMES)

    if not per_env:  # the Pallas pair in interpret mode (slow on the CPU: once per model)
        pallas = _jax_loss(
            jm, norm_I, wq, wqd,
            lambda p, s, t, a, r: jrollout_soa(jinteg, p, s, t, a, r, DT, SUB, e_tile=E,
                                               interpret=True))
        v_p, g_p = jax.value_and_grad(pallas, argnums=tuple(range(8)))(*jargs)
        np.testing.assert_allclose(float(loss.detach()), float(v_p), rtol=1e-4)
        _check_grads(g_p, g_t, NAMES)


def test_rollout_soa_observables_match_the_window(models):
    """Frame states and the boundary grf/jaf equal the plain window's."""
    _, (jm, tm) = models
    args, norm_I, wq, wqd = _problem(jm, False, seed=4)
    _, _, outs = _port_value_and_grads(tm, norm_I, wq, wqd, args)
    ke, kd, mass, tgt, act, res, bq0, bqd0 = (torch.as_tensor(a) for a in args)
    I = torch.as_tensor(norm_I) * mass[..., None, None]
    p = tint.SimParams(mass, 1.0 / mass, I, torch.linalg.inv(I), ke, kd)
    ref = tint.rollout(tint.SemiImplicitIntegrator(tm), p, tint.SimState(bq0, bqd0),
                       tgt, act, res, DT, SUB)
    for a, b in zip(outs, ref):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=1e-6)


def test_interval_without_act_and_res_gives_them_no_gradient(models):
    """with_act/with_res off (the training default): act and res are zero
    and get no gradient; values equal a run with zero act and res."""
    _, (jm, tm) = models
    args, norm_I, wq, wqd = _problem(jm, False, seed=5)
    integ = tint.SemiImplicitIntegrator(tm)
    off = soa_grad.make_diff_interval(integ, DT, SUB)
    loss, g, _ = _port_value_and_grads(tm, norm_I, wq, wqd, args, interval_fn=off)
    assert g[4] is None and g[5] is None
    zeroed = list(args)
    zeroed[4] = np.zeros_like(args[4])
    zeroed[5] = np.zeros_like(args[5])
    loss0, g0, _ = _port_value_and_grads(tm, norm_I, wq, wqd, zeroed)
    assert float(loss.detach()) == pytest.approx(float(loss0.detach()), rel=1e-6)
    for a, b in zip(g[:4] + g[6:], g0[:4] + g0[6:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_plane_params_match_sim_params(models):
    """The plain interval reads the traced planes back as the parameters
    the plain substep takes, shared and per-env."""
    _, (jm, tm) = models
    for per_env in (False, True):
        ke, kd, mass, norm_I = H.sim_params_np(jm, E if per_env else None, seed=3)
        t = torch.as_tensor
        I = t(norm_I) * t(mass)[..., None, None]
        p = tint.SimParams(t(mass), 1.0 / t(mass), I, torch.linalg.inv(I), t(ke), t(kd))
        pl = tsoa.traced_planes(tm, p)
        back, (ke3, kd3) = tint.plane_params(*(pl[n] for n in tsoa.TRACED_NAMES), E)
        didx = torch.as_tensor(tint.dof_index(tm))
        torch.testing.assert_close(back.body_inv_mass, p.body_inv_mass)
        torch.testing.assert_close(back.body_inertia, p.body_inertia)
        torch.testing.assert_close(back.body_inv_inertia, p.body_inv_inertia)
        torch.testing.assert_close(ke3, p.joint_target_ke[..., didx])
        torch.testing.assert_close(kd3, p.joint_target_kd[..., didx])


def test_interval_export_is_the_state_entering_each_substep(models):
    """The plain interval's export has K2's (S,E,13,B) layout: row j is the
    state (q then qd, each [k][b]) that the first j substeps reach; it is
    detached and leaves the outputs as they were."""
    _, (jm, tm) = models
    args, norm_I, _, _ = _problem(jm, True, seed=6)
    ke, kd, mass, tgt, act, res, bq0, bqd0 = (torch.as_tensor(a) for a in args)
    I = torch.as_tensor(norm_I) * mass[..., None, None]
    pl = tsoa.traced_planes(tm, tint.SimParams(mass, 1.0 / mass, I, torch.linalg.inv(I), ke, kd))
    planes = [pl[n] for n in tsoa.TRACED_NAMES]
    integ = tint.SemiImplicitIntegrator(tm)
    bq = bq0.permute(2, 1, 0).requires_grad_()
    bqd = bqd0.permute(2, 1, 0)
    seq = (tgt[:SUB].permute(0, 2, 1), act[:SUB].permute(0, 2, 1), res[:SUB].permute(0, 3, 2, 1))
    q, qd, sst = tint.interval(integ, DT, bq, bqd, *seq, *planes, export=True)
    assert sst.shape == (SUB, E, 13, tm.n_links) and not sst.requires_grad
    q0, qd0 = tint.interval(integ, DT, bq, bqd, *seq, *planes)
    assert torch.equal(q, q0) and torch.equal(qd, qd0) and q.requires_grad
    for j in range(SUB):
        head = tuple(x[:j] for x in seq)
        qj, qdj = tint.interval(integ, DT, bq, bqd, *head, *planes) if j else (bq, bqd)
        assert torch.equal(sst[j], torch.cat([qj, qdj], 0).detach().permute(2, 0, 1))


def _jax_loss_xp(jm, norm_I, wq, wqd, roll):
    """_jax_loss with a live joint_X_p as the ninth argument."""
    def f(ke, kd, mass, tgt, act, res, bq0, bqd0, xp):
        I = norm_I * mass[..., None, None]
        p = jint.SimParams(
            body_mass=mass, body_inv_mass=1.0 / mass, body_inertia=I,
            body_inv_inertia=jnp.linalg.inv(I), joint_target_ke=ke, joint_target_kd=kd,
            joint_X_p=xp,
        )
        q, qd, _, _ = roll(p, jint.SimState(bq0, bqd0), tgt, act, res)
        return jnp.sum(q * wq) + jnp.sum(qd * wqd)
    return f


def _port_xp(tm, norm_I, wq, wqd, args, xp, interval_fn=None):
    ts = [torch.tensor(np.asarray(a)).requires_grad_() for a in tuple(args) + (xp,)]
    ke, kd, mass, tgt, act, res, bq0, bqd0, xpt = ts
    I = torch.as_tensor(norm_I) * mass[..., None, None]
    p = tint.SimParams(mass, 1.0 / mass, I, torch.linalg.inv(I), ke, kd, joint_X_p=xpt)
    integ = tint.SemiImplicitIntegrator(tm)
    if interval_fn is None:
        interval_fn = soa_grad.make_diff_interval(integ, DT, SUB, with_res=True, with_act=True,
                                                  with_xp=True)
    q, qd, _, _ = soa_grad.rollout_soa(
        integ, p, tint.SimState(bq0, bqd0), tgt, act, res, DT, SUB, interval_fn=interval_fn)
    loss = (q * torch.as_tensor(wq)).sum() + (qd * torch.as_tensor(wqd)).sum()
    return loss, torch.autograd.grad(loss, ts, allow_unused=True)


@pytest.mark.parametrize("lanes", ["per_env", "shared"])
def test_rollout_soa_live_anchors_match_jax(models, lanes):
    """A live joint_X_p (anchors moved ~1e-2 m and ~0.05 rad from the
    model's), per env ((E,B,7): lane-E planes) or shared ((B,7): lane 1),
    through the with_xp interval: values and gradients, joint_X_p's
    included, against jax.grad of the XLA scan with the same override and,
    on a1, of the Pallas with_xp pair in interpret mode. Tolerances as
    above."""
    name, (jm, tm) = models
    args, norm_I, wq, wqd = _problem(jm, False, seed=7)
    xp = perturbed_anchors(tm, E if lanes == "per_env" else None, seed=5)
    jinteg = jint.SemiImplicitIntegrator(jm)
    jargs = tuple(jnp.asarray(a) for a in tuple(args) + (xp,))
    xla = _jax_loss_xp(jm, norm_I, wq, wqd,
                       lambda p, s, t, a, r: jint.rollout(jinteg, p, s, t, a, r, DT, SUB))
    v_x, g_x = jax.value_and_grad(xla, argnums=tuple(range(9)))(*jargs)
    loss, g_t = _port_xp(tm, norm_I, wq, wqd, args, xp)
    names = NAMES + ["joint_X_p"]
    np.testing.assert_allclose(float(loss.detach()), float(v_x), rtol=1e-4)
    _check_grads(g_x, g_t, names)
    assert float(np.abs(np.asarray(g_x[-1])).max()) > 0

    if name == "a1":  # the Pallas with_xp pair in interpret mode (slow on the CPU)
        pallas = _jax_loss_xp(
            jm, norm_I, wq, wqd,
            lambda p, s, t, a, r: jrollout_soa(jinteg, p, s, t, a, r, DT, SUB, e_tile=E,
                                               interpret=True))
        v_p, g_p = jax.value_and_grad(pallas, argnums=tuple(range(9)))(*jargs)
        np.testing.assert_allclose(float(loss.detach()), float(v_p), rtol=1e-4)
        _check_grads(g_p, g_t, names)


def test_model_anchors_passed_live_equal_no_anchors(models):
    """The model's own joint_X_p passed live (the with_xp interval) gives
    the rollout and gradients of the default path, within the file's
    tolerances: the plain interval then forms the parent arm as
    quat_rotate(parent, rp_local) instead of the anchor's world point less
    the parent's world COM, the same quantity rounded another way."""
    _, (jm, tm) = models
    args, norm_I, wq, wqd = _problem(jm, True, seed=8)
    loss0, g0, _ = _port_value_and_grads(tm, norm_I, wq, wqd, args)
    loss1, g1 = _port_xp(tm, norm_I, wq, wqd, args, np.asarray(tm.joint_X_p))
    np.testing.assert_allclose(float(loss1.detach()), float(loss0.detach()), rtol=1e-4)
    _check_grads([g.numpy() for g in g0], g1[:8], NAMES)


def test_rollout_soa_rejects_com_and_mismatched_interval(models):
    """rollout_soa raises on a live body_com (no kernel has a COM plane) and
    on an interval whose with_xp does not match params.joint_X_p."""
    _, (_, tm) = models
    integ = tint.SemiImplicitIntegrator(tm)
    st = tint.SimState(torch.zeros(1, tm.n_links, 7), torch.zeros(1, tm.n_links, 6))
    tgt = torch.zeros(SUB + 1, 1, tm.n_qd)
    p = tint.default_sim_params(tm)
    with pytest.raises(ValueError, match="body_com"):
        soa_grad.rollout_soa(integ, p._replace(body_com=torch.zeros(tm.n_links, 3)), st, tgt,
                             None, None, DT, SUB)
    live = p._replace(joint_X_p=torch.as_tensor(tm.joint_X_p))
    for params, fn in ((live, soa_grad.make_diff_interval(integ, DT, SUB)),
                       (p, soa_grad.make_diff_interval(integ, DT, SUB, with_xp=True))):
        with pytest.raises(ValueError, match="with_xp"):
            soa_grad.rollout_soa(integ, params, st, tgt, None, None, DT, SUB, interval_fn=fn)


def test_window_rejects_anchor_and_com_overrides(models):
    """SoaWindow takes the anchors and COMs from the model, as the JAX K1
    does: a live joint_X_p or body_com raises before the device branch (the
    CUDA tensors' case is in tests/test_torch_cuda.py)."""
    _, (_, tm) = models
    window = tsoa.SoaWindow(tint.SemiImplicitIntegrator(tm), DT, SUB, 2)
    st = tint.SimState(torch.zeros(1, tm.n_links, 7), torch.zeros(1, tm.n_links, 6))
    p = tint.default_sim_params(tm)
    for bad in (p._replace(joint_X_p=torch.as_tensor(tm.joint_X_p)),
                p._replace(body_com=torch.as_tensor(tm.body_com))):
        with pytest.raises(ValueError, match="joint_X_p and body_com"):
            window(st, torch.zeros(SUB + 1, 1, tm.n_qd), None, bad)


def test_interval_work_counts():
    """The roofline inputs chip_smoke.py reports for K2 and K3 at the
    training shapes: K2 does the window's per-substep work and writes the
    (S,E,13,B) export; K3 does more work than K2 and reads the export."""
    tm = H.a1_model(tbuilder, timport)
    w = soa_grad.interval_work(tm, E=512, substeps=33)
    per = tsoa.window_work(tm, 512, 33, 2)["per_env_substep"]
    assert w["fwd_ops"] == 512 * 33 * per
    export = 33 * 13 * 13 * 512 * 4
    assert w["fwd_bytes"] > export and w["bwd_bytes"] > export
    assert w["bwd_ops"] > 2 * w["fwd_ops"]
    none_active = soa_grad.interval_work(tm, E=512, substeps=33, n_active_contacts=0)
    assert none_active["bwd_ops"] < w["bwd_ops"]
