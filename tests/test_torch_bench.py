"""The port's bench (ppr_diffphys_torch/bench.py) against the JAX package:
its workload against a JAX-side construction of the root bench.py's
(bench.py:176-207, the a1 fixture in place of the absent laikago URDF),
its rollout mode against the JAX ``step_only`` loop, its training loss and
gradients against ``jax.value_and_grad`` through the XLA scan
(integrator.rollout), and ``main`` on the CPU printing its JSON line.

Tolerances: the rollout as tests/test_torch_window.py's plain window
against the XLA scan (the same fp32 algorithm in two frameworks): q 1e-5,
qd 1e-3. The training loss to rtol 1e-4 and each gradient within 5e-4 of
its largest entry, as tests/test_torch_interval.py holds the plain interval
(the JAX package's own tolerance between its two engines,
tests/test_pallas_grad.py); measured 4e-7 (ke) to 4.7e-6 (mass), and
1.3e-4 for bq0, whose quaternion entries carry rounding that the attach
springs (16000 N/m) amplify.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ppr_diffphys_tpu.sim.builder as jbuilder
import ppr_diffphys_tpu.sim.import_urdf as jimport
from ppr_diffphys_tpu.sim import integrator as jint
from ppr_diffphys_tpu.sim.kinematics import eval_fk as jeval_fk

from ppr_diffphys_torch import bench
from ppr_diffphys_torch.sim import integrator as tint

import port_helpers as H

DT = 5e-4


def _jax_workload(E, contacts="hull"):
    """bench.py:176-207 on the a1 fixture: (model, params, state, target)."""
    b = jbuilder.ModelBuilder()
    jimport.parse_urdf(
        H.A1_URDF, b, xform_p=(0, 0.417, 0), floating=True, density=1000,
        armature=0.01, stiffness=220.0, damping=2.0, shape_ke=1e4,
        shape_kd=0, shape_kf=1e2, shape_mu=1, limit_ke=0, limit_kd=0,
    )
    model = b.finalize().make_ground_contacts(contacts)
    model.joint_attach_ke = 16000.0
    model.joint_attach_kd = 200.0
    params = jint.default_sim_params(model)
    ke = jnp.concatenate([jnp.zeros(6), 220.0 * jnp.ones(model.n_dof)])
    kd = jnp.concatenate([jnp.zeros(6), 2.0 * jnp.ones(model.n_dof)])
    params = params._replace(joint_target_ke=ke, joint_target_kd=kd)
    q = np.array(model.joint_q_init, np.float32)
    rest = np.zeros(model.n_dof, np.float32)
    if model.n_dof == 12:
        rest[[2, 5, 8, 11]] = -0.8
    q[7:] = rest
    rng = np.random.RandomState(0)
    qs = np.tile(q[None], (E, 1))
    qs[:, 0:3:2] += rng.uniform(-0.05, 0.05, (E, 2))
    body_q, body_qd = jeval_fk(model, jnp.asarray(qs))
    target = jnp.tile(jnp.concatenate([jnp.zeros(6), jnp.asarray(rest)])[None], (E, 1))
    return model, params, jint.SimState(body_q, body_qd), target


def _same_start(work, jstate):
    """The port's workload with the JAX initial states, so that both sides
    integrate from the same floats."""
    return work._replace(state=tint.SimState(torch.as_tensor(np.array(jstate.body_q)),
                                             torch.as_tensor(np.array(jstate.body_qd))))


def test_workload_matches_jax():
    E = 16
    jm, jp, jst, jtgt = _jax_workload(E)
    w = bench.build_workload(envs=E, device="cpu")
    tm = w.model
    assert (tm.n_links, tm.n_qd, tm.n_dof, tm.contact_count) == (
        jm.n_links, jm.n_qd, jm.n_dof, jm.contact_count)
    assert (tm.joint_attach_ke, tm.joint_attach_kd) == (16000.0, 200.0)
    np.testing.assert_array_equal(w.target.numpy(), np.asarray(jtgt, np.float32))
    for a, b in zip(w.params[:6], jp[:6]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # forward kinematics in two frameworks: rounding only
    np.testing.assert_allclose(w.state.body_q.numpy(), np.asarray(jst.body_q), rtol=0, atol=1e-6)
    np.testing.assert_allclose(w.state.body_qd.numpy(), np.asarray(jst.body_qd), rtol=0,
                               atol=1e-6)
    # the perturbation moves x and z of every env, and only those
    root = w.state.body_q[:, 0, :3]
    assert float(root[:, 0].std()) > 0.01 and float(root[:, 2].std()) > 0.01
    assert float(root[:, 1].std()) < 1e-6


def test_rollout_mode_matches_jax():
    """Rollout at E=4, 2 K4 calls of 4 substeps, against 8 JAX step_only calls."""
    E, steps, interval = 4, 8, 4
    jm, jp, jst, jtgt = _jax_workload(E)
    b = bench.Bench(_same_start(bench.build_workload(envs=E, device="cpu"), jst),
                    "rollout", steps, interval)
    assert (b.n_iv, b.steps) == (2, 8)
    out = b.rollout(b.work.state)
    jinteg = jint.SemiImplicitIntegrator(jm)
    act = jnp.zeros((E, jm.n_qd))
    res = jnp.zeros((E, jm.n_links, 6))
    s = jst
    for _ in range(steps):
        s = jinteg.step_only(jp, s, jtgt, act, res, DT)
    np.testing.assert_allclose(out.body_q.numpy(), np.asarray(s.body_q), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.body_qd.numpy(), np.asarray(s.body_qd), rtol=0, atol=1e-3)
    assert b.launches() == {"soa_rollout": 0}  # CPU tensors: the plain version


def test_train_mode_matches_jax():
    """Train at E=2, 2 intervals of 4 substeps: the loss and its gradients
    with respect to ke, kd, mass, bq0 and bqd0 against jax.value_and_grad
    through integrator.rollout (bench.py:321-333). The bench's own start is
    ill-conditioned for a gradient check, so both sides get the same seeded
    offsets: (1) at the targets (the initial pose) dL/dke is rounding noise
    after 9 substeps (q - target ~ 1e-7 rad, |dL/dke| ~ 1e-13), so the
    targets are offset; (2) the a1 hips start at exactly 0 rad, where the
    joint angle's polynomial atan2 has its |y| kink and each framework's
    rounding (0 or +-1e-9) picks another side, so the initial joint angles
    are offset too."""
    E, steps, interval = 2, 24, 4
    jm, jp, jst, jtgt = _jax_workload(E)
    rng = np.random.RandomState(5)
    jtgt = jtgt + jnp.asarray(
        np.concatenate([np.zeros((E, 6)), 0.3 * rng.randn(E, jm.n_dof)], 1), jnp.float32)
    qs = np.tile(np.array(jm.joint_q_init, np.float32)[None], (E, 1))
    qs[:, 7:] = np.asarray(jtgt)[:, 6:] + 0.1 * rng.randn(E, jm.n_dof)
    jst = jint.SimState(*jeval_fk(jm, jnp.asarray(qs)))
    work = _same_start(bench.build_workload(envs=E, device="cpu"), jst)
    b = bench.Bench(work._replace(target=torch.as_tensor(np.array(jtgt))), "train", steps,
                    interval)
    assert (b.n_iv, b.steps) == (2, 9)
    loss, grads = b.loss_and_grads()

    jinteg = jint.SemiImplicitIntegrator(jm)
    S = b.steps
    tgt_s = jnp.tile(jtgt[None], (S, 1, 1))
    act_s = jnp.zeros((S, E, jm.n_qd))
    res_s = jnp.zeros((S, E, jm.n_links, 6))
    norm_I = jnp.asarray(np.asarray(jm.body_inertia) / np.asarray(jm.body_mass)[:, None, None])

    def jloss(ke, kd, mass, bq0, bqd0):
        inertia = norm_I * mass[:, None, None]
        p = jp._replace(body_mass=mass, body_inv_mass=1.0 / mass, body_inertia=inertia,
                        body_inv_inertia=jnp.linalg.inv(inertia), joint_target_ke=ke,
                        joint_target_kd=kd)
        q, qd, _, _ = jint.rollout(jinteg, p, jint.SimState(bq0, bqd0), tgt_s, act_s, res_s,
                                   DT, interval)
        return jnp.mean(q ** 2) + jnp.mean(qd ** 2)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jp.joint_target_ke, jp.joint_target_kd, jp.body_mass, jst.body_q, jst.body_qd)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for name, ref in zip(bench.GRAD_NAMES, jg):
        ref = np.asarray(ref)
        got = grads[name].numpy()
        assert got.shape == ref.shape, name
        scale = np.abs(ref).max()
        assert scale > 0, name
        np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("mode,steps", [("rollout", 8), ("train", 24)])
def test_main_prints_one_json_line(mode, steps, capsys):
    out = bench.main(["--device", "cpu", "--envs", "2", "--steps", str(steps),
                      "--interval", "4", "--mode", mode])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec == json.loads(json.dumps(out))
    assert rec["metric"] == "batched_a1_%s_throughput" % (
        "training" if mode == "train" else "rollout")
    assert rec["unit"] == "env-steps/sec" and rec["value"] > 0
    d = rec["detail"]
    for k in ("envs", "steps", "wall_sec", "walls_sec", "contacts", "contact_mode", "mode",
              "interval", "launches_per_rep", "device", "nvidia_smi", "device_busy_frac",
              "bound_ms", "bound_by"):
        assert k in d, k
    assert d["envs"] == 2 and d["steps"] == (8 if mode == "rollout" else 9)
    assert d["contacts"] == 28 and d["contact_mode"] == "hull" and d["interval"] == 4
    assert d["device"] == "cpu" and d["nvidia_smi"] is None and d["device_busy_frac"] is None
    assert d["bound_ms"] > 0 and d["bound_by"] in ("bytes", "operations")
    want = {"soa_rollout"} if mode == "rollout" else {
        "soa_interval_fwd", "soa_interval_bwd", "soa_interval_reduce"}
    assert set(d["launches_per_rep"]) == want
    assert rec["value"] == pytest.approx(2 * d["steps"] / d["wall_sec"])


def test_main_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing falls back here")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--envs", "2", "--steps", "8", "--interval", "4"])
