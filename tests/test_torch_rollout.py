"""The bench rollout of the port (sim/soa.py:build_soa_rollout; CPU tensors
run its plain version, integrator.rollout_substeps) against the JAX
package: the Pallas kernel in interpret mode (pallas_soa.build_soa_rollout,
the TPU kernel K4 this slice ports) and the loop of JAX ``step_only`` calls
that tests/test_pallas.py holds it against, on a1 and on the
FIXED/COMPOUND/REVOLUTE chain, E=8 envs, S=4 substeps, with random acts and
with zero acts, from grounded states (penetrating contacts) and from random
states near and under the ground (random orientations and velocities).

Tolerances are tests/test_pallas.py's between the JAX package's own two
engines: q 2e-5 / qd 2e-3 from grounded states, 5e-5 / 5e-3 from random
states (velocities up to ~5 rad/s and m/s, contact forces at their clamps).

The CUDA kernel runs only on a GPU: tests/test_torch_cuda.py holds it
against this plain version there, and chip_smoke.py does so at the bench's
shapes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ppr_diffphys_tpu.sim.builder as jbuilder
import ppr_diffphys_tpu.sim.import_urdf as jimport
from ppr_diffphys_tpu.ops import quat_normalize as jquat_normalize
from ppr_diffphys_tpu.sim import integrator as jint
from ppr_diffphys_tpu.sim import pallas_soa as jsoa
from ppr_diffphys_tpu.sim.kinematics import eval_fk as jeval_fk

import ppr_diffphys_torch.sim.builder as tbuilder
import ppr_diffphys_torch.sim.import_urdf as timport
from ppr_diffphys_torch.sim import integrator as tint
from ppr_diffphys_torch.sim import soa as tsoa
from ppr_diffphys_torch.sim.synthetic import chain_model

import port_helpers as H

DT = 5e-4
E, S = 8, 4
TOL = {"grounded": (2e-5, 2e-3), "random": (5e-5, 5e-3)}


def _models(name):
    if name == "a1":
        return H.a1_model(jbuilder, jimport), H.a1_model(tbuilder, timport)
    return chain_model(jbuilder.ModelBuilder), chain_model(tbuilder.ModelBuilder)


@pytest.fixture(scope="module", params=["a1", "chain"])
def models(request):
    return request.param, _models(request.param)


def _params(jm, per_env=False):
    ke, kd, mass, norm_I = H.sim_params_np(jm, E if per_env else None, seed=3)
    inertia = norm_I * mass[..., None, None]
    jp = jint.SimParams(
        body_mass=jnp.asarray(mass), body_inv_mass=1.0 / jnp.asarray(mass),
        body_inertia=jnp.asarray(inertia),
        body_inv_inertia=jnp.linalg.inv(jnp.asarray(inertia)),
        joint_target_ke=jnp.asarray(ke), joint_target_kd=jnp.asarray(kd),
    )
    t = torch.as_tensor
    tp = tint.SimParams(t(mass), 1.0 / t(mass), t(inertia), torch.linalg.inv(t(inertia)),
                        t(ke), t(kd))
    return jp, tp


def _states(jm, kind, seed=11):
    """(body_q (E,B,7), body_qd (E,B,6), targets (S,E,n_qd), acts) in numpy."""
    if kind == "grounded":
        q, qd, tgt, act = H.window_problem(jm, E, S, 2, seed)
        bq, bqd = jeval_fk(jm, jnp.asarray(q), jnp.asarray(qd))
        bq = H.grounded(jm, np.asarray(bq), seed)
        return bq, np.array(bqd), tgt[:S], act[:S]
    # tests/test_pallas.py:92-104 with the model's body count
    rng = np.random.RandomState(seed)
    B = jm.n_links
    pos = rng.uniform([-0.3, -0.02, -0.3], [0.3, 0.4, 0.3], (E, B, 3))
    quat = np.asarray(jquat_normalize(jnp.asarray(rng.randn(E, B, 4), jnp.float32)))
    bq = np.concatenate([pos.astype(np.float32), quat], -1)
    bqd = (rng.randn(E, B, 6) * 1.5).astype(np.float32)
    tgt = (rng.randn(S, E, jm.n_qd) * 0.3).astype(np.float32)
    act = (rng.randn(S, E, jm.n_qd) * 0.1).astype(np.float32)
    return bq, bqd, tgt, act


@pytest.mark.parametrize("kind", ["grounded", "random"])
def test_rollout_matches_jax(models, kind):
    name, (jm, tm) = models
    jp, tp = _params(jm)
    bq, bqd, tgt, act = _states(jm, kind)
    jinteg = jint.SemiImplicitIntegrator(jm)
    jkern = jsoa.build_soa_rollout(jinteg, jp, DT, S, e_tile=8, interpret=True)
    kern = tsoa.build_soa_rollout(tint.SemiImplicitIntegrator(tm), tp, DT, S)
    jst = jint.SimState(jnp.asarray(bq), jnp.asarray(bqd))
    tst = tint.SimState(torch.as_tensor(bq), torch.as_tensor(bqd))
    res = jnp.zeros((E, jm.n_links, 6))
    tol_q, tol_qd = TOL[kind]
    for acts in (act, np.zeros_like(act)):
        # zero acts go to the port as None (no acts), to JAX as zeros
        out = kern(tst, torch.as_tensor(tgt), torch.as_tensor(acts) if acts.any() else None)
        assert out.body_q.shape == (E, tm.n_links, 7) and out.body_qd.shape == (E, tm.n_links, 6)
        refs = {"pallas": jkern(jst, jnp.asarray(tgt), jnp.asarray(acts))}
        s = jst
        for i in range(S):
            s = jinteg.step_only(jp, s, jnp.asarray(tgt[i]), jnp.asarray(acts[i]), res, DT)
        refs["step_only"] = s
        for what, ref in refs.items():
            msg = "%s/%s/%s vs %s" % (name, kind, "act" if acts.any() else "zero-act", what)
            np.testing.assert_allclose(out.body_q.numpy(), np.asarray(ref.body_q), rtol=0,
                                       atol=tol_q, err_msg=msg)
            np.testing.assert_allclose(out.body_qd.numpy(), np.asarray(ref.body_qd), rtol=0,
                                       atol=tol_qd, err_msg=msg)
    assert kern.launches == 0  # CPU tensors run the plain version


def test_rollout_exercises_the_contact_law(models):
    """The grounded states press contacts into the ground, so the checks
    above reach the contact law."""
    _, (jm, tm) = models
    bq, bqd, _, _ = _states(jm, "grounded")
    st = tint.SimState(torch.as_tensor(bq), torch.as_tensor(bqd))
    f = tint.eval_body_contacts(tm, tint.default_sim_params(tm), st)
    assert float(f[..., 3:].abs().max()) > 1.0


def test_rollout_rejects_what_the_kernel_does_not_take(models):
    _, (jm, tm) = models
    integ = tint.SemiImplicitIntegrator(tm)
    _, per_env = _params(jm, per_env=True)
    with pytest.raises(ValueError, match="per-env"):
        tsoa.build_soa_rollout(integ, per_env, DT, S)
    _, shared = _params(jm)
    with pytest.raises(ValueError, match="joint_X_p"):
        tsoa.build_soa_rollout(integ, shared._replace(
            joint_X_p=torch.as_tensor(tm.joint_X_p)), DT, S)
    kern = tsoa.build_soa_rollout(integ, shared, DT, S)
    st = tint.SimState(torch.zeros(2, tm.n_links, 7), torch.zeros(2, tm.n_links, 6))
    with pytest.raises(ValueError, match="substeps"):
        kern(st, torch.zeros(S + 1, 2, tm.n_qd))


def test_rollout_work_counts(models):
    """K4's bound counts window_work's operations per env-substep, S full
    substeps, and its inputs and outputs once."""
    _, (_, tm) = models
    E_, S_ = 4096, 33
    w = tsoa.rollout_work(tm, E_, S_)
    per = tsoa.window_work(tm, E_, S_, 2)["per_env_substep"]
    assert w["per_env_substep"] == per
    assert w["ops"] == E_ * S_ * per
    B, n_qd = tm.n_links, tm.n_qd
    state = 13 * B * E_ * 4
    seq = S_ * n_qd * E_ * 4
    assert 2 * state + 2 * seq < w["bytes"] < 2 * state + 2 * seq + 64 * 1024
