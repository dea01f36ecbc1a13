"""Forward kinematics of the port (sim/kinematics.py:eval_fk) against the
JAX package on a1 and on the FIXED/COMPOUND/REVOLUTE chain: body_q and
body_qd for seeded random joint angles and rates, with extra batch dims and
with a joint_X_p override; and the gradients of a weighted sum of both
outputs with respect to joint_q and joint_qd against ``jax.grad``.

Tolerance: fp32 on both sides with the same composition order; positions
and quaternions agree to 2e-6, COM velocities (sums of cross products of
rates ~1 rad/s with lever arms ~0.5 m) to 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ppr_diffphys_tpu.sim.builder as jbuilder
import ppr_diffphys_tpu.sim.import_urdf as jimport
from ppr_diffphys_tpu.sim.kinematics import eval_fk as jfk

import ppr_diffphys_torch.sim.builder as tbuilder
import ppr_diffphys_torch.sim.import_urdf as timport
from ppr_diffphys_torch.sim.kinematics import eval_fk as tfk
from ppr_diffphys_torch.sim.synthetic import chain_model

import port_helpers as H


def _models(name):
    if name == "a1":
        return (H.a1_model(jbuilder, jimport), H.a1_model(tbuilder, timport))
    return chain_model(jbuilder.ModelBuilder), chain_model(tbuilder.ModelBuilder)


def _cmp(jout, tout):
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), atol=2e-6, rtol=0)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["a1", "chain"])
def test_eval_fk_matches_jax(name):
    jm, tm = _models(name)
    q, qd = H.random_joint_state(jm, 6, seed=1)
    qd[:, :6] *= 3.0  # a moving root
    j = jfk(jm, jnp.asarray(q), jnp.asarray(qd))
    t = tfk(tm, torch.as_tensor(q), torch.as_tensor(qd))
    assert t[0].shape == (6, tm.n_links, 7) and t[1].shape == (6, tm.n_links, 6)
    _cmp(j, t)
    # zero velocities when joint_qd is omitted
    j0 = jfk(jm, jnp.asarray(q))
    t0 = tfk(tm, torch.as_tensor(q))
    _cmp(j0, t0)
    assert float(torch.abs(t0[1]).max()) == 0.0


@pytest.mark.parametrize("name", ["a1", "chain"])
def test_eval_fk_batch_dims_and_anchor_override(name):
    jm, tm = _models(name)
    q, qd = H.random_joint_state(jm, 6, seed=2)
    q, qd = q.reshape(2, 3, -1), qd.reshape(2, 3, -1)
    rng = np.random.RandomState(3)
    xp = np.array(jm.joint_X_p)
    xp[:, 0:3] += rng.uniform(-0.01, 0.01, xp[:, 0:3].shape).astype(np.float32)
    j = jfk(jm, jnp.asarray(q), jnp.asarray(qd), joint_X_p=jnp.asarray(xp))
    t = tfk(tm, torch.as_tensor(q), torch.as_tensor(qd), joint_X_p=torch.as_tensor(xp))
    assert t[0].shape == (2, 3, tm.n_links, 7)
    _cmp(j, t)


@pytest.mark.parametrize("name", ["a1", "chain"])
def test_eval_fk_gradients_match_jax(name):
    """The initial state of the training rollout flows back through eval_fk
    into the MLPs and global_q. Tolerance: each gradient within 1e-5 of its
    largest entry (the same fp32 compositions; measured ~1e-7)."""
    jm, tm = _models(name)
    q, qd = H.random_joint_state(jm, 4, seed=6)
    rng = np.random.RandomState(7)
    wq = rng.randn(4, jm.n_links, 7).astype(np.float32)
    wqd = rng.randn(4, jm.n_links, 6).astype(np.float32)

    def jloss(q, qd):
        bq, bqd = jfk(jm, q, qd)
        return jnp.sum(bq * wq) + jnp.sum(bqd * wqd)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(qd))
    tq = torch.as_tensor(q).requires_grad_()
    tqd = torch.as_tensor(qd).requires_grad_()
    bq, bqd = tfk(tm, tq, tqd)
    loss = (bq * torch.as_tensor(wq)).sum() + (bqd * torch.as_tensor(wqd)).sum()
    tg = torch.autograd.grad(loss, (tq, tqd))
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        scale = np.abs(a).max()
        np.testing.assert_allclose(b.numpy() / scale, a / scale, atol=1e-5, rtol=0)
