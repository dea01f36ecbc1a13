"""The serving window of the port (ppr_diffphys_torch/sim/soa.py) against the
JAX package: static constants, parameter planes, and the plain window
(integrator.rollout, what CPU tensors run) against both JAX engines — the
Pallas window kernel in interpret mode (pallas_soa.build_soa_window, the
TPU kernel this slice ports) and the XLA scan (integrator.rollout) — on a1
and on a FIXED/COMPOUND/REVOLUTE chain with active joint limits, with
shared and per-env gains and masses, and with penetrating contacts.

The CUDA kernel itself runs only on a GPU: tests/test_torch_cuda.py holds
it against this plain version there, and chip_smoke.py does so at serving
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
from ppr_diffphys_tpu.sim import pallas_soa as jsoa
from ppr_diffphys_tpu.sim.kinematics import eval_fk as jeval_fk

import ppr_diffphys_torch.sim.builder as tbuilder
import ppr_diffphys_torch.sim.import_urdf as timport
from ppr_diffphys_torch.sim import integrator as tint
from ppr_diffphys_torch.sim import soa as tsoa
from ppr_diffphys_torch.sim.synthetic import chain_model

import port_helpers as H


DT = 5e-4

# Tolerances: the port's plain window and the JAX XLA scan are the same
# algorithm in two frameworks, both fp32 on the CPU, so they differ only by
# summation order and op fusion: q 1e-5, qd 1e-3, grf/jaf 1e-2 (jaf is
# dominated by attach springs, ke=16000 N/m times position differences of
# ~1e-7 m). Against the Pallas kernel (another formulation of the same
# substep: plane layout, one-hot matmul gathers) the port is held to the
# tolerances the JAX package holds between its own two engines
# (tests/test_pallas_grad.py:174-177): q 2e-5, qd 2e-3, grf/jaf 2e-2.
TOL_XLA = dict(q=1e-5, qd=1e-3, grf=1e-2, jaf=1e-2)
TOL_PALLAS = dict(q=2e-5, qd=2e-3, grf=2e-2, jaf=2e-2)


def _models(name):
    if name == "a1":
        return H.a1_model(jbuilder, jimport), H.a1_model(tbuilder, timport)
    return chain_model(jbuilder.ModelBuilder), chain_model(tbuilder.ModelBuilder)


def _params(jm, tm, per_env, E):
    ke, kd, mass, norm_I = H.sim_params_np(jm, E if per_env else None, seed=3)
    I = norm_I * mass[..., None, None]
    jp = jint.SimParams(
        body_mass=jnp.asarray(mass), body_inv_mass=1.0 / jnp.asarray(mass),
        body_inertia=jnp.asarray(I), body_inv_inertia=jnp.linalg.inv(jnp.asarray(I)),
        joint_target_ke=jnp.asarray(ke), joint_target_kd=jnp.asarray(kd),
    )
    t = lambda x: torch.as_tensor(np.asarray(x))
    tp = tint.SimParams(
        body_mass=t(mass), body_inv_mass=1.0 / t(mass), body_inertia=t(I),
        body_inv_inertia=torch.linalg.inv(t(I)),
        joint_target_ke=t(ke), joint_target_kd=t(kd),
    )
    return jp, tp


@pytest.fixture(scope="module", params=["a1", "chain"])
def models(request):
    return request.param, _models(request.param)


def test_static_constants_match_jax(models):
    name, (jm, tm) = models
    _, jconst, meta = jsoa.build_soa_static(
        jint.SemiImplicitIntegrator(jm), DT, contact_layout="loop"
    )
    tconst = tsoa.soa_static(tm)
    for k in ("axis_c", "xp_t", "xp_q", "xc_q", "com", "rp_local", "lim", "cpt",
              "cdist", "cmat"):
        np.testing.assert_array_equal(tconst[k].numpy(), np.asarray(jconst[k]), err_msg=k)
    B = jm.n_links
    parent = tconst["parent"].numpy()
    jt = tconst["joint_type"].numpy()
    # the TPU kernel's masks and one-hot gather/scatter/dof matrices are the
    # port's index tables
    np.testing.assert_array_equal((parent >= 0)[:, None], np.asarray(jconst["has_parent"]) > 0)
    for name, code in (("m_fix", 3), ("m_rev", 1), ("m_cmp", 4)):
        np.testing.assert_array_equal((jt == code)[:, None], np.asarray(jconst[name]) > 0)
    pg = np.zeros((B, B), np.float32)
    pg[np.arange(B), np.where(parent >= 0, parent, 0)] = 1.0
    np.testing.assert_array_equal(pg, np.asarray(jconst["P_gather"]))
    ps = np.zeros((B, B), np.float32)
    for i in np.nonzero(parent >= 0)[0]:
        ps[parent[i], i] = 1.0
    np.testing.assert_array_equal(ps, np.asarray(jconst["P_scatter"]))
    D = np.zeros((3, B, jm.n_qd), np.float32)
    didx = tconst["dof_idx"].numpy()
    for k in range(3):
        D[k, np.arange(B), didx[:, k]] = 1.0
    np.testing.assert_array_equal(D, np.asarray(jconst["D"]))
    np.testing.assert_array_equal(tconst["contact_body"].numpy(), jm.contact_body)
    np.testing.assert_array_equal(tconst["joint_type"].numpy(), jm.joint_type)


def test_packed_constants_layout(models):
    """The kernel's packed buffers hold the named constants at the offsets
    csrc/soa_window.cu reads them from."""
    _, (_, tm) = models
    st = tsoa.soa_static(tm)
    pk = tsoa.pack_static(st)
    bf, bi, cf = pk["body_f"].numpy(), pk["body_i"].numpy(), pk["cf"].numpy()
    B, C = tm.n_links, tm.contact_count
    assert bf.shape == (B, 32) and bi.shape == (B, 5) and cf.shape == (C, 8)
    np.testing.assert_array_equal(bf[:, 0:3], tm.joint_axis)
    np.testing.assert_array_equal(bf[:, 3:10], tm.joint_X_p)
    np.testing.assert_array_equal(bf[:, 10:14], tm.joint_X_c[:, 3:7])
    np.testing.assert_array_equal(bf[:, 14:17], tm.body_com)
    np.testing.assert_array_equal(bf[:, 17:20], st["rp_local"].numpy()[..., 0].T)
    didx = tsoa.dof_index(tm)
    for j, arr in enumerate((tm.joint_limit_lower, tm.joint_limit_upper,
                             tm.joint_limit_ke, tm.joint_limit_kd)):
        np.testing.assert_array_equal(bf[:, 20 + 3 * j: 23 + 3 * j], arr[didx])
    np.testing.assert_array_equal(bi[:, 0], tm.joint_parent)
    np.testing.assert_array_equal(bi[:, 1], tm.joint_type)
    np.testing.assert_array_equal(bi[:, 2:5], didx)
    np.testing.assert_array_equal(cf[:, 0:3], tm.contact_point)
    np.testing.assert_array_equal(cf[:, 3], tm.contact_dist)
    np.testing.assert_array_equal(cf[:, 4:8], tm.contact_material)


@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_traced_planes_match_jax(models, per_env):
    _, (jm, tm) = models
    jp, tp = _params(jm, tm, per_env, E=4)
    jpl = jsoa.traced_planes(jm, jp)
    tpl = tsoa.traced_planes(tm, tp)
    assert set(tpl) == set(jsoa.TRACED_NAMES)
    # the window wrapper's call, with its copy of the dof index kept per device
    cached = tsoa.traced_planes(tm, tp, tsoa.PackedConsts(tm).dof_index("cpu"))
    assert all(torch.equal(cached[k], tpl[k]) for k in tpl)
    for k in jsoa.TRACED_NAMES:
        assert tpl[k].shape == jpl[k].shape, k
        # inverses come from two LAPACK calls: 1e-6 relative
        np.testing.assert_allclose(tpl[k].numpy(), np.asarray(jpl[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def _window_inputs(jm, E, sub, F, seed):
    q, qd, tgt, act = H.window_problem(jm, E, sub, F, seed)
    bq, bqd = jeval_fk(jm, jnp.asarray(q), jnp.asarray(qd))
    bq = H.grounded(jm, np.asarray(bq), seed)
    return bq, np.array(bqd), tgt, act


def _check(name, outs, ref, tol, what):
    for k, a, b in zip(("q", "qd", "grf", "jaf"), outs, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, atol=tol[k], rtol=0,
                                   err_msg="%s %s vs %s" % (name, k, what))


@pytest.mark.parametrize("per_env", [False, True], ids=["shared", "per_env"])
def test_plain_window_matches_jax(models, per_env):
    name, (jm, tm) = models
    E, sub, F = 4, 3, 4
    bq, bqd, tgt, act = _window_inputs(jm, E, sub, F, seed=9)
    jp, tp = _params(jm, tm, per_env, E)
    jinteg = jint.SemiImplicitIntegrator(jm)
    jst = jint.SimState(jnp.asarray(bq), jnp.asarray(bqd))

    window = tsoa.SoaWindow(tint.SemiImplicitIntegrator(tm), DT, sub, F)
    tst = tint.SimState(torch.as_tensor(bq), torch.as_tensor(bqd))
    outs = window(tst, torch.as_tensor(tgt), torch.as_tensor(act), tp)
    # the contact law must have been exercised
    assert float(torch.abs(outs[2][..., 3:]).max()) > 1.0

    ref_xla = jint.rollout(
        jinteg, jp, jst, jnp.asarray(tgt), jnp.asarray(act),
        jnp.zeros((tgt.shape[0], E, jm.n_links, 6)), DT, sub,
    )
    _check(name, outs, ref_xla, TOL_XLA, "jax integrator.rollout")

    kern = jsoa.build_soa_window(jinteg, jp, DT, sub, F, e_tile=2, interpret=True)
    ref_pallas = kern(jst, jnp.asarray(tgt), jnp.asarray(act), jsoa.traced_planes(jm, jp))
    _check(name, outs, ref_pallas, TOL_PALLAS, "jax build_soa_window(interpret=True)")


def test_plain_window_act_none_is_zero_act(models):
    """act=None (serving: activations structurally zero) equals zero acts."""
    _, (jm, tm) = models
    E, sub, F = 2, 3, 3
    bq, bqd, tgt, _ = _window_inputs(jm, E, sub, F, seed=4)
    _, tp = _params(jm, tm, False, E)
    window = tsoa.SoaWindow(tint.SemiImplicitIntegrator(tm), DT, sub, F)
    st = tint.SimState(torch.as_tensor(bq), torch.as_tensor(bqd))
    a = window(st, torch.as_tensor(tgt), None, tp)
    b = window(st, torch.as_tensor(tgt), torch.zeros(tgt.shape), tp)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_window_rejects_wrong_substep_count(models):
    _, (_, tm) = models
    window = tsoa.SoaWindow(tint.SemiImplicitIntegrator(tm), DT, 3, 3)
    with pytest.raises(ValueError):
        window(tint.SimState(torch.zeros(1, tm.n_links, 7), torch.zeros(1, tm.n_links, 6)),
               torch.zeros(6, 1, tm.n_qd), None,
               tint.default_sim_params(tm))


def test_window_work_counts():
    """The roofline inputs chip_smoke.py reports: a1 needs ~1e4 operations
    per env-substep, and the serving window moves its targets and outputs
    once."""
    tm = H.a1_model(tbuilder, timport)
    w = tsoa.window_work(tm, E=4096, substeps=33, n_frames=24)
    assert 1.0e4 < w["per_env_substep"] < 1.3e4
    S = 33 * 23 + 1
    assert w["bytes"] > (S * 18 + 24 * 25 * 13) * 4096 * 4
    assert w["ops"] > S * 4096 * 1.0e4
