"""The lab4d field stand-ins of the port (models/fields.py), its CameraMLP
and fit_camera_mlp (models/mlp.py) and compute_gradient
(utils/autodiff.py) against the JAX package's, with the JAX parameters
carried across (never through equal initialisation) and seeded numpy
inputs handed to both.

Tolerances: one fp32 MLP in two frameworks (the same products summed in
another order): values to 1e-5 absolute on O(1) outputs, each gradient
within 1e-5 of its largest entry. The camera fit runs 100 Adam steps; Adam
divides each step by the root of its second moment, so a parameter whose
gradient is rounding-sized moves by a rounding-dependent step of up to
~lr, so two fits of 100 steps may differ by up to ~0.2 in such a
parameter: every parameter within 5e-2 absolute, 99.9 % of them within
1e-3 and their mean difference within 1e-5 (measured: max 1.1e-2, 99.9 %
within 1.6e-4, mean 3.9e-6). The fitted loss,
about 1e-6 from a start near 1 (measured 0.7 % apart between the two),
within 1e-3 of the starting loss.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ppr_diffphys_tpu.data.robot import URDFRobot as JRobot
from ppr_diffphys_tpu.models import fields as jf
from ppr_diffphys_tpu.models.mlp import CameraMLPFlax, FrameSampler as JSampler
from ppr_diffphys_tpu.models.mlp import fit_camera_mlp as jfit
from ppr_diffphys_tpu.utils.autodiff import compute_gradient as jgrad

from ppr_diffphys_torch.data.robot import URDFRobot as TRobot
from ppr_diffphys_torch.models import fields as tf
from ppr_diffphys_torch.models import mlp as tmlp
from ppr_diffphys_torch.models.interface import interface_params_from_jax
from ppr_diffphys_torch.utils.autodiff import compute_gradient as tgrad

import port_helpers as H

OFFSETS = [0, 12, 30]
N = 9


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_grads(jg, tg, tol=1e-5):
    """jg: flax-layout tree, tg: torch state-dict names -> grads."""
    want = _flat(jg)
    for k, g in tg.items():
        path, transposed = tmlp.jax_param_path(k)
        a = want[".".join(path)]
        b = g.numpy().T if transposed else g.numpy()
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=tol, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def camera_pair():
    rng = np.random.RandomState(0)
    mod = CameraMLPFlax(num_freq_t=6, num_inst=2)
    params = mod.init(jax.random.PRNGKey(3), jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))
    params = _np(params["params"])
    bq = rng.randn(2, 4).astype(np.float32)  # a non-trivial base rotation per video
    params["base_quat"] = bq
    tm = tmlp.CameraMLP(6, 2)
    tm.load_state_dict(tmlp.cameramlp_params_from_jax(params))
    return mod, params, tm


def test_camera_mlp_matches_flax(camera_pair):
    mod, params, tm = camera_pair
    rng = np.random.RandomState(1)
    t = rng.uniform(-1, 1, N).astype(np.float32)
    vid = rng.randint(0, 2, N).astype(np.int32)
    w = rng.randn(N, 7).astype(np.float32)

    def jloss(p):
        q, tr = mod.apply({"params": p}, jnp.asarray(t), jnp.asarray(vid))
        return jnp.sum(q * w[:, :4]) + jnp.sum(tr * w[:, 4:]), (q, tr)

    (lj, (qj, trj)), gj = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray,
                                                                                params))
    qt, trt = tm(torch.as_tensor(t), torch.as_tensor(vid).long())
    lt = (qt * torch.as_tensor(w[:, :4])).sum() + (trt * torch.as_tensor(w[:, 4:])).sum()
    np.testing.assert_allclose(qt.detach().numpy(), np.asarray(qj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(trt.detach().numpy(), np.asarray(trj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad(lt, list(tm.parameters()))
    _close_grads(gj, dict(zip(names, grads)))
    # and back: the flax tree the port writes is the one it read
    back = tmlp.cameramlp_params_to_jax(tm)
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(back)[k], v)


def test_fit_camera_mlp_matches_jax(camera_pair):
    """100 Adam iterations (one chunk) from the same start to the same
    per-frame priors."""
    mod, params, tm = camera_pair
    rng = np.random.RandomState(2)
    n = OFFSETS[-1]
    ang = rng.uniform(-0.3, 0.3, (n, 3))
    rot = np.stack([jax.device_get(jnp.asarray(_rotvec(a))) for a in ang]).astype(np.float32)
    rt = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    rt[:, :3, :3] = rot
    rt[:, :3, 3] = rng.randn(n, 3) * 0.5
    sampler_j = JSampler(tuple(OFFSETS))
    sampler_t = tmlp.FrameSampler(tuple(OFFSETS))
    pj = jfit(mod, jax.tree.map(jnp.asarray, params), sampler_j, rt, max_iters=100,
              termination_loss=0.0)
    pt = tmlp.fit_camera_mlp(tm, tmlp.module_params(tm), sampler_t, rt, max_iters=100,
                             termination_loss=0.0)

    def loss_j(p):
        f = jnp.arange(n, dtype=jnp.float32)
        q, tr = mod.apply({"params": p}, sampler_j.frame_to_tid(f), sampler_j.frame_to_vid(f))
        return float(jnp.mean((_mat_j(q, tr) - rt) ** 2))

    f = torch.arange(n, dtype=torch.float32)
    q, tr = torch.func.functional_call(tm, pt, (sampler_t.frame_to_tid(f),
                                                sampler_t.frame_to_vid(f)))
    loss_t = float(torch.mean((tmlp.camera_matrix(q, tr) - torch.as_tensor(rt)) ** 2))
    lj, l0 = loss_j(pj), loss_j(jax.tree.map(jnp.asarray, params))
    assert lj < 1e-2 * l0  # the fit moved
    np.testing.assert_allclose(loss_t, lj, atol=1e-3 * l0, rtol=0)
    got = _flat(tmlp.cameramlp_params_to_jax(pt))
    d = np.concatenate([np.abs(got[k] - v).ravel() for k, v in _flat(pj).items()])
    print("fit: parameter differences max %.3g, 99.9%% %.3g, mean %.3g"
          % (d.max(), np.quantile(d, 0.999), d.mean()))
    assert d.max() <= 5e-2 and np.quantile(d, 0.999) <= 1e-3 and d.mean() <= 1e-5


def _rotvec(a):
    from ppr_diffphys_tpu.ops import axis_angle_to_quat, quat_to_matrix
    return quat_to_matrix(axis_angle_to_quat(jnp.asarray(a, jnp.float32)))


def _mat_j(quat, trans):
    from ppr_diffphys_tpu.ops import quat_normalize, quat_to_matrix
    q = jnp.concatenate([quat[..., 1:], quat[..., :1]], -1)
    m = jnp.zeros(quat.shape[:-1] + (4, 4)).at[..., :3, :3].set(quat_to_matrix(quat_normalize(q)))
    return m.at[..., :3, 3].set(trans).at[..., 3, 3].set(1.0)


@pytest.fixture(scope="module")
def field_pair():
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    jobj = jf.ObjectField(OFFSETS, JRobot(H.A1_URDF), k1)
    jscn = jf.CameraField(OFFSETS, k2, name="scene_field")
    jin = jf.IntrinsicsField(OFFSETS)
    g = torch.Generator().manual_seed(4)
    tobj = tf.ObjectField(OFFSETS, TRobot(H.A1_URDF), g)
    tscn = tf.CameraField(OFFSETS, g, name="scene_field")
    tin = tf.IntrinsicsField(OFFSETS)
    rng = np.random.RandomState(5)
    trees = {}
    for name, spec in (("obj", jobj), ("scn", jscn), ("in", jin)):
        p = _np(spec.init_params)
        trees[name] = p
    # move every field off its identity start
    trees["obj"]["logscale"] = np.float32(0.3)
    trees["obj"]["field2world"] = np.concatenate(
        [rng.randn(2, 3), rng.randn(2, 4)], -1).astype(np.float32)
    art = trees["obj"]["articulation"]
    art["rest_offsets"] = (rng.randn(*art["rest_offsets"].shape) * 0.01).astype(np.float32)
    art["logscale"] = np.float32(-0.2)
    trees["in"]["ks"] = (trees["in"]["ks"] + rng.randn(*trees["in"]["ks"].shape)).astype(
        np.float32)
    ported = {k: interface_params_from_jax(v) for k, v in trees.items()}
    return (jobj, jscn, jin), (tobj, tscn, tin), trees, ported


def test_fields_match_jax(field_pair):
    (jobj, jscn, jin), (tobj, tscn, tin), trees, ported = field_pair
    fr = np.array([0.0, 3.5, 11.0, 12.0, 20.25, 29.0], np.float32)
    jfr, tfr = jnp.asarray(fr), torch.as_tensor(fr)
    vid = np.array([0, 1, 1, 0], np.int32)
    for spec_j, spec_t, k in ((jobj, tobj, "obj"), (jscn, tscn, "scn")):
        np.testing.assert_allclose(spec_t.get_camera(ported[k], tfr).numpy(),
                                   np.asarray(spec_j.get_camera(trees[k], jfr)),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(
            spec_t.get_field2world(ported[k], torch.as_tensor(vid).long()).numpy(),
            np.asarray(spec_j.get_field2world(trees[k], jnp.asarray(vid))), atol=1e-6)
    art_j, art_t = jobj.articulation_spec, tobj.articulation_spec
    pj, pt = trees["obj"]["articulation"], ported["obj"]["articulation"]
    np.testing.assert_allclose(art_t.get_vals(pt, tfr).detach().numpy(),
                               np.asarray(art_j.get_vals(pj, jfr)), atol=1e-5)
    np.testing.assert_allclose(
        art_t.compute_rel_rest_joints(pt, torch.as_tensor(vid)).numpy(),
        np.asarray(art_j.compute_rel_rest_joints(pj, jnp.asarray(vid))), atol=1e-7)
    np.testing.assert_allclose(art_t.local_rest_coord.numpy(),
                               np.asarray(art_j.local_rest_coord))
    np.testing.assert_array_equal(tin.get_vals(ported["in"], tfr).numpy(),
                                  np.asarray(jin.get_vals(trees["in"], jfr)))


def test_compute_gradient_matches_jax():
    rng = np.random.RandomState(6)
    W = rng.randn(3, 4).astype(np.float32)
    x = rng.randn(5, 3).astype(np.float32)
    gj = jgrad(lambda v: jnp.tanh(v @ W) * v[:, :1], jnp.asarray(x))
    Wt = torch.as_tensor(W)
    gt = tgrad(lambda v: torch.tanh(v @ Wt) * v[:, :1], torch.as_tensor(x))
    assert gt.shape == (5, 3, 4)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6)
