"""The lab4d coupling of the port (models/interface.py: query_q, query_ja,
phys_interface, KinematicsProxy) against the JAX package's, on the a1
fixture with the fields of models/fields.py over two videos (offsets
[0, 12, 30]), 4 substeps a frame, pos_distill_wt 0.1 and noise_std 0. a1
has no kp links in its template table, so both models get its four calf
links after construction, as the lab4d quad and human templates have theirs.
The JAX parameters are carried into the port (interface_params_from_jax,
which load_checkpoint uses); the JAX model runs its XLA engine, the port
the plain interval (CPU tensors), both with the live per-env joint anchors
of query_ja.

Tolerances: the same fp32 pipeline (fields, MLPs, FK, 8 substeps, losses)
in two frameworks, as tests/test_torch_train.py: losses to rtol 1e-4, each
gradient within 5e-4 of its largest entry (measured ~6e-6), parameters
after 2 updates to 1e-5 relative plus 1e-5 absolute; query_q/query_ja
values to 1e-5 absolute.
"""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ppr_diffphys_tpu.data.robot import URDFRobot as JRobot
from ppr_diffphys_tpu.models import fields as jf
from ppr_diffphys_tpu.models.interface import KinematicsProxy as JProxy
from ppr_diffphys_tpu.models.interface import phys_interface as JInterface
from ppr_diffphys_tpu.models.interface import query_ja as jquery_ja
from ppr_diffphys_tpu.models.interface import query_q as jquery_q
from ppr_diffphys_tpu.utils.config import build_opts as jbuild_opts

from ppr_diffphys_torch.data.robot import URDFRobot as TRobot
from ppr_diffphys_torch.models import fields as tf
from ppr_diffphys_torch.models import interface as ti
from ppr_diffphys_torch.utils.config import build_opts as tbuild_opts

import port_helpers as H

OFFSETS = [0, 12, 30]
KP_LINKS = ["FR_calf", "FL_calf", "RR_calf", "RL_calf"]
E, F = 2, 3
FRAME_START = np.array([0.0, 14.0], np.float32)


def _opts(build, logroot):
    return build(seqname="lab4d-a1", logname="t", urdf_template="a1", urdf_dir=H.FIXTURES,
                 num_rounds=1, iters_per_round=2, logroot=logroot, pos_distill_wt=0.1,
                 phys_vid=[0, 1], noise_std=0.0)


def _model_dict(obj, scn, intr):
    return dict(scene_field=(scn, scn.init_params), object_field=(obj, obj.init_params),
                intrinsics=(intr, intr.init_params), frame_interval=4 * 5e-4, frame_info=None)


def _perturb(tree, rng):
    """Move the fields off their identity start, the same way in both."""
    art = tree["object_field"]["articulation"]
    art["rest_offsets"] = (rng.randn(*np.shape(art["rest_offsets"])) * 0.01).astype(np.float32)
    art["shift"] = (rng.randn(3) * 0.02).astype(np.float32)
    tree["scene_field"]["field2world"] = np.concatenate(
        [rng.randn(2, 3) * 0.05, [[0.02, 0.0, 0.01, 1.0], [0.0, -0.03, 0.0, 1.0]]],
        -1).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jobj = jf.ObjectField(OFFSETS, JRobot(H.A1_URDF), k1)
    jscn = jf.CameraField(OFFSETS, k2, name="scene_field")
    jm = JInterface(_opts(jbuild_opts, str(tmp_path_factory.mktemp("j"))),
                    _model_dict(jobj, jscn, jf.IntrinsicsField(OFFSETS)))
    g = torch.Generator().manual_seed(0)
    tobj = tf.ObjectField(OFFSETS, TRobot(H.A1_URDF), g)
    tscn = tf.CameraField(OFFSETS, g, name="scene_field")
    tm = ti.phys_interface(_opts(tbuild_opts, str(tmp_path_factory.mktemp("t"))),
                           _model_dict(tobj, tscn, tf.IntrinsicsField(OFFSETS)), device="cpu")
    for m in (jm, tm):
        m.robot.urdf.kp_links = list(KP_LINKS)
    tree = _perturb(jax.tree.map(np.asarray, jm.params), np.random.RandomState(3))
    for sub in ("kinematics_proxy", "kinematics_distilled"):
        for k in ("object_field", "scene_field"):
            tree[sub][k] = jax.tree.map(np.copy, tree[k])
    jm.params = jax.tree.map(jnp.asarray, tree)
    tm.load_params_from_jax(tree)
    return jm, tm


def _leaves(jm, tree):
    return {jm._leaf_name(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_grad(name, got, want):
    got = got.T if name.endswith("kernel") else got
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=5e-4, rtol=0,
                               err_msg="grad " + name)


def test_interface_tree_and_lr_routing(models):
    """The port's tree names every tensor by the JAX path, with the same
    per-tensor learning rates (frozen fields, logscales at 10x)."""
    jm, tm = models
    want = _leaves(jm, jm.param_lr_tree)
    got = {n: tm._param_lr(n) for n, _ in tm.named_tensors()}
    assert set(got) == set(want)
    for n, lr in want.items():
        assert got[n] == pytest.approx(float(lr)), n
    assert "root_pose_mlp" not in tm.params and "kinematics_proxy" in tm.params
    assert got["object_field.logscale"] > 0 and got["object_field.camera_mlp.base_quat"] == 0


def test_train_step_matches_jax(models):
    """The loss dict (pos_distill included) and every tensor's gradient of
    one forward, then the parameters after 2 forward+update steps."""
    jm, tm = models
    for m in (jm, tm):
        m.reinit_envs(E, frames_per_wdw=F, is_eval=False)
    jout = jm.forward(frame_start=FRAME_START)
    tout = tm.forward(frame_start=FRAME_START)
    assert set(jout) == set(tout)
    for k in jout:
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    assert float(tout["loss_pos_distill"]) > 0

    jg = _leaves(jm, jm._grad_accum[-1][0])
    assert set(tm.last_grads) == set(jg)
    for name, g in tm.last_grads.items():
        _check_grad(name, g.numpy(), jg[name])
    # the anchors' gradient reached the rest joints (through query_ja)
    assert float(tm.last_grads["object_field.articulation.rest_offsets"].abs().max()) > 0

    for i in range(2):
        if i:
            jm.forward(frame_start=FRAME_START)
            tm.forward(frame_start=FRAME_START)
        jm.update()
        tm.update()
    want = _leaves(jm, jm.params)
    got = _leaves(jm, tm.state_np())
    assert set(got) == set(want)
    for n, v in want.items():
        np.testing.assert_allclose(got[n], v, rtol=1e-5, atol=1e-5, err_msg=n)


def test_query_q_and_query_ja_match_jax(models):
    """Values and gradients (every field tensor they read) of the urdf->world
    chain and the joint angles with their live anchors."""
    jm, tm = models
    fr = np.array([0.0, 5.5, 11.0, 12.0, 17.25, 29.0], np.float32)
    rng = np.random.RandomState(4)
    w_q, w_v = rng.randn(len(fr), 7), rng.randn(len(fr), 4, 4)
    w_a, w_x = rng.randn(len(fr), tm.n_dof), rng.randn(len(fr), tm.n_links, 7)

    def jloss(obj, scn):
        q, w2v = jquery_q(jnp.asarray(fr), jm.object_spec, obj, jm.scene_spec, scn,
                          jm.articulation_spec, obj["articulation"])
        ja, xp = jquery_ja(jnp.asarray(fr), jm.articulation_spec, obj["articulation"],
                           jm.n_links)
        return (jnp.sum(q * w_q) + jnp.sum(w2v * w_v) + jnp.sum(ja * w_a)
                + jnp.sum(xp * w_x)), (q, w2v, ja, xp)

    (lj, outs_j), (gobj, gscn) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jm.params["object_field"], jm.params["scene_field"])
    obj, scn = tm.params["object_field"], tm.params["scene_field"]
    named = ti.tree_items({"object_field": obj, "scene_field": scn})
    for _, t in named:
        t.requires_grad_(True)
    try:
        tfr = torch.as_tensor(fr)
        q, w2v = ti.query_q(tfr, tm.object_spec, obj, tm.scene_spec, scn,
                            tm.articulation_spec, obj["articulation"])
        ja, xp = ti.query_ja(tfr, tm.articulation_spec, obj["articulation"], tm.n_links)
        t = lambda a: torch.as_tensor(a, dtype=torch.float32)
        lt = ((q * t(w_q)).sum() + (w2v * t(w_v)).sum() + (ja * t(w_a)).sum()
              + (xp * t(w_x)).sum())
        grads = torch.autograd.grad(lt, [x for _, x in named], allow_unused=True)
    finally:
        for _, x in named:
            x.requires_grad_(False)
    for a, b in zip((q, w2v, ja, xp), outs_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    want = _leaves(jm, {"object_field": gobj, "scene_field": gscn})
    for (name, x), g in zip(named, grads):
        g = torch.zeros_like(x) if g is None else g
        _check_grad(name, g.numpy(), want[name])


def test_eval_forward_camera_and_query(models):
    """The eval forward over the whole sequence (1 env; the live anchors take
    the no-gradient interval chain, not the window), its vis cameras,
    get_camera and query(img_size)."""
    jm, tm = models
    for m in (jm, tm):
        m.reinit_envs(1, frames_per_wdw=int(OFFSETS[-1]), is_eval=True)
    jout = jm.forward(frame_start=np.zeros(1, np.float32))
    tout = tm.forward(frame_start=np.zeros(1, np.float32))
    for k in jout:
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    assert not any(isinstance(k, tuple) and k[0] == "window" for k in tm._kernels)
    np.testing.assert_allclose(tm.sim_trajs, jm.sim_trajs, atol=1e-5, rtol=0)
    # the chain's frame-boundary forces, which the eval's visualization reads
    for a, b in ((tm.grfs, jm.grfs), (tm.jafs, jm.jafs)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(), rtol=0)
    np.testing.assert_allclose(tm.get_camera(), jm.get_camera(), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tm.distilled_trajs, jm.distilled_trajs, atol=1e-5, rtol=0)
    jq, tq = jm.query(img_size=(64, 48)), tm.query(img_size=(64, 48))
    assert set(jq) == set(tq)
    for k in ("sim_traj", "target_traj", "control_ref", "camera", "distilled_traj"):
        np.testing.assert_allclose(tq[k], jq[k], atol=1e-4, rtol=1e-5, err_msg=k)
    dj = jm.get_distilled_kinematics(np.zeros((1, len(jm.steps_idx)), np.float32))
    dt_ = tm.get_distilled_kinematics(np.zeros((1, len(tm.steps_idx)), np.float32))
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), atol=1e-5, rtol=0)


def test_eval_window_past_the_last_frame_matches_jax(models):
    """The whole-sequence eval (1 env) from the second video's start runs its
    window past the last frame; the frame gathers there take the nearest
    frame, as JAX's clamp, and the outputs equal the JAX package's within
    the eval tolerances above."""
    jm, tm = models
    start = np.array([OFFSETS[1]], np.float32)
    for m in (jm, tm):
        m.reinit_envs(1, frames_per_wdw=int(OFFSETS[-1]), is_eval=True)
    jout = jm.forward(frame_start=start)
    tout = tm.forward(frame_start=start)
    assert set(jout) == set(tout)
    for k in jout:
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(tm.sim_trajs, jm.sim_trajs, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm.get_camera(), jm.get_camera(), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tm.distilled_trajs, jm.distilled_trajs, atol=1e-5, rtol=0)


def test_query_renders_with_its_cameras(models, tmp_path, monkeypatch):
    """The lab4d eval's query(img_size), rendered by the port's
    PhysVisualizer with its cameras, gives the frames and OBJ strips the JAX
    package's PhysVisualizer gives on the same data (the streams target,
    sim, control_ref, distilled and all)."""
    import ppr_diffphys_tpu.utils.io as jio
    import ppr_diffphys_tpu.utils.vis as jvis
    import ppr_diffphys_torch.utils.io as tio
    import ppr_diffphys_torch.utils.vis as tvis

    _, tm = models
    tm.reinit_envs(1, frames_per_wdw=int(OFFSETS[-1]), is_eval=True)
    tm.forward(frame_start=np.zeros(1, np.float32))
    data = dict(tm.query(img_size=(96, 128, 0.5)), model=tm.env)
    out = {}
    with H.private_jax_rasterizer(tmp_path):
        for name, vis_mod, io_mod in (("jax", jvis, jio), ("port", tvis, tio)):
            frames = {}
            monkeypatch.setattr(io_mod, "save_vid", lambda path, fr, **kw: frames.__setitem__(
                os.path.basename(path), np.stack(fr)))
            vis = vis_mod.PhysVisualizer(str(tmp_path / name))
            vis.show(0, data)
            vis.log.close()
            objs = {n: (tmp_path / name / n).read_bytes() for n in os.listdir(tmp_path / name)
                    if n.endswith(".obj")}
            out[name] = frames, objs
    (jfr, jobj), (tfr, tobj) = out["jax"], out["port"]
    assert sorted(tfr) == sorted(jfr) == sorted(
        "%s-00000" % k for k in ("target", "sim", "control_ref", "distilled", "all"))
    for k in jfr:
        assert tfr[k].shape[:3] == (OFFSETS[-1], 48, 64 * (4 if k.startswith("all") else 1))
        np.testing.assert_array_equal(tfr[k], jfr[k], err_msg=k)
    assert sorted(tobj) == ["distilled_traj-00000.obj", "sim_traj-00000.obj"]
    assert tobj == jobj


def test_overrides_and_kinematics_proxy(models):
    """The override_* round trips (values copied, tensors kept for the
    optimizer) and KinematicsProxy's queries and syncs, as the JAX ones."""
    jm, tm = models
    proxy_t = tm.params["kinematics_proxy"]["scene_field"]["logscale"]
    tm.params["scene_field"]["logscale"].fill_(0.37)
    tm.override_control_ref_states()
    assert tm.params["kinematics_proxy"]["scene_field"]["logscale"] is proxy_t
    assert float(proxy_t) == pytest.approx(0.37)
    tm.params["kinematics_distilled"]["scene_field"]["logscale"].fill_(-0.21)
    tm.override_states_inv()
    assert float(tm.params["scene_field"]["logscale"]) == pytest.approx(-0.21)
    tm.params["scene_field"]["logscale"].fill_(0.05)
    tm.override_distilled_states()
    assert float(tm.params["kinematics_distilled"]["scene_field"]["logscale"]) == \
        pytest.approx(0.05)
    # the same syncs on the JAX side keep the two models equal
    jm.params["scene_field"]["logscale"] = jnp.asarray(0.37)
    jm.override_control_ref_states()
    jm.params["kinematics_distilled"]["scene_field"]["logscale"] = jnp.asarray(-0.21)
    jm.override_states_inv()
    jm.params["scene_field"]["logscale"] = jnp.asarray(0.05)
    jm.override_distilled_states()

    fr = np.array([1.0, 13.5, 25.0], np.float32)
    for sub in ("kinematics_proxy", "kinematics_distilled"):
        pj, pt = JProxy(jm, sub), ti.KinematicsProxy(tm, sub)
        np.testing.assert_allclose(pt(fr).detach().numpy(), np.asarray(pj(jnp.asarray(fr))),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(pt.get_joint_angles(fr).detach().numpy(),
                                   np.asarray(pj.get_joint_angles(jnp.asarray(fr))),
                                   atol=1e-5, rtol=0)
    pt = ti.KinematicsProxy(tm)
    obj, scn = pt.override_states_inv()
    assert float(scn["logscale"]) == pytest.approx(0.37)
    assert float(tm.params["scene_field"]["logscale"]) == pytest.approx(0.37)
    scn["logscale"].fill_(0.05)  # a copy: the proxy keeps its value
    assert float(tm.params["kinematics_proxy"]["scene_field"]["logscale"]) == \
        pytest.approx(0.37)
    pt.override_states(scene_field=scn)
    assert float(tm.params["kinematics_proxy"]["scene_field"]["logscale"]) == \
        pytest.approx(0.05)
    pt.override_states()
    assert float(tm.params["kinematics_proxy"]["scene_field"]["logscale"]) == \
        pytest.approx(0.37)
    pj = JProxy(jm)
    pj.override_states_inv()
    pj.override_states()
    want = _leaves(jm, jm.params)
    for n, v in _leaves(jm, tm.state_np()).items():
        np.testing.assert_allclose(v, want[n], rtol=1e-5, atol=1e-5, err_msg=n)


def test_compute_frame_start_bounds(models):
    _, tm = models
    tm.reinit_envs(4, frames_per_wdw=3, is_eval=False)
    for _ in range(5):
        starts = tm.compute_frame_start().numpy()
        assert starts.shape == (4,)
        for s in starts:  # every window fits within its video
            vid = int(np.searchsorted(OFFSETS, s, side="right") - 1)
            assert s == np.round(s) and s + tm.frames_per_wdw <= OFFSETS[vid + 1]


def test_correct_scale_matches_jax(models):
    """The scene-scale walk ends at the same logscale as JAX's, or one
    increment off if a foot sits within rounding of the ground at the last
    step (the walk stops at the first sign change of the lowest foot)."""
    jm, tm = models
    frames = np.arange(3)
    np.testing.assert_allclose(tm.get_foot_height_frame(frames),
                               jm.get_foot_height_frame(frames), atol=1e-5)
    jm.correct_scale(frames, max_steps=40)
    tm.correct_scale(frames, max_steps=40)
    trees = lambda m, t: (t["scene_field"], t["kinematics_proxy"]["scene_field"],
                          t["kinematics_distilled"]["scene_field"])
    for a, b in zip(trees(jm, jm.params), trees(tm, tm.params)):
        assert abs(float(b["logscale"]) - float(a["logscale"])) <= 0.01 + 1e-6
    assert np.isfinite(tm.get_foot_height_frame(frames)).all()


def test_checkpoints_move_both_ways(models, tmp_path):
    """A JAX checkpoint loads into the port and the port's into JAX, every
    tensor equal."""
    jm, tm = models
    jm.save_dir = str(tmp_path / "j")
    tm.save_dir = str(tmp_path / "t")
    os.makedirs(jm.save_dir)
    jm.save_checkpoint(0)
    with open(os.path.join(jm.save_dir, "ckpt_phys_0000.pth"), "rb") as f:
        want = _leaves(jm, pickle.load(f))
    with torch.no_grad():
        for _, t in tm.named_tensors():
            t.add_(1.0)
    tm.load_checkpoint(os.path.join(jm.save_dir, "ckpt_phys_latest.pth"))
    got = _leaves(jm, tm.state_np())
    assert set(got) == set(want)
    for n, v in want.items():
        np.testing.assert_array_equal(got[n], v, err_msg=n)
    with torch.no_grad():
        tm.params["scene_field"]["logscale"].add_(0.5)
    tm.save_checkpoint(7)
    jm.load_checkpoint(os.path.join(tm.save_dir, "ckpt_phys_0007.pth"))
    want = _leaves(jm, tm.state_np())
    for n, v in _leaves(jm, jm.params).items():
        np.testing.assert_array_equal(v, want[n], err_msg=n)
