"""Visualization and IO of the port (``ppr_diffphys_torch/utils/{colors,
projection,io,render,vis}.py`` and ``render_intermediate.py``) against the
JAX package's (``ppr_diffphys_tpu/utils/`` and the root
``render_intermediate.py``) on the a1 fixture, from the same seeded numpy
inputs.

Both sides are host numpy over the same rasterizer source
(``csrc/rasterizer.cpp``, each package building its own library with the
same g++ flags; the JAX package's into a temporary directory here), so
meshes, colors, images and OBJ files are equal, not close. The port's plasma colors are matplotlib's table carried as data,
held equal to matplotlib here. ``project_bodies``/``parse_rtk`` (torch
against jnp, fp32) agree within 1e-5 relative. Video frames are taken by
patching each package's ``save_vid`` (mp4 encoding is not compared).
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ppr_diffphys_tpu.sim.builder as jbuilder
import ppr_diffphys_tpu.sim.import_urdf as jimport
import ppr_diffphys_tpu.utils.io as jio
import ppr_diffphys_tpu.utils.projection as jproj
import ppr_diffphys_tpu.utils.vis as jvis
import ppr_diffphys_torch.sim.builder as tbuilder
import ppr_diffphys_torch.sim.import_urdf as timport
import ppr_diffphys_torch.utils.io as tio
import ppr_diffphys_torch.utils.projection as tproj
import ppr_diffphys_torch.utils.vis as tvis
from ppr_diffphys_tpu.sim.urdf import URDF as JURDF
from ppr_diffphys_tpu.utils.colors import label_colormap as jlabel
from ppr_diffphys_tpu.utils.render import SoftwareRenderer as JRenderer
from ppr_diffphys_torch import render_intermediate as tri
from ppr_diffphys_torch.sim.kinematics import eval_fk
from ppr_diffphys_torch.sim.synthetic import random_joint_state
from ppr_diffphys_torch.sim.urdf import URDF as TURDF
from ppr_diffphys_torch.utils import colors as tcolors
from ppr_diffphys_torch.utils.render import SoftwareRenderer as TRenderer

import port_helpers as H

F = 4
SEED = 5


@pytest.fixture(scope="module", autouse=True)
def jax_rasterizer(tmp_path_factory):
    with H.private_jax_rasterizer(tmp_path_factory.mktemp("jax_rasterizer")):
        yield


@pytest.fixture(scope="module")
def models():
    return H.a1_model(jbuilder, jimport), H.a1_model(tbuilder, timport)


@pytest.fixture(scope="module")
def traj(models):
    """A 4-frame trajectory dict as query() gives it (numpy), seeded."""
    _, tm = models
    rng = np.random.RandomState(SEED)
    B = tm.n_links

    def bodies(seed):
        q, _ = random_joint_state(tm, F, seed)
        bq = eval_fk(tm, torch.as_tensor(q))[0].numpy()
        bq[..., 0] += np.linspace(0, 0.3, F)[:, None]  # walk along x
        return bq

    grf = np.zeros((F, B, 6), np.float32)
    grf[..., 3:6] = rng.randn(F, B, 3) * 40.0  # some above the 10 N arrow threshold
    grf[:, 0, 3:6] = [0.0, 0.0, 60.0]  # one along +z: the arrow's other basis branch
    cam = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    cam[:, 2, 3] = 2.5
    cam[:, 0, 3] = -0.15
    cam[:, 3] = [300.0, 300.0, 80.0, 60.0]  # fx fy px py
    return {
        "sim_traj": bodies(SEED), "target_traj": bodies(SEED + 1),
        "control_ref": bodies(SEED + 2), "distilled_traj": bodies(SEED + 3),
        "grf": grf, "com": rng.randn(F, 3).astype(np.float32) * 0.1,
        "body_mass": rng.uniform(0.5, 5.0, B).astype(np.float32),
        "max_w": 1.2, "camera": cam, "img_size": (120, 160, 1.0),
        "err": rng.randn(F, B).astype(np.float32) * 0.1,
        "as": rng.randn(F, B).astype(np.float32) * 2.0,
        "vs": rng.randn(F, B).astype(np.float32) * 0.5,
    }


def test_label_colormap_equal():
    np.testing.assert_array_equal(tcolors.label_colormap(), jlabel())
    np.testing.assert_array_equal(tcolors.label_colormap(7), jlabel(7))


def test_plasma_table_equals_matplotlib():
    from matplotlib import pyplot as plt

    cm = plt.get_cmap("plasma")
    rng = np.random.RandomState(0)
    for x in (rng.uniform(-0.2, 1.2, 4096), rng.uniform(0, 1, 4096).astype(np.float32),
              np.array([0.0, 1.0, 0.5, np.nan, 1 - 1e-12, 255.5 / 256]), 0.3, 1.0,
              np.float32(0.7)):
        want, got = cm(x), tcolors.plasma(x)
        assert type(got) is type(want)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_projection_matches_jax():
    rng = np.random.RandomState(1)
    rtk = np.tile(np.eye(4, dtype=np.float32), (2, 3, 1, 1))
    rtk[..., :3, :3] += rng.randn(2, 3, 3, 3).astype(np.float32) * 0.1
    rtk[..., 2, 3] = 3.0
    rtk[..., 3, :] = rng.uniform(100, 500, (2, 3, 4))
    bodies = rng.randn(2, 3, 5, 7).astype(np.float32)
    for t, j in zip(tproj.parse_rtk(torch.as_tensor(rtk)), jproj.parse_rtk(jnp.asarray(rtk))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=0)
    got = tproj.project_bodies(torch.as_tensor(bodies), torch.as_tensor(rtk)).numpy()
    want = np.asarray(jproj.project_bodies(jnp.asarray(bodies), jnp.asarray(rtk)))
    assert got.shape == want.shape == (2, 3, 5, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    pts = np.abs(got[:, :, :2]) % 60
    np.testing.assert_array_equal(tproj.plot_curves(pts, pts[::-1]),
                                  jproj.plot_curves(pts, pts[::-1]))


def _mesh_equal(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


@pytest.mark.parametrize("extras", ["plain", "gforce_com_mass"])
def test_articulated_meshes_equal(models, traj, extras):
    jm, tm = models
    kw = {} if extras == "plain" else dict(
        gforce=traj["grf"][1], com=traj["com"][1], mass=traj["body_mass"])
    (jmesh, jc), (tmesh, tc) = (jvis.articulate_robot_rbrt(jm, traj["sim_traj"][1], **kw),
                                tvis.articulate_robot_rbrt(tm, traj["sim_traj"][1], **kw))
    _mesh_equal(tmesh, jmesh)
    np.testing.assert_array_equal(tc, jc)
    if extras != "plain":  # arrows and the com marker were drawn
        assert len(tmesh.vertices) > len(tm.collision_mesh()[0])
    for scale in (20.0, 3.0):
        (jf, jfc), (tf, tfc) = jvis.create_floor_mesh(scale), tvis.create_floor_mesh(scale)
        _mesh_equal(tf, jf)
        np.testing.assert_array_equal(tfc, jfc)


def test_articulate_and_render_robot_equal(tmp_path):
    """FK-posed collision meshes at the rest pose and a random one, and the
    offscreen render of the latter (the a1 fixture's visual geometry names
    mesh files that are not in the repository)."""
    ju, tu = JURDF.load(H.A1_URDF), TURDF.load(H.A1_URDF)
    n = sum(j.joint_type != "fixed" for j in tu.joints)
    cfg = np.random.RandomState(2).uniform(-0.5, 0.5, n)
    for c in (None, cfg, dict(zip([j.name for j in tu.joints if j.joint_type != "fixed"],
                                  cfg[::-1]))):
        _mesh_equal(tvis.articulate_robot(tu, c, use_collision=True),
                    jvis.articulate_robot(ju, c, use_collision=True))
    (ti, tmesh), (ji, jmesh) = (
        tvis.render_robot(tu, str(tmp_path / "t.png"), cfg, use_collision=True, size=64),
        jvis.render_robot(ju, str(tmp_path / "j.png"), cfg, use_collision=True, size=64))
    _mesh_equal(tmesh, jmesh)
    np.testing.assert_array_equal(ti, ji)
    assert (ti != 255).any()
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def _presets():
    """(name, fn(renderer)) over every camera and light preset."""
    custom = np.eye(4, dtype=np.float32)
    custom[:3, 3] = [0.1, -0.2, 2.0]
    return [
        ("default", lambda r: r.set_camera_default()),
        ("bev", lambda r: r.set_camera_bev(3.0)),
        ("bev_gl", lambda r: r.set_camera_bev(3.0, gl=True)),
        ("frontal", lambda r: r.set_camera_frontal(2.5)),
        ("frontal_gl_delta", lambda r: r.set_camera_frontal(2.5, gl=True, delta=0.3)),
        ("custom_intrinsics", lambda r: (r.set_camera(custom),
                                         r.set_intrinsics([150.0, 160.0, 70.0, 50.0]))),
        ("light_topdown", lambda r: (r.set_camera_default(), r.set_light_topdown())),
        ("light_topdown_gl", lambda r: (r.set_camera_default(), r.set_light_topdown(gl=True))),
        ("light_camera", lambda r: (r.set_camera_frontal(2.5), r.align_light_to_camera())),
    ]


@pytest.mark.parametrize("preset", [p for p, _ in _presets()])
def test_render_presets_identical(models, traj, preset):
    jm, tm = models
    fn = dict(_presets())[preset]
    mesh, colors = tvis.articulate_robot_rbrt(tm, traj["sim_traj"][2], mass=traj["body_mass"])
    floor, fc = tvis.create_floor_mesh(4.0)
    from ppr_diffphys_torch.sim.mesh import concatenate_meshes

    scene = concatenate_meshes([mesh, floor])
    cols = np.concatenate([colors, fc])
    imgs = []
    for R in (JRenderer, TRenderer):
        r = R(96, 128)
        fn(r)
        imgs.append(r.render(scene.vertices, scene.faces, cols))
    j, t = imgs
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.uint8 and (t != 255).any()  # something was drawn
    jr, tr = JRenderer(96, 128), TRenderer(96, 128)
    fn(jr), fn(tr)
    np.testing.assert_array_equal(tr.get_cam_to_scene(), jr.get_cam_to_scene())


def _capture(monkeypatch, io_module):
    frames = {}

    def save_vid(outpath, fr, suffix=".mp4", upsample_frame=0, fps=10, target_size=None):
        frames[os.path.basename(outpath)] = (np.stack(fr), fps)
        open(outpath + suffix, "wb").close()

    monkeypatch.setattr(io_module, "save_vid", save_vid)
    return frames


SHOW_CASES = {
    "default_camera": ("sim_traj", "target_traj", "control_ref", "grf", "com", "body_mass",
                       "max_w"),
    "camera_distilled_values": None,  # every key
}


@pytest.mark.parametrize("case", sorted(SHOW_CASES))
def test_show_frames_and_strips_identical(models, traj, case, tmp_path, monkeypatch):
    jm, tm = models
    keys = SHOW_CASES[case] or tuple(traj)
    data = {k: traj[k] for k in keys}
    outs = {}
    for name, vis_mod, io_mod, model in (("jax", jvis, jio, jm), ("port", tvis, tio, tm)):
        frames = _capture(monkeypatch, io_mod)
        d = tmp_path / name
        vis = vis_mod.PhysVisualizer(str(d))
        vis.show(3, dict(data, model=model), fps=30.0)
        vis.log.close()
        outs[name] = (frames, {p: (d / p).read_bytes() for p in sorted(os.listdir(d))
                               if p.endswith(".obj")}, sorted(os.listdir(d)))
    (jf, jobj, jnames), (tf, tobj, tnames) = outs["jax"], outs["port"]
    streams = ["target", "sim", "control_ref"]
    if case != "default_camera":
        streams += ["distilled", "err", "as", "vs"]
    assert sorted(tf) == sorted(jf) == sorted("%s-00003" % s for s in streams + ["all"])
    for k in jf:
        assert tf[k][1] == jf[k][1] == 30.0
        np.testing.assert_array_equal(tf[k][0], jf[k][0], err_msg=k)
        assert tf[k][0].shape[0] == F
        assert (tf[k][0] != 255).any(), k  # not blank
    h, w = (120, 160) if case != "default_camera" else (256, 256)
    assert tf["sim-00003"][0].shape[1:] == (h, w, 3)
    assert list(tobj) == list(jobj)
    assert len(tobj) == (2 if case != "default_camera" else 1)
    for k in jobj:
        assert tobj[k] == jobj[k], k
    assert [n for n in tnames if not n.startswith("events")] == \
        [n for n in jnames if not n.startswith("events")]


def test_show_without_video_writes_the_strips_only(models, traj, tmp_path):
    _, tm = models
    vis = tvis.PhysVisualizer(str(tmp_path), render_video=False)
    vis.show("x", dict(traj, model=tm), render_video=False)
    vis.close()
    names = sorted(n for n in os.listdir(tmp_path) if not n.startswith("events"))
    assert names == ["distilled_traj-x.obj", "sim_traj-x.obj"]


def test_visualizer_names_a_missing_package(tmp_path, monkeypatch):
    monkeypatch.setattr(tvis, "VIDEO_PACKAGES", ("cv2", "no_such_package_for_videos"))
    with pytest.raises(ImportError, match="no_such_package_for_videos"):
        tvis.PhysVisualizer(str(tmp_path / "a"))
    tvis.PhysVisualizer(str(tmp_path / "b"), render_video=False).close()


def test_write_log_scalars(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    vis = tvis.PhysVisualizer(str(tmp_path), render_video=False)
    vis.write_log({"loss": 0.5, "eval/traj": np.float32(2.0)}, 3)
    vis.write_log({"loss": 0.25}, 4)
    vis.close()
    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [(3, 0.5), (4, 0.25)]
    assert [(e.step, e.value) for e in acc.Scalars("eval/traj")] == [(3, 2.0)]


def test_save_vid_and_vis_kps(tmp_path):
    """mp4 through cv2 with the frames' size rounded up to a multiple of 16,
    gif through imageio; vis_kps writes the JAX package's OBJ."""
    import cv2

    frames = [np.full((50, 70, 3), i * 40, np.uint8) for i in range(4)]
    tio.save_vid(str(tmp_path / "v"), frames, fps=5)
    cap = cv2.VideoCapture(str(tmp_path / "v.mp4"))
    ok, img = cap.read()
    cap.release()
    assert ok and img.shape == (64, 80, 3)
    tio.save_vid(str(tmp_path / "g"), frames, suffix=".gif", fps=5)
    assert (tmp_path / "g.gif").stat().st_size > 0
    np.testing.assert_array_equal(tio.resize_to_nearest_multiple(frames[0]),
                                  jio.resize_to_nearest_multiple(frames[0]))
    kps = np.random.RandomState(3).randn(3, 4, 5).astype(np.float32)
    labels = (np.arange(15).reshape(3, 5) % 2).astype(np.float32)
    tio.vis_kps(kps, str(tmp_path / "t.obj"), labels)
    jio.vis_kps(kps, str(tmp_path / "j.obj"), labels)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()


@pytest.fixture
def root_render_intermediate():
    """The repository's render_intermediate.py (absl flags), imported from the
    repository root."""
    sys.path.insert(0, os.path.dirname(H.TESTS_DIR))
    try:
        import render_intermediate
    finally:
        sys.path.pop(0)
    from absl import flags

    yield render_intermediate
    flags.FLAGS.unparse_flags()


def test_render_intermediate_identical(models, traj, tmp_path, monkeypatch,
                                       root_render_intermediate):
    _, tm = models
    vis = tvis.PhysVisualizer(str(tmp_path), render_video=False)
    for it in range(3):
        data = dict(traj, model=tm, sim_traj=np.roll(traj["sim_traj"], it, axis=0))
        vis.show(it, data, render_video=False)
    vis.close()
    from absl import flags

    args = ["--testdir", str(tmp_path), "--image_size", "96", "--fps", "4"]
    jframes = _capture(monkeypatch, jio)
    flags.FLAGS(["render_intermediate"] + args)
    root_render_intermediate.main(None)
    tframes = _capture(monkeypatch, tio)
    assert tri.main(args) == str(tmp_path / "sim_traj.mp4")
    assert list(tframes) == list(jframes) == ["sim_traj"]
    (t, tfps), (j, jfps) = tframes["sim_traj"], jframes["sim_traj"]
    assert tfps == jfps == 4.0 and t.shape == (3, 96, 96, 3)
    np.testing.assert_array_equal(t, j)
    assert (t != 255).any()
