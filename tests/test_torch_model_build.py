"""The port's numpy host modules (URDF parser, model builder, importer,
robot metadata, mocap loader, config) against the JAX package's: every
ArticulationModel array equal on a1 (hull and all contact modes) and on the
FIXED/COMPOUND/REVOLUTE chain. The port keeps its own copies because the
JAX package's __init__ imports jax; equality here is exact.
"""

import numpy as np
import pytest

import ppr_diffphys_tpu.sim.builder as jbuilder
import ppr_diffphys_tpu.sim.import_urdf as jimport
from ppr_diffphys_tpu.data import amp_loader as jamp
from ppr_diffphys_tpu.data.robot import URDFRobot as JRobot
from ppr_diffphys_tpu.utils import config as jconfig

import ppr_diffphys_torch.sim.builder as tbuilder
import ppr_diffphys_torch.sim.import_urdf as timport
from ppr_diffphys_torch.data import amp_loader as tamp
from ppr_diffphys_torch.data.robot import URDFRobot as TRobot
from ppr_diffphys_torch.sim.synthetic import add_chain, chain_model
from ppr_diffphys_torch.utils import config as tconfig

import port_helpers as H


ARRAYS = (
    "joint_type", "joint_parent", "joint_axis", "joint_X_p", "joint_X_c",
    "joint_q_start", "joint_qd_start", "joint_q_init", "joint_target_ke",
    "joint_target_kd", "joint_limit_lower", "joint_limit_upper",
    "joint_limit_ke", "joint_limit_kd", "joint_armature", "body_mass",
    "body_com", "body_inertia", "gravity", "contact_body", "contact_point",
    "contact_dist", "contact_material",
)


def _build(which):
    if which == "chain":
        return chain_model(jbuilder.ModelBuilder), chain_model(tbuilder.ModelBuilder)
    mode = which.split("-")[1]
    return (H.a1_model(jbuilder, jimport, mode),
            H.a1_model(tbuilder, timport, mode))


@pytest.mark.parametrize("which", ["a1-hull", "a1-all", "chain"])
def test_articulation_model_arrays_equal(which):
    jm, tm = _build(which)
    for name in ARRAYS:
        a, b = getattr(jm, name), getattr(tm, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("n_links", "n_q", "n_qd", "n_dof", "contact_count",
                 "joint_attach_ke", "joint_attach_kd", "contact_mode", "body_name"):
        assert getattr(tm, name) == getattr(jm, name), name
    for x, y in zip(jm.collision_mesh(), tm.collision_mesh()):
        np.testing.assert_array_equal(y, x)
    if which.startswith("a1"):
        # the slice's model: 13 bodies, 18 dofs, 28 hull contacts
        assert (tm.n_links, tm.n_qd, tm.contact_count) == (13, 18, 28)
    else:
        assert set(tm.joint_type.tolist()) == {0, 1, 3, 4}
        assert np.isfinite(tm.joint_limit_lower[6:]).all()
        assert (tm.joint_limit_ke[6:] > 0).all()


def test_chain_builder_is_shared():
    """add_chain drives either package's builder to the same model."""
    jb, tb = add_chain(jbuilder.ModelBuilder()), add_chain(tbuilder.ModelBuilder())
    assert jb.body_name == tb.body_name
    np.testing.assert_array_equal(np.asarray(jb.body_mass), np.asarray(tb.body_mass))


def test_robot_metadata_equal():
    j, t = JRobot(H.A1_URDF), TRobot(H.A1_URDF)
    np.testing.assert_array_equal(t.sim3, j.sim3)
    np.testing.assert_array_equal(t.rest_angles, j.rest_angles)
    np.testing.assert_array_equal(t.joints, j.joints)
    assert t.num_dofs == j.num_dofs and t.num_bones == j.num_bones
    for name in ("parent_idx", "name2joints_idx", "name2query_idx", "angle_names",
                 "symm_idx", "unique_body_idx", "ball_joint", "robot_name"):
        assert getattr(t.urdf, name) == getattr(j.urdf, name), name


def test_mocap_clip_and_conversion_equal():
    """The committed a1 clip loads the same way in both packages, including
    the bullet->GL conversion (a1 is in_bullet)."""
    opts = H.serve_opts()
    jd, td = jamp.DataLoader(opts), tamp.DataLoader(opts)
    assert td.frame_interval == jd.frame_interval == pytest.approx(1 / 60)
    assert td.amp_info.shape == (48, 85)
    np.testing.assert_array_equal(td.amp_info, jd.amp_info)
    np.testing.assert_array_equal(td.data_info["offset"], jd.data_info["offset"])
    for in_bullet in (True, False):
        np.testing.assert_array_equal(
            tamp.preprocess_sequence(td, in_bullet),
            jamp.preprocess_sequence(jd, in_bullet),
        )
    # the serving window's substep count for this clip
    assert int(td.frame_interval / 5e-4) == 33


def test_clip_generator_reproduces_committed_clip(tmp_path):
    import make_a1_synth_clip

    path = make_a1_synth_clip.write_clip(str(tmp_path / "clip.txt"), seed=0)
    with open(path) as f, open(make_a1_synth_clip.DEFAULT_OUT) as g:
        assert f.read() == g.read()


def test_default_opts_equal():
    """Same keys and defaults, except the data paths: the port defaults to
    the reference repository's relative data/ layout."""
    paths = ("datadir", "urdf_dir")
    assert set(tconfig.DEFAULT_OPTS) == set(jconfig.DEFAULT_OPTS)
    for k, v in jconfig.DEFAULT_OPTS.items():
        if k not in paths:
            assert tconfig.DEFAULT_OPTS[k] == v, k
    assert tconfig.DEFAULT_OPTS["datadir"].endswith("data/motion_sequences")
    assert tconfig.DEFAULT_OPTS["urdf_dir"].endswith("data/urdf_templates")
    here = dict(datadir=H.MOTION_DIR, urdf_dir=H.FIXTURES, seed=3)
    assert tconfig.build_opts(**here) == jconfig.build_opts(**here)
    assert tconfig.interp_wt((0, 10), (1.0, 2.0), 5) == jconfig.interp_wt((0, 10), (1.0, 2.0), 5)
