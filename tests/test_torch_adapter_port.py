"""The lab4d torch-field adapter: ``ppr_diffphys_torch/models/torch_adapter.py``
against ``ppr_diffphys_tpu/models/torch_adapter.py`` on the same stand-in
lab4d fields (``tests/lab4d_standin.py``: torch modules with lab4d's
state-dict keys and field surface, seeded weights) over two videos, with
the a1 fixture as the robot.

Both adapters read the same state dicts into their own fields; the queries
(get_camera, get_field2world, articulation get_vals and
compute_rel_rest_joints) agree within 1e-5 (fp32 MLPs of 256 wide on one
side in XLA and on the other in PyTorch: measured ~1e-6). The export
functions write values back into a live field exactly, and the JAX
package's exports write the same values.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ppr_diffphys_tpu.data.robot import URDFRobot as JRobot
from ppr_diffphys_tpu.models import torch_adapter as JA
from ppr_diffphys_torch.data.robot import URDFRobot as TRobot
from ppr_diffphys_torch.models import torch_adapter as TA
from ppr_diffphys_torch.models.mlp import FrameSampler, resolve_num_freq_t

import lab4d_standin
import port_helpers as H

OFFSETS = [0, 24, 40]
TOL = 1e-5


@pytest.fixture(scope="module")
def fields():
    robot = TRobot(H.A1_URDF)
    nf = resolve_num_freq_t(6, FrameSampler(tuple(OFFSETS)).max_ts)
    scene, obj = lab4d_standin.build_fields(OFFSETS, nf, robot.num_dofs, len(robot.joints))
    return scene, obj


@pytest.fixture(scope="module")
def adapted(fields):
    scene, obj = fields
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    return {
        "object": (JA.object_field_from_torch(obj, JRobot(H.A1_URDF), key),
                   TA.object_field_from_torch(obj, TRobot(H.A1_URDF), g)),
        "scene": (JA.scene_field_from_torch(scene, key),
                  TA.scene_field_from_torch(scene, g)),
    }


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


FRAMES = np.array([0, 3.5, 11, 23, 24, 30.25, 39], np.float32)


@pytest.mark.parametrize("which", ["object", "scene"])
def test_camera_queries_agree(adapted, which):
    (jf, jp), (tf, tp) = adapted[which]
    _close(tf.get_camera(tp, torch.tensor(FRAMES)), jf.get_camera(jp, jnp.asarray(FRAMES)))
    inst = np.array([0, 1, 1])
    _close(tf.get_field2world(tp, torch.tensor(inst)),
           jf.get_field2world(jp, jnp.asarray(inst)))
    _close(tp["logscale"], jp["logscale"], 0)


def test_articulation_queries_agree(adapted):
    (jf, jp), (tf, tp) = adapted["object"]
    ja, ta = jf.articulation_spec, tf.articulation_spec
    jart, tart = jp["articulation"], tp["articulation"]
    _close(ta.get_vals(tart, torch.tensor(FRAMES)), ja.get_vals(jart, jnp.asarray(FRAMES)))
    inst = np.array([0, 1])
    _close(ta.compute_rel_rest_joints(tart, torch.tensor(inst)),
           ja.compute_rel_rest_joints(jart, jnp.asarray(inst)))
    for k in ("logscale", "orient", "shift"):
        _close(tart[k], jart[k], 0)


def test_timemlp_and_cameramlp_modules_load_the_weights(fields):
    """The returned modules hold the adapted weights (not an initialization)."""
    _, obj = fields
    module, params = TA.timemlp_from_torch(obj.warp.articulation.mlp.state_dict())
    assert all(torch.equal(module.state_dict()[k], v) for k, v in params.items())
    assert set(module.state_dict()) == set(params)
    module, params = TA.cameramlp_from_torch(obj.camera_mlp.state_dict())
    assert all(torch.equal(module.state_dict()[k], v) for k, v in params.items())
    assert set(module.state_dict()) == set(params)
    assert TA.sampler_from_torch(obj.camera_mlp).frame_offset_raw == tuple(OFFSETS)


def _state(field):
    return {k: v.detach().clone() for k, v in field.state_dict().items()}


def test_exports_round_trip_exactly(fields, adapted):
    """Port params -> a fresh stand-in -> the original's values, exactly; and
    the JAX exports write the same values."""
    scene, obj = fields
    robot = TRobot(H.A1_URDF)
    nf = obj.camera_mlp.time_embedding.mapping1.in_features // 2
    fresh_scene, fresh_obj = lab4d_standin.build_fields(OFFSETS, nf, robot.num_dofs,
                                                         len(robot.joints), seed=1)
    (_, jp), (_, tp) = adapted["object"]
    TA.export_object_field_to_torch(tp, fresh_obj)
    (_, jsp), (_, tsp) = adapted["scene"]
    TA.export_camera_field_to_torch(tsp, fresh_scene)
    for src, dst in ((obj, fresh_obj), (scene, fresh_scene)):
        want, got = _state(src), _state(dst)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    _, jfresh = lab4d_standin.build_fields(OFFSETS, nf, robot.num_dofs, len(robot.joints),
                                           seed=2)
    JA.export_object_field_to_torch(jp, jfresh)
    want = _state(fresh_obj)
    for k, v in _state(jfresh).items():
        assert torch.equal(v, want[k]), k


def test_state_to_torch_matches_jax(adapted):
    """The inverse maps give lab4d's keys and the JAX package's values."""
    (_, jp), (_, tp) = adapted["object"]
    for jfn, tfn, jtree, ttree in (
            (JA.timemlp_state_to_torch, TA.timemlp_state_to_torch,
             jp["articulation"]["mlp"], tp["articulation"]["mlp"]),
            (JA.cameramlp_state_to_torch, TA.cameramlp_state_to_torch,
             jp["camera_mlp"], tp["camera_mlp"])):
        want, got = jfn(jtree), tfn(ttree)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_architecture_checks(fields):
    """A joint-angle MLP whose head does not match the robot's dofs, or
    whose frequency count does not match the frame layout, is refused (the
    JAX adapter asserts; the port raises ValueError, which -O keeps)."""
    _, obj = fields
    robot = TRobot(H.A1_URDF)
    g = torch.Generator().manual_seed(0)
    spec = TA.object_field_from_torch(obj, robot, g)[0].articulation_spec
    rng = np.random.default_rng(3)
    nf = spec.mlp.time_embedding.num_freq_t
    art = lab4d_standin.Articulation(rng, OFFSETS, nf, robot.num_dofs + 1, len(robot.joints))
    with pytest.raises(ValueError):
        TA.articulation_params_from_torch(art, spec)
    art = lab4d_standin.Articulation(rng, OFFSETS, nf + 1, robot.num_dofs, len(robot.joints))
    with pytest.raises(ValueError):
        TA.articulation_params_from_torch(art, spec)
