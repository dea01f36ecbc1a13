"""Time-MLPs of the port (models/mlp.py) against the JAX package: TimeMLP
loaded through ``timemlp_params_from_jax`` against flax ``apply`` at the
five phys_model shapes (plus a two-video case for the instance embedding),
the converter's keys and arrays against
``ppr_diffphys_tpu.models.torch_adapter.timemlp_state_to_torch``, and
FrameSampler/posenc against their JAX counterparts.

Tolerance: both sides are fp32 matmuls on the CPU (TF32 off in the port):
outputs of scale ~1-5 agree to 2e-5 absolute after 6-9 layers of width 256.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ppr_diffphys_tpu.models import mlp as jmlp
from ppr_diffphys_tpu.models.torch_adapter import timemlp_state_to_torch
from ppr_diffphys_torch.models import mlp as tmlp

# (name, out_channels, D, skips, output_scale) of phys_model.add_nn_modules
# for a1 (n_dof 12, 13 links), num_freq_t resolved for a 48-frame clip
NF = jmlp.resolve_num_freq_t(6, 48)
SHAPES = [
    ("root_pose_mlp", 6, 8, (4,), 0.5),
    ("joint_angle_mlp", 12, 5, (1, 2, 3, 4), 1.0),
    ("vel_mlp", 18, 5, (1, 2, 3, 4), 5.0),
    ("torque_mlp", 12, 5, (1, 2, 3, 4), 1.0),
    ("residual_f_mlp", 78, 5, (1, 2, 3, 4), 1.0),
]


def _pair(out, D, skips, scale, n_inst=1, seed=0):
    jmod = jmlp.TimeMLPFlax(num_freq_t=NF, num_inst=n_inst, out_channels=out,
                            D=D, skips=skips, output_scale=scale)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1,)),
                       jnp.zeros((1,), jnp.int32))["params"]
    np_params = jax.tree.map(np.asarray, params)
    tmod = tmlp.TimeMLP(NF, n_inst, out, D=D, skips=skips, output_scale=scale)
    tmod.load_state_dict(tmlp.timemlp_params_from_jax(np_params))
    return jmod, params, np_params, tmod


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_timemlp_matches_flax(shape):
    _, out, D, skips, scale = shape
    jmod, params, _, tmod = _pair(out, D, skips, scale, seed=len(shape[0]))
    rng = np.random.RandomState(0)
    t = rng.uniform(-1, 1, 40).astype(np.float32)
    vid = np.zeros(40, np.int32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(t), jnp.asarray(vid)))
    got = tmod(torch.as_tensor(t), torch.as_tensor(vid, dtype=torch.long)).detach().numpy()
    assert got.shape == (40, out)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_timemlp_two_videos_matches_flax():
    jmod, params, _, tmod = _pair(12, 5, (1, 2, 3, 4), 1.0, n_inst=2, seed=5)
    rng = np.random.RandomState(1)
    t = rng.uniform(-1, 1, 20).astype(np.float32)
    vid = rng.randint(0, 2, 20).astype(np.int32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(t), jnp.asarray(vid)))
    got = tmod(torch.as_tensor(t), torch.as_tensor(vid, dtype=torch.long)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=[s[0] for s in SHAPES[:2]])
def test_converter_matches_torch_adapter(shape):
    """Same keys and arrays as the JAX package's own flax->torch export,
    and exactly the TimeMLP module's state-dict keys."""
    _, out, D, skips, scale = shape
    _, _, np_params, tmod = _pair(out, D, skips, scale)
    ours = tmlp.timemlp_params_from_jax(np_params)
    ref = timemlp_state_to_torch(np_params)
    assert set(ours) == set(ref) == set(tmod.state_dict())
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    assert "time_embedding.inst_embedding.mapping.weight" in ours
    assert "linear_final.0.weight" in ours and "head.0.bias" in ours


def test_frame_sampler_matches_jax():
    offsets = (0, 20, 48)
    frames = np.array([0.0, 3.25, 19.9, 20.0, 20.5, 47.0, 47.9, -1.0, 50.0], np.float32)
    for scale in (1.0, 0.1):
        js, ts = jmlp.FrameSampler(offsets, scale), tmlp.FrameSampler(offsets, scale)
        np.testing.assert_array_equal(
            ts.frame_to_vid(torch.as_tensor(frames)).numpy(),
            np.asarray(js.frame_to_vid(jnp.asarray(frames))),
        )
        np.testing.assert_allclose(
            ts.frame_to_tid(torch.as_tensor(frames)).numpy(),
            np.asarray(js.frame_to_tid(jnp.asarray(frames))), atol=1e-6, rtol=0,
        )


@pytest.mark.parametrize("alpha", [None, 0.4])
def test_posenc_matches_jax(alpha):
    x = np.random.RandomState(2).uniform(-1, 1, (7, 2)).astype(np.float32)
    want = np.asarray(jmlp.posenc(jnp.asarray(x), 6, alpha))
    got = tmlp.posenc(torch.as_tensor(x), 6, alpha).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert tmlp.resolve_num_freq_t(6, 48) == jmlp.resolve_num_freq_t(6, 48)
