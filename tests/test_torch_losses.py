"""Losses of the port (models/losses.py, ops.rot_angle) against the JAX
package: se3_loss on quaternion and axis-angle poses with NaN rows,
reduce_loss with and without divergence clipping (including the sticky
env-0 threshold and an even count of positive entries, where jnp.nanmedian
averages the two middle values), gradients of both, and compute_com.

Tolerance: the same fp32 formulas; values agree to 1e-6 relative,
gradients to 1e-5 of their largest entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ppr_diffphys_tpu.models import losses as jl
from ppr_diffphys_tpu.ops import rot_angle as jrot_angle
from ppr_diffphys_torch.models import losses as tl
from ppr_diffphys_torch.ops import rot_angle as trot_angle


def _poses(n, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 5, d).astype(np.float32)
    if d == 7:
        x[..., 3:] /= np.linalg.norm(x[..., 3:], axis=-1, keepdims=True)
    return x


@pytest.mark.parametrize("d", [7, 6], ids=["quat", "axis_angle"])
def test_se3_loss_matches_jax(d):
    pred, gt = _poses(4, d, 1), _poses(4, d, 2)
    pred[1, 2, 0] = np.nan  # masked to zero
    want = np.asarray(jl.se3_loss(jnp.asarray(pred), jnp.asarray(gt)))
    got = tl.se3_loss(torch.as_tensor(pred), torch.as_tensor(gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[1, 2] == 0.0

    ok = np.nan_to_num(pred)
    jg = jax.grad(lambda p: jnp.sum(jl.se3_loss(p, jnp.asarray(gt))))(jnp.asarray(ok))
    tp = torch.as_tensor(ok).requires_grad_()
    tg, = torch.autograd.grad(tl.se3_loss(tp, torch.as_tensor(gt)).sum(), tp)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(tg.numpy() / scale, np.asarray(jg) / scale, atol=1e-5, rtol=0)


def test_rot_angle_matches_jax():
    rng = np.random.RandomState(3)
    m = rng.randn(6, 3, 3).astype(np.float32)
    np.testing.assert_allclose(trot_angle(torch.as_tensor(m)).numpy(),
                               np.asarray(jrot_angle(jnp.asarray(m))), rtol=1e-6)


def _loss_seq():
    """(E=4, T=8) per-frame losses: env 0 all zero, env 1 diverges at frame
    5 with an even count of positive entries, env 2 has zeros in between,
    env 3 diverges at frame 2."""
    x = np.zeros((4, 8), np.float32)
    x[1] = [0.1, 0.2, 0.3, 0.4, 0.25, 5.0, 6.0, 0.35]
    x[2] = [0.0, 0.5, 0.0, 0.7, 0.6, 0.0, 0.55, 0.65]
    x[3] = [0.02, 0.01, 0.9, 0.015, 0.02, 0.01, 0.03, 0.02]
    return x


@pytest.mark.parametrize("clip,env0_th", [(False, False), (True, False), (True, True)],
                         ids=["plain", "clip", "clip_env0_th"])
def test_reduce_loss_matches_jax(clip, env0_th):
    x = _loss_seq()
    want = float(jl.reduce_loss(jnp.asarray(x), clip=clip, env0_th=env0_th))
    got = float(tl.reduce_loss(torch.as_tensor(x), clip=clip, env0_th=env0_th))
    assert got == pytest.approx(want, rel=1e-6)

    jg = jax.grad(lambda v: jl.reduce_loss(v, clip=clip, env0_th=env0_th))(jnp.asarray(x))
    tx = torch.as_tensor(x).requires_grad_()
    tg, = torch.autograd.grad(tl.reduce_loss(tx, clip=clip, env0_th=env0_th), tx)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-8)


def test_reduce_loss_median_averages_the_middle_pair():
    """[1, 1, 12.5, 20] has the averaging median 6.75 (threshold 67.5:
    nothing dropped), while a lower-middle median of 1 (threshold 10) would
    drop frames 2-3."""
    x = np.array([[1.0, 1.0, 12.5, 20.0]], np.float32)
    want = float(jl.reduce_loss(jnp.asarray(x), clip=True))
    got = float(tl.reduce_loss(torch.as_tensor(x), clip=True))
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(np.mean(x), rel=1e-6)


def test_reduce_loss_all_zero_is_zero():
    x = np.zeros((2, 3), np.float32)
    assert float(tl.reduce_loss(torch.as_tensor(x), clip=True)) == 0.0


def test_compute_com_matches_jax():
    rng = np.random.RandomState(4)
    q = _poses(3, 7, 5)[:, :4]  # (3, B=4, 7)
    com = rng.randn(4, 3).astype(np.float32)
    mass = rng.rand(4).astype(np.float32) + 0.5
    want = np.asarray(jl.compute_com(jnp.asarray(q), jnp.asarray(com), jnp.asarray(mass)))
    got = tl.compute_com(torch.as_tensor(q), torch.as_tensor(com), torch.as_tensor(mass))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
