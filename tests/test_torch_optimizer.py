"""The port's optimizer surface (models/phys_model.py: add_optimizer,
check_grad_dict, update, save_checkpoint, rollback) against the JAX
package's optax chain over 30 updates on the same synthetic gradients:
AdamW with weight decay 1e-4, per-tensor learning rates by dotted-name
routing, the OneCycle schedule, the per-tensor median-queue clipping (one
spiked tensor) and a forced grad-norm rollback to the cached checkpoint,
after which only the schedule count advances.

Tolerance: the same update in fp32, AdamW applying the decay as a separate
multiply: parameters agree to 1e-6 absolute plus 1e-6 relative after every
step (the learning rates are 1e-4 and 1e-3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ppr_diffphys_tpu.data.amp_loader import DataLoader as JDataLoader
from ppr_diffphys_tpu.models.phys_model import phys_model as JModel
from ppr_diffphys_torch.data.amp_loader import DataLoader as TDataLoader
from ppr_diffphys_torch.models.phys_model import phys_model as TModel

import port_helpers as H

STEPS, ROLLBACK_AT, SPIKE_AT = 30, 15, 22


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    opts = H.serve_opts(logroot=str(tmp_path_factory.mktemp("logs")),
                        num_rounds=2, iters_per_round=15)
    jm = JModel(dict(opts), JDataLoader(opts))
    tm = TModel(dict(opts, logroot=str(tmp_path_factory.mktemp("tlogs"))),
                TDataLoader(opts), device="cpu")
    tm.load_params_from_jax(jax.tree.map(np.asarray, jm.params))
    return jm, tm


def _leaves(jm, tree):
    return {jm._leaf_name(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _sched_count(opt_state):
    return [int(s.count) for s in opt_state if isinstance(s, optax.ScaleByScheduleState)][0]


def test_trainable_tensors_and_rates_match_jax(models):
    jm, tm = models
    lr = _leaves(jm, jm.param_lr_tree)
    assert sorted(n for n, _ in tm._trainable) == sorted(n for n in lr if lr[n] > 0)
    for name, _ in tm._trainable:
        assert tm._param_lr(name) == pytest.approx(float(lr[name]))
    for step in (0, 1, 2, 10, 29, 40):
        assert tm._lr_schedule(step) == pytest.approx(float(jm._lr_schedule(step)), rel=1e-6)


def test_updates_median_clip_and_rollback_match_jax(models):
    jm, tm = models
    names = [n for n, _ in tm._trainable]
    shapes = {n: v.shape for n, v in _leaves(jm, jm.params).items()}
    rng = np.random.RandomState(0)
    seen_clip = seen_rollback = False
    for it in range(STEPS):
        if it % 10 == 0:
            jm.save_checkpoint(it)
            tm.save_checkpoint(it)
        g = {n: (rng.randn(*shapes[n]) * 0.1 / np.sqrt(max(1, np.prod(shapes[n])))
                 ).astype(np.float32) for n in names}
        if it == ROLLBACK_AT:
            g = {n: v * 100.0 for n, v in g.items()}
        if it == SPIKE_AT:
            g["global_q"] = g["global_q"] * 50.0
        norms = {n: float(np.linalg.norm(v)) for n, v in g.items()}
        gnorm = float(np.sqrt(sum(x * x for x in norms.values())))

        paths = jax.tree_util.tree_flatten_with_path(jm.params)
        jg = jax.tree_util.tree_unflatten(
            paths[1], [jnp.asarray(g[jm._leaf_name(p)]) for p, _ in paths[0]])
        jm._grad_accum.append((jg, {n: jnp.float32(v) for n, v in norms.items()},
                               jnp.float32(gnorm)))
        tg = [torch.as_tensor(g[n].T.copy() if n.endswith("kernel") else g[n]) for n in names]
        tm._grad_accum.append((tg, torch.tensor([norms[n] for n in names]),
                               torch.tensor(gnorm)))
        jd, td = jm.update(), tm.update()

        assert set(jd) == set(td)
        for k in jd:
            assert td[k] == pytest.approx(jd[k], rel=1e-5), k
        seen_clip |= any(k.startswith("grad_med/") for k in td) and it == SPIKE_AT
        seen_rollback |= (it == ROLLBACK_AT and td == {})
        assert tm._sched_step == _sched_count(jm.opt_state)
        want = _leaves(jm, jm.params)
        got = _leaves(jm, tm.state_np())
        for n, v in want.items():
            np.testing.assert_allclose(got[n], v, rtol=1e-6, atol=1e-6,
                                       err_msg="%s after update %d" % (n, it))
    assert seen_clip and seen_rollback


def test_checkpoints_cross_packages(models, tmp_path):
    """A port checkpoint loads into the JAX package and a JAX checkpoint
    into the port, both as the same pickle layout."""
    jm, tm = models
    rng = np.random.RandomState(5)
    with torch.no_grad():
        tm.params["body_mass"].mul_(torch.as_tensor(1.0 + 0.1 * rng.rand(13).astype(np.float32)))
        tm.modules["vel_mlp"].head[0].bias.add_(0.5)
    tm.save_checkpoint(99)
    jm.load_checkpoint(tm.save_dir + "/ckpt_phys_0099.pth")
    want = _leaves(jm, tm.state_np())
    got = _leaves(jm, jm.params)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)

    jm.params["target_kd"] = jm.params["target_kd"] * 1.5
    jm.save_checkpoint(98)
    tm.load_checkpoint(jm.save_dir + "/ckpt_phys_0098.pth")
    want = _leaves(jm, jm.params)
    got = _leaves(jm, tm.state_np())
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
