"""The training slice as a whole: the port's phys_model (device="cpu", so
the rollout runs the plain interval) against the JAX package's phys_model
(XLA engine) on a1 with the committed clip, after carrying the JAX
parameters across: the loss dict and every parameter gradient of one
forward (2 envs, 3 frames, noise_std=0, the same frame starts), then the
parameters after 3 forward+update steps. Also the gradient scrubbing at the
rollout boundary, the eval forward, and a CPU run of the CLI
``python -m ppr_diffphys_torch.main --device cpu``.

Tolerances: the same fp32 pipeline (MLPs, FK, 66 substeps, losses) in two
frameworks: losses to rtol 1e-4, each gradient within 5e-4 of its largest
entry (measured ~1e-5), parameters after 3 updates to 1e-5 relative plus
1e-5 absolute (measured 3e-5 absolute on target_ke ~ 220).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from ppr_diffphys_tpu.data.amp_loader import DataLoader as JDataLoader
from ppr_diffphys_tpu.models.phys_model import phys_model as JModel
from ppr_diffphys_torch.data.amp_loader import DataLoader as TDataLoader
from ppr_diffphys_torch.models import phys_model as tpm

import port_helpers as H

E, F = 2, 3
FRAME_START = np.array([0.0, 5.0], np.float32)
REPO = os.path.dirname(H.TESTS_DIR)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    opts = H.serve_opts(logroot=str(tmp_path_factory.mktemp("logs")),
                        num_rounds=1, iters_per_round=3)
    jm = JModel(dict(opts), JDataLoader(opts))
    tm = tpm.phys_model(dict(opts), TDataLoader(opts), device="cpu")
    tm.load_params_from_jax(jax.tree.map(np.asarray, jm.params))
    for m in (jm, tm):
        m.reinit_envs(E, frames_per_wdw=F, is_eval=False)
    return jm, tm


def _leaves(jm, tree):
    return {jm._leaf_name(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_train_step_matches_jax(models):
    jm, tm = models
    jout = jm.forward(frame_start=FRAME_START)
    tout = tm.forward(frame_start=FRAME_START)
    assert set(jout) == set(tout)
    for k in jout:
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    assert float(tout["loss_traj"]) > 0

    jg = _leaves(jm, jm._grad_accum[-1][0])
    tg = tm._grad_accum[-1][0]
    assert len(tg) == len(jg)
    for (name, _), g in zip(tm._trainable, tg):
        g = g.numpy()
        g = g.T if name.endswith("kernel") else g
        a = jg[name]
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(g / scale, a / scale, atol=5e-4, rtol=0,
                                   err_msg="grad " + name)

    for i in range(3):
        if i:
            jm.forward(frame_start=FRAME_START)
            tm.forward(frame_start=FRAME_START)
        jm.update()
        tm.update()
    want = _leaves(jm, jm.params)
    got = _leaves(jm, tm.state_np())
    for n, v in want.items():
        np.testing.assert_allclose(got[n], v, rtol=1e-5, atol=1e-5, err_msg=n)


def test_scrub_grad_clamps_the_rollout_cotangent():
    x = torch.zeros(5, requires_grad=True)
    g = torch.tensor([float("nan"), float("inf"), -float("inf"), 3.0, -0.5])
    got, = torch.autograd.grad(tpm.scrub_grad(x), x, g)
    assert got.tolist() == [0.0, 1.0, -1.0, 1.0, -0.5]
    got, = torch.autograd.grad(tpm.scrub_grad_ref(x), x, g)
    assert got[0] == 0.0 and got[1] == 1.0 and got[3] == 1.0 and got[4] == -0.5
    assert got[2] < -1e30  # upper-only clamp: -inf becomes the lowest float


def test_eval_forward_runs_the_window(models):
    """Eval rolls the whole clip out without gradient through SoaWindow and
    stores the env-0 trajectories for query()."""
    _, tm = models
    tm.reinit_envs(1, frames_per_wdw=tm.total_frames, is_eval=True)
    out = tm.forward()
    tm.reinit_envs(E, frames_per_wdw=F, is_eval=False)
    assert np.isfinite(float(out["loss_traj"]))
    assert tm.sim_trajs.shape == (tm.total_frames, tm.n_links, 7)
    data = tm.query()
    assert data["com"].shape == (tm.total_frames, 3)
    assert any(isinstance(k, tuple) and k[0] == "window" for k in tm._kernels)


def test_cli_runs_on_cpu(tmp_path):
    """python -m ppr_diffphys_torch.main --device cpu: 1 round of 2 iters,
    JSON loss lines on stdout and the round checkpoints."""
    cmd = [sys.executable, "-m", "ppr_diffphys_torch.main", "--device", "cpu",
           "--urdf_template", "a1", "--seqname", H.SEQNAME, "--datadir", H.MOTION_DIR,
           "--urdf_dir", H.FIXTURES, "--logroot", str(tmp_path), "--num_rounds", "1",
           "--iters_per_round", "2", "--num_envs", "2", "--frames_per_wdw", "3"]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert sum('"total_loss"' in l for l in lines) == 3  # iters 0, 1, 2
    assert sum('"eval/traj"' in l for l in lines) == 2
    save = tmp_path / ("%s-dynamics" % H.SEQNAME)
    for name in ("ckpt_phys_0000.pth", "ckpt_phys_0002.pth", "ckpt_phys_best.pth"):
        assert (save / name).exists(), name
