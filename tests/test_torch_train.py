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

import json
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


def test_reference_surface_helpers_match_jax(models):
    """get_mocap_data and get_net_pred within 1e-5 of each output's largest
    entry on the same parameters (fp32 MLPs in two frameworks: measured
    ~1.3e-6 on vel_mlp's outputs of up to ~3); rearrange_pred, the
    optimizable groups with their lrs, and rm_module_prefix equal."""
    jm, tm = models
    tm.load_params_from_jax(jax.tree.map(np.asarray, jm.params))
    steps = np.array([[0.0, 1.5, 7.25, 20.0], [3.0, 3.5, 40.0, 46.9]], np.float32)
    jd, td = jm.get_mocap_data(steps), tm.get_mocap_data(steps)
    assert set(jd) == set(td)
    for k in jd:
        want = np.asarray(jd[k])
        np.testing.assert_allclose(td[k].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    jp, tp = jm.get_net_pred(steps), tm.get_net_pred(steps)
    for name, j, t in zip(("torques", "delta_root", "delta_ja", "state_qd", "res_f"), jp, tp):
        want = np.asarray(j)
        assert t.shape == want.shape, name
        np.testing.assert_allclose(t.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)
    rng = np.random.RandomState(4)
    args = [rng.randn(2, 4, n).astype(np.float32)
            for n in (7, tm.n_dof, 6 + tm.n_dof, tm.n_dof, 6 * tm.n_links)]
    for name, j, t in zip(("ref_ja", "qq", "qd", "torques", "res_f"),
                          jm.rearrange_pred(*[jax.numpy.asarray(a) for a in args]),
                          tpm.phys_model.rearrange_pred(*[torch.as_tensor(a) for a in args])):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    (jref, _, jlr), (tref, tparams, tlr) = (jm.get_optimizable_param_list(),
                                            tm.get_optimizable_param_list())
    assert [list(d) for d in tref] == [list(d) for d in jref]
    assert tlr == jlr
    named = dict(tm.named_tensors())
    assert tparams[[list(d)[0] for d in tref].index("global_q")] is named["global_q"]
    states = {"module.a": 1, "b": 2, "module": 3, "modulex.c": 4}
    assert tm.rm_module_prefix(states) == jm.rm_module_prefix(states) == {
        "a": 1, "b": 2, "module": 3, "modulex.c": 4}


def test_cli_runs_on_cpu(tmp_path):
    """python -m ppr_diffphys_torch.main --device cpu --render_vis: 1 round of
    2 iters (rounds start at iters 0 and 2), JSON loss lines on stdout, and
    the files a round of the JAX CLI writes (checkpoints, the four videos,
    the OBJ strip, tensorboard events, whose eval/traj and per-iteration
    loss scalars equal the JSON lines) plus the --profile_dir trace."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    prof = tmp_path / "prof"
    cmd = [sys.executable, "-m", "ppr_diffphys_torch.main", "--device", "cpu",
           "--urdf_template", "a1", "--seqname", H.SEQNAME, "--datadir", H.MOTION_DIR,
           "--urdf_dir", H.FIXTURES, "--logroot", str(tmp_path), "--num_rounds", "1",
           "--iters_per_round", "2", "--num_envs", "2", "--frames_per_wdw", "3",
           "--render_vis", "--profile_dir", str(prof)]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(l) for l in out.stdout.splitlines() if l.startswith("{")]
    losses = [l for l in lines if "total_loss" in l]
    evals = [l for l in lines if "eval/traj" in l]
    assert [l["it"] for l in losses] == [0, 1, 2]
    assert [l["it"] for l in evals] == [0, 2]
    save = tmp_path / ("%s-dynamics" % H.SEQNAME)
    names = sorted(os.listdir(save))
    events = [n for n in names if n.startswith("events.out.tfevents.")]
    want = ["ckpt_phys_%s.pth" % s for s in ("0000", "0002", "best", "latest")]
    for it in ("00000", "00002"):
        want += ["%s-%s.mp4" % (s, it) for s in ("target", "sim", "control_ref", "all")]
        want.append("sim_traj-%s.obj" % it)
    assert sorted(n for n in names if n not in events) == sorted(want)
    assert len(events) == 1
    for n in names:
        assert (save / n).stat().st_size > 0, n
    acc = EventAccumulator(str(save))
    acc.Reload()
    for key, recs in (("eval/traj", evals), ("loss", losses), ("loss_traj", losses),
                      ("iter_time", losses)):
        got = [(e.step, e.value) for e in acc.Scalars(key)]
        assert got == [(r["it"], pytest.approx(r[key], rel=1e-6)) for r in recs], key
    assert (prof / "trace.json").stat().st_size > 0
