"""The lab4d step's inputs at the rows the step reads
(``phys_interface._step_inputs``): the ground truth, the proxy's root and
``vel_mlp`` at the frame boundaries (E x F rows), the proxy's joint angles
and the zeroed MLPs at every substep (E x S), against ``get_batch_input``,
which keeps its every-substep output, on the a1 interface over two videos
(offsets [0, 40, 88], 4 substeps a frame) on the CPU.

The full-row hook (``phys_model._step_inputs``, the imitation model's hook,
bound to the interface) is the step's inputs as ``get_batch_input`` gives
them, then cut to the frame rows. The rows it
computes beyond those take no part in the losses and give exact zeros to
the gradients, so the two hooks part only by the order of summation:
values, losses and every gradient are held to 1e-6 of the tensor's largest
entry (measured: values and losses equal, gradients within 3.2e-7). Every
batch has at least 64 frame rows: below that the CPU's matrix product takes
another kernel, whose rounding moves a row's value by up to ~4e-7 of the
entries, and a few substeps of simulation carry that to ~1e-5 in the
gradients. This file imports neither jax nor the JAX package.
"""

from types import MethodType

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ppr_diffphys_torch.models.phys_model import phys_model
from ppr_diffphys_torch.utils import spans

import port_helpers as H

OFFSETS = (0, 40, 88)
E, F = 12, 8
# windows in each video, one of them across the boundary at frame 40
STARTS = np.array([0, 5, 11, 18, 26, 36, 41, 49, 58, 66, 73, 80], np.float32)
SUBSTEP_KEYS = ("queried_ja", "torques", "res_f")
TOL = 1e-6


def _close(got, want, tol=TOL):
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) <= tol * scale


@pytest.fixture(scope="module")
def lab4d(tmp_path_factory):
    return H.lab4d_interface(str(tmp_path_factory.mktemp("lab4d")), offsets=OFFSETS)


def _full_rows(tm):
    return MethodType(phys_model._step_inputs, tm)


def _steps_fr(tm):
    return torch.as_tensor(STARTS)[:, None] + tm._steps_idx_fr_t[None]


def test_step_inputs_are_the_batch_at_the_rows_read(lab4d):
    tm = lab4d
    tm.reinit_envs(E, frames_per_wdw=F, is_eval=False)
    steps_fr = _steps_fr(tm)
    S = steps_fr.shape[1]
    with torch.no_grad():
        got = tm._step_inputs(tm.params, steps_fr)
        full = tm.get_batch_input(tm.params, steps_fr)
    assert set(got) == set(full)
    f2s = torch.as_tensor(tm.frame2step)
    for k in tm.FRAME_KEYS:
        assert got[k].shape[:2] == (E, F), k
        assert _close(got[k], full[k][:, f2s]), k
    for k in SUBSTEP_KEYS:
        assert full[k].shape[:2] == (E, S), k
        assert torch.equal(got[k], full[k]), k
    assert torch.equal(got["joint_X_p"], full["joint_X_p"])


def test_training_forward_matches_the_full_row_inputs(lab4d):
    """One training forward's losses and every tensor's gradient (the zeroed
    MLPs' and the frozen fields' included) from the frame-row inputs and from
    the full-row ones."""
    tm = lab4d
    tm.reinit_envs(E, frames_per_wdw=F, is_eval=False)
    runs = []
    for hook in (None, _full_rows(tm)):
        if hook is not None:
            tm._step_inputs = hook
        try:
            out = tm.forward(frame_start=STARTS)
        finally:
            tm.__dict__.pop("_step_inputs", None)
        runs.append((out, {k: g.clone() for k, g in tm.last_grads.items()}))
    tm._grad_accum.clear()
    (out, grads), (want_out, want_grads) = runs
    assert set(out) == set(want_out)
    for k in out:
        assert _close(out[k], want_out[k]), (k, float(out[k]), float(want_out[k]))
    assert float(out["loss_pos_distill"]) > 0
    assert set(grads) == set(want_grads) == {n for n, _ in tm.named_tensors()}
    for k, g in grads.items():
        assert _close(g, want_grads[k]), k
    assert float(grads["object_field.articulation.rest_offsets"].abs().max()) > 0


def test_eval_aux_is_unchanged(lab4d):
    """The eval forward over the whole sequence (1 env): the vis cameras and
    the distilled trajectory, from both hooks."""
    tm = lab4d
    vis = []
    for hook in (None, _full_rows(tm)):
        tm.reinit_envs(1, frames_per_wdw=tm.total_frames, is_eval=True)
        if hook is not None:
            tm._step_inputs = hook
        try:
            tm.forward(frame_start=[0.0])
        finally:
            tm.__dict__.pop("_step_inputs", None)
        vis.append({k: torch.as_tensor(getattr(tm, k)) for k in
                    ("target_q_vis", "world2view_vis", "ks_vis", "distilled_trajs")})
    got, want = vis
    for k in got:
        assert got[k].shape[0] == tm.total_frames, k
        assert _close(got[k], want[k]), k


def test_input_row_counters(lab4d, tmp_path):
    """Under the profiler, the time-MLPs' rows where they run: a lab4d step
    on its E x S substep rows 4 evaluations (the proxy's articulation and
    delta joint-angle MLPs, the zeroed torque and residual-force MLPs) and
    on its E x F frame rows 7 (the target's and the proxy's object and scene
    cameras and articulation or delta root MLP, ``vel_mlp``); the full-row
    hook 11 on the substep rows; an imitation step its 5 time-MLPs on the
    substep rows. A recompute in the backward (``remat``) counts nothing,
    and neither does ``get_batch_input`` called outside a step."""
    from ppr_diffphys_torch.data.amp_loader import DataLoader

    o = H.serve_opts(logroot=str(tmp_path), num_rounds=1, iters_per_round=2)
    mocap = phys_model(dict(o), DataLoader(o), device="cpu")
    for m, starts, hook, want in ((lab4d, STARTS, None, (4, 7)),
                                  (lab4d, STARTS, _full_rows(lab4d), (11, 0)),
                                  (mocap, STARTS[:2] % 20, None, (5, 0))):
        m.reinit_envs(len(starts), frames_per_wdw=F, is_eval=False)
        S = len(m.steps_idx)
        spans.reset()
        if hook is not None:
            m._step_inputs = hook
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                m.forward(frame_start=starts)
                with torch.no_grad():
                    m.get_batch_input(None, _steps_fr(m)[:len(starts)])
            c = spans.summary()["counters"]
        finally:
            m.__dict__.pop("_step_inputs", None)
            spans.reset()
        m._grad_accum.clear()
        n = len(starts)
        assert c.get("inputs.rows_substep", 0) == want[0] * n * S
        assert c.get("inputs.rows_frame", 0) == want[1] * n * F
