"""Closed-loop training: one trainer runs the model's iterations back to
back, as the training CLI's iteration body does (``forward()``, the no-op
``backward``, ``update()``), at the traffic's envs and frames. The window
starts are drawn from the seed by the system (``draw_starts``); the
schedule's ``progress`` advances as the CLI's would over its rounds and
holds at its last value past them. The CLI's per-round checkpoint, eval and
videos are left out.

Set-up builds the model and runs its first ``ref_steps`` iterations through
the window's own call; they warm up every shape and are what the plain
reference follows. The window then runs iterations until ``--seconds`` have
passed. ``correct`` compares, program against the reference built from the
same inputs and fed the same starts and noise (``compare``), the numbers
that the cell's limits name:

- ``loss_gap``: every loss term of each of those steps, |program -
  reference| / |reference|, the worst (``loss1_gap``: the first step's);
- ``grad_gap``: the first step's gradient as the optimizer got it (AdamW's
  first moment after one step over 1 - beta1), per trainable tensor the gap
  between the two norms over the larger of the reference's norm of that
  tensor and of the median tensor, the worst (``grad_gap_median``: the
  median tensor's);
- ``change1_gap`` (and ``change1_gap_median``): the parameters' change
  after the first step, where both sides start from the same parameters
  and the first gradients agree to rounding, the same way, leaving out
  tensors whose reference gradient is under a thousandth of the median
  tensor's (they move under Adam by round-off alone);
- ``change_gap`` (and ``change_gap_median``): the parameters' change over
  all those steps, the same way.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from ..systems import common

ADAM_BETA1 = 0.9


def progress(run, it):
    """The CLI's ``it / (num_rounds * iters_per_round)``, held at its last
    iteration's value (``num_rounds * iters_per_round``) past the run."""
    o = run.config["opts"]
    total = int(o["num_rounds"]) * int(o["iters_per_round"])
    return min(it, total) / total


def trainable(model):
    ids = {id(p) for g in model.optimizer.param_groups for p in g["params"]}
    return [(n, t) for n, t in model.named_tensors() if id(t) in ids]


def first_moment_grads(model, names):
    """The gradient each trainable tensor's optimizer got at its one step."""
    out = {}
    for n, t in trainable(model):
        st = model.optimizer.state.get(t, {})
        if "exp_avg" in st:
            out[n] = (st["exp_avg"] / (1.0 - ADAM_BETA1)).detach().clone()
    if len(out) != len(names):  # the step was rolled back: the optimizer got none
        out = {n: model.last_grads[n].detach().clone() for n in names}
    return out


def one_step(run, model, it, starts, span=None):
    """One iteration; ``span`` (the tracer's, in the window) times its two
    calls."""
    span = span or (lambda name: contextlib.nullcontext())
    model.progress = progress(run, it)
    with span("forward"):
        out = model.forward(starts)
        model.backward(None)
    with span("update"):
        stats = model.update()
    return out, bool(stats)  # update() gives no statistics for a step it rolled back


def follow(run, model, starts_list):
    """Run the first steps on ``model``; returns what the comparison reads."""
    names = [n for n, _ in trainable(model)]
    theta0 = {n: t.detach().clone() for n, t in trainable(model)}
    losses, g1, change1, stepped = [], None, None, []
    for k, starts in enumerate(starts_list):
        out, ok = one_step(run, model, k, starts)
        losses.append({n: float(v) for n, v in out.items()})
        stepped.append(ok)
        if k == 0:
            g1 = first_moment_grads(model, names)
            change1 = {n: t.detach() - theta0[n] for n, t in trainable(model)}
    change = {n: t.detach() - theta0[n] for n, t in trainable(model)}
    return dict(losses=losses, g1=g1, change1=change1, change=change, stepped=stepped)


def setup(run):
    system = run.cell.system
    inputs = system.inputs(run, run.device)
    model = system.build("program", run, run.device, inputs)
    rng = np.random.default_rng(common.sub_seed(run.seed, "starts"))
    E, F = int(run.traffic["num_envs"]), int(run.traffic["frames_per_wdw"])
    draw = lambda: system.draw_starts(rng, model, E, F)
    first = [draw() for _ in range(int(run.traffic["ref_steps"]))]
    return dict(model=model, draw=draw, first=first, inputs=inputs,
                followed=follow(run, model, first))


def window(run, state):
    model, draw = state["model"], state["draw"]
    it = len(state["first"])
    n_trace = int(run.traffic["trace_steps"])
    steps, bad, failed = 0, None, 0
    with contextlib.ExitStack() as stack:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < run.seconds:
            if steps == 1:  # the profiled steps follow the window's first
                stack.enter_context(run.tracer.profile())
            try:
                out, _ = one_step(run, model, it + steps, draw(), run.tracer.span)
            except (RuntimeError, ValueError) as e:
                print("benchmark: step %d raised %r" % (it + steps, e))
                failed += 1
                steps += 1
                break
            flag = (~torch.isfinite(out["total_loss"])).int()
            bad = flag if bad is None else bad + flag
            steps += 1
            if steps == 1 + n_trace:
                stack.close()
        if run.device != "cpu":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    failed += int(bad) if bad is not None else 0
    work = run.cell.system.train_work(run)
    return {"e2e": {run.traffic["step_metric"]: elapsed / steps * 1e3},
            "attempted": steps, "failed": failed, "work": dict(work, steps=min(n_trace, max(steps - 1, 0)))}


def release(run, state):
    return dict(first=state["first"], inputs=state["inputs"], followed=state["followed"])


def norm_gaps(prog, ref, names):
    """Per tensor |norm(prog) - norm(ref)| / max(norm(ref), median norm(ref))."""
    pn = {n: float(torch.linalg.vector_norm(prog[n].double())) for n in names}
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    med = float(np.median([rn[n] for n in names]))
    return {n: abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names}, rn


def compare(prog, ref) -> dict:
    """Every number the comparison can hold a cell to, program (or control)
    against the reference: ``loss_gap`` over all the followed steps and
    ``loss1_gap`` over the first, the worst tensor's ``grad_gap``,
    ``change1_gap`` and ``change_gap``, and the median tensor's
    (``*_median``)."""
    out, worst = {"loss_gap": 0.0, "loss1_gap": 0.0}, None
    for i, (lp, lr) in enumerate(zip(prog["losses"], ref["losses"])):
        for k, r in lr.items():
            gap = abs(lp[k] - r) / max(abs(r), 1e-12)
            gap = gap if np.isfinite(gap) else float("inf")
            if gap >= out["loss_gap"]:
                out["loss_gap"], worst = gap, "step %d %s: %.9g vs %.9g" % (i + 1, k, lp[k], r)
            if i == 0:
                out["loss1_gap"] = max(out["loss1_gap"], gap)
    print("benchmark: loss_gap worst %s; optimizer steps taken %s vs %s"
          % (worst, prog["stepped"], ref["stepped"]), file=sys.stderr)
    names = sorted(ref["g1"])
    grad, rn = norm_gaps(prog["g1"], ref["g1"], names)
    med = float(np.median(list(rn.values())))
    moved = [n for n in names if rn[n] >= 1e-3 * med]
    change1, _ = norm_gaps(prog["change1"], ref["change1"], moved)
    change, _ = norm_gaps(prog["change"], ref["change"], moved)
    for label, gaps in (("grad_gap", grad), ("change1_gap", change1), ("change_gap", change)):
        vals = [v if np.isfinite(v) else float("inf") for v in gaps.values()]
        out[label], out[label + "_median"] = max(vals), float(np.median(vals))
        worst = max(gaps, key=gaps.get)
        print("benchmark: %s worst tensor %s (%.3g), median %.3g; %d tensors compared"
              % (label, worst, gaps[worst], out[label + "_median"], len(gaps)), file=sys.stderr)
    return out


def reference_steps(run, starts_list, inputs, tf32=False):
    """The plain reference built from the same inputs, following the same
    first steps (in TF32 for the control)."""
    common.fp32_matmuls(tf32)
    try:
        model = run.cell.system.build("reference", run, run.device, inputs)
        return follow(run, model, starts_list)
    finally:
        common.fp32_matmuls(False)


def gaps(run, record) -> dict:
    """Every comparable number, the program against the reference."""
    return compare(record["followed"], reference_steps(run, record["first"], record["inputs"]))


def check(run, record):
    g = gaps(run, record)
    return [(n, g[n], float(lim)) for n, lim in run.limits.items()]


def readings(run, record, witness=False):
    """The program's numbers and the control's (the reference in TF32 put in
    the program's place), each against the fp32 reference computed once;
    with ``witness``, also a second fp32 reference's."""
    ref = reference_steps(run, record["first"], record["inputs"])
    ctl = reference_steps(run, record["first"], record["inputs"], tf32=True)
    out = {"program": compare(record["followed"], ref), "control": compare(ctl, ref)}
    if witness:  # the reference run again against itself: what rounding alone moves
        out["reference_again"] = compare(reference_steps(run, record["first"],
                                                         record["inputs"]), ref)
    return out
