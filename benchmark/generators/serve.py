"""Serving: one client sends rollout requests to ``RolloutServer`` in a
closed loop, each as soon as the last one's answer is synchronized. A
request is ``num_envs`` starts drawn from the seed, whole frames uniform
over ``[0, start_max]`` (so the grid prologue applies), and its answer is
the (F, E, B, 7) frame states of a ``frames``-frame window. Its latency
runs from its issue to its synchronized answer. With one request in flight
no queue forms: the tail of latency is the service time's, and the
env-steps completed per second are the server's capacity.

Every request keeps ``keep_per_request`` of its env rows, drawn from the
seed, on the device. ``correct`` compares, once the window has closed and
the server is freed, at most ``max_rows`` of the kept rows (drawn from the
seed) against the plain reference worked out from the same starts:
``q_err``, the largest absolute difference of any frame state component.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..systems import common


def make_server(run):
    from ppr_diffphys_torch.models.serve import RolloutServer
    from ppr_diffphys_torch.utils.config import build_opts

    sysm = run.cell.system
    tr = run.traffic
    opts = common.opts_from(run.config, build_opts, logname="bench-serve")
    E, F = int(tr["num_envs"]), int(tr["frames"])
    server = RolloutServer(opts, num_envs=E, frames=F, device=run.device)
    common.check_widths(dict(server.model.modules.items()), run.config)
    sysm.prepare(server.model, run.config, run.seed, run.device)
    server.model.reinit_envs(E, frames_per_wdw=F, is_eval=True)
    return server


def setup(run):
    tr = run.traffic
    server = make_server(run)
    rng = np.random.default_rng(common.sub_seed(run.seed, "requests"))
    E, k = int(tr["num_envs"]), int(tr["keep_per_request"])

    def draw():
        starts = rng.integers(0, int(tr["start_max"]) + 1, size=E).astype(np.float32)
        rows = rng.choice(E, size=k, replace=False)
        return starts, rows

    state = dict(server=server, draw=draw, kept=[])
    starts, rows = draw()  # warm-up: the request's shapes, and the kept rows' gather
    answer(run, server, starts, rows)
    return state


def answer(run, server, starts, rows, span=None):
    span = span or (lambda name: contextlib.nullcontext())
    with torch.no_grad():
        with span("prologue"):
            st, ref = server.prologue(starts)
        with span("window"):
            body_q = server.window(st, ref, None, server.model._sim_params())[0]
    idx = torch.as_tensor(rows, device=body_q.device)
    return body_q.index_select(1, idx), (~torch.isfinite(body_q)).any().int()


def window(run, state):
    tr = run.traffic
    server, draw = state["server"], state["draw"]
    n_trace = int(tr["trace_requests"])
    lat, bad, failed, n = [], None, 0, 0
    with contextlib.ExitStack() as stack:
        t0 = time.perf_counter()
        t_end = t0
        while time.perf_counter() - t0 < run.seconds:
            if n == 1:  # the profiled requests follow the window's first
                stack.enter_context(run.tracer.profile())
            starts, rows = draw()
            issued = time.perf_counter()
            try:
                if run.trace:
                    kept, flag = answer(run, server, starts, rows, run.tracer.span)
                else:
                    with torch.no_grad():
                        body_q = server.rollout(starts)
                    idx = torch.as_tensor(rows, device=body_q.device)
                    kept = body_q.index_select(1, idx)
                    flag = (~torch.isfinite(body_q)).any().int()
                if run.device != "cpu":
                    torch.cuda.synchronize()
            except (RuntimeError, ValueError) as e:
                print("benchmark: request %d raised %r" % (n, e))
                failed += 1
                n += 1
                break
            t_end = time.perf_counter()
            lat.append(t_end - issued)
            state["kept"].append((starts[rows], kept))
            bad = flag if bad is None else bad + flag
            n += 1
            if n == 1 + n_trace:
                stack.close()
    failed += int(bad) if bad is not None else 0
    sub = server.model.steps_per_fr_interval
    env_steps = int(tr["num_envs"]) * sub * (int(tr["frames"]) - 1)
    done = len(lat)
    e2e = {"rollout_env_steps_per_s": done * env_steps / (t_end - t0),
           "rollout_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95))}
    work = run.cell.system.serve_work(run)
    return {"e2e": e2e, "attempted": n, "failed": failed,
            "work": dict(work, steps=min(n_trace, max(done - 1, 0)))}


def release(run, state):
    starts = np.concatenate([s for s, _ in state["kept"]])
    rows = torch.cat([q for _, q in state["kept"]], 1)  # (F, rows, B, 7)
    return dict(starts=starts, states=rows)


def reference_states(run, starts, tf32=False):
    from ..reference.serve import served_states

    common.fp32_matmuls(tf32)
    try:
        model = run.cell.system.make_model("reference", run.config, run.device)
        run.cell.system.prepare(model, run.config, run.seed, run.device)
        F = int(run.traffic["frames"])
        model.reinit_envs(len(starts), frames_per_wdw=F, is_eval=True)
        fs = torch.as_tensor(starts, dtype=torch.float32, device=run.device)
        return served_states(model, fs, F)
    finally:
        common.fp32_matmuls(False)


def sample(run, record):
    """The compared rows: at most ``max_rows`` of the kept ones, from the seed."""
    n = len(record["starts"])
    m = min(n, int(run.traffic["max_rows"]))
    rng = np.random.default_rng(common.sub_seed(run.seed, "compare"))
    pick = np.sort(rng.choice(n, size=m, replace=False))
    return record["starts"][pick], record["states"][:, torch.as_tensor(pick)]


def q_err(got, want):
    err = (got.to(want.device) - want).abs().max()
    return float(err) if torch.isfinite(err) else float("inf")


def gaps(run, record) -> dict:
    """Every comparable number, the program against the reference."""
    starts, got = sample(run, record)
    return {"q_err": q_err(got, reference_states(run, starts))}


def check(run, record):
    g = gaps(run, record)
    return [(n, g[n], float(lim)) for n, lim in run.limits.items()]


def readings(run, record, witness=False):
    """The program's number and the control's (the reference in TF32 put in
    the program's place), each against the fp32 reference."""
    starts, got = sample(run, record)
    want = reference_states(run, starts)
    ctl = reference_states(run, starts, tf32=True)
    return {"program": {"q_err": q_err(got, want)}, "control": {"q_err": q_err(ctl, want)}}
