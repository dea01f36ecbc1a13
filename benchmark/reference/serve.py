"""The plain reference of a served rollout: the window's inputs worked out
per env from the mocap table and the five MLPs at every substep of the
env's window (no grid, no gather), FK for the initial state, and the plain
window. Returns the frame states (F, E, B, 7)."""

from __future__ import annotations

import torch

from .ops import swap_lin_ang
from .sim.integrator import SimState, rollout
from .sim.kinematics import eval_fk

CHUNK = 1024  # envs of one MLP evaluation (1024 x 760 rows)


@torch.no_grad()
def served_states(model, frame_start, frames):
    """``model``: the reference ``phys_model``; ``frame_start`` (E,) float32
    on its device; ``frames`` the window's frames."""
    sub = model.steps_per_fr_interval
    S = sub * (frames - 1) + 1
    dev = frame_start.device
    offs = torch.arange(S, dtype=torch.float32, device=dev) / sub
    qs, qds, jas = [], [], []
    for fs in torch.split(frame_start, CHUNK):
        batch = model.get_batch_input(model.params, fs[:, None] + offs[None])
        q_init = torch.cat([batch["queried_q"][:, 0], batch["queried_ja"][:, 0]], -1)
        qd_init = swap_lin_ang(batch["queried_qd"][:, 0])
        body_q, body_qd = eval_fk(model.env, q_init, qd_init)
        qs.append(body_q)
        qds.append(body_qd)
        jas.append(batch["queried_ja"])
    ja = torch.cat(jas, 0)
    E = ja.shape[0]
    ref = torch.cat([torch.zeros((S, E, 6), device=dev), ja.transpose(0, 1)], -1)
    state = SimState(torch.cat(qs, 0), torch.cat(qds, 0))
    return rollout(model.integrator, model._sim_params(), state, ref, None, None, model.dt,
                   sub)[0]
