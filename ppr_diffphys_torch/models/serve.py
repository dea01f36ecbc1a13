"""Batched serving rollouts (PyTorch/CUDA), counterpart of
``ppr_diffphys_tpu/models/serve.py``.

Rolls out a trained imitation policy (checkpointed phys_model parameters:
control-reference MLPs + identified gains/masses/global SE(3)) over many
environments at once. No gradients. On a CUDA device the window always
runs the hand-written kernel (``csrc/soa_window.cu`` through
``sim/soa.py:SoaWindow``); on the CPU it runs the kernel's plain PyTorch
version.

Usage:
    server = RolloutServer(opts, num_envs=4096, device="cuda")
    server.load_checkpoint(path)          # optional
    states = server.rollout(frame_start)  # (F, E, B, 7) frame states
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..data.amp_loader import DataLoader
from ..ops import swap_lin_ang
from ..sim.integrator import SimState
from ..sim.kinematics import eval_fk
from ..sim.soa import SoaWindow
from ..utils import spans
from .phys_model import phys_model

# Env chunk of the per-env prologue: it evaluates the five MLPs at every
# (env, substep) pair, so a chunk bounds its hidden activations
# (256 envs x ~760 substeps x 256 wide x 4 B ~ 0.2 GB per layer).
PER_ENV_CHUNK = 256


class RolloutServer:
    def __init__(self, opts, num_envs=1024, frames=None, device=None):
        self.opts = opts
        self.device = default_device(device)
        dataloader = DataLoader(opts)
        self.model = phys_model(opts, dataloader, device=self.device)
        self.num_envs = num_envs
        self.frames = frames or self.model.total_frames
        if self.frames > self.model.total_frames:
            raise ValueError(
                f"frames={self.frames} exceeds the sequence's "
                f"total_frames={self.model.total_frames}; the serving "
                "window cannot be longer than the mocap sequence"
            )
        self.model.reinit_envs(num_envs, frames_per_wdw=self.frames, is_eval=True)
        m = self.model
        self.window = SoaWindow(m.integrator, m.dt, m.steps_per_fr_interval, self.frames)

    def load_checkpoint(self, path):
        # parameters are per-call inputs of the window: a checkpoint swap
        # needs no rebuild
        self.model.load_checkpoint(path)

    # ------------------------------------------------------------------
    # prologues: initial maximal state + per-substep joint targets
    # ------------------------------------------------------------------
    def _per_env_prologue(self, frame_start):
        """frame_start (Ec,) -> (body_q, body_qd, queried_ja (Ec, S, n_dof))."""
        m = self.model
        steps_fr = frame_start[:, None] + torch.as_tensor(
            m.steps_idx_fr, dtype=torch.float32, device=self.device
        )[None]
        with spans.span("prologue.mlp"):
            batch = m.get_batch_input(m.params, steps_fr)
        q_init = torch.cat([batch["queried_q"][:, 0], batch["queried_ja"][:, 0]], -1)
        qd_init = swap_lin_ang(batch["queried_qd"][:, 0])
        with spans.span("prologue.fk"):
            body_q, body_qd = eval_fk(m.env, q_init, qd_init)
        return body_q, body_qd, batch["queried_ja"]

    def _grid_prologue(self, frame_start):
        """The control MLPs are functions of time only: evaluate them once on
        the K absolute-substep grid and gather each env's window by index.
        Exact when every start lies on the substep grid inside
        [0, total_frames - frames] (rollout() checks)."""
        m = self.model
        sub = m.steps_per_fr_interval
        K = (m.total_frames - 1) * sub + 1
        S = sub * (self.frames - 1) + 1
        with spans.span("prologue.mlp"):
            g = torch.arange(K, dtype=torch.float32, device=self.device) / sub
            batch = m.get_batch_input(m.params, g[None])
        grid_q = batch["queried_q"][0]  # (K, 7)
        grid_ja = batch["queried_ja"][0]  # (K, n_dof)
        grid_qd = batch["queried_qd"][0]  # (K, 6 + n_dof)
        with spans.span("prologue.gather"):
            k0 = torch.round(frame_start * sub).to(torch.long)
            q_init = torch.cat([grid_q[k0], grid_ja[k0]], -1)
            qd_init = swap_lin_ang(grid_qd[k0])
            idx = k0[:, None] + torch.arange(S, device=self.device)[None]  # (E, S)
            queried_ja = grid_ja[idx]
        with spans.span("prologue.fk"):
            body_q, body_qd = eval_fk(m.env, q_init, qd_init)
        return body_q, body_qd, queried_ja

    def _check(self, frame_start):
        """Validate frame_start on the caller's host array; returns (starts
        as float64 numpy, whether the grid prologue applies)."""
        if frame_start is None:
            frame_start = np.zeros((self.num_envs,), np.float32)
        if isinstance(frame_start, torch.Tensor):
            frame_start = frame_start.detach().cpu().numpy()
        k_host = np.asarray(frame_start, np.float64)
        if k_host.shape != (self.num_envs,):
            raise ValueError(
                f"frame_start shape {k_host.shape} != ({self.num_envs},)"
            )
        sub = self.model.steps_per_fr_interval
        k = k_host * sub
        # grid prologue: every start on the substep grid AND inside
        # [0, total_frames - frames]; other starts take the per-env
        # prologue, which extrapolates linearly via _interp_amp
        in_range = bool(
            np.all(k_host >= 0)
            and np.all(k_host <= self.model.total_frames - self.frames)
        )
        return k_host, bool(np.all(k == np.round(k))) and in_range

    @torch.no_grad()
    def prologue(self, frame_start=None):
        """Window inputs for ``frame_start`` (E,): the initial SimState and
        the per-substep joint targets (S, E, n_qd). While the profiler
        records, a call is the span ``prologue`` with its children
        ``prologue.check``, ``prologue.mlp``, ``prologue.gather`` and
        ``prologue.fk``."""
        with spans.span("prologue"):
            with spans.span("prologue.check"):
                k_host, grid = self._check(frame_start)
                fs = torch.as_tensor(k_host, dtype=torch.float32, device=self.device)
            if grid:
                body_q, body_qd, queried_ja = self._grid_prologue(fs)
            else:
                parts = [self._per_env_prologue(c) for c in torch.split(fs, PER_ENV_CHUNK)]
                with spans.span("prologue.gather"):
                    body_q, body_qd, queried_ja = (torch.cat(p, 0) for p in zip(*parts))
            E, S = queried_ja.shape[:2]
            # (S, E, n_qd), contiguous: the window kernel reads it as it is
            with spans.span("prologue.gather"):
                ref = torch.cat(
                    [torch.zeros((S, E, 6), device=self.device), queried_ja.transpose(0, 1)],
                    -1)
            return SimState(body_q, body_qd), ref

    @torch.no_grad()
    def rollout(self, frame_start=None):
        """frame_start: (E,) starting frames (defaults to 0s).
        Returns (F, E, B, 7) maximal-coordinate frame states."""
        state, ref = self.prologue(frame_start)
        # joint activations are structurally zero in serving (the reference
        # multiplies torque_mlp by 0): the window takes act=None
        body_q, _, _, _ = self.window(state, ref, None, self.model._sim_params())
        return body_q
