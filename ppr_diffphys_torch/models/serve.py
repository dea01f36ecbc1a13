"""Batched serving rollouts (PyTorch/CUDA), counterpart of
``ppr_diffphys_tpu/models/serve.py``.

Rolls out a trained imitation policy (checkpointed phys_model parameters:
control-reference MLPs + identified gains/masses/global SE(3)) over many
environments at once. No gradients. On a CUDA device the window always
runs the hand-written kernel (``csrc/soa_window.cu`` through
``sim/soa.py:SoaWindow``); on the CPU it runs the kernel's plain PyTorch
version.

On a CUDA device the grid prologue (whole-frame starts) is captured once
per key into one CUDA graph and replayed on every later request
(:class:`PrologueGraph`): the host launches one graph a request instead of
the ~1k kernels of the MLPs on the substep grid, the gathers and FK, and
makes no blocking copy (the starts go from pinned memory into a static
buffer). The graph's outputs are static tensors that every request
rewrites: a prologue's outputs are valid until the next ``prologue`` call.

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
from .step_graph import to_device

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
        self._graph = None  # the grid prologue's PrologueGraph

    def load_checkpoint(self, path):
        # parameters are per-call inputs of the window, and the prologue's
        # graph reads them where they live (the load writes them in place):
        # a checkpoint swap needs no rebuild and no new capture
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
        [0, total_frames - frames] (``_check``). Returns (SimState, ref); it
        reads nothing from the host, so ``PrologueGraph`` can capture it."""
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
            # the window's (S, E, n_qd) targets in one gather of the grid's
            # rows, zero on the root's 6 as the per-env path's
            grid_ref = torch.cat([torch.zeros((K, 6), device=self.device), grid_ja], -1)
            idx = torch.arange(S, device=self.device)[:, None] + k0[None]  # (S, E)
            ref = grid_ref[idx]
        with spans.span("prologue.fk"):
            body_q, body_qd = eval_fk(m.env, q_init, qd_init)
        return SimState(body_q, body_qd), ref

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
        the per-substep joint targets (S, E, n_qd). Grid starts go through
        the ``PrologueGraph`` of the present key, whose outputs the next call
        rewrites: they are valid until then. While the profiler records, a
        call is the span ``prologue`` with its children ``prologue.check``
        and either ``prologue.graph`` (grid starts; ``prologue.mlp``,
        ``.gather`` and ``.fk`` under it run only at a capture or off CUDA)
        or ``prologue.mlp``, ``.gather`` and ``.fk`` (the per-env path,
        which counts ``prologue.eager``)."""
        with spans.span("prologue"):
            with spans.span("prologue.check"):
                k_host, grid = self._check(frame_start)
            if grid:
                return self._prologue_graph().step(k_host)
            spans.count("prologue.eager", 1)
            fs = torch.as_tensor(k_host, dtype=torch.float32, device=self.device)
            parts = [self._per_env_prologue(c) for c in torch.split(fs, PER_ENV_CHUNK)]
            with spans.span("prologue.gather"):
                body_q, body_qd, queried_ja = (torch.cat(p, 0) for p in zip(*parts))
                E, S = queried_ja.shape[:2]
                # (S, E, n_qd), contiguous: the window kernel reads it as it is
                ref = torch.cat(
                    [torch.zeros((S, E, 6), device=self.device), queried_ja.transpose(0, 1)],
                    -1)
            return SimState(body_q, body_qd), ref

    def _prologue_graph(self):
        """The PrologueGraph of the present key, made anew when it changes:
        the envs and frames fix its buffers' shapes, and the mocap table,
        which ``init_global_q`` replaces, is read by address."""
        key = (self.num_envs, self.frames, id(self.model.amp_table))
        if self._graph is None or self._graph.key != key:
            self._graph = None  # its memory goes before the next capture takes more
            self._graph = PrologueGraph(self, key)
        return self._graph

    @torch.no_grad()
    def rollout(self, frame_start=None):
        """frame_start: (E,) starting frames (defaults to 0s).
        Returns (F, E, B, 7) maximal-coordinate frame states."""
        state, ref = self.prologue(frame_start)
        # joint activations are structurally zero in serving (the reference
        # multiplies torque_mlp by 0): the window takes act=None
        body_q, _, _, _ = self.window(state, ref, None, self.model._sim_params())
        return body_q


class PrologueGraph:
    """The grid prologue (``RolloutServer._grid_prologue``) of one key on a
    static (E,) ``frame_start`` buffer, a request's one host input. On CUDA
    it is captured into one CUDA graph at the first call, after one eager
    warm-up on a side stream (it builds what the prologue makes at first
    use), and replayed on every call; off CUDA the same body runs eagerly
    on the same buffer. The graph reads the parameters where they live and
    the mocap table it was captured with (kept alive here; a new table
    makes a new key), and writes ``(SimState(body_q, body_qd), ref)`` into
    the same tensors on every replay: ``step``'s outputs are valid until
    its next call. While the profiler records, a call is the span
    ``prologue.graph`` (staging and the replay, or the capture) and counts
    ``prologue.captures`` and ``prologue.replays``, or ``prologue.eager``
    off CUDA."""

    def __init__(self, server, key):
        self.server = server
        self.key = key
        self.frame_start = torch.zeros((server.num_envs,), dtype=torch.float32,
                                       device=server.device)
        self.amp_table = server.model.amp_table  # alive while a graph may read it
        self.graph = None
        self.outputs = None  # (SimState, ref), rewritten by each call

    def step(self, k_host):
        """Stage the starts (a float64 host array), capture at the first
        CUDA call, replay: the prologue's outputs, valid until the next
        call."""
        with spans.span("prologue.graph"):
            to_device(torch.from_numpy(k_host.astype(np.float32)), self.frame_start.device,
                      self.frame_start)
            if self.frame_start.device.type != "cuda":
                spans.count("prologue.eager", 1)
                self.outputs = self.server._grid_prologue(self.frame_start)
                return self.outputs
            if self.graph is None:
                self._capture()
            self.graph.replay()
            spans.count("prologue.replays", 1)
        return self.outputs

    def _capture(self):
        dev = self.frame_start.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.server._grid_prologue(self.frame_start)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.outputs = self.server._grid_prologue(self.frame_start)
        self.graph = graph
        spans.count("prologue.captures", 1)
