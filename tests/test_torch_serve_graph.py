"""The serving grid prologue on its static buffers (``models/serve.py``:
``PrologueGraph``), run eagerly on the CPU: bit for bit the prologue as it
was written before the graph (``_unstaged_grid_prologue`` below, a frozen
copy), for start sets in a row and after a checkpoint swap; off-grid starts
take the per-env path. The graph's capture and replay are held to the eager
prologue on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ppr_diffphys_torch.models.serve import RolloutServer
from ppr_diffphys_torch.ops import swap_lin_ang
from ppr_diffphys_torch.sim.kinematics import eval_fk
from ppr_diffphys_torch.utils import spans

import port_helpers as H

E, F = 4, 3


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    opts = H.serve_opts(logroot=str(tmp_path_factory.mktemp("logs")))
    return RolloutServer(opts, num_envs=E, frames=F, device="cpu")


def _unstaged_grid_prologue(server, starts):
    """The grid prologue before the static buffers: the starts uploaded as
    they come, the MLPs on the substep grid, the gathers, FK and ``ref``."""
    m = server.model
    fs = torch.as_tensor(np.asarray(starts, np.float64), dtype=torch.float32)
    sub = m.steps_per_fr_interval
    K = (m.total_frames - 1) * sub + 1
    S = sub * (server.frames - 1) + 1
    g = torch.arange(K, dtype=torch.float32) / sub
    batch = m.get_batch_input(m.params, g[None])
    grid_q, grid_ja, grid_qd = (batch[k][0] for k in ("queried_q", "queried_ja", "queried_qd"))
    k0 = torch.round(fs * sub).to(torch.long)
    q_init = torch.cat([grid_q[k0], grid_ja[k0]], -1)
    qd_init = swap_lin_ang(grid_qd[k0])
    idx = k0[:, None] + torch.arange(S)[None]
    queried_ja = grid_ja[idx]
    body_q, body_qd = eval_fk(m.env, q_init, qd_init)
    ref = torch.cat([torch.zeros((S, len(fs), 6)), queried_ja.transpose(0, 1)], -1)
    return body_q, body_qd, ref


def _assert_bitwise(got, want):
    state, ref = got
    for name, a, b in zip(("body_q", "body_qd", "ref"), (state.body_q, state.body_qd, ref), want):
        assert a.shape == b.shape and torch.equal(a, b), name


def _counted(fn):
    """``fn()`` under the CPU profiler: (its result, the program's summary)."""
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = fn()
        return out, spans.summary()
    finally:
        spans.reset()


def test_static_buffer_prologue_equals_the_unstaged_one(server):
    """Two start sets in a row: each call's outputs are its own starts'."""
    for starts in ([0.0, 1.0, 7.0, 45.0], [3.0, 0.0, 45.0, 12.0]):
        fs = np.asarray(starts, np.float32)
        _assert_bitwise(server.prologue(fs), _unstaged_grid_prologue(server, fs))
    assert server._graph.graph is None  # the CPU runs the body eagerly


def test_prologue_serves_a_loaded_checkpoint(server, tmp_path):
    fs = np.asarray([2.0, 5.0, 0.0, 30.0], np.float32)
    state, ref = server.prologue(fs)
    before = (state.body_q.clone(), ref.clone())
    graph = server._graph
    server.load_checkpoint(H.perturbed_checkpoint(server.model, str(tmp_path / "ckpt.pth")))
    got = server.prologue(fs)
    assert server._graph is graph  # the load wrote the parameters in place: same key
    _assert_bitwise(got, _unstaged_grid_prologue(server, fs))
    assert not torch.equal(got[0].body_q, before[0]) and not torch.equal(got[1], before[1])


@pytest.mark.parametrize("starts,grid", [
    ([0.0, 1.0, 7.0, 45.0], True),
    ([0.0, 1.5, 2.25, 30.1], False),  # fractional
    ([-0.5, 3.0, 46.0, 47.5], False),  # out of range
], ids=["grid", "fractional", "out_of_range"])
def test_prologue_counters_and_path(server, monkeypatch, starts, grid):
    """Every CPU prologue counts ``prologue.eager``; grid starts run under
    ``prologue.graph``, off-grid ones through the per-env prologue."""
    per_env = []
    body = server._per_env_prologue
    monkeypatch.setattr(server, "_per_env_prologue", lambda c: per_env.append(c) or body(c))
    (state, ref), summ = _counted(lambda: server.prologue(np.asarray(starts, np.float32)))
    c, sp = summ["counters"], summ["spans"]
    assert c.get("prologue.eager") == 1
    assert "prologue.captures" not in c and "prologue.replays" not in c
    assert sp["prologue"]["roots"] == 1
    assert ("prologue.graph" in sp) == grid
    assert len(per_env) == (0 if grid else 1)
    S = server.model.steps_per_fr_interval * (F - 1) + 1
    assert state.body_q.shape == (E, 13, 7) and ref.shape == (S, E, 6 + 12)
