"""The yardstick's frozen counts equal the port's own hand counts
(``sim/soa.py:window_work``, ``sim/soa_grad.py:interval_work``) at each
cell's shapes, and the MLP operation count matches the built modules."""

import pytest
import torch

from benchmark import harness
from benchmark.systems import imitation, lab4d
from benchmark.work import counts

TRAIN_CELLS = ["a1-imitation.train-e512", "a1-imitation.train-e10"]


def run_of(cell):
    return harness.Run(harness.Cell(cell), 1, 1, 0, "cpu")


def a1_env():
    """The a1 robot both configurations run (the reference's build)."""
    return imitation.shapes(run_of(TRAIN_CELLS[0])).env


@pytest.mark.parametrize("cell", TRAIN_CELLS + ["a1-lab4d.step-e512"])
def test_interval_work_equals_the_ports(cell):
    from ppr_diffphys_torch.sim.soa_grad import interval_work

    run = run_of(cell)
    env = a1_env()
    E = int(run.traffic["num_envs"])
    xp = E if cell.startswith("a1-lab4d") else 0
    want = interval_work(env, E, 33, n_active_contacts=0, xp_lanes=xp)
    assert counts.interval_work(env, E, 33, xp_lanes=xp) == want
    work = (lab4d if xp else imitation).train_work(run)
    assert work["k2"] == dict(bytes=want["fwd_bytes"], ops=want["fwd_ops"])
    assert work["k3"] == dict(bytes=want["bwd_bytes"], ops=want["bwd_ops"])
    assert work["intervals"] == int(run.traffic["frames_per_wdw"]) - 1


@pytest.mark.parametrize("cell", ["a1-imitation.serve-grid-e4096"])
def test_window_work_equals_the_ports(cell):
    from ppr_diffphys_torch.sim.soa import window_work

    run = run_of(cell)
    env = a1_env()
    E, F = int(run.traffic["num_envs"]), int(run.traffic["frames"])
    want = window_work(env, E, 33, F)
    assert counts.window_work(env, E, 33, F) == want
    assert imitation.serve_work(run)["k1"] == dict(bytes=want["bytes"], ops=want["ops"])


def test_mlp_ops_count_every_linear():
    lin = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.ReLU(), torch.nn.Linear(5, 7))
    assert counts.mlp_ops(lin, 10, backward=False) == 10 * 2 * (15 + 35)
    # backward: weight gradients of both, the input gradient of the second
    assert counts.mlp_ops(lin, 10, backward=True) == 10 * (3 * 2 * (15 + 35) - 2 * 15)


def test_train_work_counts_five_mlps_at_every_substep():
    run = run_of("a1-imitation.train-e512")
    m = imitation.shapes(run)
    rows = 512 * (33 * 23 + 1)
    per_row = sum(counts.mlp_ops(mod, 1, backward=True) for mod in m.modules.values())
    assert imitation.train_work(run)["mlp_ops"] == pytest.approx(rows * per_row)
    # a D=5, W=256 trunk with skips 1-4, its time embedding and an 18-wide
    # head: 2 * (13*256 + 512*256 + 256*256 + 4*512*256 + 256*256 + 256*18)
    fwd = counts.mlp_ops(m.modules["vel_mlp"], 1, backward=False)
    assert fwd == 2 * (13 * 256 + 512 * 256 + 256 * 256 + 4 * 512 * 256 + 256 * 256 + 256 * 18)


def test_roofline_is_the_larger_bound():
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
