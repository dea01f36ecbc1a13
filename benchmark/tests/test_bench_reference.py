"""The plain reference agrees with the port's CPU path (the kernels' plain
versions) at a tiny size: the imitation step, the lab4d step and a served
rollout, from the same inputs. And the reference imports nothing of the
port, of jax or of the JAX package."""

import ast
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.generators import serve, train

TINY_TRAIN = {"num_envs": 3, "frames_per_wdw": 4}


def tiny(cell, scale, seed=20241018):
    return harness.Run(harness.Cell(cell), seed, 1, 0, "cpu", scale)


@pytest.mark.parametrize("cell", ["a1-imitation.train-e512", "a1-lab4d.step-e512"])
def test_training_steps_match_the_port_on_the_cpu(cell):
    run = tiny(cell, TINY_TRAIN)
    state = train.setup(run)
    record = train.release(run, state)
    ref = train.reference_steps(run, record["first"], record["inputs"])
    for lp, lr in zip(record["followed"]["losses"], ref["losses"]):
        for k in lr:
            assert lp[k] == pytest.approx(lr[k], rel=1e-6, abs=1e-9), k
    gaps = train.compare(record["followed"], ref)
    assert max(gaps.values()) < 1e-5, gaps
    # the steps trained: the optimizer moved the parameters
    moved = [float(d.abs().max()) for d in ref["change"].values()]
    assert max(moved) > 0


def test_served_rollout_matches_the_port_on_the_cpu():
    run = tiny("a1-imitation.serve-grid-e4096",
               {"num_envs": 6, "frames": 3, "keep_per_request": 6, "max_rows": 6})
    server = serve.make_server(run)
    starts = np.array([0, 1, 5, 20, 44, 45], np.float32)
    with torch.no_grad():
        got = server.rollout(starts)
    want = serve.reference_states(run, starts)
    # the grid prologue against the per-env one: time stamps rounded apart
    assert float((got - want).abs().max()) < 1e-5


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_no_program_and_no_jax():
    ref_dir = os.path.join(harness.BENCH_DIR, "reference")
    seen = 0
    for dirpath, _, files in os.walk(ref_dir):
        for f in files:
            if f.endswith(".py"):
                seen += 1
                for name in _imports(os.path.join(dirpath, f)):
                    top = name.split(".")[0]
                    assert top not in ("ppr_diffphys_torch", "ppr_diffphys_tpu", "jax",
                                       "jaxlib", "flax"), (f, name)
    assert seen >= 15
