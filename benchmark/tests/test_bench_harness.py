"""The harness around the cells, on the CPU: the JAX check, the exits
without a card or without the program, a cell added by files alone, and
``correct`` coming out false for each fault that a cell can have, with the
timed path broken underneath (the look for a chip skipped: ``run_cell`` on
the CPU at a tiny size)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import faults, harness

ROOT = harness.ROOT
TINY_TRAIN = {"num_envs": 4, "frames_per_wdw": 4}
TINY_SERVE = {"num_envs": 6, "frames": 3, "keep_per_request": 3, "max_rows": 12}
SEED = 3000000019  # above 2**31


def env_without_cards():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_forbidden_modules_compare_top_level_names_whole():
    fake = {"os": None, "jax.numpy": None, "ppr_diffphys_torch.sim": None, "jax_utils": None,
            "flaxen": None, "jaxlib.xla_client": None, "ppr_diffphys_tpu.models": None}
    assert harness.forbidden_modules(fake) == ["jax", "jaxlib", "ppr_diffphys_tpu"]
    assert harness.forbidden_modules({"ppr_diffphys_torch": None, "flax_like": None}) == []


@pytest.mark.parametrize("name,found", [("ppr_diffphys_torch", "[]"),
                                        ("jax", "['jax']"),
                                        ("ppr_diffphys_tpu", "['ppr_diffphys_tpu']")])
def test_jax_check_in_a_process(name, found):
    """A process that loaded only the port passes; one with a module named
    jax or ppr_diffphys_tpu loaded fails (a stand-in module is enough)."""
    load = ("import ppr_diffphys_torch" if name == "ppr_diffphys_torch" else
            "import sys, types; sys.modules[%r] = types.ModuleType(%r)" % (name, name))
    code = ("%s\nfrom benchmark.harness import forbidden_modules\nprint(forbidden_modules())"
            % load)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == found


def _no_result(out):
    return not any(l.strip().startswith("{") for l in out.stdout.splitlines())


def test_run_without_a_card_exits_non_zero_with_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "a1-imitation.train-e10", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env_without_cards())
    assert out.returncode != 0 and _no_result(out)
    assert "CUDA" in out.stderr


def test_run_without_the_program_exits_non_zero_with_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "a1-imitation.train-e512", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env_without_cards())
    assert out.returncode != 0 and _no_result(out)


def test_a_cell_traffic_and_metric_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell, its limits and a
    per-layer metric as new files and BENCHMARK.json entries only; the
    harness finds and runs them (traced, on the CPU at a tiny size)."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = tmp_path / "benchmark"
    (b / "traffic" / "train-e3.json").write_text(json.dumps(
        dict(json.load(open(b / "traffic" / "train-e10.json")), num_envs=3, frames_per_wdw=3)))
    (b / "cells" / "a1-imitation.train-e3.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-6, "grad_gap": 1e-6, "change_gap": 1e-6}}))
    (b / "metrics" / "train.envs.py").write_text(
        "def read(ctx):\n    return ctx['run'].traffic['num_envs']\n")
    cell = "a1-imitation.train-e3"
    spec["workloads"].append({"name": cell, "config": "a1-imitation", "traffic": "train-e3",
                              "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_step_ms":
            m["workloads"].append(cell)
    spec["per_layer"].append({"name": "train.envs", "unit": "envs", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "train_step_ms", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; sys.path.append(%r)  # the program, after this copy\n"
            "from benchmark.harness import run_cell\n"
            "print(json.dumps(run_cell(%r, %d, 1, 1, device='cpu')))" % (ROOT, cell, SEED))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["train.envs"]["value"] == 3


# ---- faults: the timed path broken underneath, correct must come out false

def _run(cell, scale):
    return harness.run_cell(cell, SEED, 1, 0, device="cpu", scale=scale)


def test_sound_runs_are_correct():
    assert _run("a1-imitation.train-e512", TINY_TRAIN)["correct"]
    assert _run("a1-imitation.serve-grid-e4096", TINY_SERVE)["correct"]


@pytest.mark.parametrize("cell,fault", [
    ("a1-imitation.train-e512", "unchanged"), ("a1-imitation.train-e512", "half"),
    ("a1-imitation.train-e512", "altered"), ("a1-lab4d.step-e512", "unchanged"),
    ("a1-imitation.serve-grid-e4096", "unchanged"), ("a1-imitation.serve-grid-e4096", "half"),
    ("a1-imitation.serve-grid-e4096", "altered")])
def test_each_fault_makes_the_run_incorrect(cell, fault):
    generator = harness.Cell(cell).traffic["generator"]
    with faults.planted(fault, generator):
        res = _run(cell, TINY_SERVE if generator == "serve" else TINY_TRAIN)
    assert not res["correct"], res["checks"]
