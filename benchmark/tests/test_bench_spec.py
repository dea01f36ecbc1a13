"""BENCHMARK.json against the form it must have, and every name in it
resolved to its files: configurations, traffic mixes, cell limits, systems,
generators and metric readers."""

import importlib
import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and os.path.isdir(os.path.join(ROOT, p))
    for w in SPEC["command"]:
        assert line(w)
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    for group in (names, CELLS, [m["name"] for m in metrics]):
        assert len(group) == len(set(group))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        c = harness.Cell(cell, SPEC)
        names = [m["name"] for m in c.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        for m in c.per_layer:  # a layer metric's cell reports what it moves
            assert m["moves"] in names


def test_layers_metrics_name_the_same_layer_letter_for_letter():
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%" and m["layer"] == "device"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.Cell(cell, SPEC)
    assert c.config_entry["file"].startswith("benchmark/configs/")
    assert c.config["system"] and c.traffic["generator"]
    for fn in ("setup", "window", "release", "check", "readings"):
        assert callable(getattr(c.generator, fn))
    train = c.traffic["generator"] == "train"
    for fn in ("inputs", "build", "draw_starts") if train else ("prepare",):
        assert callable(getattr(c.system, fn))
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(c.reader(m).read)


def test_every_configuration_and_file_is_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        cfg = json.load(open(os.path.join(ROOT, f)))
        importlib.import_module("benchmark.systems." + cfg["system"])
        assert cfg["precision"] == "float32" and cfg["tf32"] is False


def test_four_chip_cells_within_the_share():
    four = sum(1 for w in SPEC["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(CELLS) // 4)


def test_check_fits_the_day():
    n = len(CELLS)
    total = (2 + 14 * n) * (SPEC["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200
    full = (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert full <= 43200
