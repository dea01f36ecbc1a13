"""The benchmark harness: one cell of ``BENCHMARK.json`` run once.

Everything that belongs to one cell is found by name:

- ``BENCHMARK.json`` (the checkout's root): the cell (``workloads``), its
  configuration (``configs``) and the metrics that name it;
- ``configs/<config>.json``: the configuration's sizes and options, and the
  ``system`` (``systems/<system>.py``) that builds the program and the plain
  reference from them;
- ``traffic/<traffic>.json``: the traffic mix's parameters, and the
  ``generator`` (``generators/<generator>.py``) that generates it from the seed,
  drives the window and checks the outputs;
- ``cells/<config>.<traffic>.json``: the limits of the cell's correctness
  comparison, with the readings they were set from;
- ``metrics/<metric>.py``: one reader per per-layer metric, ``read(ctx)``,
  which returns a number or None (nothing to read).

A run: set-up (build, warm up, the first steps that the reference follows)
-> the window of ``--seconds`` -> the device's peak memory -> the program's
state freed -> the plain reference and the comparison -> the check that no
JAX module is loaded -> the result line, last on stdout.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# compared whole against each loaded module's top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "ppr_diffphys_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names of the loaded modules that are JAX or the JAX
    package (the part of each name before the first dot, compared whole)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def process_env():
    """The run's environment, set before torch loads: one host thread for
    PyTorch's and the math libraries' pools (one process loads the card;
    idle pool threads would only contend with it for the host's cores),
    and fixed cache directories inside the checkout, so that a Triton or
    torch extension build, should the program ever make one, is found
    again by the next run. The port's own kernel libraries build into
    ``ppr_diffphys_torch/build/`` inside the checkout."""
    base = os.path.join(ROOT, ".bench_cache")
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(k, "1")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_file_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell with everything found by its name."""

    def __init__(self, name, spec=None):
        spec = load_json(os.path.join(ROOT, "BENCHMARK.json")) if spec is None else spec
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError("no workload %r in BENCHMARK.json (%s)" % (name, sorted(cells)))
        self.name = name
        self.workload = cells[name]
        self.chips = int(self.workload["chips"])
        cfg = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        self.config_entry = cfg
        self.config = load_json(os.path.join(ROOT, cfg["file"]))
        self.traffic_name = self.workload["traffic"]
        self.traffic = load_json(os.path.join(BENCH_DIR, "traffic", self.traffic_name + ".json"))
        self.limits = load_json(os.path.join(BENCH_DIR, "cells", name + ".json"))["limits"]
        self.system = importlib.import_module("benchmark.systems." + self.config["system"])
        self.generator = importlib.import_module("benchmark.generators." + self.traffic["generator"])
        covers = lambda m: name in m.get("workloads", [name])
        self.end_to_end = [m for m in spec["end_to_end"] if covers(m)]
        self.per_layer = [m for m in spec["per_layer"] if covers(m)]

    def reader(self, metric):
        path = os.path.join(BENCH_DIR, "metrics", metric["name"] + ".py")
        return load_file_module(path, "benchmark_metric_" + metric["name"].replace(".", "_"))


class Run:
    """What a generator gets: the cell, the seed, the window length, whether
    the run is traced, the device, and ``scale`` (test-only overrides of
    the traffic's sizes; None in every benchmark run)."""

    def __init__(self, cell, seed, seconds, trace, device, scale=None):
        from .trace import Tracer

        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.traffic = dict(cell.traffic, **(scale or {}))
        self.config = cell.config
        self.limits = cell.limits
        self.tracer = Tracer(self.trace, device)


def run_cell(name, seed, seconds, trace, device="cuda", scale=None, spec=None):
    """Run one cell once; returns the result dict (without the chip check,
    which ``main`` makes). ``checks`` is a list of (name, value, limit)."""
    import torch

    cell = Cell(name, spec)
    run = Run(cell, seed, seconds, trace, device, scale)
    gen = cell.generator
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = gen.setup(run)
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if forbidden_modules():
        raise RuntimeError("modules of JAX or the JAX package are loaded after set-up: %s"
                           % forbidden_modules())
    meas = gen.window(run, state)
    if device != "cpu":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    else:
        peak = 0
    record = gen.release(run, state)
    del state
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    checks = gen.check(run, record)
    print("benchmark: set-up %.1f s, window %d x %s, reference and comparison %.1f s"
          % (setup_s, meas["attempted"], cell.traffic["generator"], time.perf_counter() - t1),
          file=sys.stderr, flush=True)
    correct = bool(checks) and all(v <= lim for _, v, lim in checks) and meas["failed"] == 0

    values = dict(meas["e2e"], setup_s=setup_s)
    result = {"correct": correct, "attempted": int(meas["attempted"]),
              "failed": int(meas["failed"])}
    if not trace:
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        ctx = dict(run=run, values=values, spans=run.tracer.span_ms(), profile=run.tracer.summary,
                   work=meas["work"], counters=meas.get("counters", {}))
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
    result["device"] = device_info(device, peak, run.tracer.summary if trace else None)
    if trace and run.tracer.summary is not None:
        result["breakdown"] = run.tracer.summary["breakdown"]
    finite = lambda v: float(v) if v == v and abs(v) != float("inf") else None
    result["checks"] = {n: {"value": finite(v), "limit": float(lim)} for n, v, lim in checks}
    return result


def device_info(device, peak, summary):
    import torch

    if device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": peak}
    if summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    return info


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    process_env()
    import torch

    cell = Cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("benchmark: the cell needs %d CUDA device(s); torch sees %d"
              % (cell.chips, torch.cuda.device_count() if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, a.trace)
    found = forbidden_modules()
    if found:
        print("benchmark: modules of JAX or the JAX package are loaded: %s" % found,
              file=sys.stderr)
        return 3
    for n, c in result["checks"].items():
        print("check %s %s limit %.6g" % (n, c["value"], c["limit"]), file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
    return 0
