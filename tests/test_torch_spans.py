"""The program's span and counter recorder (``ppr_diffphys_torch/utils/spans.py``)
in the training step, the serving prologue and the per-layer metric readers
of ``benchmark/metrics`` that read it.

The recorder records only while the torch profiler records: with none
running a training step records nothing; under ``torch.profiler.profile``
(CPU activity) a tiny a1 step (2 envs x 3 frames) records the forward tree
with one root id per step. The card test (marked ``cuda``) holds K3's span
under ``forward.backward`` across autograd's device thread and the two K3
counters to each other. This file imports neither jax nor the JAX package,
so the card runs it as ``python -m pytest --noconftest tests/test_torch_spans.py``.
"""

import contextlib
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ppr_diffphys_torch.utils import spans

import port_helpers as H

REPO = os.path.dirname(H.TESTS_DIR)
E, F, STEPS = 2, 3, 2
STARTS = np.array([0.0, 5.0], np.float32)

# the training step's spans and their parents
TRAIN_TREE = {
    "phys_model.forward": None,
    "forward.inputs": "phys_model.forward",
    "forward.fk": "phys_model.forward",
    "forward.rollout": "phys_model.forward",
    "rollout.observables": "forward.rollout",
    "rollout.interval": "forward.rollout",
    "forward.losses": "phys_model.forward",
    "forward.backward": "phys_model.forward",
    "forward.grad_norms": "phys_model.forward",
    "phys_model.update": None,
    "update.grad_read": "phys_model.update",
    "update.adamw": "phys_model.update",
}
PROLOGUE_TREE = {"prologue": None, "prologue.check": "prologue", "prologue.mlp": "prologue",
                 "prologue.gather": "prologue", "prologue.fk": "prologue"}


@pytest.fixture(autouse=True)
def clean_recorder():
    spans.reset()
    yield
    spans.reset()


def _a1_model(device, tmp):
    from ppr_diffphys_torch.data.amp_loader import DataLoader
    from ppr_diffphys_torch.models.phys_model import phys_model

    o = H.serve_opts(logroot=str(tmp), num_rounds=1, iters_per_round=STEPS + 2)
    m = phys_model(dict(o), DataLoader(o), device=device)
    m.reinit_envs(E, frames_per_wdw=F, is_eval=False)
    return m


def _steps(m, n):
    for _ in range(n):
        m.forward(frame_start=STARTS)
        m.update()


@pytest.fixture(scope="module")
def traced_cpu_steps(tmp_path_factory):
    """STEPS profiled training steps on the CPU after one unprofiled step:
    (the recorder's state after the unprofiled step, its summary and raw
    spans after the profiled ones, the profiler's event names)."""
    spans.reset()
    m = _a1_model("cpu", tmp_path_factory.mktemp("logs"))
    _steps(m, 1)
    before = spans.summary()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(m, STEPS)
    # the profiler's own events, unparsed (``prof.events()`` builds the same
    # names into a tree, ~40 s for these ~550k events)
    out = dict(before=before, summary=spans.summary(), raw=spans.raw(),
               events={e.name() for e in prof.profiler.kineto_results.events()})
    spans.reset()
    return out


def test_no_profiler_records_nothing(traced_cpu_steps):
    before = traced_cpu_steps["before"]
    assert before["spans"] == {} and before["counters"] == {} and before["raw"] == 0
    assert not spans.recording()
    a, b = spans.span("phys_model.forward"), spans.span("window")
    assert a is b and isinstance(a, contextlib.nullcontext)
    spans.count("k3.contact_triples", 5)
    assert spans.summary()["counters"] == {}


def test_training_step_records_the_forward_tree(traced_cpu_steps):
    sp = traced_cpu_steps["summary"]["spans"]
    assert set(sp) == set(TRAIN_TREE)  # no K3 span on the CPU: the plain interval
    for name, parent in TRAIN_TREE.items():
        s = sp[name]
        assert s["parent"] == parent, name
        assert s["roots"] == STEPS, name
        assert 0.0 <= s["self_ms"] <= s["host_ms"] + 1e-9, name
    assert sp["rollout.interval"]["calls"] == (F - 1) * STEPS
    assert sp["rollout.observables"]["calls"] == F * STEPS
    assert sp["forward.fk"]["calls"] == 2 * STEPS
    for root in ("phys_model.forward", "phys_model.update", "forward.rollout"):
        kids = sum(s["host_ms"] for n, s in sp.items() if s["parent"] == root)
        assert kids <= sp[root]["host_ms"] + 1e-6, root
        assert sp[root]["self_ms"] == pytest.approx(sp[root]["host_ms"] - kids, abs=1e-3)


def test_one_root_id_per_step(traced_cpu_steps):
    raw = traced_cpu_steps["raw"]
    by_root = {}
    for name, parent, root, t0, t1 in raw:
        assert t0 <= t1
        by_root.setdefault(root, []).append((name, parent))
    assert len(by_root) == 2 * STEPS  # each step's forward and update
    for members in by_root.values():
        roots = [n for n, p in members if p is None]
        assert len(roots) == 1 and roots[0] in ("phys_model.forward", "phys_model.update")


def test_span_names_are_profiler_ranges(traced_cpu_steps):
    missing = set(TRAIN_TREE) - traced_cpu_steps["events"]
    assert not missing


def test_prologue_records_its_children(tmp_path):
    from ppr_diffphys_torch.models.serve import RolloutServer

    opts = H.serve_opts(logroot=str(tmp_path))
    server = RolloutServer(opts, num_envs=3, frames=3, device="cpu")
    grid = np.array([0.0, 4.0, 7.0], np.float32)
    offgrid = grid + np.float32(0.25)
    with torch.no_grad():
        server.prologue(grid)
    assert spans.summary()["spans"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for starts in (grid, offgrid):
            st, ref = server.prologue(starts)
            server.window(st, ref, None, server.model._sim_params())
    sp = spans.summary()["spans"]
    assert set(sp) == set(PROLOGUE_TREE) | {"window"}
    for name, parent in PROLOGUE_TREE.items():
        assert sp[name]["parent"] == parent and sp[name]["roots"] == 2, name
    assert sp["window"]["parent"] is None and sp["window"]["roots"] == 2
    assert sp["prologue.mlp"]["calls"] == 2 and sp["prologue.fk"]["calls"] == 2
    kids = sum(s["host_ms"] for s in sp.values() if s["parent"] == "prologue")
    assert kids <= sp["prologue"]["host_ms"] + 1e-6


def test_a_thread_with_no_open_span_nests_under_the_open_root():
    """As autograd's device thread does under ``forward.backward``."""
    rec = spans.Recorder(recording=lambda: True)
    done, seen = [], []

    def worker():
        seen.append(rec.stack())
        with rec.span("backward.interval"):
            seen.append(rec.stack())
            time.sleep(0.02)
        done.append(True)

    with rec.span("phys_model.forward"):
        with rec.span("forward.backward"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and done
    assert seen == [["phys_model.forward", "forward.backward"], ["backward.interval"]]
    with rec.span("phys_model.update"):
        pass
    sp = rec.summary()["spans"]
    assert sp["backward.interval"]["parent"] == "forward.backward"
    assert sp["backward.interval"]["roots"] == 1
    fb = sp["forward.backward"]
    assert fb["self_ms"] == pytest.approx(fb["host_ms"] - sp["backward.interval"]["host_ms"])
    roots = {r[2] for r in rec.raw() if r[0] != "phys_model.update"}
    assert len(roots) == 1 and sp["phys_model.update"]["roots"] == 1


def test_counters_raw_cap_and_reset():
    rec = spans.Recorder(recording=lambda: True, max_raw=3)
    rec.count("k3.contact_triples", 10)
    rec.count("k3.contact_triples", 5)
    rec.count("k3.active_contacts", torch.tensor(2))
    rec.count("k3.active_contacts", torch.tensor(3))
    for _ in range(5):
        with rec.span("rollout.interval"):
            pass
    s = rec.summary()
    assert s["counters"] == {"k3.contact_triples": 15, "k3.active_contacts": 5.0}
    assert s["raw"] == 3 and s["dropped"] == 2 and s["spans"]["rollout.interval"]["calls"] == 5
    assert s["spans"]["rollout.interval"]["roots"] == 5
    rec.reset()
    assert rec.summary() == {"spans": {}, "counters": {}, "raw": 0, "dropped": 0}
    off = spans.Recorder(recording=lambda: False)
    off.count("k3.contact_triples", 1)
    with off.span("window"):
        pass
    assert off.summary()["spans"] == {} and off.summary()["counters"] == {}


# ---- the per-layer readers ------------------------------------------------
def _summary(steps=4):
    sp = lambda ms, parent, roots=steps: dict(calls=roots, host_ms=ms, self_ms=ms,
                                              parent=parent, roots=roots)
    return dict(spans={
        "phys_model.forward": sp(400.0, None), "forward.inputs": sp(40.0, "phys_model.forward"),
        "rollout.interval": sp(92.0, "forward.rollout"),
        "rollout.observables": sp(48.0, "forward.rollout"),
        "forward.backward": sp(200.0, "phys_model.forward"),
        "update.grad_read": sp(8.0, "phys_model.update"),
        "losses.distill": sp(12.0, "forward.losses"),
        "prologue": sp(120.0, None), "prologue.mlp": sp(60.0, "prologue"),
        "prologue.fk": sp(20.0, "prologue")},
        counters={"k3.contact_triples": 4000, "k3.active_contacts": 500.0}, raw=0, dropped=0)


READERS = {  # metric -> its reading of _summary() at 4 steps
    "train.inputs_host_ms": 10.0, "train.interval_host_ms": 23.0,
    "train.observables_host_ms": 12.0, "train.backward_host_ms": 50.0,
    "train.grad_wait_ms": 2.0, "train.k3_active_share": 12.5,
    "lab4d.inputs_host_ms": 10.0, "lab4d.distill_host_ms": 3.0, "lab4d.grad_wait_ms": 2.0,
    "serve.prologue_mlp_host_ms": 15.0, "serve.prologue_fk_host_ms": 5.0,
}


def _reader(name):
    from benchmark.harness import load_file_module

    return load_file_module(os.path.join(REPO, "benchmark", "metrics", name + ".py"),
                            "spans_test_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_summary(name, monkeypatch):
    read = _reader(name).read
    ctx = {"work": {"steps": 4}}
    monkeypatch.setattr(spans, "summary", lambda: _summary())
    assert read(ctx) == pytest.approx(READERS[name])
    empty = dict(spans={}, counters={}, raw=0, dropped=0)
    monkeypatch.setattr(spans, "summary", lambda: empty)
    assert read(ctx) is None
    if not name.endswith("k3_active_share"):  # spans of other steps than the window's
        monkeypatch.setattr(spans, "summary", lambda: _summary(steps=3))
        assert read(ctx) is None


def test_readers_read_nothing_where_nothing_recorded():
    assert spans.summary()["spans"] == {}
    for name in READERS:
        assert _reader(name).read({"work": {"steps": 4}}) is None, name


# ---- on the card ------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k3_span_and_counters_on_the_card(cuda_device, tmp_path):
    """K3's span, opened on autograd's device thread, nests under
    ``forward.backward``; the counters: every K3 launch's E x S x C triples,
    of which the penetrating ones a share."""
    m = _a1_model(cuda_device, tmp_path)
    _steps(m, 1)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _steps(m, 1)
    s = spans.summary()
    sp = s["spans"]
    assert sp["backward.interval"]["parent"] == "forward.backward"
    assert sp["backward.interval"]["calls"] == F - 1 and sp["backward.interval"]["roots"] == 1
    assert sp["rollout.interval"]["calls"] == F - 1
    kids = sp["backward.interval"]["host_ms"]
    assert sp["forward.backward"]["self_ms"] <= sp["forward.backward"]["host_ms"] - kids + 1e-6
    c = s["counters"]
    S, C = m.steps_per_fr_interval, m.env.contact_count
    assert c["k3.contact_triples"] == (F - 1) * S * E * C
    assert 0 <= c["k3.active_contacts"] <= c["k3.contact_triples"]
