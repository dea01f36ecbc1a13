"""The reader of ``train.graph_host_ms`` on made-up span summaries, and its
silence where there is nothing to read."""

import os

import pytest

from benchmark.harness import load_file_module

READER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "metrics", "train.graph_host_ms.py")


def _summary(roots, names):
    span = lambda ms, parent: dict(calls=roots, host_ms=ms, self_ms=ms, parent=parent, roots=roots)
    return dict(spans={n: span(ms, p) for n, (ms, p) in names.items()}, counters={}, raw=0,
                dropped=0)


def _ctx(steps):
    return {"profile": None, "spans": {}, "work": {"steps": steps}}


def test_graph_host_ms_reads_the_step_graph_span(monkeypatch):
    """``forward.graph``'s host ms per traced step; None where the program
    recorded no such span (an eager step), or where its steps are not the
    window's."""
    from ppr_diffphys_torch.utils import spans

    read = load_file_module(READER, "bench_test_graph_host_ms").read
    graphed = {"phys_model.forward": (40.0, None), "forward.graph": (6.0, "phys_model.forward")}
    monkeypatch.setattr(spans, "summary", lambda: _summary(4, graphed))
    assert read(_ctx(4)) == pytest.approx(1.5)
    monkeypatch.setattr(spans, "summary", lambda: _summary(3, graphed))
    assert read(_ctx(4)) is None
    eager = {"phys_model.forward": (40.0, None), "forward.backward": (30.0, "phys_model.forward")}
    monkeypatch.setattr(spans, "summary", lambda: _summary(4, eager))
    assert read(_ctx(4)) is None
    monkeypatch.setattr(spans, "summary", lambda: dict(spans={}, counters={}, raw=0, dropped=0))
    assert read(_ctx(4)) is None
