"""The reader of ``serve.replay_share`` on made-up span summaries, and its
silence where there is nothing to read."""

import os

import pytest

from benchmark.harness import load_file_module

READER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "metrics", "serve.replay_share.py")


def _summary(roots, counters):
    span = dict(calls=roots, host_ms=1.0, self_ms=1.0, parent=None, roots=roots)
    return dict(spans={"prologue": span} if roots is not None else {}, counters=counters,
                raw=0, dropped=0)


@pytest.mark.parametrize("roots,counters,want", [
    (20, {"prologue.replays": 20}, 100.0),
    (20, {"prologue.replays": 15, "prologue.eager": 5}, 75.0),
    (20, {"prologue.eager": 20}, None),  # a program that replays nothing
    (None, {"prologue.replays": 3}, None),  # no request traced
    (0, {"prologue.replays": 0}, None),
], ids=["all", "some", "eager", "no_root", "no_requests"])
def test_replay_share_reads_replays_over_requests(monkeypatch, roots, counters, want):
    from ppr_diffphys_torch.utils import spans

    read = load_file_module(READER, "bench_test_replay_share").read
    monkeypatch.setattr(spans, "summary", lambda: _summary(roots, counters))
    got = read({"profile": None, "spans": {}, "work": {"steps": 20}})
    assert got == (pytest.approx(want) if want is not None else None)
