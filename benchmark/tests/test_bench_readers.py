"""The per-layer readers' arithmetic on a made-up traced run, and their
silence where there is nothing to read."""

import pytest

from benchmark import readers
from benchmark.work import counts


def ctx(profile, spans=None, steps=2):
    work = {"k2": {"bytes": 3.35e9, "ops": 0.0}, "mlp_ops": 6.7e12, "intervals": 0,
            "k3": {"bytes": 0.0, "ops": 0.0}, "steps": steps}
    return {"profile": profile, "spans": spans or {}, "work": work}


PROFILE = {"window_s": 2.0, "busy_s": 0.5, "kernels": {
    "(anonymous namespace)::soa_interval_fwd_kernel((anonymous namespace)::Args, int)":
        {"ms": 4.0, "launches": 2},
    "void cutlass::Kernel2<x>(x::Params)": {"ms": 100.0, "launches": 7}}}


def test_roofline_matches_the_kernel_by_its_function_name():
    # bound 1 ms a launch (3.35 GB at 3.35 TB/s), 2 launches in 4 ms of device time
    assert readers.kernel_roofline(ctx(PROFILE), ["soa_interval_fwd"], "k2") == pytest.approx(50.0)
    assert readers.kernel_roofline(ctx(PROFILE), ["soa_window"], "k2") is None


def test_idle_and_mfu():
    assert readers.idle(ctx(PROFILE)) == pytest.approx(75.0)
    # 6.7e12 operations a step, 2 steps in 2 s: 10 % of 67 TFLOP/s
    assert readers.mfu(ctx(PROFILE), 6.7e12) == pytest.approx(100.0 * 6.7e12 * 2 / (2.0 * counts.FP32_OPS_PER_S))


def test_nothing_to_read_gives_none():
    c = ctx(None)
    assert readers.idle(c) is None and readers.mfu(c, 1.0) is None
    assert readers.kernel_roofline(c, ["soa_window"], "k2") is None
    assert readers.mean_span_ms(c, "forward") is None
    assert readers.mean_span_ms(ctx(None, {"forward": [1.0, 3.0]}), "forward") == 2.0
