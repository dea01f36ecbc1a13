"""Device milliseconds of one request's window (``sim/soa.py:SoaWindow``
and K1), by the benchmark's CUDA events around the call, mean over the
window's requests."""

from benchmark.readers import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "window")
