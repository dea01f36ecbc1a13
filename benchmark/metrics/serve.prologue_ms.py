"""Device milliseconds of one request's prologue (``RolloutServer.prologue``:
the MLPs on the substep grid, FK, the gather), by the benchmark's CUDA
events around the call, mean over the window's requests."""

from benchmark.readers import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "prologue")
