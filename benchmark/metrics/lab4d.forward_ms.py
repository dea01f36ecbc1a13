"""Device milliseconds of one forward() with its gradient, by the
benchmark's CUDA events around the call, mean over the window's steps."""

from benchmark.readers import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "forward")
