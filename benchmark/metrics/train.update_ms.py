"""Device milliseconds of one update() (grad statistics, median queue,
AdamW), by the benchmark's CUDA events around the call, mean over the
window's steps."""

from benchmark.readers import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "update")
