"""K1 (``soa_window``) share of its roofline: the frozen ``window_work``
bound per launch at the cell's shapes over the profiler's device time per
launch."""

from benchmark.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, ["soa_window"], "k1")
