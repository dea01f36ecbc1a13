"""K2 (``soa_interval_fwd``) share of its roofline: the frozen
``interval_work`` bound per launch at the cell's shapes over the profiler's
device time per launch."""

from benchmark.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, ["soa_interval_fwd"], "k2")
