"""K3 with live joint anchors (``soa_interval_bwd`` with its env reduction ``soa_interval_reduce``)
share of its roofline: the frozen ``interval_work`` bound per launch at the
cell's shapes over their device time per launch."""

from benchmark.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, ["soa_interval_bwd", "soa_interval_reduce"], "k3")
