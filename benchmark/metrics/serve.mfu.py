"""Percent of the H100's fp32 peak (67 TFLOP/s) that the traced requests'
counted work fills: the MLPs forward on the substep grid and K1's
operations, over the traced window."""

from benchmark.readers import mfu


def read(ctx):
    w = ctx["work"]
    return mfu(ctx, w["mlp_ops"] + w["k1"]["ops"])
