"""Percent of the H100's fp32 peak (67 TFLOP/s) that the traced steps'
counted work fills: the MLPs forward and backward at their rows and each
interval's K2 and K3 operations, over the traced window."""

from benchmark.readers import mfu, train_step_ops


def read(ctx):
    return mfu(ctx, train_step_ops(ctx["work"]))
