"""What the per-layer metric readers (``metrics/<name>.py``) share. Each
returns None where its run has nothing to read: no span, no trace, no
launch of the kernel it names."""

from __future__ import annotations

import numpy as np

from .work import counts


def mean_span_ms(ctx, name):
    """The mean milliseconds of the benchmark's CUDA-event span ``name``."""
    ms = ctx["spans"].get(name)
    return float(np.mean(ms)) if ms else None


def kernel_function(name):
    """A kernel's function name as the profiler names it, without its
    namespace, return type and arguments."""
    n = name.replace("(anonymous namespace)::", "")
    return (n[5:] if n.startswith("void ") else n).split("(")[0]


def kernel_roofline(ctx, prefixes, work_key):
    """Percent of the roofline: the frozen bound of each launch of the first
    kernel name (``work[work_key]``'s bytes and operations) times its
    launches, over the profiler's device time of every kernel whose
    function name begins with one of ``prefixes`` (the trace names them
    ``(anonymous namespace)::soa_interval_fwd_kernel(...)``)."""
    prof = ctx["profile"]
    if prof is None:
        return None
    ks = {kernel_function(n): k for n, k in prof["kernels"].items()}
    launches = sum(k["launches"] for n, k in ks.items() if n.startswith(prefixes[0]))
    dev_ms = sum(k["ms"] for n, k in ks.items() if n.startswith(tuple(prefixes)))
    if launches == 0 or dev_ms <= 0:
        return None
    w = ctx["work"][work_key]
    return 100.0 * counts.bound_s(w["bytes"], w["ops"]) * 1e3 * launches / dev_ms


def idle(ctx):
    """Percent of the traced window in which no operation ran on the device."""
    prof = ctx["profile"]
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu(ctx, per_unit_ops):
    """Percent of the fp32 peak: the counted operations of the traced units
    (steps or requests, ``work["steps"]``) over the traced window."""
    prof = ctx["profile"]
    n = ctx["work"].get("steps", 0)
    if prof is None or n <= 0 or prof["window_s"] <= 0:
        return None
    return 100.0 * per_unit_ops * n / (prof["window_s"] * counts.FP32_OPS_PER_S)


def train_step_ops(work):
    """A training step's counted operations: the MLPs forward and backward
    and each interval's K2 and K3."""
    return work["mlp_ops"] + work["intervals"] * (work["k2"]["ops"] + work["k3"]["ops"])
