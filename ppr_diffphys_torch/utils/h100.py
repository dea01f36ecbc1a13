"""The NVIDIA H100's published peaks and the device readings that the
port's bench (``ppr_diffphys_torch/bench.py``) and ``chip_smoke.py`` share,
so that their bounds are computed against the same card.

The peaks are NVIDIA's data sheet figures for the SXM part at its full
700 W power limit; a card set below it runs slower, so every reading is
reported beside the card's name and power limit (:func:`nvidia_smi_line`).
"""

from __future__ import annotations

import subprocess
import time

BYTES_PER_S = 3.35e12  # HBM3
FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores


def roofline(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take for work that moves ``n_bytes``
    and does ``n_ops`` fp32 operations: ``ms`` (the larger of the two
    times), ``by`` ("bytes" or "operations"), ``bytes_ms`` and ``ops_ms``."""
    b = n_bytes / BYTES_PER_S * 1e3
    o = n_ops / FP32_OPS_PER_S * 1e3
    return dict(ms=max(b, o), by="operations" if o >= b else "bytes", bytes_ms=b, ops_ms=o)


def nvidia_smi_line() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them. Raises if nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def kernel_times(fn, n: int):
    """Run ``fn()`` n times under torch.profiler. Returns (host wall ms per
    call, [(device ms per call, launches per call, kernel name)] sorted by
    time, largest first). Only device-side events count: host ops also
    carry the device time of the kernels they launched, and a region
    annotated on the device timeline spans kernels counted already. The
    list is empty when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / n / 1e3, e.count / n, e.key))
    rows.sort(reverse=True)
    return wall_ms, rows
