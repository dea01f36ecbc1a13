"""Spans and the device trace of a traced run (``--trace 1``).

- ``span(name)``: CUDA events around one call of the program, recorded by
  the benchmark's own code; ``span_ms()`` gives each name's milliseconds
  per call, read once after the window.
- ``profile()``: ``torch.profiler`` (CPU and CUDA activities) over a fixed
  part of the window that the generator chooses. ``summary`` then holds the
  traced window's length, the union of the device's activity intervals
  (``busy_s``), the device time and launch count of every kernel by name,
  and the ``breakdown``: the device operations that took most time and the
  idle gaps summed by what the host was doing when each began (the
  benchmark's own ``bench.*`` range and the last host operation begun).

With tracing off, or on the CPU, every span and profile is a no-op.
"""

from __future__ import annotations

import bisect
import contextlib
import time

TOP = 10


class Tracer:
    def __init__(self, enabled, device):
        self.enabled = bool(enabled) and device != "cpu"
        self._events = {}
        self.summary = None

    @contextlib.contextmanager
    def span(self, name):
        if not self.enabled:
            yield
            return
        import torch

        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        with torch.profiler.record_function("bench." + name):
            yield
        b.record()
        self._events.setdefault(name, []).append((a, b))

    def span_ms(self) -> dict:
        """{name: [ms of each call]} (synchronizes once)."""
        if not self._events:
            return {}
        import torch

        torch.cuda.synchronize()
        return {n: [a.elapsed_time(b) for a, b in ev] for n, ev in self._events.items()}

    @contextlib.contextmanager
    def profile(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        self.summary = reduce_profile(prof, window_s)


def _is_device(e):
    import torch

    if getattr(e, "is_user_annotation", False):
        return False
    return e.device_type == torch.autograd.DeviceType.CUDA


def union_seconds(intervals) -> tuple:
    """(total length, merged intervals) of (start, end) pairs, in their unit."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def gap_labels(gaps, host_events):
    """Sum idle gaps by what the host was doing when each began: the
    ``bench.*`` range open then and the host operation begun last before
    it. ``gaps`` are (start, length) and ``host_events`` (start, end, name),
    one clock."""
    ranges = sorted((s, e, n) for s, e, n in host_events if n.startswith("bench."))
    ops = sorted((s, n) for s, e, n in host_events if not n.startswith("bench."))
    op_starts = [s for s, _ in ops]
    out = {}
    for g0, length in gaps:
        rng = "host"
        for s, e, n in ranges:
            if s <= g0 < e:
                rng = n
        i = bisect.bisect_right(op_starts, g0) - 1
        op = ops[i][1] if i >= 0 else "none"
        key = "%s/%s" % (rng, op)
        out[key] = out.get(key, 0.0) + length
    return out


def reduce_profile(prof, window_s) -> dict:
    events = list(prof.events())
    dev = [e for e in events if _is_device(e)]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events if not _is_device(e)]
    by_name = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    busy_us, merged = union_seconds((e.time_range.start, e.time_range.end) for e in dev)
    gaps = [(a[1], b[0] - a[1]) for a, b in zip(merged, merged[1:])]
    labels = gap_labels(gaps, host)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    top_gaps = sorted(labels.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        window_s=window_s,
        busy_s=busy_us / 1e6,
        kernels={n: {"ms": ms, "launches": c} for n, (ms, c) in by_name.items()},
        breakdown={"device_ops": [[n[:160], ms / 1e3] for n, (ms, _) in top_ops],
                   "idle_gaps": [[n[:160], us / 1e6] for n, us in top_gaps]},
    )
