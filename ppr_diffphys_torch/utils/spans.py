"""Spans and counters of the program's layers, on the profiler's clock.

- ``span(name)``: a context manager around one layer's work. It records the
  span (name, parent span, root id, host start and end by
  ``time.perf_counter_ns``) and opens ``torch.profiler.record_function(name)``
  over it, so that the trace shows the span as a range over the kernels it
  launched. The root id is the sequence number of the outermost open span
  (one training step's ``phys_model.forward``, one request's ``prologue``):
  every span of that step or request shares it.
- ``count(name, value)``: adds a Python number, or a 0-d device tensor on
  the device (read once, in ``summary()``: a counter never makes the host
  wait while the program runs).
- ``rows(name)``: a context manager; while it is open on the calling
  thread, ``count_rows(n)`` (each time-MLP evaluation, ``models/mlp.py``,
  with its row count) adds ``n`` to the counter ``name``. A recompute in
  the backward pass (activation checkpointing) runs after it closed and
  counts nothing.
- ``summary()``: per span name ``calls``, ``host_ms`` (total), ``self_ms``
  (total less what its child spans cover), ``parent`` and ``roots`` (the
  distinct root ids it was seen under); every counter; the raw spans kept
  and dropped. ``reset()`` clears them.

The recorder records only while the torch profiler records on the
calling thread (one flag read per span): ``--trace 1`` in the benchmark,
``--profile_dir`` in the training CLI. Otherwise ``span`` returns one shared
no-op context and ``count`` does nothing. The autograd engine runs a CUDA
backward on a device thread of its own, which sees the caller's profiler:
a span opened on a thread with no open span, while exactly one other thread
has spans open, nests under that thread's innermost span (``backward.interval``
under ``forward.backward``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

MAX_RAW = 100_000  # raw spans kept; the aggregates are always kept
_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "name", "parent", "root", "tid", "t0", "child_ns", "rf")

    def __init__(self, rec, name):
        self.rec = rec
        self.name = name
        self.child_ns = 0

    def __enter__(self):
        self.rec._open(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        self.rec._close(self, t1)
        return False


class Recorder:
    """Spans and counters of one process. ``recording`` (default: whether
    the torch profiler records on the calling thread) is read once per span
    and per count."""

    def __init__(self, recording=None, max_raw=MAX_RAW):
        self.recording = recording or torch._C._autograd._profiler_enabled
        self.max_raw = int(max_raw)
        self._lock = threading.Lock()
        self._rows = threading.local()  # .name: the open rows counter
        self._stacks = {}  # thread id -> its open spans, innermost last
        self._next_root = 0
        self.reset()

    def reset(self):
        with self._lock:
            self._agg = {}  # name -> [calls, host_ns, child_ns, {parent: calls}, {root ids}]
            self._counts = {}
            self._dev = {}
            self._raw = []
            self._dropped = 0

    def span(self, name):
        if not self.recording():
            return _NOOP
        return _Span(self, name)

    def count(self, name, value):
        if not self.recording():
            return
        with self._lock:
            if isinstance(value, torch.Tensor):
                v = value.detach().reshape(())
                prev = self._dev.get(name)
                self._dev[name] = v if prev is None else prev + v
            else:
                self._counts[name] = self._counts.get(name, 0) + value

    def rows(self, name):
        if not self.recording():
            return _NOOP
        return self._rows_open(name)

    @contextlib.contextmanager
    def _rows_open(self, name):
        outer = getattr(self._rows, "name", None)
        self._rows.name = name
        try:
            yield
        finally:
            self._rows.name = outer

    def count_rows(self, n):
        name = getattr(self._rows, "name", None)
        if name is not None:
            self.count(name, n)

    def _enclosing(self, tid):
        """The open spans that a span opened on thread ``tid`` nests in: the
        thread's own, else those of the one other thread with spans open."""
        own = self._stacks.get(tid)
        if own:
            return own
        others = [st for t, st in self._stacks.items() if t != tid and st]
        return others[0] if len(others) == 1 else []

    def _open(self, s):
        tid = threading.get_ident()
        with self._lock:
            enclosing = self._enclosing(tid)
            if enclosing:
                up = enclosing[-1]
                s.parent, s.root = up, up.root
            else:
                s.parent, s.root = None, self._next_root
                self._next_root += 1
            s.tid = tid
            self._stacks.setdefault(tid, []).append(s)

    def _close(self, s, t1):
        dur = t1 - s.t0
        with self._lock:
            stack = self._stacks[s.tid]
            stack.remove(s)
            if not stack:
                del self._stacks[s.tid]
            if s.parent is not None:
                s.parent.child_ns += dur
            parent = None if s.parent is None else s.parent.name
            a = self._agg.get(s.name)
            if a is None:
                a = self._agg[s.name] = [0, 0, 0, {}, set()]
            a[0] += 1
            a[1] += dur
            a[2] += s.child_ns
            a[3][parent] = a[3].get(parent, 0) + 1
            a[4].add(s.root)
            if len(self._raw) < self.max_raw:
                self._raw.append((s.name, parent, s.root, s.t0, t1))
            else:
                self._dropped += 1

    def summary(self) -> dict:
        """{"spans": {name: {calls, host_ms, self_ms, parent, roots}},
        "counters": {name: value}, "raw": kept, "dropped": dropped}; the
        device counters are read in one transfer (the one sync). ``parent``
        is the parent most of the name's calls had (None: a root)."""
        with self._lock:
            agg = {n: (a[0], a[1], a[2], dict(a[3]), len(a[4])) for n, a in self._agg.items()}
            counts = dict(self._counts)
            dev = dict(self._dev)
            raw, dropped = len(self._raw), self._dropped
        if dev:
            first = next(iter(dev.values()))
            vals = torch.stack([t.to(first.device, torch.float64) for t in dev.values()])
            counts.update(zip(dev, vals.tolist()))
        spans = {n: dict(calls=c, host_ms=h / 1e6, self_ms=(h - ch) / 1e6,
                         parent=max(p, key=p.get), roots=r)
                 for n, (c, h, ch, p, r) in agg.items()}
        return dict(spans=spans, counters=counts, raw=raw, dropped=dropped)

    def raw(self) -> list:
        """The kept spans: (name, parent name, root id, start ns, end ns)."""
        with self._lock:
            return list(self._raw)

    def stack(self) -> list:
        """The names of the open spans that a span opened on the calling
        thread would nest in, outermost first."""
        with self._lock:
            return [s.name for s in self._enclosing(threading.get_ident())]


def per_root_ms(summ, name, root, steps=None):
    """``name``'s host milliseconds per root of the span ``root`` (per step
    or request), from a ``summary()``; None where either was not recorded
    or, given ``steps``, where ``root`` was recorded under another number of
    roots."""
    sp = summ["spans"]
    if name not in sp or root not in sp:
        return None
    n = sp[root]["roots"]
    if n <= 0 or (steps is not None and n != steps):
        return None
    return sp[name]["host_ms"] / n


_recorder = Recorder()
recording = _recorder.recording
span = _recorder.span
count = _recorder.count
rows = _recorder.rows
count_rows = _recorder.count_rows
summary = _recorder.summary
reset = _recorder.reset
raw = _recorder.raw
stack = _recorder.stack
