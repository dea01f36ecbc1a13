"""Faults planted in the program's timed path, to see ``correct`` come out
false (``tests/test_bench_harness.py`` on the CPU) and to read each
compared number under each fault on the card (``calibrate.py --fault``).
The benchmark's own runs never plant one.

- ``unchanged``: a training step returns its state unchanged (``update``
  takes the grad statistics and makes no optimizer step); a served window
  returns the initial state at every frame.
- ``half``: half of the batch left out: the losses' mean taken over the
  first half of the env rows; a served window computes the first half of
  its envs and repeats them for the rest.
- ``altered``: an answer altered where it is produced: 1e-3 added to every
  state an interval (training) or a window (serving) returns.

The exchange between chips has no fault here: every cell runs on one chip.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def planted(fault, generator):
    """A context in which the program carries ``fault`` (``generator``:
    "train" or "serve")."""
    from ppr_diffphys_torch.models import phys_model as pm
    from ppr_diffphys_torch.sim import soa, soa_grad

    if generator == "train":
        if fault == "unchanged":
            return _patched(pm.phys_model, "update", lambda self: self.check_grad())
        if fault == "half":
            reduce = pm.reduce_loss
            return _patched(pm, "reduce_loss",
                            lambda rows, **kw: reduce(rows[: rows.shape[0] // 2], **kw))
        if fault == "altered":
            call = soa_grad.DiffInterval.__call__

            def altered(self, *a):
                q, qd = call(self, *a)
                return q + 1e-3, qd

            return _patched(soa_grad.DiffInterval, "__call__", altered)
    if generator == "serve":
        call = soa.SoaWindow.__call__

        def broken(self, state, targets, acts, params):
            q, qd, grf, jaf = call(self, state, targets, acts, params)
            if fault == "unchanged":
                q = state.body_q[None].expand_as(q).clone()
            elif fault == "half":
                h = q.shape[1] // 2
                q = torch.cat([q[:, :h], q[:, :q.shape[1] - h]], 1)
            else:
                q = q + 1e-3
            return q, qd, grf, jaf

        return _patched(soa.SoaWindow, "__call__", broken)
    raise ValueError("no fault %r for the %s generator" % (fault, generator))
