"""Synchronizing and blocking CUDA calls on one benchmark cell's hot path,
listed by the program span they fall in:

    python scripts/sync_inventory.py --workload a1-imitation.train-e512 --seed 7 [--units 1]

Builds the cell as the benchmark does (``benchmark/harness.py``: its set-up,
warm-up included), then runs ``--units`` of its units (training steps as
the benchmark's window runs them; serving requests as
``RolloutServer.rollout``) with ``torch.cuda.set_sync_debug_mode("warn")``
and the torch profiler recording (CPU activity only), so that the program's
spans (``ppr_diffphys_torch/utils/spans.py``) are open. Each warning is
counted under the spans open on its thread and the source line that made
the call. Prints one JSON line: the rows (span path, line, message, count)
and the units' span summary. Needs a CUDA device.
"""

import argparse
import collections
import json
import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def unit_fn(run, state):
    """One unit of the cell's hot path: fn(i)."""
    gen = run.cell.generator
    if run.cell.traffic["generator"] == "train":
        it0 = len(state["first"])
        return lambda i: gen.one_step(run, state["model"], it0 + i, state["draw"]())
    return lambda i: state["server"].rollout(state["draw"]()[0])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--units", type=int, default=1)
    a = p.parse_args(argv)

    harness.process_env()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ppr_diffphys_torch.utils import spans

    if not torch.cuda.is_available():
        raise SystemExit("sync_inventory: needs a CUDA device")
    cell = harness.Cell(a.workload)
    run = harness.Run(cell, a.seed, 0.0, False, "cuda")
    state = cell.generator.setup(run)
    unit = unit_fn(run, state)
    torch.cuda.synchronize()

    rows = collections.Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        where = "/".join(spans.stack()) or "(no span)"
        src = os.path.relpath(filename, ROOT) if filename.startswith(ROOT) else filename
        rows[(where, "%s:%d" % (src, lineno), str(message).split("\n")[0][:160])] += 1

    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]), warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(a.units):
                unit(i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    out = dict(workload=a.workload, units=a.units, device=torch.cuda.get_device_name(0),
               rows=[dict(span=w, line=src, message=m, count=n)
                     for (w, src, m), n in sorted(rows.items())],
               spans=spans.summary())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
