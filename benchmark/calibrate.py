"""The readings that the limits of ``correct`` are set from, for one cell:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 3]
        [--fault half|altered|unchanged | --program-only | --witness]

For each seed, in one process: the program's set-up (and, for a served
cell, a short window of ``--seconds`` that keeps more rows of each
request), then, with the program freed, the fp32 reference and the control,
the reference in TF32 put in the program's place. Prints one JSON line per
seed with each compared number of the program (the lower readings) and of
the control (the upper readings), beside the cell's current limits. Not run
by the benchmark's own runs.
"""

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import Cell, Run, process_env  # noqa: E402

# a served cell keeps this many rows of each request here, so that a short
# window gives as many compared rows as a whole run
CALIBRATION_SCALE = {"serve": {"keep_per_request": 512}}


def readings(name, seed, seconds, device="cuda", scale=None, witness=False, fault=None,
             program_only=False):
    """The program's and the control's numbers on one seed; with ``fault``
    (``faults.py``), the program's numbers with that fault planted; with
    ``program_only``, the program's numbers alone."""
    import contextlib

    import torch

    from benchmark import faults

    cell = Cell(name)
    kind = cell.traffic["generator"]
    scale = dict(CALIBRATION_SCALE.get(kind, {}), **(scale or {}))
    run = Run(cell, seed, seconds, 0, device, scale)
    gen = cell.generator
    with faults.planted(fault, kind) if fault else contextlib.nullcontext():
        state = gen.setup(run)
        if kind == "serve":
            gen.window(run, state)
        record = gen.release(run, state)
    del state
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    if fault:
        out = {"fault": {fault: gen.gaps(run, record)}}
    elif program_only:
        out = {"program": gen.gaps(run, record)}
    else:
        out = gen.readings(run, record, witness)
    return dict(seed=seed, limits=cell.limits, **out)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--witness", action="store_true",
                   help="also run the reference twice and compare it with itself")
    p.add_argument("--fault", default=None,
                   help="plant a fault of faults.py in the program (no control then)")
    p.add_argument("--program-only", action="store_true",
                   help="the program's readings alone (no control)")
    a = p.parse_args()
    process_env()
    for s in a.seeds.split(","):
        print(json.dumps(readings(a.workload, int(s), a.seconds, witness=a.witness,
                                  fault=a.fault, program_only=a.program_only)), flush=True)


if __name__ == "__main__":
    main()
