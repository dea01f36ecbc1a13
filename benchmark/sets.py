"""The runs that a cell's bounds are set from, and their spreads:

    python3 benchmark/sets.py --workload <cell> --seeds 1,2,3,4,5,6 --sets 2 \
        --seconds 30 [--trace-seeds 7,8,9] --out <file.jsonl>

Runs the cell once per seed in each of ``--sets`` sets (the same seeds in
every set), then once traced per ``--trace-seeds``, each a process of its
own (``run.py``), one after another. Appends one JSON line per run to
``--out`` (set, seed, exit code, wall seconds, the result line), and prints
for each end-to-end metric each set's median and spread: the distance
between the first and third quartiles (``statistics.quantiles(n=4)``) over
the median.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def one_run(workload, seed, seconds, trace):
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
                          workload, "--seed", str(seed), "--seconds", str(seconds),
                          "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True)
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    result = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    if result is None:
        sys.stderr.write(out.stderr[-4000:])
    return dict(trace=trace, seed=seed, rc=out.returncode,
                wall_s=round(time.perf_counter() - t0, 1), result=result)


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return q2, (q3 - q1) / q2


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace-seeds", default="")
    p.add_argument("--out", required=True)
    a = p.parse_args()
    seeds = [int(s) for s in a.seeds.split(",")]
    plan = [(k, s, 0) for k in range(a.sets) for s in seeds]
    plan += [(a.sets, int(s), 1) for s in a.trace_seeds.split(",") if s]
    rows = []
    with open(a.out, "a") as f:
        for k, seed, trace in plan:
            row = dict(set=k, **one_run(a.workload, seed, a.seconds, trace))
            rows.append(row)
            f.write(json.dumps(row) + "\n")
            f.flush()
    for k in range(a.sets):
        done = [r["result"] for r in rows if r["set"] == k and r["result"]]
        wrong = sum(not r["correct"] for r in done)
        for name in (done[0]["metrics"] if done else {}):
            vals = [r["metrics"][name]["value"] for r in done]
            if len(vals) >= 2:
                med, sp = spread(vals)
                print("%s set %d %s: median %r spread %.4f over %d runs (%d not correct)"
                      % (a.workload, k, name, med, sp, len(vals), wrong), flush=True)


if __name__ == "__main__":
    main()
