"""On the card: for every cell, at the cell's own size, the control (the
plain reference computed with TF32 matrix products, the precision below the
configurations' fp32, put in the program's place) comes out not correct on
three seeds, while the program passes on the same seeds. Each seed takes
about a minute and a half (set-up, the reference and the control).

    python -m pytest benchmark/tests/test_bench_control.py -m cuda
"""

import pytest
import torch

from benchmark import calibrate, harness

SEEDS = (4000000007, 4000000009, 4000000011)
CELLS = [w["name"] for w in harness.load_json(harness.ROOT + "/BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.process_env()
    for seed in SEEDS:
        r = calibrate.readings(cell, seed, seconds=3.0)
        lim = r["limits"]
        assert any(r["control"][n] > lim[n] for n in lim), r
        assert all(r["program"][n] <= lim[n] for n in lim), r
