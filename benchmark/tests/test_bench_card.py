"""A short run of each cell on the card: the whole harness, as
`python3 -m benchmark.run` runs it, with a result line whose `correct`
is true. Skips on a host without a CUDA card."""

import json
import subprocess
import sys

import pytest

from benchmark import spec

CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, traced, cuda_card):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                        "--seed", str(2**31 + 41), "--seconds", "6", "--trace", str(traced)],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["kind"] == cuda_card and line["device"]["platform"] == "gpu"
    if traced:
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
