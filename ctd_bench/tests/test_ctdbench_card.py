"""On the card: a short run of each cell through ``run.py`` gives a result
line that is correct and names the card.  Skips where there is no card
(decided in the ``cuda_device`` fixture)."""

import json
import subprocess
import sys

import pytest

from ctd_bench import harness
from ctd_bench.tests.conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in harness.benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(cuda_device, workload):
    proc = subprocess.run([sys.executable, "ctd_bench/run.py", "--workload", workload, "--seed", "2147483999",
                           "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
