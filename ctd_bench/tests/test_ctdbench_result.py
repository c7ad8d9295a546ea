"""The result line: its keys, and no result without a card."""

import json
import subprocess
import sys

import pytest

from ctd_bench.tests.conftest import ROOT, run_small


def test_no_card_no_result():
    """Without CUDA the run exits non-zero and prints nothing on stdout."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run([sys.executable, "ctd_bench/run.py", "--workload", "serve-bf16-1024", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_keys(trace):
    res = run_small("page-f32-1024", trace=trace)
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "page_ms_p50.page" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"page_ms_p95", "setup_s"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(res)
