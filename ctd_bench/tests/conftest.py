"""Shared pieces of the benchmark's CPU tests: smaller mixes of the cells'
traffic, found by the same names in ``tests/data/traffic``, so that a
whole run (set-up, window, check) fits a test."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
SMALL_TRAFFIC = os.path.join(ROOT, "ctd_bench", "tests", "data", "traffic")


def small_mix(workload: str) -> dict:
    from ctd_bench import harness, traffic

    return traffic.load_mix(harness.cell_entry(harness.benchmark(), workload)["traffic"], SMALL_TRAFFIC)


def run_small(workload: str, seed: int = 20240001, seconds: float = 1.5, trace: bool = False):
    """A whole run of ``workload`` on the CPU with its small mix."""
    import time

    from ctd_bench import harness

    return harness.run(workload, seed, seconds, trace, time.perf_counter(),
                       harness.Bench(traffic=SMALL_TRAFFIC, device="cpu"))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
