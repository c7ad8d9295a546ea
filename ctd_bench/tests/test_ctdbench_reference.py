"""The plain reference against the port at a small size on the CPU: in
float32 both give the same pages and the same DB training step."""

import numpy as np
import pytest
import torch

from ctd_bench import compare, harness, traffic
from ctd_bench.loops import common, train_db
from ctd_bench.tests.conftest import small_mix


@pytest.mark.parametrize("workload", ["serve-bf16-1024", "page-f32-1024"])
def test_pages_agree_in_float32(workload):
    """The cell's loop with its net in float32 (the stream's too) against
    the reference: the same net outputs to rounding, the same blocks, line
    quads and raw masks, and the steps after the net equal to the
    reference's on the program's own net outputs."""
    config = dict(harness.load_config("ctd-flagship-f32"))
    mix = small_mix(workload)
    loop = harness.load_loop(mix["loop"])
    st = loop.setup(config, mix, 4321, torch.device("cpu"), False)
    loop.window(st, 1.0, False)
    outs = loop.outputs(st)
    loop.release(st)
    got = common.check_pages(config, mix, "cpu", outs)
    assert got["mask_gap"] < 1e-5 and got["shrink_gap"] < 1e-5 and got["det_gap"] < 1e-5
    assert got["box_gap"] == 0 and got["quad_gap"] == 0 and got["raw_gap"] == 0
    assert got["refined_gap"] < 0.05  # the device refine resamples windows past its buckets
    assert got["stage_box_gap"] == 0 and got["stage_quad_gap"] == 0 and got["stage_raw_gap"] == 0
    assert got["stage_refined_gap"] < 0.05
    assert sum(len(r["blocks"]) for r in outs["results"]) > 0  # the pages hold text the path finds


def test_db_step_agrees():
    config = harness.load_config("ctd-flagship-f32")
    mix = small_mix("train-db-1024")
    st = train_db.setup(config, mix, 77, torch.device("cpu"), False)
    got, batches = st["got"], st["batches"]
    ref = train_db.reference_run(config, mix, torch.device("cpu"), batches)
    numbers = compare.train_numbers(got, ref)
    assert numbers["loss_gap"] < 1e-6 and numbers["grad_gap"] < 1e-5 and numbers["change_gap"] < 1e-4
    assert len(got["losses"]) == mix["checked_updates"] * mix["hyp_train"]["accumulation_steps"]


def test_pool_repeats_from_seed():
    mix = small_mix("serve-bf16-1024")
    a, b = traffic.page_pool(mix, 2**31 + 7), traffic.page_pool(mix, 2**31 + 7)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert traffic.sample_indices(mix, 5, len(a)) == traffic.sample_indices(mix, 5, len(a))
