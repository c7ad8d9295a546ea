"""The comparison fails what it must: the lower-precision control (the
reference in fp8 for a bf16 configuration, in TF32 for a float32 one; for
the steps after the net, those steps on net outputs rounded to fp8 or
bf16), and a run whose timed path is broken underneath (an answer altered
where it is produced, half of a batch left out, a block dropped or a blank
refine after the net, a train step that leaves its state unchanged), each
judged incorrect under the cell's own limits."""

import pytest
import torch

from ctd_bench import compare, harness
from ctd_bench.loops import train_db
from ctd_bench.reference import pipeline as ref
from ctd_bench.tests.conftest import run_small, small_mix


def test_fp8_control_is_incorrect():
    config = harness.load_config("ctd-flagship-bf16")
    mix = small_mix("serve-bf16-1024")
    from ctd_bench import traffic

    pages = traffic.page_pool(mix, 4242)[:3]
    model = ref.inference_model(config, "cpu")
    want = [ref.detect_page(model, p, mix["input_size"], config, "cpu") for p in pages]
    ctl = [ref.detect_page(model, p, mix["input_size"], config, "cpu", "fp8") for p in pages]
    numbers = compare.page_numbers(ctl, want)
    assert not compare.verdict(numbers, compare.load_limits("serve-bf16-1024"))


@pytest.mark.parametrize("workload", ["serve-bf16-1024", "page-f32-1024"])
def test_stage_control_is_incorrect(workload):
    from ctd_bench import traffic

    config = harness.load_config(harness.cell_entry(harness.benchmark(), workload)["config"])
    mix = small_mix(workload)
    pages = traffic.page_pool(mix, 4243)[:3]
    model = ref.inference_model(config, "cpu")
    nets = [ref.net_outputs(model, p, mix["input_size"], "cpu")[0] for p in pages]
    want = [ref.page_stages(p, n, mix["input_size"], config) for p, n in zip(pages, nets)]
    ctl = [ref.page_stages(p, ref.rounded(n, config["stage_control"]), mix["input_size"], config)
           for p, n in zip(pages, nets)]
    numbers = compare.stage_numbers(ctl, want)
    limits = {k: v for k, v in compare.load_limits(workload).items() if k.startswith("stage_")}
    assert limits and not compare.verdict(numbers, limits)


def test_tf32_control_is_incorrect():
    config = harness.load_config("ctd-flagship-f32")
    mix = small_mix("train-db-1024")
    st = train_db.setup(config, mix, 99, torch.device("cpu"), False)
    batches = st["batches"]
    want = train_db.reference_run(config, mix, torch.device("cpu"), batches)
    ctl = train_db.reference_run(config, mix, torch.device("cpu"), batches, "tf32")
    assert not compare.verdict(compare.train_numbers(ctl, want), compare.load_limits("train-db-1024"))


def _zero_masks(module):
    def mask_to_u8(x):
        return torch.zeros(x.shape, dtype=torch.uint8, device=x.device)

    return (module, "mask_to_u8", mask_to_u8)


def _half_batch(module):
    run_net = module.run_net

    def half(model, lb):
        k = max(1, lb.shape[0] // 2)
        outs = run_net(model, lb[:k])
        return tuple(torch.cat([o] + [o[-1:]] * (lb.shape[0] - k)) for o in outs)

    return (module, "run_net", half)


def _drop_last_block(module):
    group_output = module.group_output

    def dropped(*args, **kw):
        return group_output(*args, **kw)[:-1]

    return (module, "group_output", dropped)


def _blank_refine(module):
    name = "refine_pages" if hasattr(module, "refine_pages") else "refine_page"
    refine = getattr(module, name)

    def blank(*args, **kw):
        return torch.zeros_like(refine(*args, **kw))

    return (module, name, blank)


@pytest.mark.parametrize("fault", ["answer", "half", "block", "refine"])
@pytest.mark.parametrize("workload", ["serve-bf16-1024", "page-f32-1024"])
def test_broken_page_path_is_incorrect(monkeypatch, workload, fault):
    """``answer``: the masks zeroed where K6 makes them; ``half``: half of
    the batch (of a single page) left out; ``block``: the grouping drops a
    page's last block; ``refine``: the device refine returns blank
    canvases."""
    from comic_text_detector_tpu_torch.pipeline import batch, detector

    module = batch if workload.startswith("serve") else detector
    if fault in ("block", "refine"):
        monkeypatch.setattr(*(_drop_last_block(module) if fault == "block" else _blank_refine(module)))
    elif fault == "half" and module is detector:
        # a single page has no batch to halve: leave out the lower half of the page instead
        run_net = detector.run_net

        def half_page(model, lb):
            lb = lb.clone()
            lb[:, lb.shape[1] // 2:] = 0
            return run_net(model, lb)

        monkeypatch.setattr(detector, "run_net", half_page)
    else:
        monkeypatch.setattr(*(_zero_masks(module) if fault == "answer" else _half_batch(module)))
    res = run_small(workload, seed=555)
    assert res["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half", "answer"])
def test_broken_train_step_is_incorrect(monkeypatch, fault):
    from comic_text_detector_tpu_torch.training import losses, steps

    if fault == "unchanged":
        monkeypatch.setattr(steps.Optimizer, "step", lambda self: True)
    elif fault == "half":
        db_loss = losses.db_loss

        def half(pred, batch, **kw):
            k = max(1, pred.shape[0] // 2)
            return db_loss(pred[:k], {n: v[:k] for n, v in batch.items()}, **kw)

        monkeypatch.setattr(losses, "db_loss", half)
    else:
        db_loss = losses.db_loss

        def altered(pred, batch, **kw):
            out = db_loss(pred, batch, **kw)
            out["loss"] = out["loss"] * 1.01
            return out

        monkeypatch.setattr(losses, "db_loss", altered)
    res = run_small("train-db-1024", seed=556)
    assert res["correct"] is False
