"""The FLOP counter (``flops.py``, from the layers' shapes on the meta
device) against ``torch.utils.flop_counter.FlopCounterMode`` running the
reference at a small size."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from ctd_bench import flops, harness
from ctd_bench.reference.net import build_inference_model, build_train_model


def test_net_flops_match_counter_mode():
    config = harness.load_config("ctd-flagship-bf16")
    model = build_inference_model(config["graph"], act=config["seg_db_act"]).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.rand(2, 3, 128, 128))
    assert flops.net_flops(config, 128, batch=2) == counter.get_total_flops()


def test_db_train_flops_match_counter_mode():
    config = harness.load_config("ctd-flagship-f32")
    model = build_train_model(config["graph"], act=config["seg_db_act"], with_db=True)
    for n, p in model.named_parameters():
        p.requires_grad_(n.startswith("dbnet."))
    model.train()
    with FlopCounterMode(display=False) as counter:
        model(torch.rand(2, 3, 64, 64)).sum().backward()
    assert flops.db_train_flops(config, 64, 2) == counter.get_total_flops()
