"""The yardstick's arithmetic: the chip's published peaks, the bytes a
pixel of the hand-written kernels, and the FLOPs of the net, counted from
its layers' shapes.

Peaks: one NVIDIA H100 SXM (the data sheet's dense rates): 989 TFLOP/s in
bf16, 67 TFLOP/s in float32 outside the tensor cores (the float32
configuration runs with TF32 off), 3.35 TB/s of HBM.  K2's bytes a pixel for its roofline share.

FLOPs: 2 a multiply-add of every convolution (``2 N Cout Hout Wout Cin/g
kh kw``) and transposed convolution (``2 N Cin Hin Win Cout/g kh kw``),
read from the reference net's shapes on the meta device (no memory, no
arithmetic).  Elementwise work (BatchNorm, activations, sigmoids) is not
counted, as ``torch.utils.flop_counter`` does not count it.  A DB training
step is the forward of the whole train composite plus, for each DB-head
convolution, its weight gradient and, where its input needs one, its
input gradient (each as many FLOPs as its forward).
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List

import torch

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# bytes a pixel of K2 (PERF.md's kernel table): it reads a uint8 mask and
# writes int32 labels
KERNEL_BYTES_PER_PIXEL = {"k2": 5.0}


def _conv_records(model: torch.nn.Module, x: torch.Tensor, train_db: bool = False) -> List[Dict]:
    """Each convolution's forward FLOPs in a forward of ``model`` on ``x``
    (and whether it belongs to the DB head and its input needs a gradient)."""
    from ctd_bench.reference import nn as rnn

    records = []

    def hook(mod, inputs, out):
        inp = inputs[0]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            n, cin, h, w = inp.shape
            f = 2 * n * cin * h * w * (mod.out_channels // mod.groups) * mod.kernel_size[0] * mod.kernel_size[1]
        else:
            n, cout, h, w = out.shape
            f = 2 * n * cout * h * w * (mod.in_channels // mod.groups) * mod.kernel_size[0] * mod.kernel_size[1]
        records.append({"flops": int(f), "name": names[mod], "input_grad": bool(inp.requires_grad)})

    names = {m: n for n, m in model.named_modules()}
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (rnn.Conv2d, rnn.ConvTranspose2d, torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        model(x)
    finally:
        for h in handles:
            h.remove()
    return records


def _cfg_key(config: Dict) -> str:
    return json.dumps({"graph": config["graph"], "act": config["seg_db_act"]}, sort_keys=True)


@functools.lru_cache(maxsize=None)
def _net_flops(cfg_key: str, size: int, batch: int) -> int:
    from ctd_bench.reference.net import build_inference_model

    cfg = json.loads(cfg_key)
    with torch.device("meta"):
        model = build_inference_model(cfg["graph"], act=cfg["act"]).eval()
        x = torch.empty(batch, 3, size, size)
    with torch.no_grad():
        return sum(r["flops"] for r in _conv_records(model, x))


def net_flops(config: Dict, size: int, batch: int = 1) -> int:
    """FLOPs of the three-head net's forward on ``batch`` pages at ``size``."""
    return _net_flops(_cfg_key(config), size, batch)


@functools.lru_cache(maxsize=None)
def _db_train_flops(cfg_key: str, size: int, batch: int) -> int:
    from ctd_bench.reference.net import build_train_model

    cfg = json.loads(cfg_key)
    with torch.device("meta"):
        model = build_train_model(cfg["graph"], act=cfg["act"], with_db=True)
        x = torch.empty(batch, 3, size, size)
    for n, p in model.named_parameters():
        p.requires_grad_(n.startswith("dbnet."))
    model.train()
    total = 0
    for r in _conv_records(model, x, train_db=True):
        total += r["flops"]
        if r["name"].startswith("dbnet."):
            total += r["flops"] * (2 if r["input_grad"] else 1)
    return total


def db_train_flops(config: Dict, size: int, batch: int) -> int:
    """FLOPs of one DB training mini-step (see the module docstring)."""
    return _db_train_flops(_cfg_key(config), size, batch)
