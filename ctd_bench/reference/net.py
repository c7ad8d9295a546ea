"""The reference's three-head net (``TextDetBase``) and the DB training
composite (``TextDetTrain``), frozen copy of the port's
``models/detector.py`` in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ctd_bench.reference.config import OUT_INDICES, GraphSpec, backbone_spec, full_spec
from ctd_bench.reference.constants import TEXTDET_DET, TEXTDET_MASK
from ctd_bench.reference.heads import DBHead, UnetHead
from ctd_bench.reference.yolo import YoloGraph


class TextDetBase(nn.Module):
    """(B, 3, H, W) BGR image in [0, 1] -> (blks (B, N, 7), mask (B, 1, H, W),
    lines (B, 2, H, W)), all three float32.

    The YOLO graph runs with SiLU (its checkpoint's activation); the seg/DB
    heads run with ``act`` ('leaky' for the deployed checkpoint, reference
    inference.py:24,120).  ``dtype`` is the compute dtype (float32 or
    bfloat16): the input is cast to it, each layer computes in it from its
    float32 parameters, and the heads' sigmoids read float32 casts of their
    logits, as in the JAX package's ``dtype`` plumbing.
    """

    def __init__(self, spec: GraphSpec, act: str = "leaky", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.blk_det = YoloGraph(spec, OUT_INDICES, act="silu")
        self.text_seg = UnetHead(act=act)
        self.text_det = DBHead(64, act=act)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        blks, taps = self.blk_det(x.to(self.dtype))
        mask, feats = self.text_seg(*taps)
        lines = self.text_det(*feats)
        return blks, mask, lines


def build_inference_model(cfg: Optional[dict] = None, act: str = "leaky",
                          dtype: torch.dtype = torch.float32) -> TextDetBase:
    return TextDetBase(full_spec(cfg), act=act, dtype=dtype).eval()


class TextDetTrain(nn.Module):
    """Train-time composite: truncated backbone + UnetHead (+ DBHead).

    ``with_db=False`` holds the backbone and the whole U-Net and runs
    TEXTDET_MASK (U-Net training: returns the (B, 1, H, W) mask);
    ``with_db=True`` holds the backbone, the U-Net trunk and the DB head and
    runs TEXTDET_DET (DB training: returns the DB head's maps, 3 channels in
    train mode).  These are the variables the JAX package's MASK- and
    DET-mode initializations create (its ``with_db`` is never read).

    The backbone runs in eval mode always and, with ``freeze_backbone``,
    without gradients (reference basemodel.py:200-209; the JAX package's
    ``train=False`` and ``stop_gradient``).  In DET mode the U-Net trunk
    runs the same way (basemodel.py:207-209).  ``train()`` keeps those
    parts in eval mode, so their BatchNorm running stats never move.
    """

    def __init__(self, spec: GraphSpec, act: str = "leaky", with_db: bool = False,
                 freeze_backbone: bool = True):
        super().__init__()
        self.with_db = with_db
        self.freeze_backbone = freeze_backbone
        self.backbone = YoloGraph(spec, OUT_INDICES, act="silu")
        self.seg_net = UnetHead(act=act, trunk_only=with_db)
        if with_db:
            self.dbnet = DBHead(64, act=act)

    @property
    def forward_mode(self) -> int:
        return TEXTDET_DET if self.with_db else TEXTDET_MASK

    def train(self, mode: bool = True) -> "TextDetTrain":
        super().train(mode)
        self.backbone.eval()
        if self.with_db:
            self.seg_net.eval()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_backbone):
            _, taps = self.backbone(x)
        if not self.with_db:
            return self.seg_net(*taps, forward_mode=TEXTDET_MASK)
        with torch.no_grad():
            feats = self.seg_net(*taps, forward_mode=TEXTDET_DET)
        return self.dbnet(*feats)


def build_train_model(cfg: Optional[dict] = None, act: str = "leaky", with_db: bool = False,
                      freeze_backbone: bool = True) -> TextDetTrain:
    return TextDetTrain(backbone_spec(cfg), act=act, with_db=with_db, freeze_backbone=freeze_backbone)


