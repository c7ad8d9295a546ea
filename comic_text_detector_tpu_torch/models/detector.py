"""The fused three-head inference net.

Counterpart of the JAX package's ``models/detector.py::TextDetBase``
(reference basemodel.py:222-244): YOLO graph (detections + backbone taps)
-> U-Net head (mask + intermediate features) -> DB head (shrink/thresh
maps).  Inference only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from comic_text_detector_tpu_torch.config import OUT_INDICES, GraphSpec, full_spec
from comic_text_detector_tpu_torch.models.heads import DBHead, UnetHead
from comic_text_detector_tpu_torch.models.yolo import YoloGraph


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
