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
    lines (B, 2, H, W)).

    The YOLO graph runs with SiLU (its checkpoint's activation); the seg/DB
    heads run with ``act`` ('leaky' for the deployed checkpoint, reference
    inference.py:24,120).
    """

    def __init__(self, spec: GraphSpec, act: str = "leaky"):
        super().__init__()
        self.blk_det = YoloGraph(spec, OUT_INDICES, act="silu")
        self.text_seg = UnetHead(act=act)
        self.text_det = DBHead(64, act=act)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        blks, taps = self.blk_det(x)
        mask, feats = self.text_seg(*taps)
        lines = self.text_det(*feats)
        return blks, mask, lines


def build_inference_model(cfg: Optional[dict] = None, act: str = "leaky") -> TextDetBase:
    return TextDetBase(full_spec(cfg), act=act).eval()
