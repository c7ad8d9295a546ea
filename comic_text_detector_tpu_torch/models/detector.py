"""Composite models: the fused three-head inference net and the train-time
composition.

Counterpart of the JAX package's ``models/detector.py``.  ``TextDetBase``
(reference basemodel.py:222-244): YOLO graph (detections + backbone taps)
-> U-Net head (mask + intermediate features) -> DB head (shrink/thresh
maps).  ``TextDetTrain`` (basemodel.py:162-209): the backbone frozen in
eval mode, one trainable head.  ``BlkDetTrain``: the whole YOLO graph,
trained as the block detector.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from comic_text_detector_tpu_torch.config import OUT_INDICES, GraphSpec, backbone_spec, full_spec
from comic_text_detector_tpu_torch.constants import TEXTDET_DET, TEXTDET_MASK
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


class BlkDetTrain(nn.Module):
    """Train-time block detector: the full YOLO graph (backbone, neck and
    Detect, SiLU) under the deploy name ``blk_det``, so its state dict keys
    are the inference net's and trained weights go straight into a deploy
    tree.  Trained whole: in ``train()`` every BatchNorm normalizes with
    its batch statistics and updates its running ones.  ``forward``
    returns ``(raw, taps)``: the raw per-level (B, na, h, w, no) maps the
    loss reads, or with ``decode=True`` the decoded (B, N, no) rows."""

    def __init__(self, spec: GraphSpec):
        super().__init__()
        self.spec = spec
        self.blk_det = YoloGraph(spec, OUT_INDICES, act="silu")

    def forward(self, x: torch.Tensor, decode: bool = False):
        return self.blk_det(x, decode=decode)


def build_blk_train_model(cfg: Optional[dict] = None) -> BlkDetTrain:
    return BlkDetTrain(full_spec(cfg))


def init_variables(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-draw ``model``'s parameters in place with the JAX package's flax
    initializers (``models/blocks.py``), from ``generator``: convolution
    kernels truncated-normal with variance 2 / fan_in (cut at two standard
    deviations), transposed-convolution kernels uniform with variance
    1 / fan_in, biases 0, BatchNorm scale 1 and shift 0, running mean 0 and
    variance 1.  fan_in counts the input channels times the kernel's area.
    The values differ from JAX's (another RNG); the distributions do not.
    Returns ``model``."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                transposed = isinstance(mod, nn.ConvTranspose2d)
                fan_in = (w.shape[0] if transposed else w.shape[1]) * w.shape[2] * w.shape[3]
                if transposed:
                    limit = math.sqrt(3.0 / fan_in)
                    w.uniform_(-limit, limit, generator=generator)
                else:
                    # flax's truncated normal: std / 0.8796 (the std of a
                    # unit normal cut at +-2), cut at two of its deviations
                    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
                    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
    return model


def damp_output_biases(variables: Dict, value: float = -8.0, parts=("detect", "db")) -> Dict:
    """Shift detection/DB output biases of deploy variables (the nested
    numpy dict ``weights.load_npz`` reads) so that a randomly initialized
    net emits (near-)empty predictions.  ``parts`` selects 'detect' (YOLO
    objectness) and/or 'db' (the DB towers).  Returns a copy."""
    variables = copy.deepcopy(variables)
    params = variables["params"]
    if "detect" in parts:
        for name, sub in params.get("blk_det", {}).items():
            if name.startswith("model_") and any(k.startswith("m_") for k in sub):
                for mk, conv in sub.items():
                    if mk.startswith("m_") and "bias" in conv:
                        b = np.array(conv["bias"], dtype=np.float32)
                        b.reshape(3, -1)[:, 4] = value
                        conv["bias"] = b
    if "db" in parts:
        db = params.get("text_det", {})
        for tower in ("binarize", "thresh"):
            if tower in db and "seq6" in db[tower] and "bias" in db[tower]["seq6"]:
                db[tower]["seq6"]["bias"] = np.full_like(np.asarray(db[tower]["seq6"]["bias"]), value)
    return variables
