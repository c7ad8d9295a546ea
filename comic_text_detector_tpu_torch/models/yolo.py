"""Config-driven YOLOv5 graph + Detect decode (NCHW).

Counterpart of the JAX package's ``models/yolo.py`` (reference
models/yolov5/yolo.py:7-259).  The graph comes from ``config.parse_graph``;
layer ``i`` is ``model.<i>`` as in the reference state dict.  With it:
the Detect conv biases' training prior (``initialize_detect_biases``) and
the multi-scale + flip test-time augmentation (``scale_img``,
``augmented_detect``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from comic_text_detector_tpu_torch.config import OUT_INDICES, GraphSpec
from comic_text_detector_tpu_torch.models import blocks
from comic_text_detector_tpu_torch.ops import nn as tnn
from comic_text_detector_tpu_torch.ops.resize import resize_bilinear


class Detect(nn.Module):
    """Per-level 1x1 prediction convs + anchor decode.

    Output rows are ordered (level, anchor, row, col); xy/wh use the v5
    decode ``xy = (2σ-0.5+grid)·stride``, ``wh = (2σ)²·anchor``.  The
    ``anchors`` buffer holds anchors in stride units, as the reference's
    does (its ``model.<i>.anchors`` key).
    """

    def __init__(self, nc: int, anchors: Sequence[Sequence[float]], ch: Sequence[int],
                 strides: Sequence[int] = (8, 16, 32)):
        super().__init__()
        self.nc, self.no = nc, nc + 5
        self.na = len(anchors[0]) // 2
        self.strides = tuple(float(s) for s in strides[:len(anchors)])  # one a level
        a = torch.tensor(anchors, dtype=torch.float32).view(len(anchors), -1, 2)
        self.register_buffer("anchors", a / torch.tensor(self.strides).view(-1, 1, 1))
        self.m = nn.ModuleList(tnn.Conv2d(c, self.no * self.na, 1) for c in ch)

    def forward(self, feats: Sequence[torch.Tensor], decode: bool = True) -> Union[torch.Tensor, List[torch.Tensor]]:
        """The decoded rows (B, sum of na*h*w, no), or with ``decode=False``
        the raw per-level maps (B, na, h, w, no) the training loss reads."""
        out: List[torch.Tensor] = []
        for i, f in enumerate(feats):
            p = self.m[i](f)
            b, _, h, w = p.shape
            # (b, na*no, h, w) -> (b, na, h, w, no): the reference's row order
            p = p.view(b, self.na, self.no, h, w).permute(0, 1, 3, 4, 2)
            if not decode:
                out.append(p)
                continue
            y = torch.sigmoid(p.float())
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=p.device),
                torch.arange(w, dtype=torch.float32, device=p.device),
                indexing="ij",
            )
            grid = torch.stack([gx, gy], dim=-1)[None, None]
            anc = (self.anchors[i] * self.strides[i]).view(1, self.na, 1, 1, 2)
            xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * self.strides[i]
            wh = torch.square(y[..., 2:4] * 2.0) * anc
            out.append(torch.cat([xy, wh, y[..., 4:]], dim=-1).reshape(b, -1, self.no))
        return torch.cat(out, dim=1) if decode else out


def _build_layer(spec, act: str) -> nn.Module:
    """The module of one LayerSpec, with the JAX package's argument
    unpacking (its ``models/yolo.py::_build_layer``).  A module-level repeat
    count above 1 (``[-1, 2, "Bottleneck", ...]``: the reference builds an
    ``nn.Sequential`` of that many) raises, as does an unknown module."""
    m, a = spec.module, spec.args
    if spec.repeats > 1:
        raise ValueError(f"layer {spec.index} ({m}): a module-level repeat count of {spec.repeats} is not "
                         "supported (the reference stacks that many modules in an nn.Sequential)")
    if m == "Conv":  # (c1, c2, k[, s[, p]])
        k = a[2] if len(a) > 2 else 1
        s = a[3] if len(a) > 3 else 1
        p = a[4] if len(a) > 4 else None
        return blocks.Conv(a[0], a[1], k, s, p, act=act)
    if m == "C3":  # (c1, c2, n[, shortcut])
        shortcut = a[3] if len(a) > 3 else True
        return blocks.C3(a[0], a[1], n=a[2], shortcut=shortcut, act=act)
    if m == "SPPF":
        return blocks.SPPF(a[0], a[1], k=a[2] if len(a) > 2 else 5, act=act)
    if m == "SPP":
        return blocks.SPP(a[0], a[1], k=tuple(a[2]) if len(a) > 2 else (5, 9, 13), act=act)
    if m == "Focus":
        return blocks.Focus(a[0], a[1], a[2] if len(a) > 2 else 1, act=act)
    if m == "Bottleneck":
        return blocks.Bottleneck(a[0], a[1], act=act)
    if m == "DWConv":  # groups = gcd(c1, c2) (reference common.py:52)
        k = a[2] if len(a) > 2 else 1
        s = a[3] if len(a) > 3 else 1
        return blocks.Conv(a[0], a[1], k, s, g=math.gcd(a[0], a[1]), act=act)
    if m == "GhostConv":
        k = a[2] if len(a) > 2 else 1
        s = a[3] if len(a) > 3 else 1
        g = a[4] if len(a) > 4 else 1
        return blocks.GhostConv(a[0], a[1], k, s, g=g, act=act)
    if m == "GhostBottleneck":
        k = a[2] if len(a) > 2 else 3
        s = a[3] if len(a) > 3 else 1
        return blocks.GhostBottleneck(a[0], a[1], k, s, act=act)
    if m in ("BottleneckCSP", "C3TR", "C3Ghost"):  # (c1, c2, n[, shortcut])
        shortcut = a[3] if len(a) > 3 else True
        return getattr(blocks, m)(a[0], a[1], n=a[2], shortcut=shortcut, act=act)
    if m == "C3SPP":
        return blocks.C3SPP(a[0], a[1], k=tuple(a[2]) if len(a) > 2 else (5, 9, 13), act=act)
    if m == "BatchNorm2d":
        return tnn.BatchNorm2d(a[0], eps=1e-3, momentum=0.03)
    if m == "Contract":
        return blocks.Contract(a[0])
    if m == "Expand":
        return blocks.Expand(a[0])
    if m == "Upsample":
        return blocks.Upsample()
    if m == "Concat":
        return blocks.Concat()
    raise ValueError(f"layer {spec.index}: unsupported graph module {m!r}")


class YoloGraph(nn.Module):
    """Sequential-with-skips executor of a resolved GraphSpec.

    ``forward`` returns ``(dets, taps)``: the decoded Detect rows
    (B, N, 5+nc) and the backbone feature maps at ``out_indices`` for the
    seg/DB heads (reference Model._forward_once, yolo.py:115-134); with
    ``decode=False`` the raw per-level Detect maps in place of the rows.  Built
    from ``config.backbone_spec`` it holds the ten backbone layers alone and
    ``dets`` is None (the train-time composite's backbone).
    """

    def __init__(self, spec: GraphSpec, out_indices: Tuple[int, ...] = OUT_INDICES, act: str = "silu"):
        super().__init__()
        self.spec = spec
        self.out_indices = tuple(out_indices)
        layers = []
        for ls in spec.layers:
            if ls.module == "Detect":
                layers.append(Detect(spec.nc, spec.anchors, ls.c_in, spec.strides))
            else:
                layers.append(_build_layer(ls, act))
        self.model = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, decode: bool = True):
        saved: Dict[int, torch.Tensor] = {}
        taps: List[torch.Tensor] = []
        dets = None
        y = x
        for ls, mod in zip(self.spec.layers, self.model):
            if isinstance(ls.frm, tuple):
                inp = [y if j == -1 else saved[j] for j in ls.frm]
            else:
                inp = y if ls.frm == -1 else saved[ls.frm]
            if ls.module == "Detect":
                y = dets = mod(inp, decode=decode)
            else:
                y = mod(inp)
            if ls.index in self.spec.save:
                saved[ls.index] = y
            if ls.index in self.out_indices:
                taps.append(y)
        return dets, taps


def initialize_detect_biases(model: nn.Module, img_size: int = 640) -> nn.Module:
    """The Detect conv biases' prior (reference Model._initialize_biases,
    yolo.py:170-178), in place on every Detect of ``model``: per level of
    stride s, objectness += log(8 / (img_size / s)**2) and each class +=
    log(0.6 / (nc - 0.999999)).  Returns ``model``."""
    with torch.no_grad():
        for det in (m for m in model.modules() if isinstance(m, Detect)):
            for conv, s in zip(det.m, det.strides):
                b = conv.bias.view(det.na, -1)
                b[:, 4] += math.log(8 / (img_size / s) ** 2)
                b[:, 5:] += math.log(0.6 / (det.nc - 0.999999))
    return model


def scale_img(x: torch.Tensor, ratio: float, gs: int = 32, pad_value: float = 0.447) -> torch.Tensor:
    """Scale an NCHW batch by ``ratio`` (bilinear, ``ops/resize.py::
    resize_bilinear``) and pad bottom/right with ``pad_value`` to multiples
    of ``gs`` (reference utils/yolov5_utils.py scale_img :11-21)."""
    if ratio == 1.0:
        return x
    h, w = x.shape[-2:]
    nh, nw = int(h * ratio), int(w * ratio)
    y = resize_bilinear(x, (nh, nw))
    ph = math.ceil(h * ratio / gs) * gs
    pw = math.ceil(w * ratio / gs) * gs
    return F.pad(y, (0, pw - nw, 0, ph - nh), value=pad_value)


@torch.no_grad()
def augmented_detect(model: YoloGraph, x: torch.Tensor, gs: int = 32) -> torch.Tensor:
    """Multi-scale + flip test-time-augmented detection (reference
    Model._forward_augment / _descale_pred / _clip_augmented,
    models/yolov5/yolo.py:101-162) of the full graph ``model`` on an NCHW
    batch: scales 1, 0.83 (flipped left-right) and 0.67, each de-scaled
    (and un-flipped), the first output's last-level tail and the last
    output's first-level head clipped.  Returns (B, sum of N', no) decoded
    rows."""
    img_w = x.shape[-1]
    outs = []
    for si, flip in zip((1.0, 0.83, 0.67), (False, True, False)):
        xi = scale_img(torch.flip(x, dims=(-1,)) if flip else x, si, gs=gs)
        dets, _ = model(xi)
        xy = dets[..., 0:2] / si
        wh = dets[..., 2:4] / si
        if flip:
            xy = torch.stack([img_w - xy[..., 0], xy[..., 1]], dim=-1)
        outs.append(torch.cat([xy, wh, dets[..., 4:]], dim=-1))
    nl = 3
    g = sum(4 ** k for k in range(nl))
    i0 = outs[0].shape[1] // g
    outs[0] = outs[0][:, :-i0]
    i2 = (outs[-1].shape[1] // g) * 4 ** (nl - 1)
    outs[-1] = outs[-1][:, i2:]
    return torch.cat(outs, dim=1)
