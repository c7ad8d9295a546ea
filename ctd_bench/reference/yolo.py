"""Config-driven YOLOv5 graph + Detect decode (NCHW).

Counterpart of the JAX package's ``models/yolo.py`` (reference
models/yolov5/yolo.py:7-259).  The graph comes from ``config.parse_graph``;
layer ``i`` is ``model.<i>`` as in the reference state dict.  Frozen
copy of the port's ``models/yolo.py`` with the blocks the YOLOv5s graph
uses (Conv, C3, SPPF, Bottleneck, Upsample, Concat); its test-time
augmentation and training prior are left out.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch
from torch import nn

from ctd_bench.reference.config import OUT_INDICES, GraphSpec
from ctd_bench.reference import blocks
from ctd_bench.reference import nn as tnn


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
    ``nn.Sequential`` of that many) raises, as does a module this copy
    leaves out."""
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
    if m == "Bottleneck":
        return blocks.Bottleneck(a[0], a[1], act=act)
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


