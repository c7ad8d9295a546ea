"""YOLOv5 detection loss with dense in-graph target assignment.

Counterpart of the JAX package's ``training/yolo_loss.py``: labels arrive
as a fixed (B, L, 5) padded tensor with a (B, L) mask, and the v5
assignment (anchor wh-ratio gate ``max(w/aw, aw/w, h/ah, ah/h) <
ANCHOR_T``, the 0.5-cell neighbour spread) scores every (label, anchor,
offset) candidate at once and writes the winners into dense per-level
target maps (B, na, gh, gw, 6).  The loss is then elementwise over the
dense maps: CIoU box loss, IoU-valued objectness targets with per-level
``BALANCE``, BCE class loss.

Candidates that land on the same (cell, anchor) keep one winner, the last
in the flat (B, L, na, 5) candidate order: the JAX package's scatter keeps
that one on the CPU.  A torch scatter with duplicate indices promises no
winner (on CUDA it can change from run to run), so the winner is chosen
explicitly: the largest candidate ordinal per target cell, then a gather.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

ANCHOR_T = 4.0  # wh-ratio gate (v5 hyp.anchor_t)
BALANCE = (4.0, 1.0, 0.4)  # per-level objectness balance (v5, 3 levels)


def ciou_xywh(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete-IoU between center-format boxes (..., 4) -> (...,).  The
    aspect term's weight ``alpha`` carries no gradient."""
    x1, y1, w1, h1 = box1.unbind(-1)
    x2, y2, w2, h2 = box2.unbind(-1)
    l1, r1, t1, b1 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
    l2, r2, t2, b2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    inter = (torch.minimum(r1, r2) - torch.maximum(l1, l2)).clamp_min(0) * (
        torch.minimum(b1, b2) - torch.maximum(t1, t2)
    ).clamp_min(0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(r1, r2) - torch.minimum(l1, l2)
    ch = torch.maximum(b1, b2) - torch.minimum(t1, t2)
    c2 = cw * cw + ch * ch + eps
    rho2 = (x2 - x1) ** 2 + (y2 - y1) ** 2
    v = (4 / math.pi**2) * torch.square(torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps)))
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def _level_targets(
    labels: torch.Tensor,  # (B, L, 5) [cls, x, y, w, h] normalized
    label_mask: torch.Tensor,  # (B, L) bool
    anchors_grid: torch.Tensor,  # (na, 2) anchor wh in grid units
    gh: int,
    gw: int,
) -> torch.Tensor:
    """Dense target map (B, na, gh, gw, 6): [tx, ty, tw, th, cls, pos].

    tx/ty are the v5 regression targets relative to the assigned cell
    (range (-0.5, 1.5)); tw/th in grid units.  Constants enter as Python
    scalars, never as host tensors copied to the device: such a copy
    waits for the device."""
    b, l = labels.shape[:2]
    na = anchors_grid.shape[0]
    dev = labels.device
    labels = labels.to(torch.float32)
    gxy = torch.stack([labels[..., 1] * gw, labels[..., 2] * gh], dim=-1)  # (B, L, 2)
    gwh = torch.stack([labels[..., 3] * gw, labels[..., 4] * gh], dim=-1)
    cls = labels[..., 0]

    # anchor gate: (B, L, na)
    r = gwh[:, :, None, :] / anchors_grid[None, None, :, :]
    ratio = torch.maximum(r, 1.0 / r.clamp_min(1e-9)).amax(-1)
    match = (ratio < ANCHOR_T) & label_mask.bool()[:, :, None] & (gwh.prod(-1) > 0)[:, :, None]

    # neighbour spread: centre + left/right + top/bottom (g = 0.5); offsets
    # are subtracted from gxy before the floor (v5 convention)
    g = 0.5
    fx, fy = torch.remainder(gxy[..., 0], 1.0), torch.remainder(gxy[..., 1], 1.0)
    take_l = (fx < g) & (gxy[..., 0] > 1.0)
    take_r = (fx > g) & (gxy[..., 0] < gw - 1.0)
    take_t = (fy < g) & (gxy[..., 1] > 1.0)
    take_b = (fy > g) & (gxy[..., 1] < gh - 1.0)
    # (x, y) offsets paired with [centre, take_l, take_r, take_t, take_b]
    offs = ((0.0, 0.0), (g, 0.0), (-g, 0.0), (0.0, g), (0.0, -g))
    off_ok = torch.stack([torch.ones_like(take_l), take_l, take_r, take_t, take_b], dim=-1)  # (B, L, 5)

    # candidate grid: (B, L, na, 5)
    valid = match[:, :, :, None] & off_ok[:, :, None, :]
    cell = torch.stack([torch.stack([gxy[..., 0] - ox, gxy[..., 1] - oy], dim=-1) for ox, oy in offs], dim=2)
    cell = torch.floor(cell)[:, :, None].expand(b, l, na, 5, 2)
    gi = cell[..., 0].clamp(0, gw - 1)
    gj = cell[..., 1].clamp(0, gh - 1)
    txy = gxy[:, :, None, None, :] - torch.stack([gi, gj], dim=-1)  # in (-0.5, 1.5)

    bidx = torch.arange(b, device=dev)[:, None, None, None]
    aidx = torch.arange(na, device=dev)[None, None, :, None]
    n = b * na * gh * gw
    flat_idx = ((bidx * na + aidx) * gh + gj.long()) * gw + gi.long()
    flat_idx = torch.where(valid, flat_idx, n).reshape(-1)  # invalid -> the dump slot n

    rows = torch.cat(
        [
            txy,
            gwh[:, :, None, None, :].expand(txy.shape),
            cls[:, :, None, None, None].expand(txy.shape[:-1] + (1,)),
            torch.ones(txy.shape[:-1] + (1,), dtype=torch.float32, device=dev),
        ],
        dim=-1,
    ).reshape(-1, 6)  # (B*L*na*5, 6)

    # the last candidate in flat order wins each cell: max ordinal, gathered
    ordinal = torch.arange(flat_idx.numel(), device=dev)
    win = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, flat_idx, ordinal, reduce="amax", include_self=True)
    win = win[:n]
    dense = torch.where((win >= 0)[:, None], rows[win.clamp_min(0)], 0.0)
    return dense.reshape(b, na, gh, gw, 6)


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE (elementwise), the JAX package's
    formula."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def yolo_loss(
    raw: Sequence[torch.Tensor],  # per level (B, na, h, w, no)
    labels: torch.Tensor,  # (B, L, 5) [cls, x, y, w, h] normalized
    label_mask: torch.Tensor,  # (B, L)
    anchors: Tuple[Tuple[float, ...], ...],  # pixel units per level
    strides: Tuple[int, ...],
    nc: int,
    box_gain: float = 0.05,
    obj_gain: float = 1.0,
    cls_gain: float = 0.3,
) -> Dict[str, torch.Tensor]:
    """v5 composite loss over the raw Detect maps -> {'loss', 'lbox',
    'lobj', 'lcls'} as scalars."""
    dev = raw[0].device
    na = raw[0].shape[1]
    # anchors in grid units, divided on the host; one copy, from pinned
    # memory so that it does not wait for the device
    grid_anchors = torch.tensor(anchors, dtype=torch.float32).view(len(raw), na, 2) / torch.tensor(
        strides, dtype=torch.float32).view(-1, 1, 1)
    if dev.type == "cuda":
        grid_anchors = grid_anchors.pin_memory().to(dev, non_blocking=True)
    lbox = lobj = lcls = torch.zeros((), dtype=torch.float32, device=dev)
    for i, p in enumerate(raw):
        b, na, gh, gw, no = p.shape
        anchors_grid = grid_anchors[i]
        t = _level_targets(labels, label_mask, anchors_grid, gh, gw)
        pos = t[..., 5] > 0
        posf = pos.to(torch.float32)
        n_pos = posf.sum().clamp_min(1.0)

        pf = p.to(torch.float32)
        pxy = torch.sigmoid(pf[..., 0:2]) * 2.0 - 0.5
        pwh = torch.square(torch.sigmoid(pf[..., 2:4]) * 2.0) * anchors_grid[None, :, None, None, :]
        iou = ciou_xywh(torch.cat([pxy, pwh], -1), t[..., 0:4])  # (B, na, gh, gw)
        lbox = lbox + torch.sum((1.0 - iou) * posf) / n_pos

        tobj = posf * iou.detach().clamp_min(0.0)
        lobj = lobj + sigmoid_bce(pf[..., 4], tobj).mean() * BALANCE[i % len(BALANCE)]

        if nc > 1:
            # jax.nn.one_hot: a class outside [0, nc) is all zeros
            tcls = (t[..., 4].to(torch.int32)[..., None] == torch.arange(nc, device=dev)).to(torch.float32)
            bce_cls = sigmoid_bce(pf[..., 5:], tcls).sum(-1)
            lcls = lcls + torch.sum(bce_cls * posf) / (n_pos * nc)

    loss = box_gain * lbox + obj_gain * lobj + cls_gain * lcls
    return {"loss": loss, "lbox": lbox, "lobj": lobj, "lcls": lcls}
