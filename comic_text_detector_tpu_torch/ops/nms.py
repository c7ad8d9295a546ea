"""Fixed-shape non-maximum suppression.

Counterpart of the JAX package's ``ops/nms.py::nms_single`` (and
``nms_batch``, one ``nms_single`` per image): top-K
candidates, a KxK IoU matrix, and iteration to the exact greedy-NMS
fixpoint (keep[j] = valid[j] ∧ ∀i<j: ¬(keep[i] ∧ iou[i,j]>t)).  The top-K
is a stable descending sort, because ``lax.top_k`` puts the lower index
first on ties and ``torch.topk`` does not promise to.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from comic_text_detector_tpu_torch.constants import MAX_DET, MAX_NMS_CANDIDATES
from comic_text_detector_tpu_torch.utils.profiling import count

# per-class box offset of batched NMS (reference utils/yolov5_utils.py:195)
_MAX_WH = 4096.0


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) center-format -> corner-format boxes."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes a (N, 4) x b (M, 4) -> (N, M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def _top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest, lower index first among equals."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k]


def _greedy_keep(iou: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Exact greedy-NMS keep mask for score-desc-sorted boxes; the fixpoint
    is reached in at most K steps (suppression chains are a few deep).  Each
    step's test waits on the device (``host_syncs``)."""
    k = iou.shape[0]
    order = torch.arange(k, device=iou.device)
    over = (iou > iou_thresh) & (order[:, None] < order[None, :])
    keep = valid
    for _ in range(k):
        nxt = valid & ~(over & keep[:, None]).any(dim=0)
        count("host_syncs")
        if torch.equal(nxt, keep):
            break
        keep = nxt
    return keep


def nms_single(
    pred: torch.Tensor,
    conf_thresh: float,
    iou_thresh: float,
    max_det: int = MAX_DET,
    max_nms: int = MAX_NMS_CANDIDATES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS over one image's (N, 5+nc) Detect rows [cx, cy, w, h, obj, cls...].

    Returns ((max_det, 6) rows [x1, y1, x2, y2, conf, cls] zero-padded, the
    count of valid rows).  Semantics of the reference non_max_suppression
    (utils/yolov5_utils.py:124-218): obj > thresh candidate filter,
    conf = obj * best class conf with a second > thresh filter, class-offset
    (4096 px) batched NMS.
    """
    obj = pred[:, 4]
    cls_conf, cls = pred[:, 5:].max(dim=-1)
    conf = obj * cls_conf
    cls = cls.to(torch.float32)
    valid = (obj > conf_thresh) & (conf > conf_thresh)
    scores = torch.where(valid, conf, -1.0)

    k = min(max_nms, scores.shape[0])
    top_scores, idx = _top_k(scores, k)
    top_valid = top_scores > 0
    boxes = xywh2xyxy(pred[idx, :4])
    ccls = cls[idx]
    off = (ccls * _MAX_WH)[:, None]
    keep = _greedy_keep(box_iou_matrix(boxes + off, boxes + off), top_valid, iou_thresh)

    # compact kept rows to the front, fixed size max_det
    m = min(max_det, k)
    sel_scores, sel = _top_k(torch.where(keep, top_scores, -1.0), m)
    sel_valid = sel_scores > 0
    rows = torch.cat([boxes[sel], top_scores[sel][:, None], ccls[sel][:, None]], dim=-1)
    rows = torch.where(sel_valid[:, None], rows, 0.0)
    rows = F.pad(rows, (0, 0, 0, max_det - m))
    return rows, sel_valid.sum()


def nms_batch(
    pred: torch.Tensor,
    conf_thresh: float,
    iou_thresh: float,
    max_det: int = MAX_DET,
    max_nms: int = MAX_NMS_CANDIDATES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`nms_single` over each image of a (B, N, 5+nc) stack ->
    ((B, max_det, 6) rows, (B,) counts)."""
    outs = [nms_single(p, conf_thresh, iou_thresh, max_det, max_nms) for p in pred]
    return torch.stack([r for r, _ in outs]), torch.stack([c for _, c in outs])
