"""The reference's page path: one BGR uint8 page -> the net's three
outputs, the grouped blocks with their line quads, the raw mask and the
refined mask, computed in float32 (or, for a control, in a lower
precision: ``precision``).

Steps, as the reference detector (inference.py) and the port's device
path define them: cv2-exact letterbox to ``size`` (bottom/right padding),
the net on BGR / 255, NMS (objectness and objectness x class confidence
over ``conf_thresh``, greedy per class at ``nms_thresh``, at most 300
boxes), the grey mask ``trunc(255 p)`` un-letterboxed cv2-exact to the
page and binarised at > 30, the DB decode (``dbdecode.py``) with
``box_thresh``, the grouping (``textblock.group_output``) and the
colour-model refinement of each block (``textmask.refine_mask`` on the
grey page mask).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import numpy as np
import torch

from ctd_bench.reference import dbdecode
from ctd_bench.reference import nn as rnn
from ctd_bench.reference.constants import LANG_LIST
from ctd_bench.reference.net import build_inference_model, build_train_model
from ctd_bench.reference.resize import letterbox_shape, resize_cv2exact_u8_np
from ctd_bench.reference.textblock import group_output
from ctd_bench.reference.textmask import refine_mask
from ctd_bench.reference.weights import load_npz, state_dict_from_jax, train_from_deploy, train_state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_variables(config: Dict) -> Dict:
    return load_npz(os.path.join(ROOT, config["weights"]))


def inference_model(config: Dict, device, variables=None) -> torch.nn.Module:
    """The three-head net of ``config`` in float32 with the weights file's
    values."""
    variables = load_variables(config) if variables is None else variables
    model = build_inference_model(config["graph"], act=config["seg_db_act"], dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(variables, config["graph"]), strict=True)
    return model.to(device).eval()


def db_train_model(config: Dict, device, variables=None) -> torch.nn.Module:
    """The DB training composite (frozen backbone and U-Net trunk, the DB
    head trainable) with the weights file's values."""
    variables = load_variables(config) if variables is None else variables
    model = build_train_model(config["graph"], act=config["seg_db_act"], with_db=True)
    model.load_state_dict(train_state_dict_from_jax(train_from_deploy(variables, with_db=True)), strict=True)
    return model.to(device)


@contextlib.contextmanager
def precision(mode: str):
    """``f32``: float32 with TF32 off; ``tf32``: TF32 on in cuDNN and
    cuBLAS (the control of a float32 configuration); ``fp8``: convolution
    operands rounded to float8 e4m3 (the control of a bf16 one).  cuDNN
    runs its deterministic algorithms in each."""
    tf32 = mode == "tf32"
    old_mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    rnn.set_precision(mode)
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=tf32):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_mm
        rnn.set_precision("f32")


def letterbox_u8(page: np.ndarray, size: int):
    h, w = page.shape[:2]
    nh, nw, dw, dh, _ = letterbox_shape(h, w, size)
    lb = np.pad(resize_cv2exact_u8_np(page, (nh, nw)), ((0, dh), (0, dw), (0, 0)))
    return lb, dw, dh


def nms(rows: np.ndarray, conf_thresh: float, iou_thresh: float, max_det: int = 300):
    """Detect rows (N, 5 + nc) [cx, cy, w, h, obj, cls...] -> kept
    (x1, y1, x2, y2, conf, cls) rows, greedy in descending confidence with
    boxes of different classes kept apart."""
    rows = rows.astype(np.float64)
    obj = rows[:, 4]
    cls = rows[:, 5:].argmax(1)
    conf = obj * rows[:, 5:].max(1)
    ok = np.flatnonzero((obj > conf_thresh) & (conf > conf_thresh))
    ok = ok[np.argsort(-conf[ok], kind="stable")]
    cx, cy, bw, bh = rows[ok, 0], rows[ok, 1], rows[ok, 2], rows[ok, 3]
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
    kept = []
    for i in range(len(ok)):
        if len(kept) >= max_det:
            break
        ok_i = True
        for j in kept:
            if cls[ok[j]] != cls[ok[i]]:
                continue
            a, b = boxes[i], boxes[j]
            iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
            ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
            inter = iw * ih
            union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
            if union > 0 and inter / union > iou_thresh:
                ok_i = False
                break
        if ok_i:
            kept.append(i)
    out = np.zeros((len(kept), 6))
    for r, i in enumerate(kept):
        out[r, :4] = boxes[i]
        out[r, 4] = conf[ok[i]]
        out[r, 5] = cls[ok[i]]
    return out


@torch.no_grad()
def net_outputs(model, page: np.ndarray, size: int, device):
    """(blks (N, 7), mask (S, S), shrink (S, S)) float32 on the CPU, and the
    letterbox's (dw, dh)."""
    lb, dw, dh = letterbox_u8(page, size)
    x = torch.from_numpy(lb).to(device).permute(2, 0, 1)[None].to(torch.float32) / 255.0
    blks, mask, lines = model(x)
    return (blks[0].float().cpu(), mask[0, 0].float().cpu(), lines[0, 0].float().cpu()), (dw, dh)


def detect_page(model, page: np.ndarray, size: int, config: Dict, device, mode: str = "f32") -> Dict:
    """Everything the page path produces for ``page`` (see the module
    docstring), in the form ``compare.py`` reads."""
    with precision(mode):
        net, _ = net_outputs(model, page, size, device)
    return page_stages(page, net, size, config)


def page_stages(page: np.ndarray, net, size: int, config: Dict) -> Dict:
    """The steps after the net (NMS, the grey and raw masks, the DB decode,
    the grouping, the refinement) on the net's three outputs ``net``
    (``net_outputs``' form: float32 on the CPU)."""
    blks, mask, shrink = net
    im_h, im_w = page.shape[:2]
    _, _, dw, dh, _ = letterbox_shape(im_h, im_w, size)
    ratio = (im_w / (size - dw), im_h / (size - dh))
    det = nms(blks.numpy(), config["conf_thresh"], config["nms_thresh"])
    det[:, [0, 2]] *= ratio[0]
    det[:, [1, 3]] *= ratio[1]
    yolo = (det[:, :4].astype(np.int32), det[:, 5].astype(np.int32), np.round(det[:, 4], 3))
    grey = resize_cv2exact_u8_np((mask.numpy() * 255.0).astype(np.float32).astype(np.uint8)[: size - dh, : size - dw],
                                 (im_h, im_w))
    raw = np.where(grey > 30, np.uint8(255), np.uint8(0))
    quads, scores = dbdecode.decode(shrink.numpy(), config["db_thresh"], unclip_ratio=config["unclip_ratio"])
    quads = quads[scores > config["box_thresh"]]
    if quads.size:
        q = quads.astype(np.float64)
        q[..., 0] *= ratio[0]
        q[..., 1] *= ratio[1]
        lines = q.astype(np.int32)
    else:
        lines = []
    blk_list = group_output(yolo, lines, im_w, im_h, raw)
    refined = refine_mask(page, grey, blk_list)
    return {
        "net": (blks, mask, shrink),
        "blocks": [(list(b.xyxy), LANG_LIST.index(b.language) if b.language in LANG_LIST else -1) for b in blk_list],
        "lines": [np.asarray(ln, np.int64).reshape(4, 2) for b in blk_list for ln in b.lines],
        "raw": raw > 0,
        "refined": refined > 0,
    }


def rounded(net, mode: str):
    """The net's outputs rounded to a lower precision, each tensor (each
    column of the Detect rows) scaled to its own range first for
    ``fp8`` (float8 e4m3): the control of the steps after the net."""
    def one(t, per_column=False):
        if mode == "bf16":
            return t.to(torch.bfloat16).float()
        amax = t.abs().amax(dim=0, keepdim=True) if per_column else t.abs().amax()
        scale = 448.0 / torch.clamp(amax, min=1e-12)
        return (t * scale).to(torch.float8_e4m3fn).float() / scale

    blks, mask, shrink = net
    return one(blks, per_column=True), one(mask), one(shrink)
