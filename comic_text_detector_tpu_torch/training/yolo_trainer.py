"""Block-detector (YOLO) trainer.

Counterpart of the JAX package's ``training/yolo_trainer.py``: whole-graph
v5 training (backbone, neck and Detect) on the renderer's pages, built as
the seg and DB trainers are (warm-up + cosine learning rate, periodic
eval, best/last checkpoints), on ``torch.optim`` and the port's steps
(``training/steps.py``).  The eval reports the validation loss terms and
per-class (eng/ja) AP50 through decode, NMS and greedy IoU-0.5 matching.
Runs on ``device="cuda"`` unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import functools
import os
import os.path as osp
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch

from comic_text_detector_tpu_torch.data.blk_dataset import create_dataloader
from comic_text_detector_tpu_torch.models.detector import build_blk_train_model, init_variables
from comic_text_detector_tpu_torch.models.yolo import initialize_detect_biases
from comic_text_detector_tpu_torch.ops.nms import nms_single
from comic_text_detector_tpu_torch.training import checkpoint as ckpt_lib
from comic_text_detector_tpu_torch.training.metrics import per_class_ap50
from comic_text_detector_tpu_torch.training.seg_trainer import make_lr_schedule, uploader
from comic_text_detector_tpu_torch.training.steps import (
    Optimizer,
    TrainState,
    create_yolo_train_state,
    yolo_decode_step,
    yolo_eval_step,
    yolo_train_step,
)
from comic_text_detector_tpu_torch.utils.device import resolve_device
from comic_text_detector_tpu_torch.utils.log import LOGGER
from comic_text_detector_tpu_torch.weights import train_state_dict_from_jax


def detect_batch(state: TrainState, imgs: torch.Tensor, conf: float = 0.1, nms_iou: float = 0.45):
    """Decode a (B, H, W, 3) batch in eval mode and run ``nms_single`` on
    each page -> ((B, MAX_DET, 6) rows [x1, y1, x2, y2, conf, cls], (B,)
    counts), on the batch's device."""
    outs = [nms_single(d, conf, nms_iou) for d in yolo_decode_step(state, imgs)]
    return torch.stack([r for r, _ in outs]), torch.stack([c for _, c in outs])


def gt_boxes(labels: np.ndarray, mask: np.ndarray, s: int) -> np.ndarray:
    """One page's labels (L, 5) [cls, x, y, w, h] normalized, masked ->
    (G, 5) rows [cls, x1, y1, x2, y2] in pixels of the ``s``-square
    canvas."""
    lab = labels[mask > 0]
    g = np.zeros((len(lab), 5), np.float64)
    g[:, 0] = lab[:, 0]
    g[:, 1] = (lab[:, 1] - lab[:, 3] / 2) * s
    g[:, 2] = (lab[:, 2] - lab[:, 4] / 2) * s
    g[:, 3] = (lab[:, 1] + lab[:, 3] / 2) * s
    g[:, 4] = (lab[:, 2] + lab[:, 4] / 2) * s
    return g


def eval_detection_ap(state: TrainState, val_loader, nc: int = 2, conf: float = 0.1, nms_iou: float = 0.45) -> Dict:
    """Per-class (eng/ja) AP50 over a val loader: decode + NMS + greedy
    IoU-0.5 matching (``training/metrics.py::per_class_ap50``), on the
    model's device.  The loss eval cannot see class confusion; this reports
    detection quality as the deployed pipeline consumes it."""
    device = next(state.model.parameters()).device
    put = uploader(device)
    preds, gts = [], []
    for imgs, labels, mask in val_loader:
        rows, counts = detect_batch(state, put(imgs), conf, nms_iou)
        rows, counts = rows.cpu().numpy(), counts.cpu().numpy()
        s = imgs.shape[1]  # square letterbox canvas
        for b in range(len(rows)):
            preds.append(rows[b][: int(counts[b])])
            gts.append(gt_boxes(np.asarray(labels[b]), np.asarray(mask[b]), s))
    return per_class_ap50(preds, gts, nc=nc)


def build_model(variables=None, img_size: int = 640):
    """``BlkDetTrain`` from JAX-layout ``variables`` (``{'params':
    {'blk_det': ...}, 'batch_stats': {'blk_det': ...}}``, nested numpy
    dicts), or drawn with the JAX package's initializers from seed 0 with
    the Detect bias prior for ``img_size``."""
    model = build_blk_train_model()
    if variables is None:
        init_variables(model, torch.Generator().manual_seed(0))
        initialize_detect_biases(model, img_size=img_size)
    else:
        sd = train_state_dict_from_jax(variables)
        sd.update((k, v) for k, v in model.state_dict().items() if k.endswith(".anchors"))
        model.load_state_dict(sd, strict=True)
    return model


def train(hyp: Dict, variables=None, max_steps: Optional[int] = None, mesh=None, device: str = "cuda") -> Dict:
    """Train the block detector from a hyp dict (the seg/DB trainers'
    shape).  ``variables`` injects JAX-layout ``BlkDetTrain`` variables
    (``weights.blk_train_from_deploy`` makes them from a deploy
    checkpoint); otherwise the model is randomly initialized.
    ``max_steps`` bounds the total train steps.  ``mesh`` (data
    parallelism) is not ported yet.  Returns {'state', 'best_loss',
    'last_loss', 'steps', 'ap'}."""
    if mesh is not None:
        raise NotImplementedError("data-parallel training (mesh=) comes with the port's DDP slice")
    dev = resolve_device(device)
    hyp_train, hyp_data = hyp["train"], hyp["data"]
    save_dir = hyp_data.get("save_dir", "data")
    os.makedirs(save_dir, exist_ok=True)
    epochs = hyp_train["epochs"]
    batch_size = hyp_train["batch_size"]
    imgsz = hyp_data["imgsz"]

    model = build_model(variables, img_size=imgsz).to(dev)
    nc = model.spec.nc

    train_dataset, train_loader = create_dataloader(
        hyp_data["train_img_dir"], imgsz, batch_size,
        augment=hyp_data.get("augment", True), aug_param=hyp_data.get("aug_param"),
        shuffle=True, as_uint8=True,
    )
    val_dataset, val_loader = create_dataloader(
        hyp_data["val_img_dir"], imgsz, min(4, batch_size), augment=False, shuffle=False, as_uint8=True,
    )
    nb = len(train_loader)
    LOGGER.info(f"num training imgs: {len(train_dataset)}, num val imgs: {len(val_dataset)}")

    tx = functools.partial(
        Optimizer, kind="adam" if hyp_train.get("optimizer", "adam") == "adam" else "sgd",
        lr=make_lr_schedule(hyp_train, nb), momentum=hyp_train.get("momentum", 0.937),
        weight_decay=hyp_train.get("weight_decay", 0.0), accumulation_steps=hyp_train.get("accumulation_steps", 1),
    )
    state = create_yolo_train_state(model, tx)

    put = uploader(dev)
    gains = hyp_train.get("gains")
    eval_interval = hyp_train.get("eval_interval", 1)
    total_steps = 0
    best_loss = float("inf")
    m_loss = 0.0
    last_ap = None

    for epoch in range(epochs):
        train_dataset.initialize()
        losses = []  # device scalars, read once an epoch
        for imgs, labels, mask in train_loader:
            losses.append(yolo_train_step(state, put(imgs), put(labels), put(mask), gains)["loss"])
            total_steps += 1
            if max_steps is not None and total_steps >= max_steps:
                break
        m_loss = float(torch.stack(losses).mean()) if losses else 0.0

        if (epoch + 1) % eval_interval == 0 or epoch == epochs - 1 or (max_steps and total_steps >= max_steps):
            sums = torch.zeros(4, dtype=torch.float64, device=dev)  # loss, lbox, lobj, lcls
            n = 0
            for imgs, labels, mask in val_loader:
                m = yolo_eval_step(state, put(imgs), put(labels), put(mask), gains)
                sums += torch.stack([m["loss"], m["lbox"], m["lobj"], m["lcls"]]).double()
                n += 1
            e = dict(zip(("loss", "lbox", "lobj", "lcls"), (v / max(n, 1) for v in sums.tolist())))
            save_best = e["loss"] < best_loss
            if save_best:
                best_loss = e["loss"]
            # yolo_last carries best_loss so that a resumed run keeps the
            # best-model bookkeeping
            meta = {"epoch": epoch, "best_loss": best_loss, "date": datetime.now().isoformat()}
            ckpt_lib.save(osp.join(save_dir, "yolo_last.ctd"), state, meta)
            if save_best:
                ckpt_lib.save(osp.join(save_dir, "yolo_best.ctd"), state, meta)
            ap_str = ""
            if hyp_train.get("eval_ap", True):
                ap = eval_detection_ap(state, val_loader, nc=nc)
                last_ap = ap
                names = ("eng", "ja")
                per = " ".join(
                    f"{names[c] if c < 2 else c}:{ap['ap50'][c]:.3f}(n={ap['n_gt'][c]})" for c in range(nc)
                )
                ap_str = f" mAP50 {ap['map50']:.3f} [{per}]"
            LOGGER.info(
                f"epoch {epoch}/{epochs-1} train loss: {m_loss:.4f} "
                f"val: loss {e['loss']:.4f} box {e['lbox']:.4f} obj {e['lobj']:.4f} cls {e['lcls']:.4f}" + ap_str
            )
        if max_steps is not None and total_steps >= max_steps:
            break

    return {"state": state, "best_loss": best_loss, "last_loss": m_loss, "steps": total_steps, "ap": last_ap}
