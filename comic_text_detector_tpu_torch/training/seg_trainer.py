"""U-Net mask-head trainer.

Counterpart of the JAX package's ``training/seg_trainer.py`` (reference
train_seg.py:57-183): frozen-backbone dice training with warmup +
cosine/linear LR, gradient accumulation, periodic pixel-P/R/F1 eval,
best/last checkpointing and pluggable logging, on ``torch.optim`` and the
port's train steps (``training/steps.py``).  Runs on ``device="cuda"``
unless the caller asks for ``device="cpu"``.

Data parallel under ``mesh=`` (the three trainers alike): each process
calls ``train`` on its mesh's one device.  Every rank runs the
one-process loader (same seed, so the same global batches and augments)
and its train step takes the rank's contiguous block of each global
batch; ``nb`` and the learning-rate schedule stay the global ones.  The
parameters and buffers start from rank 0's; rank 0 alone runs the evals
over the whole val set and broadcasts their numbers, so every rank takes
the same best-checkpoint decision, and rank 0 alone writes the
checkpoints, behind a barrier.
"""

from __future__ import annotations

import functools
import math
import os
import os.path as osp
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch

from comic_text_detector_tpu_torch.data.seg_dataset import create_dataloader
from comic_text_detector_tpu_torch.models.detector import build_train_model, init_variables
from comic_text_detector_tpu_torch.parallel.mesh import barrier, broadcast_module, from_rank0
from comic_text_detector_tpu_torch.training import checkpoint as ckpt_lib
from comic_text_detector_tpu_torch.training.metrics import pixel_prf1
from comic_text_detector_tpu_torch.training.steps import (
    Optimizer,
    create_seg_train_state,
    seg_eval_step,
    seg_train_step,
    train_device,
)
from comic_text_detector_tpu_torch.utils.log import LOGGER, Loggers
from comic_text_detector_tpu_torch.weights import train_state_dict_from_jax


def make_lr_schedule(hyp_train: Dict, nb: int):
    """Reference LR rule: warmup interp over nw steps, then lr0·lf(epoch).

    ``schedule_epochs`` (default: ``epochs``) pins the decay horizon when a
    long schedule runs as several shorter resumed processes.
    ``warmup_steps`` overrides the reference warmup floor ``max(3*nb, 700)``
    (train.py:156), which a short fine-tune never leaves; 0 disables
    warmup.  The JAX package evaluates the rule in float32, the port in
    float64."""
    epochs = hyp_train.get("schedule_epochs", hyp_train["epochs"])
    lr0 = hyp_train["lr0"]
    lrf = hyp_train["lrf"]
    if hyp_train.get("linear_lr", False):
        lf = lambda e: (1 - e / max(epochs - 1, 1)) * (1.0 - lrf) + lrf  # noqa: E731
    else:
        lf = lambda e: ((1 - math.cos(e * math.pi / epochs)) / 2) * (lrf - 1.0) + 1.0  # noqa: E731
    nw = hyp_train.get("warmup_steps")
    if nw is None:
        nw = max(round(3 * nb), 700)
    nw = max(int(nw), 1)

    def schedule(step: int) -> float:
        base = lr0 * lf(step // max(nb, 1))
        return min(step / nw, 1.0) * base if step <= nw else base

    return schedule


def build_model(variables, act: str, with_db: bool, freeze_backbone: bool = True):
    """The train-time model from JAX-layout ``variables`` (nested numpy
    dicts), or drawn with the JAX package's initializers from seed 0."""
    model = build_train_model(act=act, with_db=with_db, freeze_backbone=freeze_backbone)
    if variables is None:
        init_variables(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(train_state_dict_from_jax(variables), strict=True)
    return model


def uploader(device: torch.device):
    return lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device, non_blocking=True)


def batch_uploader(mesh, device: torch.device):
    """Upload of a global train batch: to ``device``, or under a mesh kept
    on the host, whence each rank's train step moves its block."""
    return uploader(device if mesh is None else torch.device("cpu"))


def train(hyp: Dict, variables=None, max_steps: Optional[int] = None, mesh=None, device: str = "cuda") -> Dict:
    """Run seg training from a hyp dict (reference data/train_hyp.yaml shape).

    ``variables`` injects model variables in the JAX package's layout
    (``weights.train_from_deploy`` makes them from a deploy checkpoint);
    otherwise the model is randomly initialized.  ``max_steps`` bounds the
    total train steps.  ``mesh`` (``parallel.mesh.make_mesh(group=...)``)
    trains data-parallel, one process a device (see the module docstring).
    Returns a summary dict."""
    dev = train_device(mesh, device)
    main = mesh is None or mesh.rank == 0
    hyp_train, hyp_data = hyp["train"], hyp["data"]
    hyp_model = hyp.get("model", {})
    save_dir = hyp_data.get("save_dir", "data")
    os.makedirs(save_dir, exist_ok=True)
    epochs = hyp_train["epochs"]
    batch_size = hyp_train["batch_size"]

    train_backbone = bool(hyp_train.get("train_backbone", False))
    model = build_model(variables, hyp_model.get("act", "leaky"), with_db=False,
                        freeze_backbone=not train_backbone).to(dev)
    broadcast_module(mesh, model)  # every rank starts from rank 0's weights
    imgsz = hyp_data["imgsz"]

    train_dataset, train_loader = create_dataloader(
        hyp_data["train_img_dir"], hyp_data.get("train_mask_dir", ""), imgsz, batch_size,
        hyp_data.get("augment", False), hyp_data.get("aug_param"), shuffle=True,
        cache=hyp_data.get("cache", False), as_uint8=True,
    )
    val_dataset, val_loader = create_dataloader(
        hyp_data["val_img_dir"], hyp_data.get("val_mask_dir", ""), imgsz, min(4, batch_size),
        augment=False, shuffle=False, cache=hyp_data.get("cache", False), as_uint8=True,
    )
    nb = len(train_loader)
    LOGGER.info(f"num training imgs: {len(train_dataset)}, num val imgs: {len(val_dataset)}")

    tx = functools.partial(
        Optimizer, kind="adam" if hyp_train.get("optimizer", "adam") == "adam" else "sgd",
        lr=make_lr_schedule(hyp_train, nb), momentum=hyp_train.get("momentum", 0.937),
        weight_decay=hyp_train.get("weight_decay", 0.0), accumulation_steps=hyp_train.get("accumulation_steps", 1),
    )
    state = create_seg_train_state(model, tx, train_backbone=train_backbone)
    start_epoch = 0
    best_f1 = -1.0
    logger = Loggers(hyp) if main and hyp.get("logger", {}).get("type") else None

    resume = hyp.get("resume", {})
    if resume.get("resume_training"):
        payload = ckpt_lib.restore(resume["ckpt"], state)
        start_epoch = payload["meta"].get("epoch", -1) + 1
        best_f1 = payload["meta"].get("best_f1", -1.0)
        LOGGER.info(f"resumed from {resume['ckpt']} at epoch {start_epoch}")

    put = uploader(dev)
    put_batch = batch_uploader(mesh, dev)
    eval_interval = hyp_train.get("eval_interval", 1)
    total_steps = 0
    m_loss = 0.0

    for epoch in range(start_epoch, epochs):
        train_dataset.initialize()
        losses = []  # device scalars, read once an epoch
        for imgs, masks in train_loader:
            losses.append(seg_train_step(state, put_batch(imgs), put_batch(masks), mesh)["loss"])
            total_steps += 1
            if max_steps is not None and total_steps >= max_steps:
                break
        m_loss = float(torch.stack(losses).mean()) if losses else 0.0

        if (epoch + 1) % eval_interval == 0 or (max_steps and total_steps >= max_steps):

            def evaluate():
                sums = torch.zeros(5, dtype=torch.float64, device=dev)  # tp, gt, pr, loss, batches
                for imgs, masks in val_loader:
                    m = seg_eval_step(state, put(imgs), put(masks))
                    sums[:4] += torch.stack([m["tp"], m["gt"], m["pr"], m["loss"]]).double()
                    sums[4] += 1
                return sums.tolist()

            tp, gt, pr, e_loss, n_batches = from_rank0(mesh, evaluate, 5)
            recall, precision, f1 = pixel_prf1(tp, gt, pr)
            save_best = best_f1 < f1
            if save_best:
                best_f1 = f1
            # unet_last carries the UPDATED best_f1 so resumed runs can't
            # overwrite unet_best with a worse epoch
            meta = {"epoch": epoch, "best_f1": best_f1, "date": datetime.now().isoformat(), "hyp": None}
            if main:
                ckpt_lib.save(osp.join(save_dir, "unet_last.ctd"), state, meta)
                if save_best:
                    LOGGER.info(f"saving model at epoch {epoch}, best val f1: {best_f1}")
                    ckpt_lib.save(osp.join(save_dir, "unet_best.ctd"), state, {**meta, "best_f1": best_f1})
            barrier(mesh)
            LOGGER.info(f"epoch {epoch}/{epochs-1} loss: {m_loss:.4f} precision: {precision:.4f} recall: {recall:.4f}")
            if logger is not None:
                logger.on_train_epoch_end(epoch, {
                    "train/loss": m_loss, "eval/recall": recall, "eval/precision": precision, "eval/f1": f1,
                    "eval/loss": e_loss / max(n_batches, 1),
                })
        if max_steps is not None and total_steps >= max_steps:
            break

    return {"state": state, "best_f1": best_f1, "last_loss": m_loss, "steps": total_steps}
