"""DB text-line-head trainer.

Counterpart of the JAX package's ``training/db_trainer.py`` (reference
train_db.py:59-198): the DB head trained on a frozen backbone and a frozen
U-Net trunk (upconv3/4 grafted from the trained U-Net,
basemodel.py:182-192), OHEM-BCE/dice losses, mid-epoch size re-jitter, and
an eval through ``SegDetectorRepresenter`` + ``QuadMetric``.  The eval's
DB decode runs on the model's device: on the card it launches K6 binarize
and K2 (``postproc/db_rep.py``).  As in the JAX package, the eval gates on
the epoch (the reference gated on the batch index, train_db.py:168).
Runs on ``device="cuda"`` unless the caller asks for ``device="cpu"``;
``mesh=`` trains data-parallel as ``training/seg_trainer.py`` sets out,
with the eval on rank 0.
"""

from __future__ import annotations

import copy
import functools
import os
import os.path as osp
import time
from datetime import datetime
from typing import Dict, Optional

import torch

from comic_text_detector_tpu_torch.data.db_dataset import create_dataloader
from comic_text_detector_tpu_torch.models.detector import build_train_model, init_variables
from comic_text_detector_tpu_torch.parallel.mesh import barrier, broadcast_module, from_rank0
from comic_text_detector_tpu_torch.postproc.db_rep import SegDetectorRepresenter
from comic_text_detector_tpu_torch.training import checkpoint as ckpt_lib
from comic_text_detector_tpu_torch.training.metrics import QuadMetric
from comic_text_detector_tpu_torch.training.seg_trainer import batch_uploader, build_model, make_lr_schedule, uploader
from comic_text_detector_tpu_torch.training.steps import (
    Optimizer,
    create_db_train_state,
    db_eval_step,
    db_train_step,
    train_device,
)
from comic_text_detector_tpu_torch.utils.log import LOGGER, Loggers
from comic_text_detector_tpu_torch.weights import variables_from_state_dict

_BATCH_KEYS = ("imgs", "shrink_map", "shrink_mask", "threshold_map", "threshold_mask")


def graft_db_variables(variables: Dict, unet_variables: Dict) -> Dict:
    """Initialize DBHead's upconv3/upconv4 from a trained UnetHead
    (reference TextDetector.initialize_db, basemodel.py:182-192), and
    refresh the frozen trunk (down_conv1, upconv0, upconv2) from it.

    ``variables`` — JAX-layout ``TextDetTrain`` variables holding 'dbnet';
    ``unet_variables`` — variables whose 'seg_net' holds the trained U-Net
    (MASK layout, so upconv3/4 exist).  Returns a copy."""
    params = dict(variables["params"])
    stats = dict(variables.get("batch_stats", {}))
    seg_p = unet_variables["params"]["seg_net"]
    seg_s = unet_variables["batch_stats"]["seg_net"]
    db_p = dict(params["dbnet"])
    db_s = dict(stats.get("dbnet", {}))
    for key in ("upconv3", "upconv4"):
        db_p[key] = copy.deepcopy(seg_p[key])
        db_s[key] = copy.deepcopy(seg_s[key])
    params["dbnet"] = db_p
    stats["dbnet"] = db_s
    trunk_p = dict(params["seg_net"])
    trunk_s = dict(stats["seg_net"])
    for key in ("down_conv1", "upconv0", "upconv2"):
        trunk_p[key] = copy.deepcopy(seg_p[key])
        trunk_s[key] = copy.deepcopy(seg_s[key])
    params["seg_net"] = trunk_p
    stats["seg_net"] = trunk_s
    return {"params": params, "batch_stats": stats}


def eval_model(state, val_loader, post_process, metric_cls, box_thresh: float = 0.6):
    """Recall, precision and F-measure of the DB head on ``val_loader``:
    the eval maps stay on the model's device for ``post_process``."""
    put = uploader(next(state.model.parameters()).device)
    raw_metrics = []
    total_frame = 0.0
    total_time = 0.0
    for batch in val_loader:
        start = time.time()
        preds = db_eval_step(state, put(batch["imgs"]))
        boxes, scores = post_process(batch, preds)
        total_frame += preds.shape[0]
        total_time += time.time() - start
        raw_metrics.append(metric_cls.validate_measure(batch, (boxes, scores), box_thresh))
    metrics = metric_cls.gather_measure(raw_metrics)
    if total_time > 0:
        LOGGER.info("FPS:{}".format(total_frame / total_time))
    return metrics["recall"].avg, metrics["precision"].avg, metrics["fmeasure"].avg


def train(hyp: Dict, variables=None, unet_variables=None, max_steps: Optional[int] = None, mesh=None,
          device: str = "cuda") -> Dict:
    """Run DB training from a hyp dict.  ``variables`` (JAX-layout DB train
    variables) and ``unet_variables`` (a trained U-Net's, grafted in) as in
    the JAX package; ``mesh`` (``parallel.mesh.make_mesh(group=...)``)
    trains data-parallel, one process a device."""
    dev = train_device(mesh, device)
    main = mesh is None or mesh.rank == 0
    hyp_train, hyp_data = hyp["train"], hyp["data"]
    hyp_model = hyp.get("model", {})
    save_dir = hyp_data.get("save_dir", "data")
    os.makedirs(save_dir, exist_ok=True)
    epochs = hyp_train["epochs"]
    batch_size = hyp_train["batch_size"]
    use_bce = hyp_train.get("loss", "bce") == "bce"
    act = hyp_model.get("act", "leaky")

    if variables is None:
        variables = variables_from_state_dict(
            init_variables(build_train_model(act=act, with_db=True), torch.Generator().manual_seed(0)).state_dict())
    if unet_variables is not None:
        variables = graft_db_variables(variables, unet_variables)
    model = build_model(variables, act, with_db=True).to(dev)
    broadcast_module(mesh, model)  # every rank starts from rank 0's weights
    imgsz = hyp_data["imgsz"]

    train_dataset, train_loader = create_dataloader(
        hyp_data["train_img_dir"], hyp_data.get("train_mask_dir", ""), imgsz, batch_size,
        hyp_data.get("augment", False), hyp_data.get("aug_param"), shuffle=True,
        cache=hyp_data.get("cache", False), as_uint8=True,
    )
    val_dataset, val_loader = create_dataloader(
        hyp_data["val_img_dir"], hyp_data.get("val_mask_dir", ""), imgsz, batch_size, augment=False,
        shuffle=False, cache=hyp_data.get("cache", False), as_uint8=True, with_ann=True,
    )
    if hyp_data.get("cache_prepared"):
        train_dataset.enable_prepared_cache(disk_dir=hyp_data.get("prepared_cache_dir"))
    nb = len(train_loader)
    LOGGER.info(f"num training imgs: {len(train_dataset)}, num val imgs: {len(val_dataset)}")

    # adam's b1 is 0.937 whatever hyp's momentum, as in the JAX package
    adam = hyp_train.get("optimizer", "adam") == "adam"
    tx = functools.partial(
        Optimizer, kind="adam" if adam else "sgd", lr=make_lr_schedule(hyp_train, nb),
        momentum=0.937 if adam else hyp_train.get("momentum", 0.937),
        weight_decay=hyp_train.get("weight_decay", 0.0), accumulation_steps=hyp_train.get("accumulation_steps", 1),
    )
    state = create_db_train_state(model, tx)
    start_epoch = 0
    best_f1 = -1.0
    logger = Loggers(hyp) if main and hyp.get("logger", {}).get("type") else None

    resume = hyp.get("resume", {})
    if resume.get("resume_training"):
        payload = ckpt_lib.restore(resume["ckpt"], state)
        start_epoch = payload["meta"].get("epoch", -1) + 1
        best_f1 = payload["meta"].get("best_f1", -1.0)

    put = batch_uploader(mesh, dev)
    metric_cls = QuadMetric()
    post_process = SegDetectorRepresenter(thresh=0.5, device=str(dev))
    eval_interval = hyp_train.get("eval_interval", 1)
    total_steps = 0
    keys = ("loss", "loss_shrink_maps", "loss_threshold_maps", "loss_binary_maps")
    means = {k: 0.0 for k in keys}

    for epoch in range(start_epoch, epochs):
        epoch_metrics = {k: [] for k in keys}  # device scalars, read once an epoch
        for i, batch in enumerate(train_loader):
            if (i + 2) % 256 == 0:
                train_dataset.initialize()
            metrics = db_train_step(state, {k: put(v) for k, v in batch.items() if k in _BATCH_KEYS}, use_bce, mesh)
            for k in keys:
                epoch_metrics[k].append(metrics[k])
            total_steps += 1
            if max_steps is not None and total_steps >= max_steps:
                break
        if epoch_metrics["loss"]:
            got = torch.stack([torch.stack(epoch_metrics[k]).mean() for k in keys]).tolist()
            means = dict(zip(keys, got))

        if (epoch + 1) % eval_interval == 0 or epoch == epochs - 1 or (max_steps and total_steps >= max_steps):
            recall, precision, fmeasure = from_rank0(
                mesh, lambda: eval_model(state, val_loader, post_process, metric_cls), 3)
            save_best = best_f1 < fmeasure
            if save_best:
                best_f1 = fmeasure
            # db_last carries the UPDATED best_f1: resumed runs restore it,
            # and a stale value would let a worse epoch overwrite db_best
            meta = {"epoch": epoch, "best_f1": best_f1, "date": datetime.now().isoformat()}
            if main:
                ckpt_lib.save(osp.join(save_dir, "db_last.ctd"), state, meta)
                if save_best:
                    ckpt_lib.save(osp.join(save_dir, "db_best.ctd"), state, {**meta, "best_f1": best_f1})
            barrier(mesh)
            LOGGER.info(f"epoch {epoch}: loss {means['loss']:.4f} P {precision:.4f} R {recall:.4f} F1 {fmeasure:.4f}")
            if logger is not None:
                logger.on_train_epoch_end(epoch, {
                    "train/loss": means["loss"], "train/loss_shrink": means["loss_shrink_maps"],
                    "train/loss_threshold": means["loss_threshold_maps"],
                    "train/loss_binary_maps": means["loss_binary_maps"],
                    "eval/recall": recall, "eval/precision": precision, "eval/f1": fmeasure,
                })
        if max_steps is not None and total_steps >= max_steps:
            break

    return {"state": state, "best_f1": best_f1, "steps": total_steps, "last_metrics": means}
