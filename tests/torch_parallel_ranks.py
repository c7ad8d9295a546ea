"""Rank functions for ``tests/test_torch_parallel.py``.

Each runs in a process of its own, started by
``comic_text_detector_tpu_torch.parallel.mesh.spawn`` with a one-device
mesh and the launched gloo group, and imports nothing of JAX (the spawned
interpreter imports this module by name).  The ranks that compute run on
one torch thread each, so that the ranks of a test share the CPU.  Inputs arrive as the global
batch in NumPy; each rank takes its contiguous block, and returns NumPy
results that the test compares with the one-process function on the
global batch.
"""

import os
import time

import torch
import torch.distributed as dist

from comic_text_detector_tpu_torch.models.detector import build_blk_train_model, build_train_model
from comic_text_detector_tpu_torch.ops import nn as tnn
from comic_text_detector_tpu_torch.parallel.mesh import shard_batch
from comic_text_detector_tpu_torch.training import db_trainer, losses, seg_trainer, yolo_trainer
from comic_text_detector_tpu_torch.training.steps import (
    build_optimizer,
    create_db_train_state,
    create_seg_train_state,
    create_yolo_train_state,
    db_train_step,
    seg_train_step,
    yolo_train_step,
)
from comic_text_detector_tpu_torch.training.yolo_loss import yolo_loss
from comic_text_detector_tpu_torch.weights import (
    blk_train_from_deploy,
    load_npz,
    train_from_deploy,
    train_state_dict_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
DB_KEYS = ("shrink_map", "shrink_mask", "threshold_map", "threshold_mask")
YOLO_ANCHORS = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119), (116, 90, 156, 198, 373, 326))
YOLO_STRIDES = (8, 16, 32)
GAINS = {"box": 0.05, "obj": 1.0, "cls": 0.3}


def loss_case(name, t, mesh=None):
    """Loss ``name`` on the tensors ``t`` (a dict; float inputs that take a
    gradient already require it) -> the scalar the step backpropagates."""
    if name == "binary_dice":
        return losses.binary_dice_loss(t["pred"], t["target"], mesh=mesh)
    if name.startswith("balance_bce"):
        return losses.balance_bce_loss(t["logits"], t["gt"], t["mask"], mesh=mesh)
    if name == "dice":
        return losses.dice_loss(t["pred"], t["gt"], t["mask"], mesh=mesh)
    if name == "mask_l1":
        return losses.mask_l1_loss(t["pred"], t["gt"], t["mask"], mesh=mesh)
    if name.startswith("db_loss"):
        return losses.db_loss(t["pred"], t, use_bce=name.endswith("bce"), mesh=mesh)["loss"]
    if name == "yolo":
        raw = [t["p0"], t["p1"], t["p2"]]
        out = yolo_loss(raw, t["labels"], t["label_mask"], YOLO_ANCHORS, YOLO_STRIDES, 2, mesh=mesh, **{
            f"{k}_gain": v for k, v in GAINS.items()})
        return torch.stack([out["loss"], out["lbox"], out["lobj"], out["lcls"]])
    if name == "batchnorm":
        bn = tnn.BatchNorm2d(t["x"].shape[1], eps=1e-3, momentum=0.03)
        with torch.no_grad():
            bn.weight.copy_(t["weight"])
            bn.bias.copy_(t["bias"])
            bn.running_var.copy_(t["running_var"])
        bn.train()
        bn.group = None if mesh is None else mesh.group
        y = bn(t["x"])
        return torch.sum(y * t["w_out"]), y, bn
    raise ValueError(name)


def run_loss(name, arrays, grad_keys, mesh=None):
    """One loss forward and backward -> (value(s), {key: input gradient},
    extras): on the global batch without ``mesh``, on this rank's block
    with it (the gradients then this rank's block)."""
    t = {}
    for k, v in arrays.items():
        x = torch.from_numpy(v)
        if mesh is not None and k not in ("weight", "bias", "running_var"):
            x = shard_batch(mesh, x)[0]
        t[k] = x.requires_grad_(k in grad_keys)
    extras = {}
    if name == "batchnorm":
        out, y, bn = loss_case(name, t, mesh)
        extras = {"y": y.detach().numpy(), "running_mean": bn.running_mean.numpy().copy(),
                  "running_var": bn.running_var.numpy().copy()}
        out.backward()
    else:
        out = loss_case(name, t, mesh)
        (out[0] if out.ndim else out).backward()
    return out.detach().numpy(), {k: t[k].grad.numpy() for k in grad_keys}, extras


def losses_rank(mesh, cases):
    """Every loss case on this rank's block: {name: run_loss(...)}."""
    torch.set_num_threads(1)
    return {name: run_loss(name, arrays, grad_keys, mesh) for name, (arrays, grad_keys) in cases.items()}


def seg_state():
    deploy = load_npz(WEIGHTS)
    model = build_train_model()
    model.load_state_dict(train_state_dict_from_jax(train_from_deploy(deploy)), strict=True)
    return create_seg_train_state(model, build_optimizer("adam", 1e-3, momentum=0.9, weight_decay=5e-4))


def db_state():
    deploy = load_npz(WEIGHTS)
    model = build_train_model(with_db=True)
    model.load_state_dict(train_state_dict_from_jax(train_from_deploy(deploy, with_db=True)), strict=True)
    return create_db_train_state(model, build_optimizer("sgd", 1e-3))


def yolo_state():
    deploy = load_npz(WEIGHTS)
    model = build_blk_train_model()
    sd = train_state_dict_from_jax(blk_train_from_deploy(deploy))
    sd.update((k, v) for k, v in model.state_dict().items() if k.endswith(".anchors"))
    model.load_state_dict(sd, strict=True)
    return create_yolo_train_state(model, build_optimizer("adam", 1e-3, momentum=0.9, weight_decay=5e-4))


STATES = {"seg": seg_state, "db": db_state, "yolo": yolo_state}


def run_step(kind, batch, mesh=None):
    """One train step of ``kind`` from the flagship weights on the global
    ``batch`` -> (metrics, {trainable parameter: gradient}, {buffer:
    value}, {trainable parameter: value after the step})."""
    state = STATES[kind]()
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    if kind == "seg":
        metrics = seg_train_step(state, t["imgs"], t["masks"], mesh=mesh)
    elif kind == "db":
        metrics = db_train_step(state, {k: t[k] for k in ("imgs",) + DB_KEYS}, use_bce=True, mesh=mesh)
    else:
        metrics = yolo_train_step(state, t["imgs"], t["labels"], t["label_mask"], GAINS, mesh=mesh)
    trained = {n for name in state.trainable for n, _ in getattr(state.model, name).named_parameters(prefix=name)}
    params = {k: p for k, p in state.model.named_parameters() if k in trained}
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.numpy().copy() for k, p in params.items() if p.grad is not None},
            {k: b.numpy().copy() for k, b in state.model.named_buffers() if "running" in k},
            {k: p.detach().numpy().copy() for k, p in params.items()})


def steps_rank(mesh, batches):
    """Each step kind on its global batch under the mesh: {name:
    run_step(...)}; ``batches`` maps a name to (kind, batch)."""
    torch.set_num_threads(1)
    return {name: run_step(kind, batch, mesh) for name, (kind, batch) in batches.items()}


def failing_rank(mesh):
    """Rank 1 raises at once; rank 0 waits in a sum over the ranks that
    rank 1 never joins."""
    if mesh.rank == 1:
        raise ValueError("rank 1 failed on purpose")
    dist.all_reduce(torch.zeros(1), group=mesh.group)
    return "rank 0 should not get here"


def sleeping_rank(mesh, seconds):
    """Sleeps ``seconds``, far past the deadline the test sets."""
    time.sleep(seconds)


def trainers_rank(mesh, hyps):
    """``seg_trainer``, ``db_trainer`` and ``yolo_trainer``'s ``train``
    under the mesh, from the flagship weights -> per trainer (summary,
    {parameter: value}, files in its save_dir)."""
    torch.set_num_threads(1)
    return {kind: train_summary(kind, hyp, mesh) for kind, hyp in hyps.items()}


def train_summary(kind, hyp, mesh=None):
    """``train`` of trainer ``kind`` for 2 steps from the flagship weights
    -> (summary, {trainable parameter: value}, files in its save_dir)."""
    deploy = load_npz(WEIGHTS)
    if kind == "seg":
        out = seg_trainer.train(hyp, variables=train_from_deploy(deploy), max_steps=2, mesh=mesh, device="cpu")
        summary = {"loss": out["last_loss"], "best": out["best_f1"]}
    elif kind == "db":
        out = db_trainer.train(hyp, variables=train_from_deploy(deploy, with_db=True), max_steps=2, mesh=mesh,
                               device="cpu")
        summary = {"loss": out["last_metrics"]["loss"], "best": out["best_f1"]}
    else:
        out = yolo_trainer.train(hyp, variables=blk_train_from_deploy(deploy), max_steps=2, mesh=mesh,
                                 device="cpu")
        summary = {"loss": out["last_loss"], "best": out["best_loss"], "map50": out["ap"]["map50"]}
    summary["steps"] = out["steps"]
    params = {k: p.detach().numpy().copy() for k, p in out["state"].model.named_parameters() if p.requires_grad}
    return summary, params, sorted(os.listdir(hyp["data"]["save_dir"]))

