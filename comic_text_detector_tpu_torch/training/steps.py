"""Train and eval steps of the trainers, and their optimizer.

Counterpart of the JAX package's ``training/steps.py`` (reference
basemodel.py:162-209, train_seg.py:120-153, train_db.py:130-166): for the
head trainers a frozen backbone, one trainable head, dice / DB losses; for
the block detector the whole YOLO graph in train mode under the v5 loss
(``training/yolo_loss.py``).  Where the JAX package
builds jitted step functions, the port's steps are plain functions over a
:class:`TrainState`; images arrive as (B, H, W, 3) uint8 (or float) NHWC
batches and are cast and scaled on their device.

The optimizer is :class:`Optimizer`, the optax chain the JAX package
builds, on ``torch.optim``:

* ``add_decayed_weights(wd)`` before ``adam(lr, b1=momentum, b2=0.999)``
  is coupled L2: ``torch.optim.Adam(betas=(momentum, 0.999),
  weight_decay=wd)``;
* ``sgd(lr, momentum, nesterov=True)`` is ``torch.optim.SGD(momentum,
  dampening=0, nesterov=True)``;
* a schedule is read at the count of updates applied before this one, as
  optax's ``scale_by_schedule`` reads it;
* ``MultiSteps(every_k_schedule=k)`` keeps the running mean of k
  mini-steps' gradients and applies the inner update every k-th call, the
  only calls that advance the inner count (and the schedule).

Each train step is a span of ``utils/profiling.py`` (``train``, one unit a
mini-step, with ``forward``, ``loss``, ``backward`` and ``update``).

Float32 convolutions run without TF32 and only through cuDNN's
deterministic algorithms, so that a step repeats bit for bit on the card.

Under a mesh (``mesh=``, one device a process, the processes joined by its
group) a train step takes the global batch and computes the JAX step of
the global batch, as the JAX package's jit over a batch sharded on the
``data`` axis does: each rank runs its contiguous block, the trainable
subnets' BatchNorms normalise with global statistics
(``ops/nn.py::BatchNorm2d``), the losses return the global values and
backpropagate each rank's share (``training/losses.py``), and the ranks'
parameter gradients are summed in one all-reduce before the optimizer
step.  A batch the ``data`` axis does not divide is computed whole on
every rank, with no collective and no gradient sum, as the JAX trainers
replicate it.  The eval steps take no mesh: the trainers evaluate on rank
0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from comic_text_detector_tpu_torch.models.detector import BlkDetTrain, TextDetTrain
from comic_text_detector_tpu_torch.ops import nn as tnn
from comic_text_detector_tpu_torch.parallel.collectives import sum_grads
from comic_text_detector_tpu_torch.parallel.mesh import Mesh, shard_batch
from comic_text_detector_tpu_torch.training import losses
from comic_text_detector_tpu_torch.training.yolo_loss import yolo_loss
from comic_text_detector_tpu_torch.utils.device import resolve_device
from comic_text_detector_tpu_torch.utils.profiling import new_unit, span

Schedule = Callable[[int], float]


class Optimizer:
    """adam or sgd (nesterov) with coupled weight decay, an optional
    learning-rate schedule and gradient accumulation, updating ``params``
    from their ``.grad`` (see the module docstring for the optax
    equivalence)."""

    def __init__(self, params, kind: str = "adam", lr: Union[float, Schedule] = 1e-3, momentum: float = 0.937,
                 weight_decay: float = 0.0, accumulation_steps: int = 1):
        self.params: List[torch.Tensor] = list(params)
        self.lr = lr
        self.accumulation_steps = int(accumulation_steps)
        if kind == "adam":
            self.inner = torch.optim.Adam(self.params, lr=self.lr_at(0), betas=(momentum, 0.999), eps=1e-8,
                                          weight_decay=weight_decay)
        elif kind == "sgd":
            self.inner = torch.optim.SGD(self.params, lr=self.lr_at(0), momentum=momentum, dampening=0.0,
                                         nesterov=True, weight_decay=weight_decay)
        else:
            raise ValueError(f"unknown optimizer {kind!r}: use 'adam' or 'sgd'")
        self.count = 0  # updates applied (optax's schedule count)
        self.mini_step = 0  # mini-steps accumulated since the last update
        self.acc: Optional[List[torch.Tensor]] = None

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> bool:
        """Take the gradients in the parameters' ``.grad``; returns whether
        the parameters were updated (every ``accumulation_steps``-th
        call)."""
        k = self.accumulation_steps
        if k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            for a, p in zip(self.acc, self.params):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                a.add_((g - a) / (self.mini_step + 1))
            if self.mini_step < k - 1:
                self.mini_step += 1
                return False
            for a, p in zip(self.acc, self.params):
                p.grad = a.clone()
                a.zero_()
            self.mini_step = 0
        for group in self.inner.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.inner.step()
        self.count += 1
        return True

    def state_dict(self) -> Dict:
        return {"inner": self.inner.state_dict(), "count": self.count, "mini_step": self.mini_step,
                "acc": None if self.acc is None else [a.detach().clone() for a in self.acc]}

    def load_state_dict(self, state: Dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        acc = state.get("acc")
        self.acc = None if acc is None else [a.to(p.device) for a, p in zip(acc, self.params)]


def build_optimizer(kind: str, lr0: float, momentum: float = 0.937, weight_decay: float = 0.0,
                    accumulation_steps: int = 1, schedule: Optional[Schedule] = None) -> Callable:
    """adam/sgd + optional LR factor schedule (``lr0 * schedule(count)``) +
    grad accumulation, the reference optimizer setup (train_seg.py:69-87).
    Returns a factory: call it with the trainable parameters (the train
    state constructors do)."""
    lr: Union[float, Schedule] = lr0 if schedule is None else (lambda count: lr0 * schedule(count))
    return functools.partial(Optimizer, kind=kind, lr=lr, momentum=momentum, weight_decay=weight_decay,
                             accumulation_steps=accumulation_steps)


def one_cycle(y1: float = 0.0, y2: float = 1.0, steps: int = 100) -> Schedule:
    """Cosine y1 -> y2 schedule factory (reference train_seg.py:28)."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


@dataclasses.dataclass
class TrainState:
    """The train-time model (its trainable submodules, named by
    ``trainable``, and the frozen rest), the optimizer over the trainable
    parameters, and the count of train steps taken."""

    model: nn.Module  # TextDetTrain or BlkDetTrain
    trainable: Tuple[str, ...]
    optimizer: Optimizer
    step: int = 0

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "trainable": list(self.trainable)}

    def load_state_dict(self, state: Dict) -> None:
        if tuple(state["trainable"]) != self.trainable:
            raise ValueError(f"checkpoint trains {state['trainable']}, this state {list(self.trainable)}")
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def _create_state(model: nn.Module, tx: Callable, trainable: Sequence[str]) -> TrainState:
    params = []
    for name, sub in model.named_children():
        sub.requires_grad_(name in trainable)
        if name in trainable:
            params += list(sub.parameters())
    return TrainState(model=model, trainable=tuple(trainable), optimizer=tx(params))


def create_seg_train_state(model: TextDetTrain, tx: Callable, train_backbone: bool = False) -> TrainState:
    """``train_backbone=True`` adds the backbone to the trainable set —
    pair with ``build_train_model(freeze_backbone=False)``."""
    if model.with_db:
        raise ValueError("seg training needs build_train_model(with_db=False)")
    return _create_state(model, tx, ("seg_net", "backbone") if train_backbone else ("seg_net",))


def create_db_train_state(model: TextDetTrain, tx: Callable) -> TrainState:
    if not model.with_db:
        raise ValueError("DB training needs build_train_model(with_db=True)")
    return _create_state(model, tx, ("dbnet",))


def create_yolo_train_state(model: BlkDetTrain, tx: Callable) -> TrainState:
    """Whole-graph detection training: backbone, neck and Detect."""
    return _create_state(model, tx, ("blk_det",))


def _as_float_img(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 (transfer-compact loaders) or float NHWC batch ->
    (B, 3, H, W) float32 in [0, 1]."""
    x = x.permute(0, 3, 1, 2)
    x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x.to(torch.float32)
    return x.contiguous()


def _as_float_mask(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _cudnn():
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)


def train_device(mesh: Optional[Mesh], device: Union[str, torch.device]) -> torch.device:
    """The device a trainer runs on: ``device``, or under a mesh the
    mesh's one device (a trainer drives one device a process)."""
    if mesh is None:
        return resolve_device(device)
    if len(mesh.devices) != 1:
        raise ValueError(f"a trainer drives one device a process, this mesh holds {len(mesh.devices)}: start one "
                         "process a device (parallel.mesh.spawn or torchrun) and pass make_mesh(group=...)")
    return mesh.devices[0]


@dataclasses.dataclass
class _Shard:
    """How a train step runs its batch: ``group`` is the mesh's process
    group when this rank holds a block of the batch, else ``None``."""

    mesh: Optional[Mesh]
    group: Optional[object]

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the global batch ``x``, on its device."""
        if self.mesh is None:
            return x
        if self.group is None:
            return x.to(self.mesh.devices[0])
        return shard_batch(self.mesh, x)[0]

    @property
    def loss_mesh(self) -> Optional[Mesh]:
        return None if self.group is None else self.mesh


@contextlib.contextmanager
def _sharded(state: TrainState, mesh: Optional[Mesh], n: int) -> Iterator[_Shard]:
    """Shard a global batch of ``n`` over the mesh when its ``data`` axis
    divides ``n``, with the trainable subnets' BatchNorms on the mesh's
    group for the step."""
    if mesh is None or mesh.group is None or n % mesh.shape["data"]:
        if mesh is not None and mesh.group is None and len(mesh.devices) != 1:
            raise ValueError("a train step drives one device a process")
        yield _Shard(mesh, None)
        return
    bns = [m for name in state.trainable for m in getattr(state.model, name).modules()
           if isinstance(m, tnn.BatchNorm2d)]
    for m in bns:
        m.group = mesh.group
    try:
        yield _Shard(mesh, mesh.group)
    finally:
        for m in bns:
            m.group = None


def _update(state: TrainState, loss: torch.Tensor, group=None) -> None:
    with span("backward"):
        state.optimizer.zero_grad()
        loss.backward()
    with span("update"):
        sum_grads(state.optimizer.params, group)
        state.optimizer.step()
    state.step += 1


def seg_train_step(state: TrainState, imgs: torch.Tensor, masks: torch.Tensor,
                   mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """U-Net mask training step: dice(pred, mask) on the trainable seg_net.
    Returns the loss as a device scalar (no host sync).  Under a ``mesh``,
    ``imgs`` and ``masks`` are the global batch (see the module
    docstring)."""
    state.model.train()
    with span("train", new_unit()), _sharded(state, mesh, imgs.shape[0]) as shard, _cudnn():
        with span("forward"):
            pred = state.model(_as_float_img(shard.take(imgs)))
        with span("loss"):
            loss = losses.binary_dice_loss(pred[:, 0], _as_float_mask(shard.take(masks)), mesh=shard.loss_mesh)
        _update(state, loss, shard.group)
    return {"loss": loss.detach()}


@torch.no_grad()
def seg_eval_step(state: TrainState, imgs: torch.Tensor, masks: torch.Tensor) -> Dict[str, torch.Tensor]:
    state.model.eval()
    masks = _as_float_mask(masks)
    with _cudnn():
        pred = state.model(_as_float_img(imgs))[:, 0]
    return {"tp": torch.sum(pred * masks), "gt": torch.sum(masks), "pr": torch.sum(pred),
            "loss": losses.binary_dice_loss(pred, masks)}


def db_train_step(state: TrainState, batch: Dict[str, torch.Tensor], use_bce: bool = True,
                  mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """DB head training step on the frozen backbone and U-Net trunk.
    ``batch``: imgs (B, H, W, 3), shrink_map, shrink_mask, threshold_map,
    threshold_mask (B, H, W).  Returns the loss terms as device scalars.
    Under a ``mesh``, ``batch`` is the global batch."""
    state.model.train()
    with span("train", new_unit()), _sharded(state, mesh, batch["imgs"].shape[0]) as shard, _cudnn():
        with span("forward"):
            batch = {k: shard.take(v) for k, v in batch.items()}
            pred = state.model(_as_float_img(batch["imgs"]))
        with span("loss"):
            metrics = losses.db_loss(pred, batch, use_bce=use_bce, mesh=shard.loss_mesh)
        _update(state, metrics["loss"], shard.group)
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def db_eval_step(state: TrainState, imgs: torch.Tensor) -> torch.Tensor:
    """-> (B, 2, H, W) shrink and threshold maps (eval mode)."""
    state.model.eval()
    with _cudnn():
        return state.model(_as_float_img(imgs))


def _yolo_loss(model: BlkDetTrain, raw, labels: torch.Tensor, label_mask: torch.Tensor,
               gains: Optional[Dict] = None, mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    g = gains or {}
    spec = model.spec
    return yolo_loss(raw, labels, label_mask, spec.anchors, spec.strides, spec.nc, box_gain=g.get("box", 0.05),
                     obj_gain=g.get("obj", 1.0), cls_gain=g.get("cls", 0.3), mesh=mesh)


def yolo_train_step(state: TrainState, imgs: torch.Tensor, labels: torch.Tensor, label_mask: torch.Tensor,
                    gains: Optional[Dict] = None, mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """Detection training step: the v5 loss over the raw Detect maps of the
    whole graph in train mode, with dense target assignment on the device.
    ``imgs`` (B, H, W, 3), ``labels`` (B, L, 5) [cls, x, y, w, h]
    normalized, ``label_mask`` (B, L); ``gains`` {'box', 'obj', 'cls'}
    (defaults 0.05, 1.0, 0.3).  Returns the loss terms as device scalars.
    Under a ``mesh`` the three arrays are the global batch."""
    state.model.train()
    with span("train", new_unit()), _sharded(state, mesh, imgs.shape[0]) as shard, _cudnn():
        with span("forward"):
            raw, _ = state.model(_as_float_img(shard.take(imgs)), decode=False)
        with span("loss"):
            metrics = _yolo_loss(state.model, raw, shard.take(labels), shard.take(label_mask), gains,
                                 shard.loss_mesh)
        _update(state, metrics["loss"], shard.group)
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def yolo_decode_step(state: TrainState, imgs: torch.Tensor) -> torch.Tensor:
    """-> (B, N, 5 + nc) decoded Detect rows (eval mode)."""
    state.model.eval()
    with _cudnn():
        return state.model(_as_float_img(imgs), decode=True)[0]


@torch.no_grad()
def yolo_eval_step(state: TrainState, imgs: torch.Tensor, labels: torch.Tensor, label_mask: torch.Tensor,
                   gains: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The same loss terms in eval mode (running BatchNorm statistics)."""
    state.model.eval()
    with _cudnn():
        raw, _ = state.model(_as_float_img(imgs), decode=False)
        return _yolo_loss(state.model, raw, labels, label_mask, gains)
