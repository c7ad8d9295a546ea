"""The reference's DB training step: the DB head trained on the frozen
backbone and U-Net trunk (eval mode, no gradient), the DB head in train
mode, ``losses.db_loss``, and Adam with coupled weight decay, betas
(0.937, 0.999), eps 1e-8, over the running mean of ``accumulation`` mini-
steps' gradients, at the reference's learning-rate rule (linear warm-up
over max(3 nb, 700) updates of the cosine one-cycle factor, read at the
count of updates before each).  Adam is written out here (torch.optim's
formula: the step lr / (1 - b1^t) times m / (sqrt(v) / sqrt(1 - b2^t) +
eps)).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from ctd_bench.reference.losses import db_loss

LOSS_KEYS = ("loss", "loss_shrink_maps", "loss_threshold_maps", "loss_binary_maps")


def lr_schedule(hyp_train: Dict, nb: int):
    epochs = hyp_train["epochs"]
    lr0, lrf = hyp_train["lr0"], hyp_train["lrf"]

    def lf(e):
        if hyp_train.get("linear_lr", False):
            return (1 - e / max(epochs - 1, 1)) * (1.0 - lrf) + lrf
        return ((1 - math.cos(e * math.pi / epochs)) / 2) * (lrf - 1.0) + 1.0

    nw = max(max(round(3 * nb), 700), 1) if hyp_train.get("warmup_steps") is None else max(
        int(hyp_train["warmup_steps"]), 1)

    def schedule(count: int) -> float:
        base = lr0 * lf(count // max(nb, 1))
        return min(count / nw, 1.0) * base if count <= nw else base

    return schedule


class DBTrainer:
    """One DB training run of the reference: ``mini_step(batch)`` returns
    the loss terms; ``params`` are the DB head's parameters by name."""

    def __init__(self, model: torch.nn.Module, hyp_train: Dict, nb: int):
        self.model = model
        self.params = {n: p for n, p in model.dbnet.named_parameters()}
        for n, p in model.named_parameters():
            p.requires_grad_(n.startswith("dbnet."))
        self.k = int(hyp_train.get("accumulation_steps", 1))
        self.wd = float(hyp_train.get("weight_decay", 0.0))
        self.b1, self.b2, self.eps = 0.937, 0.999, 1e-8
        self.lr = lr_schedule(hyp_train, nb)
        self.acc = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.mini = 0
        self.count = 0
        self.first_grad: Dict[str, torch.Tensor] = {}

    def mini_step(self, batch: Dict[str, torch.Tensor]) -> List[float]:
        self.model.train()
        self.model.backbone.eval()
        self.model.seg_net.eval()
        x = batch["imgs"].permute(0, 3, 1, 2).to(torch.float32) / 255.0
        for p in self.params.values():
            p.grad = None
        pred = self.model(x.contiguous())
        terms = db_loss(pred, {k: v.float() for k, v in batch.items() if k != "imgs"})
        terms["loss"].backward()
        with torch.no_grad():
            for n, p in self.params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                self.acc[n].add_((g - self.acc[n]) / (self.mini + 1))
            self.mini += 1
            if self.mini == self.k:
                self._update()
                self.mini = 0
        return [float(terms[k]) for k in LOSS_KEYS]

    @torch.no_grad()
    def _update(self) -> None:
        lr = self.lr(self.count)
        t = self.count + 1
        bc1, bc2 = 1 - self.b1**t, 1 - self.b2**t
        for n, p in self.params.items():
            g = self.acc[n] + self.wd * p
            if self.count == 0:
                self.first_grad[n] = g.clone()
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[n].sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-lr / bc1)
            self.acc[n].zero_()
        self.count += 1
