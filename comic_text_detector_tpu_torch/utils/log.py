"""Logging / observability.

Own copy of the JAX package's ``utils/log.py``.

Process-rank-aware stdlib logger + a pluggable epoch-metrics adapter
(reference utils/general.py:7-63's LOGGER/Loggers, minus the hard wandb
dependency: wandb/tensorboard attach only if importable, else metrics go to
the stdlib logger and an in-memory history the tests can assert on).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional


def set_logging(name: Optional[str] = None, verbose: bool = True) -> logging.Logger:
    rank = int(os.getenv("RANK", -1))
    logging.basicConfig(
        format="%(message)s", level=logging.INFO if (verbose and rank in (-1, 0)) else logging.WARNING
    )
    return logging.getLogger(name)


LOGGER = set_logging(__name__)


class Loggers:
    """Epoch-end metrics sink: wandb / tensorboard when present, stdlib +
    history always."""

    def __init__(self, hyp: Dict):
        cfg = hyp.get("logger", {}) or {}
        self.type = cfg.get("type", "")
        self.epochs = hyp.get("train", {}).get("epochs", 0)
        self.history: List[Dict] = []
        self.wandb = None
        self.writer = None
        if self.type == "wandb":
            try:
                import wandb

                project = cfg.get("project") or "ComicTextDetectorTPU"
                run_id = cfg.get("run_id") or None
                self.wandb = wandb.init(
                    project=project, config=hyp, resume="must" if run_id else "allow", id=run_id
                )
            except Exception:
                self.wandb = None
        elif self.type == "tb":
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(hyp.get("data", {}).get("save_dir", "runs"))
            except Exception:
                self.writer = None

    def on_train_batch_end(self, metrics: Dict) -> None:
        if self.wandb:
            self.wandb.log(metrics)

    def on_train_epoch_end(self, epoch: int, metrics: Dict) -> None:
        LOGGER.info(f"fin epoch {epoch}/{self.epochs}, metrics: {metrics}")
        self.history.append({"epoch": epoch, **metrics})
        if self.wandb:
            self.wandb.log(metrics)
        elif self.writer:
            for key, val in metrics.items():
                self.writer.add_scalar(key, val, epoch)
