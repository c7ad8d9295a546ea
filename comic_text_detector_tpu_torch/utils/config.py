"""YAML hyp config of the trainers (reference data/train_hyp.yaml /
train_db_hyp.yaml: sections train, data, model, logger, resume): the
defaults, deep-merged overrides, and the effective config written at the
start of a run.

Own copy of the JAX package's ``utils/config.py``.  ``yaml`` is imported
inside the calls that read or write a file, so the package imports
without it.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional

SEG_DEFAULTS: Dict = {
    "data": {
        "train_img_dir": "dataset/train",
        "train_mask_dir": "",
        "val_img_dir": "dataset/val",
        "val_mask_dir": "",
        "imgsz": 1024,
        "augment": True,
        "cache": False,
        "save_dir": "data",
        "aug_param": {"hsv": 0.3, "mini_mosaic": 0.5, "flip_lr": 0.5, "neg": 0.3, "size_range": [0.7, 1]},
    },
    "train": {
        "epochs": 15,
        "linear_lr": False,
        "optimizer": "adam",
        "batch_size": 4,
        "lr0": 0.01,
        "lrf": 0.005,
        "momentum": 0.937,
        "weight_decay": 0.0005,
        "warmup_epochs": 3.0,
        "warmup_momentum": 0.8,
        "warmup_bias_lr": 0.1,
        "eval_interval": 1,
        "loss": "dice",
        "accumulation_steps": 1,
    },
    "model": {"weights": "", "act": "leaky"},
    "logger": {"type": "", "run_id": "", "project": ""},
    "resume": {"resume_training": False, "ckpt": ""},
}

DB_DEFAULTS: Dict = copy.deepcopy(SEG_DEFAULTS)
DB_DEFAULTS["data"]["aug_param"].update({"rotate": 0.33, "rotate_range": [-70, 70], "size_range": [0.85, 1.1]})
DB_DEFAULTS["data"]["num_workers"] = 8
DB_DEFAULTS["train"].update({"epochs": 160, "lrf": 0.002, "weight_decay": 2e-5, "loss": "bce", "warm_up": True,
                             "accumulation_steps": 4})
DB_DEFAULTS["model"].update({"unet_weights": "", "db_weights": ""})


def deep_merge(base: Dict, override: Optional[Dict]) -> Dict:
    """A copy of ``base`` with ``override`` merged in, dict by dict."""
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_hyp(path: Optional[str] = None, kind: str = "seg", overrides: Optional[Dict] = None) -> Dict:
    """The defaults of ``kind`` ("seg" or "db"), the YAML file at ``path``
    (where it exists) and ``overrides``, merged in that order."""
    base = SEG_DEFAULTS if kind == "seg" else DB_DEFAULTS
    loaded = {}
    if path and os.path.exists(path):
        import yaml

        with open(path, encoding="utf8") as f:
            loaded = yaml.safe_load(f.read()) or {}
    return deep_merge(deep_merge(base, loaded), overrides)


def dump_effective(hyp: Dict, path: str) -> None:
    """Write the effective config at the start of a run (reference
    train_seg.py:58-59 writes data/training_hyp.yaml)."""
    import yaml

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf8") as f:
        yaml.safe_dump(hyp, f)
