"""Checkpoint save/restore.

Counterpart of the JAX package's ``training/checkpoint.py``.  ``save`` /
``restore`` keep the reference's checkpoint payload (train_seg.py:158-171)
as ``torch.save`` of the train state — the model, the optimizer state and
the step — beside the same JSON-able ``.meta.json`` (epoch, best_f1, date,
hyp) that the trainers read to resume.  ``save_compact`` /
``load_compact`` write and read the JAX package's template-free npz
(nested variable dicts flattened to '/'-joined keys, float16 below 0.9 of
float16's max), so a deploy tree the port trains loads in the JAX
package's ``load_compact`` and in the port's ``weights.load_npz``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from comic_text_detector_tpu_torch.weights import load_npz


def save(path: str, state: Any, meta: Dict) -> None:
    torch.save(state.state_dict(), path)
    with open(path + ".meta.json", "w") as f:
        json.dump(_jsonable(meta), f)


def restore(path: str, state: Any) -> Dict:
    """Load ``path`` into ``state`` (in place, on its devices); returns
    ``{'state': state, 'meta': meta}``."""
    device = next(state.model.parameters()).device
    state.load_state_dict(torch.load(path, map_location=device, weights_only=True))
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return {"state": state, "meta": meta}


def _jsonable(obj):
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        if isinstance(obj, dict):
            return {k: _jsonable(v) for k, v in obj.items()}
        return str(obj)


def save_compact(path: str, variables: Any, dtype="float16") -> None:
    """Nested dict of arrays (numpy or tensors) -> compressed npz; float
    arrays stored as ``dtype`` unless their range passes 0.9 of float16's
    max (large BatchNorm running variances stay exact)."""
    flat: Dict[str, np.ndarray] = {}
    f16_max = np.finfo(np.float16).max

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            arr = node.detach().cpu().numpy() if isinstance(node, torch.Tensor) else np.asarray(node)
            if arr.dtype.kind == "f" and np.abs(arr).max(initial=0.0) < 0.9 * f16_max:
                arr = arr.astype(dtype)
            flat[prefix] = arr

    walk(variables, "")
    with open(path, "wb") as f:
        np.savez_compressed(f, **flat)


def load_compact(path: str) -> Dict:
    return load_npz(path)
