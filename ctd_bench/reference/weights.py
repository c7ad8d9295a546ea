"""Weight reading for the plain reference: the compact ``.npz`` checkpoint
(flax paths joined with ``/``) into nested float32 NumPy dicts, and the
JAX-layout trees into torch state dicts of the reference's modules.

Frozen copy of the port's ``weights.py`` readers (``load_npz``,
``export_state_dict``, ``state_dict_from_jax``, ``train_from_deploy``,
``train_state_dict_from_jax``): the reference derives its own weights from
the raw file and takes nothing the program has made.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ctd_bench.reference.config import OUT_INDICES, YOLOV5S_CFG, parse_graph

SUBNETS = ("blk_det", "text_seg", "text_det")

# torch ConvTranspose2d weights inside the heads (reference basemodel.py:26,
# :57, :99-102, :138-141); every other 4-D weight is a regular conv
_CONVT_RE = re.compile(
    r"(^|\.)((upconv\d+\.conv\.1)|(upconv6\.0)|(binarize\.[36])|(thresh\.[36]))\.weight$"
)
_SEQ_PARENTS = ("conv", "binarize", "thresh", "shortcut")


def load_npz(path: str) -> Dict:
    """Compact ``.npz`` checkpoint -> nested dict of float32 numpy arrays."""
    out: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            arr = data[key]
            if arr.dtype.kind == "f":
                arr = arr.astype(np.float32)
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return out


def _torch_path(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """flax module path -> torch module path."""
    out = []
    for t in path:
        prev = out[-1] if out else None
        if t.startswith("model_"):
            out += ["model", t[len("model_"):]]
        elif t.startswith("m_"):
            out += ["m", t[len("m_"):]]
        elif t.startswith("tr_"):
            out += ["tr", t[len("tr_"):]]  # TransformerBlock's layers
        elif t.startswith("seq") and t[3:].isdigit() and prev in _SEQ_PARENTS:
            out.append(t[3:])
        elif t == "c3" and prev == "down_conv1":
            out.append("conv")
        elif t == "c3" and prev is not None and prev.startswith("upconv"):
            out += ["conv", "0"]
        elif t == "up" and prev is not None and prev.startswith("upconv"):
            out += ["conv", "1"]
        elif t == "bn" and prev is not None and prev.startswith("upconv"):
            out += ["conv", "2"]
        elif t == "upconv6":
            out += ["upconv6", "0"]  # Sequential(ConvT, Sigmoid)
        else:
            out.append(t)
    return tuple(out)


def export_state_dict(params: Mapping[str, Any], stats: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """One subnet's JAX-layout ``params`` / ``batch_stats`` trees -> its
    torch-layout state dict of NumPy arrays, with int64
    ``num_batches_tracked`` zeros (JAX ``models/convert.py::export_state_dict``)."""
    sd: Dict[str, np.ndarray] = {}

    def walk_params(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk_params(v, path + (k,))
                continue
            arr = np.asarray(v)
            prefix = ".".join(_torch_path(path))
            if k == "kernel" and arr.ndim == 4:
                key = prefix + ".weight"
                if _CONVT_RE.search(key):
                    sd[key] = np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))  # -> (I, O, kh, kw)
                else:
                    sd[key] = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
            elif k in ("kernel", "scale"):  # a 2-D kernel is TorchLinear's, already (out, in)
                sd[prefix + ".weight"] = arr
            elif k == "bias":
                sd[prefix + ".bias"] = arr
            elif k in ("in_proj_weight", "in_proj_bias"):  # attention's packed projection
                sd[f"{prefix}.{k}"] = arr
            else:
                raise ValueError(f"unhandled param leaf {path + (k,)}")

    def walk_stats(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk_stats(v, path + (k,))
                continue
            prefix = ".".join(_torch_path(path))
            if k == "mean":
                sd[prefix + ".running_mean"] = np.asarray(v)
            elif k == "var":
                sd[prefix + ".running_var"] = np.asarray(v)
                sd[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)
            else:
                raise ValueError(f"unhandled stats leaf {path + (k,)}")

    walk_params(params, ())
    walk_stats(stats, ())
    return sd


def detect_anchors(spec) -> Tuple[str, torch.Tensor]:
    """Detect's ``anchors`` buffer for the graph ``spec``: its state dict
    key and anchors / strides, as the reference's ``.pt`` holds it."""
    detect_idx = max(ls.index for ls in spec.layers)
    anchors = torch.tensor(spec.anchors, dtype=torch.float32).view(len(spec.anchors), -1, 2)
    strides = torch.tensor(spec.strides[:len(spec.anchors)], dtype=torch.float32).view(-1, 1, 1)
    return f"blk_det.model.{detect_idx}.anchors", anchors / strides


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A torch tensor of its own memory with ``arr``'s shape (0-d stays 0-d,
    where ``np.ascontiguousarray`` would make it (1,))."""
    return torch.from_numpy(np.array(arr))


def train_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX train variables (nested numpy dict) -> the port's state dict:
    ``TextDetTrain``'s from ``backbone``, ``seg_net`` and, for DB training,
    ``dbnet``; ``BlkDetTrain``'s from ``blk_det``, less Detect's anchors
    buffer, which JAX has not (the caller takes the model's own)."""
    out: Dict[str, torch.Tensor] = {}
    stats = variables.get("batch_stats", {})
    for subnet, params in variables["params"].items():
        for k, v in export_state_dict(params, stats.get(subnet, {})).items():
            out[f"{subnet}.{k}"] = _tensor(v)
    return out


# the U-Net layers DB training keeps frozen in its trunk (JAX DET mode)
_TRUNK = ("down_conv1", "upconv0", "upconv2")


def _subtree(tree: Mapping[str, Any], keys=None) -> Dict:
    return {k: copy.deepcopy(v) for k, v in tree.items() if keys is None or k in keys}


def train_from_deploy(deploy: Mapping[str, Any], with_db: bool = False) -> Dict:
    """Deploy variables -> JAX-layout ``TextDetTrain`` variables:
    ``backbone`` <- ``blk_det`` layers ``model_0`` .. ``model_9``,
    ``seg_net`` <- ``text_seg`` (its trunk alone with ``with_db``), and with
    ``with_db`` ``dbnet`` <- ``text_det``."""
    out: Dict = {"params": {}, "batch_stats": {}}
    layers = {k for k in deploy["params"]["blk_det"] if int(k.split("_")[1]) <= max(OUT_INDICES)}
    trunk = _TRUNK if with_db else None
    for col in ("params", "batch_stats"):
        out[col]["backbone"] = _subtree(deploy[col]["blk_det"], layers)
        out[col]["seg_net"] = _subtree(deploy[col]["text_seg"], trunk)
        if with_db:
            out[col]["dbnet"] = _subtree(deploy[col]["text_det"])
    return out


def state_dict_from_jax(variables: Mapping[str, Any], cfg: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """JAX ``TextDetBase`` variables (nested numpy dict) -> the port's
    ``TextDetBase`` state dict."""
    spec = parse_graph(cfg or YOLOV5S_CFG)
    out: Dict[str, torch.Tensor] = {}
    for subnet in SUBNETS:
        sd = export_state_dict(variables["params"][subnet], variables["batch_stats"][subnet])
        for k, v in sd.items():
            out[f"{subnet}.{k}"] = _tensor(v)
    key, anchors = detect_anchors(spec)
    out[key] = anchors
    return out


