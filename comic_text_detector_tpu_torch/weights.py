"""Weight readers and the JAX-parameter converter.

* :func:`load_npz` reads the JAX package's compact float16 checkpoint
  (flax paths joined with ``/``, ``training/checkpoint.py::save_compact``)
  into a nested dict of float32 numpy arrays.
* :func:`state_dict_from_jax` turns that nested dict (``{'params': ...,
  'batch_stats': ...}``) into the port's ``TextDetBase`` state dict: conv
  HWIO -> OIHW, transposed conv flipped-HWIO -> (I, O, kh, kw), BatchNorm
  scale/bias/mean/var -> weight/bias/running_mean/running_var.  Own copy of
  ``models/convert.py::export_state_dict`` / ``export_torch_checkpoint``.
* :func:`load_reference_pt` reads a reference-format combined ``.pt``
  (``{'blk_det': {'cfg', 'weights'}, 'text_seg': sd, 'text_det': sd}``),
  whose keys already have the port's layout.
* The train trees: :func:`train_state_dict_from_jax` /
  :func:`variables_from_state_dict` carry the JAX ``TextDetTrain``
  variables (``backbone``, ``seg_net``, ``dbnet``) and ``BlkDetTrain``
  variables (``blk_det``) to the port's state dicts and back;
  :func:`train_from_deploy`, :func:`blk_train_from_deploy` and
  :func:`deploy_from_train` move weights between a deploy tree
  (``blk_det``, ``text_seg``, ``text_det``) and a train tree.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from comic_text_detector_tpu_torch.config import OUT_INDICES, YOLOV5S_CFG, parse_graph

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


def _subnet_state_dict(params: Mapping[str, Any], stats: Mapping[str, Any]) -> Dict[str, np.ndarray]:
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
            elif k in ("kernel", "scale"):
                sd[prefix + ".weight"] = arr
            elif k == "bias":
                sd[prefix + ".bias"] = arr
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


def _anchors_key(spec) -> Tuple[str, torch.Tensor]:
    detect_idx = max(ls.index for ls in spec.layers)
    anchors = torch.tensor(spec.anchors, dtype=torch.float32).view(len(spec.anchors), -1, 2)
    strides = torch.tensor(spec.strides, dtype=torch.float32).view(-1, 1, 1)
    return f"blk_det.model.{detect_idx}.anchors", anchors / strides


def train_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX train variables (nested numpy dict) -> the port's state dict:
    ``TextDetTrain``'s from ``backbone``, ``seg_net`` and, for DB training,
    ``dbnet``; ``BlkDetTrain``'s from ``blk_det``, less Detect's anchors
    buffer, which JAX has not (the caller takes the model's own)."""
    out: Dict[str, torch.Tensor] = {}
    stats = variables.get("batch_stats", {})
    for subnet, params in variables["params"].items():
        for k, v in _subnet_state_dict(params, stats.get(subnet, {})).items():
            out[f"{subnet}.{k}"] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def _flax_path(tokens: Tuple[str, ...]) -> Tuple[str, ...]:
    """torch module path -> flax module path (inverse of ``_torch_path``)."""
    out = []
    i = 0
    while i < len(tokens):
        t = tokens[i]
        nxt = tokens[i + 1] if i + 1 < len(tokens) else None
        prev = out[-1] if out else None
        if t in ("model", "m") and nxt is not None and nxt.isdigit():
            out.append(f"{t}_{nxt}")
            i += 2
            continue
        if t == "conv" and prev is not None and prev.startswith("upconv") and nxt in ("0", "1", "2"):
            out.append({"0": "c3", "1": "up", "2": "bn"}[nxt])
            i += 2
            continue
        if t == "0" and prev == "upconv6":
            i += 1
            continue
        if t == "conv" and prev == "down_conv1":
            out.append("c3")
        elif t.isdigit() and prev in _SEQ_PARENTS:
            out.append(f"seq{t}")
        else:
            out.append(t)
        i += 1
    return tuple(out)


def variables_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict:
    """A port state dict (``TextDetTrain`` or ``TextDetBase``) -> JAX
    variables ``{'params': ..., 'batch_stats': ...}`` as nested float32
    numpy dicts: OIHW -> HWIO, (I, O, kh, kw) -> flipped HWIO,
    weight/bias/running_mean/running_var -> scale/bias/mean/var.  Detect's
    ``anchors`` buffer and BatchNorm's ``num_batches_tracked`` have no JAX
    counterpart and are dropped."""
    params: Dict = {}
    stats: Dict = {}

    def put(tree, path, leaf, value):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value

    for key, t in sd.items():
        *mods, leaf = key.split(".")
        if leaf in ("num_batches_tracked", "anchors"):
            continue
        path = _flax_path(tuple(mods))
        arr = t.detach().cpu().numpy()
        bn = ".".join(mods) + ".running_mean" in sd
        if leaf == "running_mean":
            put(stats, path, "mean", arr)
        elif leaf == "running_var":
            put(stats, path, "var", arr)
        elif leaf == "bias":
            put(params, path, "bias", arr)
        elif leaf == "weight" and bn:
            put(params, path, "scale", arr)
        elif leaf == "weight" and arr.ndim == 4:
            if _CONVT_RE.search(key):
                arr = np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1]  # (I, O, kh, kw) -> flipped HWIO
            else:
                arr = np.transpose(arr, (2, 3, 1, 0))  # OIHW -> HWIO
            put(params, path, "kernel", np.ascontiguousarray(arr))
        elif leaf == "weight":
            put(params, path, "kernel", arr)
        else:
            raise ValueError(f"unhandled state dict entry {key}")
    return {"params": params, "batch_stats": stats}


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


def blk_train_from_deploy(deploy: Mapping[str, Any]) -> Dict:
    """Deploy variables -> JAX-layout ``BlkDetTrain`` variables: the whole
    ``blk_det`` graph."""
    return {col: {"blk_det": _subtree(deploy[col]["blk_det"])} for col in ("params", "batch_stats")}


def deploy_from_train(train: Mapping[str, Any], deploy: Mapping[str, Any]) -> Dict:
    """A deploy tree with trained parts: a copy of ``deploy`` whose
    ``blk_det`` is ``train``'s where it has one (the block trainer's tree),
    whose ``text_seg`` layers are replaced by ``train``'s ``seg_net`` ones
    (the trunk alone after DB training) and whose ``text_det`` is
    ``train``'s ``dbnet`` where it has one.  A head trainer's backbone is
    not carried back: those trainers keep it frozen."""
    out = copy.deepcopy(dict(deploy))
    for col in ("params", "batch_stats"):
        if "blk_det" in train[col]:
            out[col]["blk_det"] = _subtree(train[col]["blk_det"])
        out[col]["text_seg"].update(_subtree(train[col].get("seg_net", {})))
        if "dbnet" in train[col]:
            out[col]["text_det"] = _subtree(train[col]["dbnet"])
    return out


def state_dict_from_jax(variables: Mapping[str, Any], cfg: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """JAX ``TextDetBase`` variables (nested numpy dict) -> the port's
    ``TextDetBase`` state dict."""
    spec = parse_graph(cfg or YOLOV5S_CFG)
    out: Dict[str, torch.Tensor] = {}
    for subnet in SUBNETS:
        sd = _subnet_state_dict(variables["params"][subnet], variables["batch_stats"][subnet])
        for k, v in sd.items():
            out[f"{subnet}.{k}"] = torch.from_numpy(np.ascontiguousarray(v))
    key, anchors = _anchors_key(spec)
    out[key] = anchors
    return out


def _fold_fused_bn(sd: Dict[str, torch.Tensor], fused_bn_eps: float = 1e-3) -> Dict[str, torch.Tensor]:
    """A ``X.conv.bias`` with no ``X.bn.weight`` is a conv+BN pair the
    reference fused at load (models/yolov5/yolo.py:185-192): give it an
    exact-identity BN carrying the fused bias, as the JAX converter does."""
    out = dict(sd)
    for key in list(sd):
        if not key.endswith(".conv.bias"):
            continue
        parent = key[: -len(".conv.bias")]
        if f"{parent}.bn.weight" in sd:
            continue
        bias = out.pop(key).float()
        c = bias.shape[0]
        out[f"{parent}.bn.weight"] = torch.ones(c)
        out[f"{parent}.bn.bias"] = bias
        out[f"{parent}.bn.running_mean"] = torch.zeros(c)
        out[f"{parent}.bn.running_var"] = torch.full((c,), 1.0 - fused_bn_eps)
        out[f"{parent}.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


def load_reference_pt(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """Reference-format combined ``.pt`` -> (the port's state dict, the
    embedded yolo cfg or None)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    blk = ckpt["blk_det"]
    cfg = blk.get("cfg") if isinstance(blk, Mapping) else None
    parts = {
        "blk_det": blk["weights"] if isinstance(blk, Mapping) and "weights" in blk else blk,
        "text_seg": ckpt["text_seg"],
        "text_det": ckpt["text_det"],
    }
    out: Dict[str, torch.Tensor] = {}
    for subnet, sd in parts.items():
        if isinstance(sd, Mapping) and "weights" in sd:
            sd = sd["weights"]
        for k, v in _fold_fused_bn(dict(sd)).items():
            if k.endswith(".anchor_grid") or k in ("anchors", "anchor_grid", "stride"):
                continue  # derived from the cfg, not parameters of the port
            out[f"{subnet}.{k}"] = v.float() if v.is_floating_point() else v
    key, anchors = _anchors_key(parse_graph(cfg or YOLOV5S_CFG))
    out.setdefault(key, anchors)
    return out, cfg
