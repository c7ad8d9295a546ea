"""Reference checkpoints <-> JAX-layout variables, and BatchNorm folding.

Counterpart of the JAX package's ``models/convert.py``, on the same
JAX-layout NumPy trees (``{'params': ..., 'batch_stats': ...}``, as
``weights.load_npz`` reads them), so that both packages' results compare
leaf by leaf and ``TextDetector(variables=..., cfg=...)`` takes them in
either package.  The layout rules are ``weights.py``'s:
``variables_from_state_dict`` (torch -> JAX) and ``export_state_dict``
(JAX -> torch, one subnet).

Ingests the reference checkpoint layouts (reference basemodel.py:211-220,
utils/export.py:23-28):

* the combined deploy checkpoint ``{'blk_det': {'cfg', 'weights'},
  'text_seg': sd, 'text_det': sd}``;
* the three training checkpoints, ``{'cfg', 'weights'}`` (the block
  detector) and ``{'weights', 'epoch', ...}`` (the seg and DB heads).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from comic_text_detector_tpu_torch.config import YOLOV5S_CFG, parse_graph
from comic_text_detector_tpu_torch.weights import (
    SUBNETS,
    detect_anchors,
    expand_fused_bn,
    export_state_dict,
    variables_from_state_dict,
)


def _unwrap(sd: Mapping[str, Any]) -> Mapping[str, Any]:
    return sd["weights"] if isinstance(sd, Mapping) and "weights" in sd else sd


def convert_state_dict(sd: Mapping[str, Any]) -> Dict[str, Dict]:
    """One reference-layout state dict -> ``{'params': tree, 'batch_stats':
    tree}``.  A conv+BN pair the reference fused at load becomes
    ``weights.expand_fused_bn``'s exact-identity BN.  Detect's
    ``anchors``, ``anchor_grid`` and ``stride`` are config here and are
    dropped."""
    kept = {k: v for k, v in sd.items()
            if not (k.endswith((".anchors", ".anchor_grid")) or k in ("anchors", "anchor_grid", "stride"))}
    return variables_from_state_dict(expand_fused_bn(kept))


def convert_combined_checkpoint(ckpt: Mapping[str, Any]) -> Tuple[Dict, Optional[dict]]:
    """The combined deploy checkpoint (already ``torch.load``-ed) ->
    (``TextDetBase`` variables, the embedded yolo cfg or None)."""
    blk = ckpt["blk_det"]
    cfg = blk.get("cfg") if isinstance(blk, Mapping) else None
    sub = {subnet: convert_state_dict(_unwrap(ckpt[subnet])) for subnet in SUBNETS}
    variables = {col: {subnet: sub[subnet][col] for subnet in SUBNETS} for col in ("params", "batch_stats")}
    return variables, cfg


def load_from_parts(blk_path: str, seg_path: str, det_path: str) -> Tuple[Dict, Optional[dict]]:
    """``TextDetBase`` variables and cfg from the reference's three training
    checkpoints (the yolov5 block checkpoint, ``unet_best.ckpt`` and
    ``db_best.ckpt``): the merge the reference does in ``concate_models``
    (utils/export.py:23-28), done at conversion time.  The block
    checkpoint carries its cfg dict, so these are not weights-only loads:
    read only files you trust."""
    paths = (blk_path, seg_path, det_path)
    return convert_combined_checkpoint(
        {subnet: torch.load(path, map_location="cpu", weights_only=False) for subnet, path in zip(SUBNETS, paths)}
    )


# (conv, BN, eps of that BN in the nets): every yolov5 Conv (the YOLO graph
# and the heads' C3 blocks) has eps 1e-3 (models/blocks.py::Conv); the
# heads' own BatchNorms, after the U-Net's transposed convs and in the DB
# towers, have torch's default 1e-5 (models/heads.py)
_FOLD_PAIRS = (("conv", "bn", 1e-3), ("up", "bn", 1e-5), ("seq0", "seq1", 1e-5), ("seq3", "seq4", 1e-5))


def fold_batchnorm(variables: Mapping[str, Any]) -> Dict:
    """Fold eval-mode BatchNorms into the conv before each (the reference's
    ``fuse_conv_and_bn`` at load, utils/yolov5_utils.py:23-43 /
    ``TextDetBase.fuse``, basemodel.py:229-237), on a copy of the JAX-layout
    tree: each kernel is scaled along its last (O) axis by ``scale /
    sqrt(var + eps)`` and the BN becomes an exact identity (scale 1, mean 0,
    var 1 - eps) carrying the shift.  NumPy float32, as the JAX package
    computes it, with each BN's own eps (``_FOLD_PAIRS``)."""
    params = copy.deepcopy(_to_plain(variables["params"]))
    stats = copy.deepcopy(_to_plain(variables["batch_stats"]))

    def walk(p_node: Dict, s_node: Dict) -> None:
        for conv_key, bn_key, eps in _FOLD_PAIRS:
            conv, bn, st = p_node.get(conv_key), p_node.get(bn_key), s_node.get(bn_key)
            if not (isinstance(conv, dict) and "kernel" in conv and isinstance(bn, dict) and "scale" in bn
                    and isinstance(st, dict)):
                continue
            inv = np.asarray(bn["scale"]) / np.sqrt(np.asarray(st["var"]) + eps)
            # the additive term rides the (now identity) BN's bias: the
            # convs before a BN have no bias slot in these nets
            conv["kernel"] = np.asarray(conv["kernel"]) * inv  # O last
            bias = np.asarray(bn["bias"]) - np.asarray(st["mean"]) * inv
            if "bias" in conv:
                bias = bias + np.asarray(conv["bias"]) * inv
                conv["bias"] = np.zeros_like(np.asarray(conv["bias"]), np.float32)
            bn["scale"] = np.ones_like(inv, np.float32)
            bn["bias"] = bias.astype(np.float32)
            st["mean"] = np.zeros_like(inv, np.float32)
            st["var"] = np.full_like(inv, 1.0 - eps, np.float32)
        for k, v in p_node.items():
            if isinstance(v, dict):
                walk(v, s_node.get(k, {}))

    for root, p_sub in params.items():
        walk(p_sub, stats.get(root, {}))
    return {"params": params, "batch_stats": stats}


def _to_plain(tree) -> Dict:
    if isinstance(tree, Mapping):
        return {k: _to_plain(v) for k, v in tree.items()}
    return tree


def export_torch_checkpoint(variables: Mapping[str, Any], cfg: Optional[dict] = None) -> Dict[str, Any]:
    """``TextDetBase`` variables -> the reference's combined deploy
    checkpoint (utils/export.py:23-28 layout) of torch tensors:
    ``{'blk_det': {'cfg', 'weights'}, 'text_seg': sd, 'text_det': sd}``,
    with int64 ``num_batches_tracked`` zeros of shape (1,), as the JAX
    package's file holds them, and Detect's ``anchors``
    buffer (anchors / strides).  No ``anchor_grid``: the reference's Detect
    keeps it as a plain list attribute (yolo.py:18), so its strict
    ``load_state_dict`` (yolo.py:291-292) rejects the key."""
    cfg = cfg or YOLOV5S_CFG
    out = {}
    for subnet in SUBNETS:
        sd = export_state_dict(variables["params"][subnet], variables["batch_stats"][subnet])
        out[subnet] = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    key, anchors = detect_anchors(parse_graph(cfg))
    out["blk_det"][key[len("blk_det."):]] = anchors
    return {"blk_det": {"cfg": cfg, "weights": out["blk_det"]}, "text_seg": out["text_seg"],
            "text_det": out["text_det"]}
