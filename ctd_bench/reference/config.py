"""Model graph configuration.

The reference ships its YOLOv5 graph spec inside the torch checkpoint and
rebuilds it with ``parse_model`` (reference models/yolov5/yolo.py:208-259).
We carry the spec as a plain dict.  ``YOLOV5S_CFG`` is the standard yolov5s
v6 topology with ``nc=2`` (eng / ja), which is what the published
``comictextdetector.pt`` embeds; a converter ingesting a real checkpoint
overrides this with the embedded cfg.

Spec rows are ``[from, repeats, module, args]`` exactly like the upstream
yaml format so embedded checkpoint cfgs load unmodified.

Own copy of the JAX package's ``config.py``.

Frozen copy of the port's ``config.py`` for the benchmark's plain reference,
which imports nothing of the port.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, List, Tuple, Union

YOLOV5S_CFG = {
    "nc": 2,
    "ch": 3,
    "depth_multiple": 0.33,
    "width_multiple": 0.50,
    "anchors": [
        [10, 13, 16, 30, 33, 23],  # P3/8
        [30, 61, 62, 45, 59, 119],  # P4/16
        [116, 90, 156, 198, 373, 326],  # P5/32
    ],
    "backbone": [
        [-1, 1, "Conv", [64, 6, 2, 2]],  # 0  P1/2
        [-1, 1, "Conv", [128, 3, 2]],  # 1  P2/4   <- tap f160 (64ch)
        [-1, 3, "C3", [128]],  # 2
        [-1, 1, "Conv", [256, 3, 2]],  # 3  P3/8   <- tap f80 (128ch)
        [-1, 6, "C3", [256]],  # 4
        [-1, 1, "Conv", [512, 3, 2]],  # 5  P4/16  <- tap f40 (256ch)
        [-1, 9, "C3", [512]],  # 6
        [-1, 1, "Conv", [1024, 3, 2]],  # 7  P5/32  <- tap f20 (512ch)
        [-1, 3, "C3", [1024]],  # 8
        [-1, 1, "SPPF", [1024, 5]],  # 9          <- tap f3 (512ch)
    ],
    "head": [
        [-1, 1, "Conv", [512, 1, 1]],  # 10
        [-1, 1, "Upsample", [None, 2, "nearest"]],  # 11
        [[-1, 6], 1, "Concat", [1]],  # 12
        [-1, 3, "C3", [512, False]],  # 13
        [-1, 1, "Conv", [256, 1, 1]],  # 14
        [-1, 1, "Upsample", [None, 2, "nearest"]],  # 15
        [[-1, 4], 1, "Concat", [1]],  # 16
        [-1, 3, "C3", [256, False]],  # 17 (P3/8)
        [-1, 1, "Conv", [256, 3, 2]],  # 18
        [[-1, 14], 1, "Concat", [1]],  # 19
        [-1, 3, "C3", [512, False]],  # 20 (P4/16)
        [-1, 1, "Conv", [512, 3, 2]],  # 21
        [[-1, 10], 1, "Concat", [1]],  # 22
        [-1, 3, "C3", [1024, False]],  # 23 (P5/32)
        [[17, 20, 23], 1, "Detect", ["nc", "anchors"]],  # 24
    ],
}

# Backbone feature taps consumed by the UNet / DB heads
# (reference basemodel.py:168: out_indices = [1, 3, 5, 7, 9]).
OUT_INDICES = (1, 3, 5, 7, 9)


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round channel counts up to a hardware-friendly multiple."""
    return int(math.ceil(x / divisor) * divisor)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One resolved node of the model graph."""

    index: int
    frm: Union[int, Tuple[int, ...]]  # producing layer index/indices (-1 = prev)
    module: str
    args: Tuple[Any, ...]
    repeats: int
    c_in: Union[int, Tuple[int, ...]]
    c_out: int


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    layers: Tuple[LayerSpec, ...]
    save: Tuple[int, ...]  # layer outputs needed by non-sequential consumers
    nc: int
    anchors: Tuple[Tuple[float, ...], ...]
    strides: Tuple[int, ...] = (8, 16, 32)
    ch_in: int = 3


_CH_MODULES = {
    "Conv", "C3", "SPPF", "SPP", "Bottleneck", "Focus", "DWConv", "GhostConv",
    "GhostBottleneck", "BottleneckCSP", "C3TR", "C3SPP", "C3Ghost",
}
# modules whose yaml repeat count becomes an inner-stage count
# (reference parse_model, models/yolov5/yolo.py:231-233; C3SPP is absent
# there too — its repeats stay module-level)
_N_AS_ARG = {"C3", "C3TR", "C3Ghost", "BottleneckCSP"}


def parse_graph(cfg: dict, max_layer: int | None = None) -> GraphSpec:
    """Resolve a yolov5-style cfg dict into a static :class:`GraphSpec`.

    Width/depth multiples are applied exactly as the reference does
    (models/yolov5/yolo.py:208-259) so channel counts line up with torch
    checkpoints.  ``max_layer`` truncates the graph (the heads only need the
    first ``max(OUT_INDICES)+1`` backbone layers, reference basemodel.py:170).
    """
    cfg = copy.deepcopy(cfg)
    anchors, nc = cfg["anchors"], cfg["nc"]
    gd, gw = cfg["depth_multiple"], cfg["width_multiple"]
    na = len(anchors[0]) // 2
    no = na * (nc + 5)

    rows = list(cfg["backbone"]) + list(cfg["head"])
    if max_layer is not None:
        rows = rows[: max_layer + 1]
    # normalize module names from torch-format cfgs embedded in checkpoints
    _renames = {"nn.Upsample": "Upsample", "nn.BatchNorm2d": "BatchNorm2d"}
    rows = [[f, n, _renames.get(m, m), a] for f, n, m, a in rows]

    layers: List[LayerSpec] = []
    save: set = set()
    ch: List[int] = [cfg.get("ch", 3)]
    for i, (frm, n, mod, args) in enumerate(rows):
        args = list(args)
        # resolve symbolic args ('nc', 'anchors') the way parse_model eval()s them
        for j, a in enumerate(args):
            if a == "nc":
                args[j] = nc
            elif a == "anchors":
                args[j] = anchors
            elif a == "None":
                args[j] = None
        n_ = max(round(n * gd), 1) if n > 1 else n

        if mod in _CH_MODULES:
            c1 = ch[frm]
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            args = [c1, c2, *args[1:]]
            if mod in _N_AS_ARG:
                args.insert(2, n_)
                n_ = 1
            c_in: Union[int, Tuple[int, ...]] = c1
        elif mod == "Concat":
            c2 = sum(ch[x] for x in frm)
            c_in = tuple(ch[x] for x in frm)
        elif mod == "Detect":
            args.append([ch[x] for x in frm])
            c2 = no
            c_in = tuple(ch[x] for x in frm)
        elif mod == "Upsample":
            c2 = ch[frm]
            c_in = c2
        elif mod == "Contract":
            gain = args[0] if args else 2
            c2 = ch[frm] * gain ** 2
            c_in = ch[frm]
            args = [gain]
        elif mod == "Expand":
            gain = args[0] if args else 2
            c2 = ch[frm] // gain ** 2
            c_in = ch[frm]
            args = [gain]
        elif mod == "BatchNorm2d":
            c2 = ch[frm]
            c_in = c2
            args = [c2]
        else:
            raise ValueError(f"unsupported module in graph cfg: {mod}")

        layers.append(
            LayerSpec(
                index=i,
                frm=tuple(frm) if isinstance(frm, (list, tuple)) else frm,
                module=mod,
                args=tuple(args),
                repeats=n_,
                c_in=c_in,
                c_out=c2,
            )
        )
        frms = frm if isinstance(frm, (list, tuple)) else [frm]
        save.update(x % i for x in frms if x != -1)
        if i == 0:
            ch = []
        ch.append(c2)

    # anchor order must match stride order (reference check_anchor_order,
    # utils/yolov5_utils.py:45-51): flip when areas descend while strides ascend
    anchors_t = tuple(tuple(float(v) for v in a) for a in anchors)
    areas = [sum(a[i] * a[i + 1] for i in range(0, len(a), 2)) for a in anchors_t]
    if len(areas) > 1 and areas[-1] < areas[0]:
        anchors_t = anchors_t[::-1]

    return GraphSpec(
        layers=tuple(layers),
        save=tuple(sorted(save)),
        nc=nc,
        anchors=anchors_t,
        ch_in=cfg.get("ch", 3),
    )


def backbone_spec(cfg: dict | None = None) -> GraphSpec:
    """Graph truncated to the 10 backbone layers used by the seg/det heads."""
    return parse_graph(cfg or YOLOV5S_CFG, max_layer=max(OUT_INDICES))


def full_spec(cfg: dict | None = None) -> GraphSpec:
    return parse_graph(cfg or YOLOV5S_CFG)
