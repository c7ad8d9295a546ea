"""ONNX deploy-checkpoint ingestion.

Own copy of the JAX package's ``models/onnx_ingest.py``.  The reference's
most-distributed artifact is the ONNX export of the combined model
(``comictextdetector.pt.onnx``, reference utils/export.py:30-58).  A minimal
protobuf wire-format reader pulls the graph's initializers and nodes (the
``onnx`` package is not needed, and the card's machine does not have it);
each conv node is paired with its module by its position in the trace, and
the weights become the port's ``TextDetBase`` state dict
(``weights.state_dict_from_parts``), which loads with ``strict=True``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from comic_text_detector_tpu_torch.config import YOLOV5S_CFG, parse_graph
from comic_text_detector_tpu_torch.weights import state_dict_from_parts

# --- protobuf wire format -----------------------------------------------------
#
# tag = (field_number << 3) | wire_type
# wire types: 0 = varint, 1 = fixed64, 2 = length-delimited, 5 = fixed32

_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, payload) for one message buffer.
    Payload is an int for varint/fixed, a memoryview for length-delimited."""
    view = memoryview(buf)
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _LEN:
            n, pos = _read_varint(buf, pos)
            val = view[pos:pos + n]
            pos += n
        elif wire == _FIXED64:
            val = struct.unpack_from("<q", buf, pos)[0]
            pos += 8
        elif wire == _FIXED32:
            val = struct.unpack_from("<i", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _packed_varints(payload) -> List[int]:
    buf = bytes(payload)
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


# --- ONNX schema subset --------------------------------------------------------
#
# Field numbers from onnx.proto3.  Only what weight ingestion needs.

# TensorProto.data_type values
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _parse_tensor(buf) -> Tuple[str, np.ndarray]:
    """TensorProto -> (name, ndarray)."""
    name = ""
    dims: List[int] = []
    data_type = 1
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int64_data: List[int] = []
    int32_data: List[int] = []
    for field, wire, val in _fields(bytes(buf)):
        if field == 1:  # dims (repeated int64)
            dims.extend(_packed_varints(val) if wire == _LEN else [val])
        elif field == 2:
            data_type = val
        elif field == 4:  # float_data, packed
            float_data.extend(struct.unpack(f"<{len(val) // 4}f", bytes(val)))
        elif field == 5:  # int32_data
            int32_data.extend(_packed_varints(val) if wire == _LEN else [val])
        elif field == 7:  # int64_data
            int64_data.extend(_packed_varints(val) if wire == _LEN else [val])
        elif field == 8:
            name = bytes(val).decode("utf-8")
        elif field == 9:
            raw = bytes(val)
        elif field == 13:
            raise ValueError(f"tensor '{name}' uses external data — unsupported")
    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(f"tensor '{name}' has unsupported data_type {data_type}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    elif int32_data:
        arr = np.asarray(int32_data, np.int32)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr


def _parse_node(buf) -> Dict[str, Any]:
    node = {"input": [], "output": [], "name": "", "op_type": ""}
    for field, _wire, val in _fields(bytes(buf)):
        if field == 1:
            node["input"].append(bytes(val).decode("utf-8"))
        elif field == 2:
            node["output"].append(bytes(val).decode("utf-8"))
        elif field == 3:
            node["name"] = bytes(val).decode("utf-8")
        elif field == 4:
            node["op_type"] = bytes(val).decode("utf-8")
    return node


def read_onnx_graph(path: str) -> Tuple[Dict[str, np.ndarray], List[Dict[str, Any]]]:
    """Parse a .onnx file -> (initializers by name, nodes in graph order)."""
    with open(path, "rb") as f:
        model = f.read()
    graph_buf = None
    for field, _wire, val in _fields(model):
        if field == 7:  # ModelProto.graph
            graph_buf = val
            break
    if graph_buf is None:
        raise ValueError(f"{path}: no graph found — not an ONNX model?")
    initializers: Dict[str, np.ndarray] = {}
    nodes: List[Dict[str, Any]] = []
    for field, _wire, val in _fields(bytes(graph_buf)):
        if field == 1:  # node
            nodes.append(_parse_node(val))
        elif field == 5:  # initializer
            name, arr = _parse_tensor(val)
            initializers[name] = arr
    return initializers, nodes


# --- expected conv sequence ------------------------------------------------------
#
# Mapping strategy: the torchscript exporter fuses eval-mode Conv+BN pairs and
# often *renames* the fused weights ("onnx::Conv_1234"), so initializer names
# alone cannot be trusted.  What IS stable is the trace: every conv in the
# model lowers to exactly one Conv/ConvTranspose node, in forward execution
# order (blk_det fully, then text_seg, then text_det — TextDetBase.forward,
# basemodel.py:240-244).  So we enumerate the model's convs in trace order and
# zip them against the graph's conv nodes, reading each node's actual weight/
# bias inputs and its consumer (a surviving BatchNormalization node, or not).
# Named initializers double as alignment checks wherever they survive.

class _ConvSlot:
    """One expected conv in trace order (torch-style naming), with the eps
    of the BatchNorm after it in the port's net."""

    __slots__ = ("prefix", "op", "has_bias", "bn_prefix", "eps")

    def __init__(self, prefix: str, op: str, has_bias: bool, bn_prefix: Optional[str], eps: float = 1e-5):
        self.prefix = prefix
        self.op = op  # "Conv" | "ConvTranspose"
        self.has_bias = has_bias
        self.bn_prefix = bn_prefix
        self.eps = eps  # torch's default: the heads' own BatchNorms


def _conv_bn(prefix: str) -> _ConvSlot:
    """yolov5 Conv module: conv (no bias) + bn, eps 1e-3 (``models/blocks.py::
    Conv``) wherever it sits: in the YOLO graph and in the heads' C3 blocks."""
    return _ConvSlot(f"{prefix}.conv", "Conv", False, f"{prefix}.bn", eps=1e-3)


def _c3_slots(prefix: str, n: int) -> List[_ConvSlot]:
    """C3 trace order: cv1, bottlenecks (cv1, cv2 each), cv2, cv3
    (reference models/yolov5/common.py:126-139)."""
    slots = [_conv_bn(f"{prefix}.cv1")]
    for j in range(n):
        slots += [_conv_bn(f"{prefix}.m.{j}.cv1"), _conv_bn(f"{prefix}.m.{j}.cv2")]
    slots += [_conv_bn(f"{prefix}.cv2"), _conv_bn(f"{prefix}.cv3")]
    return slots


def _yolo_slots(cfg: Optional[dict]) -> List[_ConvSlot]:
    spec = parse_graph(cfg or YOLOV5S_CFG)
    slots: List[_ConvSlot] = []
    for ls in spec.layers:
        p = f"model.{ls.index}"
        if ls.module in ("Conv", "DWConv"):
            slots.append(_conv_bn(p))
        elif ls.module == "Focus":
            slots.append(_conv_bn(f"{p}.conv"))
        elif ls.module == "C3":
            slots += _c3_slots(p, ls.args[2])
        elif ls.module == "Bottleneck":
            slots += [_conv_bn(f"{p}.cv1"), _conv_bn(f"{p}.cv2")]
        elif ls.module in ("SPP", "SPPF"):
            slots += [_conv_bn(f"{p}.cv1"), _conv_bn(f"{p}.cv2")]
        elif ls.module == "Detect":
            for j in range(len(ls.frm)):
                slots.append(_ConvSlot(f"{p}.m.{j}", "Conv", True, None))
        elif ls.module in ("Concat", "Upsample", "BatchNorm2d"):
            pass
        else:
            raise ValueError(f"ONNX ingestion: unhandled yolo module {ls.module}")
    return slots


def _upconv_slots(prefix: str) -> List[_ConvSlot]:
    """double_conv_up_c3: C3 -> ConvT(x2, no bias) -> BN (basemodel.py:21-32)."""
    return _c3_slots(f"{prefix}.conv.0", 1) + [
        _ConvSlot(f"{prefix}.conv.1", "ConvTranspose", False, f"{prefix}.conv.2")
    ]


def _unet_slots() -> List[_ConvSlot]:
    """UnetHead trace order (basemodel.py:62-78)."""
    slots = _c3_slots("down_conv1.conv", 1)
    for name in ("upconv0", "upconv2", "upconv3", "upconv4", "upconv5"):
        slots += _upconv_slots(name)
    slots.append(_ConvSlot("upconv6.0", "ConvTranspose", False, None))
    return slots


def _tower_slots(prefix: str, conv_bias: bool) -> List[_ConvSlot]:
    """DBHead binarize/thresh tower: conv3x3+BN, ConvT+BN, ConvT
    (basemodel.py:95-103, :130-143)."""
    return [
        _ConvSlot(f"{prefix}.0", "Conv", conv_bias, f"{prefix}.1"),
        _ConvSlot(f"{prefix}.3", "ConvTranspose", True, f"{prefix}.4"),
        _ConvSlot(f"{prefix}.6", "ConvTranspose", True, None),
    ]


def _dbhead_slots() -> List[_ConvSlot]:
    """DBHead trace order: upconv3, upconv4, conv, thresh, binarize
    (basemodel.py:106-112)."""
    return (
        _upconv_slots("upconv3")
        + _upconv_slots("upconv4")
        + [_ConvSlot("conv.0", "Conv", True, "conv.1")]
        + _tower_slots("thresh", conv_bias=False)
        + _tower_slots("binarize", conv_bias=True)
    )


def expected_conv_slots(cfg: Optional[dict] = None) -> List[Tuple[str, _ConvSlot]]:
    """(subnet, slot) for every conv of TextDetBase in trace order."""
    return (
        [("blk_det", s) for s in _yolo_slots(cfg)]
        + [("text_seg", s) for s in _unet_slots()]
        + [("text_det", s) for s in _dbhead_slots()]
    )


# --- weight ingestion ----------------------------------------------------------


def onnx_to_state_dicts(
    initializers: Dict[str, np.ndarray],
    nodes: List[Dict[str, Any]],
    cfg: Optional[dict] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Reconstruct per-subnet torch-style state dicts from the ONNX graph.

    Fused Conv+BN pairs are re-expanded as conv + exact-identity BN (the fused
    bias rides the BN bias — or the conv bias where the torch conv has one),
    so downstream conversion and the flax module tree see the same structure
    as an unfused torch checkpoint.
    """
    # resolve initializer references through Identity pass-throughs
    ident = {n["output"][0]: n["input"][0] for n in nodes if n["op_type"] == "Identity"}

    def init_of(name: str) -> Optional[np.ndarray]:
        seen = set()
        while name not in initializers and name in ident and name not in seen:
            seen.add(name)
            name = ident[name]
        return initializers.get(name)

    consumers: Dict[str, Dict[str, Any]] = {}
    for n in nodes:
        for inp in n["input"]:
            consumers.setdefault(inp, n)

    conv_nodes = [n for n in nodes if n["op_type"] in ("Conv", "ConvTranspose")]
    expected = expected_conv_slots(cfg)
    if len(conv_nodes) != len(expected):
        raise ValueError(
            f"ONNX graph has {len(conv_nodes)} conv nodes, expected {len(expected)} "
            "for the TextDetBase topology — wrong model or unsupported cfg"
        )

    sds: Dict[str, Dict[str, np.ndarray]] = {"blk_det": {}, "text_seg": {}, "text_det": {}}
    for node, (subnet, slot) in zip(conv_nodes, expected):
        sd = sds[subnet]
        if node["op_type"] != slot.op:
            raise ValueError(
                f"trace mismatch at {subnet}.{slot.prefix}: graph has "
                f"{node['op_type']}, expected {slot.op}"
            )
        wname = node["input"][1]
        if "." in wname and not wname.startswith("onnx::"):
            # surviving module-path name — must agree with the trace position
            if wname != f"{subnet}.{slot.prefix}.weight":
                raise ValueError(
                    f"trace mismatch: node weight '{wname}' at expected slot "
                    f"'{subnet}.{slot.prefix}.weight'"
                )
        weight = init_of(wname)
        if weight is None:
            raise ValueError(f"conv weight '{wname}' has no initializer")
        bias = init_of(node["input"][2]) if len(node["input"]) > 2 else None
        sd[f"{slot.prefix}.weight"] = weight

        consumer = consumers.get(node["output"][0], {})
        if consumer.get("op_type") == "BatchNormalization":
            # BN survived export: read its parameters positionally
            scale, b, mean, var = (init_of(x) for x in consumer["input"][1:5])
            bnp = slot.bn_prefix
            if bnp is None:
                raise ValueError(f"unexpected BN after {subnet}.{slot.prefix}")
            sd[f"{bnp}.weight"] = scale
            sd[f"{bnp}.bias"] = b
            sd[f"{bnp}.running_mean"] = mean
            sd[f"{bnp}.running_var"] = var
            if slot.has_bias and bias is not None:
                sd[f"{slot.prefix}.bias"] = bias
        else:
            if slot.has_bias and bias is not None:
                sd[f"{slot.prefix}.bias"] = bias
            if slot.bn_prefix is not None:
                # Conv+BN fused at export: re-expand as an exact-identity BN.
                # var = 1 - eps makes (x - 0) / sqrt(var + eps) exact identity
                # under the BN's own eps (1e-3 in every yolov5 Conv, the
                # heads' C3 blocks' too; 1e-5 in the heads' own BNs).  The
                # fused bias rides the BN bias, except where the torch
                # conv has its own bias slot (then it rode the conv above).
                c = weight.shape[1] if slot.op == "ConvTranspose" else weight.shape[0]
                bnp = slot.bn_prefix
                bn_bias = np.zeros(c, np.float32)
                if not slot.has_bias and bias is not None:
                    bn_bias = bias.astype(np.float32)
                sd[f"{bnp}.weight"] = np.ones(c, np.float32)
                sd[f"{bnp}.bias"] = bn_bias
                sd[f"{bnp}.running_mean"] = np.zeros(c, np.float32)
                sd[f"{bnp}.running_var"] = np.full(c, 1.0 - slot.eps, np.float32)
            elif bias is not None and not slot.has_bias:
                raise ValueError(f"unexpected bias on {subnet}.{slot.prefix}")
    return sds


def convert_onnx_checkpoint(path: str, cfg: Optional[dict] = None) -> Tuple[Dict[str, torch.Tensor], None]:
    """A reference-format .onnx deploy file -> (the port's ``TextDetBase``
    state dict, None).  The ONNX artifact embeds no model yaml (the torch
    ckpt does), so the second item is always None and callers fall back to
    the deployed yolov5s config (pass ``cfg`` for another topology)."""
    initializers, nodes = read_onnx_graph(path)
    sds = onnx_to_state_dicts(initializers, nodes, cfg)
    parts = {k: {name: torch.from_numpy(np.array(v)) for name, v in sd.items()} for k, sd in sds.items()}
    return state_dict_from_parts(parts, cfg), None
