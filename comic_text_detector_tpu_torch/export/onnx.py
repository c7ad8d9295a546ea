"""Export to the reference's ONNX deploy file (``comictextdetector.pt.onnx``).

Counterpart of the reference's ``utils/export.py:30-58`` (``export_onnx``),
which traces ``TextDetBase`` through torch's TorchScript exporter at opset 11
with inputs ``images`` and outputs ``blk``, ``seg``, ``det``.  The port's
layers compute as the JAX package does (each bias added after its
convolution, eval BatchNorm as one multiply-add), which would trace into
other nodes; the export runs a copy of the net whose layers are torch's own
``nn.Conv2d``, ``nn.ConvTranspose2d`` and ``nn.BatchNorm2d`` (the port's
layers subclass them and add no state), so the file holds the reference's
graph: each eval Conv+BN folded into one ``Conv``, in the reference's trace
order, which ``models/onnx_ingest.py`` reads back.

The exporter's last pass inserts onnxscript functions into the model and
imports ``onnx`` even when the graph has none; where ``onnx`` is not
installed that pass is skipped, which leaves the file as the pass would for
this graph.
"""

from __future__ import annotations

import copy
import importlib.util
import warnings

import torch
from torch import nn

from comic_text_detector_tpu_torch.ops import nn as tnn

_TORCH_LAYERS = ((tnn.Conv2d, nn.Conv2d), (tnn.ConvTranspose2d, nn.ConvTranspose2d),
                 (tnn.BatchNorm2d, nn.BatchNorm2d))


def _reference_layers(model: nn.Module) -> nn.Module:
    """A copy of ``model`` on the CPU, in float32 and eval mode, whose
    convolutions and BatchNorms are torch's own classes."""
    out = copy.deepcopy(model).float().cpu().eval()
    for mod in out.modules():
        for port_cls, torch_cls in _TORCH_LAYERS:
            if type(mod) is port_cls:
                mod.__class__ = torch_cls
    return out


def export_onnx(model: nn.Module, path: str, input_size: int = 1024) -> None:
    """Write ``model`` (the port's ``TextDetBase``) to ``path`` as the
    reference's ONNX deploy file, traced at (1, 3, input_size, input_size).
    The weights do not depend on ``input_size``; the graph's shapes do.

    Side effect for the whole process: where ``onnx`` is not installed, the
    exporter's private ``onnx_proto_utils._add_onnxscript_fn`` is replaced
    by a pass-through for the length of the call, so exports in other
    threads at the same time skip that pass too.  The private module's path
    was checked on torch 2.11 and 2.13."""
    try:
        from torch.onnx._internal.torchscript_exporter import onnx_proto_utils
    except ImportError as e:
        raise ImportError(
            f"export_onnx needs torch.onnx._internal.torchscript_exporter.onnx_proto_utils, which torch "
            f"{torch.__version__} does not have (checked on torch 2.11 and 2.13)"
        ) from e

    net = _reference_layers(model)
    add_fn = onnx_proto_utils._add_onnxscript_fn
    if importlib.util.find_spec("onnx") is None:
        onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the TorchScript exporter's deprecation and tracer warnings
            # opset 11, inputs and outputs as the reference's utils/export.py:30-58 writes them
            torch.onnx.export(net, torch.zeros(1, 3, input_size, input_size), path, opset_version=11,
                              input_names=["images"], output_names=["blk", "seg", "det"], dynamo=False)
    finally:
        onnx_proto_utils._add_onnxscript_fn = add_fn
