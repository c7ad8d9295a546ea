"""The deploy artifact: a ``torch.export`` program of the three-head net.

Counterpart of the JAX package's ``export/stablehlo.py`` (the TPU-native
stand-in for the reference's ONNX chain, utils/export.py:23-58): the fused
forward is saved with its weights as a program that loads without the
Python model definition (``torch.export.save`` / ``load``), and a parity
check replaces the reference's torch-against-OpenCV-DNN check
(inference.py:202-209).

The program takes one (1, 3, S, S) float32 NCHW page in [0, 1] at the fixed
``input_size`` S and returns ``(blk, seg, det)`` as the module does.  A
``path + ".json"`` sidecar records the input, outputs, activation, compute
dtype and the device it was exported on.  The program is bound to that
device, as a JAX export is bound to its platform: Detect's grid and the
weights are traced there, so :func:`load_exported` refuses another device
rather than moving it.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from comic_text_detector_tpu_torch.config import YOLOV5S_CFG
from comic_text_detector_tpu_torch.models.detector import build_inference_model
from comic_text_detector_tpu_torch.utils.device import resolve_device
from comic_text_detector_tpu_torch.weights import SUBNETS, state_dict_from_jax

FORMAT = "torch.export"


def concate_models(blk_sd: Mapping[str, torch.Tensor], seg_sd: Mapping[str, torch.Tensor],
                   det_sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Three per-subnet state dicts (the block detector's ``YoloGraph``, the
    ``UnetHead`` and the ``DBHead``) -> one ``TextDetBase`` state dict
    (reference ``concate_models``, utils/export.py:23-28)."""
    return {f"{subnet}.{k}": v for subnet, sd in zip(SUBNETS, (blk_sd, seg_sd, det_sd)) for k, v in sd.items()}


def _model(state_or_variables: Mapping[str, Any], act: str, cfg: Optional[dict], dtype: torch.dtype,
           device: torch.device):
    """The net with these weights (JAX-layout variables or a port state
    dict), in eval mode on ``device``."""
    model_cfg = cfg or YOLOV5S_CFG
    state = state_or_variables
    if "params" in state_or_variables:
        state = state_dict_from_jax(state_or_variables, model_cfg)
    model = build_inference_model(model_cfg, act=act, dtype=dtype)
    model.load_state_dict(state, strict=True)
    return model.to(device)


def export_program(state_or_variables: Mapping[str, Any], path: str, input_size: int = 1024,
                   act: str = "leaky", cfg: Optional[dict] = None, dtype: torch.dtype = torch.float32,
                   device: str = "cuda") -> None:
    """Save the net with its weights to ``path`` as a ``torch.export``
    program at a fixed (1, 3, input_size, input_size) float32 input,
    computing in ``dtype`` (bf16 as ``half=True`` does), traced on
    ``device``; write the ``path + ".json"`` sidecar."""
    dev = resolve_device(device)
    model = _model(state_or_variables, act, cfg, dtype, dev)
    example = torch.zeros(1, 3, input_size, input_size, device=dev)
    with torch.no_grad():
        program = torch.export.export(model, (example,))
    torch.export.save(program, path)
    with open(path + ".json", "w") as f:
        json.dump({"input": [1, 3, input_size, input_size], "outputs": ["blk", "seg", "det"], "act": act,
                   "dtype": str(dtype).removeprefix("torch."), "device": dev.type, "format": FORMAT}, f)


def read_sidecar(path: str) -> Dict[str, Any]:
    with open(path + ".json") as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}.json: format {meta.get('format')!r}, not a {FORMAT} program")
    return meta


def load_exported(path: str, device: str = "cuda") -> torch.nn.Module:
    """Load a program written by :func:`export_program`: a module taking the
    (1, 3, S, S) float32 page and returning ``(blk, seg, det)``.  Raises if
    ``device`` is not the one it was exported on."""
    dev = resolve_device(device)
    meta = read_sidecar(path)
    if meta["device"] != dev.type:
        raise ValueError(
            f"{path} was exported on {meta['device']!r} (its sidecar {path}.json) and runs only there; "
            f"export it again on {dev.type!r}"
        )
    return torch.export.load(path).module()


def parity_check(state_or_variables: Mapping[str, Any], path: str, input_size: int = 1024, act: str = "leaky",
                 cfg: Optional[dict] = None, atol: float = 1e-4, device: str = "cuda") -> Tuple[bool, float]:
    """Run the live net and the loaded program on the same seeded random page
    and compare: (every output within ``atol``, the largest gap)."""
    dev = resolve_device(device)
    meta = read_sidecar(path)
    dtype = getattr(torch, meta["dtype"])
    model = _model(state_or_variables, act, cfg, dtype, dev)
    program = load_exported(path, device)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(1, 3, input_size, input_size, generator=gen).to(dev)
    with torch.no_grad():
        live, exported = model(x), program(x)
    gap = max(float((a.float() - b.float()).abs().max()) for a, b in zip(live, exported))
    return gap <= atol, gap
