"""Seeded random weights (reference utils/weight_init.py).

The reference's explicit init recipe (init_weights :91-103: kaiming-normal
convolution kernels, unit BatchNorm), the JAX package's
``training/init.py`` transform, and :func:`random_variables`, the deploy
variables of a detector of random weights.  Draws come from an explicit
``torch.Generator``; they follow the JAX package's distributions, not its
values (another RNG).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from comic_text_detector_tpu_torch.config import YOLOV5S_CFG
from comic_text_detector_tpu_torch.models.detector import build_inference_model
from comic_text_detector_tpu_torch.weights import variables_from_state_dict


def kaiming_normal(shape: Sequence[int], a: float = 0.0, mode: str = "fan_in", transposed: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """He-normal for a 4-D kernel of torch's layout, (out, in, kh, kw), or
    (in, out, kh, kw) with ``transposed``, with the leaky-relu gain
    sqrt(2 / (1 + a**2)) (torch ``kaiming_normal_`` semantics; fan_in counts
    the input channels, as the JAX package's HWIO kernels do)."""
    c_out, c_in = (shape[1], shape[0]) if transposed else (shape[0], shape[1])
    fan = shape[2] * shape[3] * (c_in if mode == "fan_in" else c_out)
    std = math.sqrt(2.0 / (1 + a**2)) / math.sqrt(fan)
    return torch.randn(tuple(shape), generator=generator) * std


def apply_reference_init(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-initialize ``module`` the reference way, in place: kaiming-normal
    4-D kernels, zero biases, unit BatchNorm scale and zero shift.  Running
    stats are left as they are, as the JAX transform leaves batch_stats,
    and so are 2-D (linear) kernels and attention's packed projection,
    which the JAX transform does not touch either."""
    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                if name == "weight" and p.ndim == 4:
                    p.copy_(kaiming_normal(p.shape, transposed=isinstance(mod, nn.ConvTranspose2d),
                                           generator=generator))
                elif name == "weight" and p.ndim == 1:  # BatchNorm scale
                    p.fill_(1.0)
                elif name == "bias":
                    p.zero_()
    return module


def random_variables(seed: int = 0, cfg: Optional[dict] = None) -> dict:
    """Deploy variables (JAX layout, float32 NumPy) of the three-head net on
    ``cfg`` from ``apply_reference_init`` with a ``torch.Generator`` seeded
    with ``seed``; parameters the recipe leaves alone (the transformer's
    linear kernels) are drawn from the same generator, uniform within
    +-sqrt(3 / fan_in).  ``TextDetector.random_init`` and
    ``BatchTextDetector.random_init`` take these."""
    gen = torch.Generator().manual_seed(seed)
    model = apply_reference_init(build_inference_model(cfg or YOLOV5S_CFG), gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 2:
                limit = math.sqrt(3.0 / p.shape[1])
                p.copy_(torch.rand(p.shape, generator=gen) * (2 * limit) - limit)
    return variables_from_state_dict(model.state_dict())
