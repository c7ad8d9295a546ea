"""Weight initialization transforms (reference utils/weight_init.py).

Counterpart of the JAX package's ``training/init.py``: the reference's
explicit init recipe (init_weights :91-103 — kaiming-normal convolution
kernels, unit BatchNorm) and the bilinear transposed-convolution kernel
(:75-88).  Draws come from an explicit ``torch.Generator``; they follow
the JAX package's distributions, not its values (another RNG).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn


def bilinear_kernel(in_channels: int, out_channels: int, kernel_size: int) -> np.ndarray:
    """Bilinear-upsampling ConvTranspose kernel in torch's
    (in, out, kh, kw) layout."""
    factor = (kernel_size + 1) // 2
    center = factor - 1 if kernel_size % 2 == 1 else factor - 0.5
    og = np.arange(kernel_size)
    filt = (1 - np.abs(og[:, None] - center) / factor) * (1 - np.abs(og[None, :] - center) / factor)
    weight = np.zeros((in_channels, out_channels, kernel_size, kernel_size), np.float32)
    for i in range(min(in_channels, out_channels)):
        weight[i, i] = filt
    return weight


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
    stats are left as they are, as the JAX transform leaves batch_stats."""
    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                if name == "weight" and p.ndim == 4:
                    p.copy_(kaiming_normal(p.shape, transposed=isinstance(mod, nn.ConvTranspose2d),
                                           generator=generator))
                elif name == "weight":
                    p.fill_(1.0)
                elif name == "bias":
                    p.zero_()
    return module
