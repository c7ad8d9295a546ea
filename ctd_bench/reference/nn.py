"""NCHW primitives of the plain reference: frozen copy of the port's
``ops/nn.py`` (padding rule, activations, nearest upsampling, convolutions
that add their bias after the convolution, eval-mode BatchNorm as one
multiply-add), without its process-group BatchNorm.

``set_precision("fp8")`` turns the reference into the lower-precision
control of a bf16 configuration: every convolution reads its input and its
weight rounded to float8 e4m3 (each tensor scaled so that its largest
magnitude maps to e4m3's largest finite value, 448), and computes in
float32.  ``"f32"`` (the default) leaves them as they are.  ``"tf32"`` is the
control of a float32 configuration: on the card a cuDNN/cuBLAS flag the
caller sets (``pipeline.py::precision``); on the CPU, whose convolutions
have no TF32, the operands are rounded to TF32's 10-bit mantissa here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_PRECISION = {"mode": "f32"}
_E4M3_MAX = 448.0


def set_precision(mode: str) -> None:
    if mode not in ("f32", "fp8", "tf32"):
        raise ValueError(f"unknown reference precision {mode!r}")
    _PRECISION["mode"] = mode


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in x's dtype."""
    amax = x.detach().abs().amax().to(torch.float32).clamp_min(1e-12)
    scale = _E4M3_MAX / amax
    return ((x.to(torch.float32) * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale).to(x.dtype)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _operands(x: torch.Tensor, w: torch.Tensor):
    w = w.to(x.dtype)
    mode = _PRECISION["mode"]
    if mode == "fp8":
        return _round_fp8(x), _round_fp8(w)
    if mode == "tf32" and x.device.type == "cpu" and x.dtype == torch.float32:
        return _round_tf32(x), _round_tf32(w)
    return x, w


def autopad(k: int, p: Optional[int] = None) -> int:
    """'same' padding for odd kernels (reference models/yolov5/common.py:24)."""
    return k // 2 if p is None else p


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, slope)


ACTIVATIONS = {
    "silu": F.silu,
    "leaky": leaky_relu,
    "relu": F.relu,
    "identity": lambda x: x,
}


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """torch.nn.Upsample(scale_factor=2, mode='nearest') on NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool2d(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    return F.avg_pool2d(x, k, stride)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in the input's dtype, bias added after the convolution."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = _operands(x, self.weight)
        y = F.conv2d(x, w, None, self.stride, self.padding, self.dilation, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in the input's dtype, bias added after the
    convolution."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = _operands(x, self.weight)
        y = F.conv_transpose2d(x, w, None, self.stride, self.padding, self.output_padding, self.groups,
                               self.dilation)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


class BatchNorm2d(nn.BatchNorm2d):
    """Eval-mode BatchNorm as ``x * inv + (bias - mean * inv)`` with
    ``inv = rsqrt(var + eps) * weight``; train mode is torch's own."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        b = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]
