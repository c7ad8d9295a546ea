"""NCHW neural-net primitives of the port.

Counterpart of the JAX package's ``ops/nn.py``.  There the primitives pin
torch semantics onto NHWC ``lax`` calls; here they are torch's own, so this
module keeps only what the blocks share: the padding rule, the activation
table, nearest 2x upsampling, and the layers whose arithmetic follows the
JAX package's in a lower compute dtype (bf16): convolutions that cast their
float32 weight to the input's dtype and add the bias after the convolution
in that dtype, and eval-mode BatchNorm as one multiply-add whose scale and
shift are formed in float32.  Parameters stay float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from comic_text_detector_tpu_torch.parallel.collectives import all_reduce, group_size


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
    """``nn.Conv2d`` in the input's dtype, bias added after the convolution
    (``ops/nn.py::conv2d`` of the JAX package): a fused bias would be added
    before the bf16 output is rounded and differ by one rounding."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding, self.dilation, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in the input's dtype, bias added after the
    convolution (``ops/nn.py::conv_transpose2d`` of the JAX package)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(
            x, self.weight.to(x.dtype), None, self.stride, self.padding, self.output_padding, self.groups,
            self.dilation,
        )
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


class BatchNorm2d(nn.BatchNorm2d):
    """Eval-mode BatchNorm computed as ``x * inv + (bias - mean * inv)`` with
    ``inv = rsqrt(var + eps) * weight``: the JAX package's order of
    operations (``ops/nn.py::batch_norm_inference``).  Parameter and buffer
    names are torch's, so reference state dicts load unchanged.

    ``group`` (a ``torch.distributed`` process group, set by the train steps
    under a mesh) makes the train-mode forward normalise with the
    statistics of the global batch, whose equal blocks the group's ranks
    hold: the JAX package's two passes (``models/blocks.py::BatchNorm``),
    each sum taken over the ranks through the autograd all-reduce, so the
    backward carries the cross-rank terms too."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.group is not None:
            return self._global_batch_forward(x)
        if self.training:
            return super().forward(x)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        b = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        n = x.numel() // x.shape[1] * group_size(self.group)  # the global count
        mean = all_reduce(xf.sum((0, 2, 3)), self.group) / n
        d = xf - mean[:, None, None]
        var = all_reduce(torch.square(d).sum((0, 2, 3)), self.group) / n  # biased
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * (var * (n / max(n - 1, 1))))
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (d * inv[:, None, None] + self.bias[:, None, None]).to(x.dtype)
