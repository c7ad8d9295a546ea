"""YOLOv5 building blocks (NCHW ``nn.Module``s) of the YOLOv5s graph:
Conv, Bottleneck, C3, SPPF, Concat, Upsample (reference
models/yolov5/common.py).  Frozen copy of the port's ``models/blocks.py``
without the variants of other yolov5 releases.  Submodule names follow the
reference state dict, so the weights load with ``strict=True``; every
layer computes in its input's dtype from float32 parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ctd_bench.reference import nn as tnn


class Conv(nn.Module):
    """Conv + BatchNorm + activation (reference common.py:30).  The BN eps is
    1e-3, as the reference's initialize_weights sets it and the JAX package
    keeps it for every ConvBnAct."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, act: str = "silu"):
        super().__init__()
        self.conv = tnn.Conv2d(c1, c2, k, s, tnn.autopad(k, p), groups=g, bias=False)
        self.bn = tnn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = tnn.ACTIVATIONS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """Standard bottleneck (reference common.py:94)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 act: str = "silu"):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act=act)
        self.cv2 = Conv(c_, c2, 3, 1, g=g, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions (reference common.py:126)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, act: str = "silu"):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act=act)
        self.cv2 = Conv(c1, c_, 1, 1, act=act)
        self.cv3 = Conv(2 * c_, c2, 1, 1, act=act)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0, act=act) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast (reference common.py:181)."""

    def __init__(self, c1: int, c2: int, k: int = 5, act: str = "silu"):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1, act=act)
        self.cv2 = Conv(c_ * 4, c2, 1, 1, act=act)
        self.m = nn.MaxPool2d(kernel_size=k, stride=1, padding=k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        p1 = self.m(y)
        p2 = self.m(p1)
        return self.cv2(torch.cat([y, p1, p2, self.m(p2)], dim=1))


class Concat(nn.Module):
    """Channel concatenation of the graph's skip inputs (no parameters)."""

    def forward(self, xs) -> torch.Tensor:
        return torch.cat(list(xs), dim=1)


class Upsample(nn.Module):
    """Nearest 2x upsampling (no parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tnn.upsample_nearest2x(x)


