"""YOLOv5 building blocks (NCHW ``nn.Module``s).

Counterpart of the JAX package's ``models/blocks.py`` (reference
models/yolov5/common.py: Conv :30, Bottleneck :94, C3 :126, SPP :165,
SPPF :181, Focus :199, and the variants of :58-266 that checkpoints from
other yolov5 releases embed in their cfg).  Submodule names follow the
reference state dict (``conv``/``bn``, ``cv1``..``cv4``, ``m.<i>``,
``tr.<i>``, ``ma.in_proj_weight``) so checkpoints load with
``load_state_dict(strict=True)``.  Every layer computes in its input's
dtype from float32 parameters, as ``ops/nn.py``'s layers do; attention
takes its softmax in float32, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from comic_text_detector_tpu_torch.ops import nn as tnn


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


class SPP(nn.Module):
    """Spatial pyramid pooling (reference common.py:165)."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13), act: str = "silu"):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1, act=act)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1, 1, act=act)
        self.m = nn.ModuleList(nn.MaxPool2d(kernel_size=x, stride=1, padding=x // 2) for x in k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [m(y) for m in self.m], dim=1))


class Focus(nn.Module):
    """Space-to-depth stem (reference common.py:199): the four pixel
    phases [::2, ::2], [1::2, ::2], [::2, 1::2], [1::2, 1::2] of H, W
    stacked on the channels, then one Conv."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None, g: int = 1,
                 act: str = "silu"):
        super().__init__()
        self.conv = Conv(c1 * 4, c2, k, s, p, g, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat(
            [x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2], x[..., 1::2, 1::2]], dim=1))


class Linear(nn.Linear):
    """``nn.Linear`` in the input's dtype, bias added after the product
    (the JAX package's ``TorchLinear``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(y.dtype)


class MultiheadAttention(nn.Module):
    """Batch-first multi-head attention with ``nn.MultiheadAttention``'s
    parameter names (``in_proj_weight`` (3C, C), ``in_proj_bias``,
    ``out_proj``): explicit projections, q scaled by ``d**-0.5``, the
    softmax in float32 and cast back, as the JAX package's
    ``TorchMultiheadAttention`` computes it."""

    def __init__(self, embed: int, num_heads: int):
        super().__init__()
        self.embed, self.num_heads = embed, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed, embed))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed))
        self.out_proj = Linear(embed, embed)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def project(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """The ``i``-th in-projection (0 q, 1 k, 2 v): (B, L, C) -> (B, h, L, d)."""
        c, h = self.embed, self.num_heads
        rows = slice(i * c, (i + 1) * c)
        y = F.linear(x, self.in_proj_weight[rows].to(x.dtype)) + self.in_proj_bias[rows].to(x.dtype)
        return y.view(y.shape[0], y.shape[1], h, c // h).transpose(1, 2)

    @staticmethod
    def attend(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
        """Scaled heads (B, h, L, d) -> (B, L, C): scores, softmax in
        float32 cast back to the heads' dtype, weighted sum of ``vh``."""
        attn = torch.softmax(torch.matmul(qh, kh.transpose(-2, -1)).float(), dim=-1)
        out = torch.matmul(attn.to(qh.dtype), vh).transpose(1, 2)
        return out.reshape(out.shape[0], out.shape[1], -1)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        d = self.embed // self.num_heads
        return self.out_proj(self.attend(self.project(q, 0) * (d ** -0.5), self.project(k, 1), self.project(v, 2)))


class TransformerLayer(nn.Module):
    """Attention and a two-layer MLP, both residual, no LayerNorm
    (reference common.py:58-73), on (B, L, C)."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.q = Linear(c, c, bias=False)
        self.k = Linear(c, c, bias=False)
        self.v = Linear(c, c, bias=False)
        self.ma = MultiheadAttention(c, num_heads)
        self.fc1 = Linear(c, c, bias=False)
        self.fc2 = Linear(c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ma(self.q(x), self.k(x), self.v(x)) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """Transformer layers over the H x W positions, flattened row-major,
    after a learned linear position term (reference common.py:75-91); a
    Conv to ``c2`` first where ``c1 != c2``."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int, act: str = "silu"):
        super().__init__()
        self.conv = Conv(c1, c2, act=act) if c1 != c2 else None
        self.linear = Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads) for _ in range(num_layers)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            x = self.conv(x)
        b, c, h, w = x.shape
        p = x.flatten(2).transpose(1, 2)  # (B, H*W, C)
        p = self.tr(p + self.linear(p))
        return p.transpose(1, 2).reshape(b, c, h, w)


class GhostConv(nn.Module):
    """Primary conv and a cheap depthwise 5x5 expansion (reference
    common.py:212)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act: str = "silu"):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, g=g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, g=c_, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=1)


class GhostBottleneck(nn.Module):
    """GhostNet bottleneck (reference common.py:224): ``conv`` = GhostConv,
    a depthwise stride conv at stride 2 (``nn.Identity`` otherwise), a
    GhostConv without activation; ``shortcut`` = depthwise + pointwise
    convs without activation at stride 2, the identity otherwise."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, act: str = "silu"):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1, act=act),
            Conv(c_, c_, k, s, g=c_, act="identity") if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act="identity"),
        )
        self.shortcut = (nn.Sequential(Conv(c1, c1, k, s, g=c1, act="identity"), Conv(c1, c2, 1, 1, act="identity"))
                         if s == 2 else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + self.shortcut(x)


class BottleneckCSP(nn.Module):
    """CSP bottleneck (reference common.py:109-124): bare bias-free 1x1
    convs ``cv2`` and ``cv3`` on the two branches, re-joined through a
    standalone BatchNorm (eps 1e-3) and SiLU whatever the graph's
    activation, then ``cv4``."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 act: str = "silu"):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act=act)
        self.cv2 = tnn.Conv2d(c1, c_, 1, 1, bias=False)
        self.cv3 = tnn.Conv2d(c_, c_, 1, 1, bias=False)
        self.cv4 = Conv(2 * c_, c2, 1, 1, act=act)
        self.bn = tnn.BatchNorm2d(2 * c_, eps=1e-3, momentum=0.03)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0, act=act) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.cv3(self.m(self.cv1(x))), self.cv2(x)], dim=1)
        return self.cv4(F.silu(self.bn(y)))


class C3TR(C3):
    """C3 with a TransformerBlock (4 heads, ``n`` layers) as its inner
    stage (reference common.py:141)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 act: str = "silu"):
        super().__init__(c1, c2, 0, shortcut, g, e, act)
        c_ = int(c2 * e)
        self.m = TransformerBlock(c_, c_, 4, n, act=act)


class C3SPP(C3):
    """C3 with an SPP inner stage (reference common.py:148)."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13), shortcut: bool = True, g: int = 1,
                 e: float = 0.5, act: str = "silu"):
        super().__init__(c1, c2, 0, shortcut, g, e, act)
        c_ = int(c2 * e)
        self.m = SPP(c_, c_, k, act=act)


class C3Ghost(C3):
    """C3 with ``n`` GhostBottlenecks as its inner stage (reference
    common.py:156); ``shortcut`` is not read, as in the reference."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 act: str = "silu"):
        super().__init__(c1, c2, 0, shortcut, g, e, act)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(GhostBottleneck(c_, c_, act=act) for _ in range(n)))


class Contract(nn.Module):
    """Space folded into channels (reference common.py:235-245), NCHW:
    output channel ``(s1 * gain + s2) * C + c`` takes pixel (s1, s2) of each
    gain x gain cell."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        s = self.gain
        x = x.view(n, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(n, c * s * s, h // s, w // s)


class Expand(nn.Module):
    """Channels unfolded into space, the inverse of :class:`Contract`
    (reference common.py:248-258)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        s = self.gain
        x = x.view(n, s, s, c // s ** 2, h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(n, c // s ** 2, h * s, w * s)
