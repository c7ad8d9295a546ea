"""U-Net mask head and DBNet text-line head (NCHW ``nn.Module``s).

Counterpart of the JAX package's ``models/heads.py`` (reference
basemodel.py: UnetHead :47, DBHead :83, double_conv_up_c3 :21,
double_conv_c3 :34).  Submodule names and ``nn.Sequential`` indices follow
the reference state dict (``upconvK.conv.{0,1,2}``, ``upconv6.0``,
``binarize.{0,1,3,4,6}``), and the channel plumbing is the JAX package's.

Frozen copy of the port's ``models/heads.py`` for the benchmark's plain reference,
which imports nothing of the port.
"""

from __future__ import annotations

import torch
from torch import nn

from ctd_bench.reference.constants import TEXTDET_DET, TEXTDET_INFERENCE, TEXTDET_MASK
from ctd_bench.reference.blocks import C3
from ctd_bench.reference import nn as tnn

# Head BatchNorms are plain torch defaults (eps=1e-5), unlike the yolo
# graph's 1e-3.
_BN_EPS = 1e-5


class DoubleConvUpC3(nn.Module):
    """C3 -> ConvTranspose(x2) -> BN -> ReLU (reference double_conv_up_c3)."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int, act: str = "leaky"):
        super().__init__()
        self.conv = nn.Sequential(
            C3(in_ch, mid_ch, n=1, act=act),
            tnn.ConvTranspose2d(mid_ch, out_ch, kernel_size=4, stride=2, padding=1, bias=False),
            tnn.BatchNorm2d(out_ch, eps=_BN_EPS),
            nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class DoubleConvC3(nn.Module):
    """AvgPool(stride) -> C3 (reference double_conv_c3)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, act: str = "leaky"):
        super().__init__()
        self.stride = stride
        self.conv = C3(in_ch, out_ch, n=1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            x = tnn.avg_pool2d(x, 2, 2)
        return self.conv(x)


class UnetHead(nn.Module):
    """U-Net decoder over the 5 backbone taps -> full-res sigmoid text mask
    (reference UnetHead.forward, basemodel.py:62-78).

    ``forward_mode``: TEXTDET_INFERENCE returns (mask, (f80, f40, u40)), the
    features the DB head reads; TEXTDET_MASK the mask alone (U-Net
    training); TEXTDET_DET stops at u40 and returns (f80, f40, u40) (DB
    training).  ``trunk_only`` builds only the layers DET mode runs
    (down_conv1, upconv0, upconv2), as the JAX package's DET-mode
    initialization creates them.
    """

    def __init__(self, act: str = "leaky", trunk_only: bool = False):
        super().__init__()
        self.down_conv1 = DoubleConvC3(512, 512, stride=2, act=act)
        self.upconv0 = DoubleConvUpC3(512, 512, 256, act=act)
        self.upconv2 = DoubleConvUpC3(768, 512, 256, act=act)
        if trunk_only:
            return
        self.upconv3 = DoubleConvUpC3(512, 512, 256, act=act)
        self.upconv4 = DoubleConvUpC3(384, 256, 128, act=act)
        self.upconv5 = DoubleConvUpC3(192, 128, 64, act=act)
        self.upconv6 = nn.Sequential(
            tnn.ConvTranspose2d(64, 1, kernel_size=4, stride=2, padding=1, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, f160, f80, f40, f20, f3, forward_mode: int = TEXTDET_INFERENCE):
        d10 = self.down_conv1(f3)
        u20 = self.upconv0(d10)
        u40 = self.upconv2(torch.cat([f20, u20], dim=1))
        if forward_mode == TEXTDET_DET:
            return f80, f40, u40
        u80 = self.upconv3(torch.cat([f40, u40], dim=1))
        u160 = self.upconv4(torch.cat([f80, u80], dim=1))
        u320 = self.upconv5(torch.cat([f160, u160], dim=1))
        mask = self.upconv6[1](self.upconv6[0](u320).float())
        if forward_mode == TEXTDET_MASK:
            return mask
        return mask, (f80, f40, u40)


def _tower(in_ch: int, conv_bias: bool) -> nn.Sequential:
    """conv3x3 -> BN -> ReLU -> ConvT(x2) -> BN -> ReLU -> ConvT(x2) -> 1ch
    (DBHead.binarize / .thresh, basemodel.py:95-103, :130-143)."""
    c4 = in_ch // 4
    return nn.Sequential(
        tnn.Conv2d(in_ch, c4, 3, padding=1, bias=conv_bias),
        tnn.BatchNorm2d(c4, eps=_BN_EPS),
        nn.ReLU(),
        tnn.ConvTranspose2d(c4, c4, 2, 2),
        tnn.BatchNorm2d(c4, eps=_BN_EPS),
        nn.ReLU(),
        tnn.ConvTranspose2d(c4, 1, 2, 2),
    )


class DBHead(nn.Module):
    """DBNet head: shrink (prob) map + threshold map (reference DBHead,
    basemodel.py:83-160).  Owns its private copies of upconv3/upconv4.

    In eval mode returns (B, 2, H, W) = cat(shrink, thresh).  In train mode
    returns (B, 3, H, W) = cat(shrink, thresh, binary), binary the
    differentiable binarization ``step_function`` with k=50, and a fourth
    channel of raw shrink logits when ``shrink_with_sigmoid=False``
    (basemodel.py:115-120), as the JAX package's ``train=True`` does."""

    def __init__(self, in_channels: int = 64, k: float = 50.0, shrink_with_sigmoid: bool = True,
                 act: str = "leaky"):
        super().__init__()
        self.k = k
        self.shrink_with_sigmoid = shrink_with_sigmoid
        self.upconv3 = DoubleConvUpC3(512, 512, 256, act=act)
        self.upconv4 = DoubleConvUpC3(384, 256, 128, act=act)
        self.conv = nn.Sequential(
            tnn.Conv2d(128, in_channels, 1, bias=True),
            tnn.BatchNorm2d(in_channels, eps=_BN_EPS),
            nn.ReLU(),
        )
        self.binarize = _tower(in_channels, conv_bias=True)
        self.thresh = _tower(in_channels, conv_bias=False)

    def forward(self, f80, f40, u40) -> torch.Tensor:
        u80 = self.upconv3(torch.cat([f40, u40], dim=1))
        x = self.upconv4(torch.cat([f80, u80], dim=1))
        x = self.conv(x)
        thresh = torch.sigmoid(self.thresh(x).float())
        logits = self.binarize(x).float()
        shrink = torch.sigmoid(logits)
        if not self.training:
            return torch.cat([shrink, thresh], dim=1)
        outs = [shrink, thresh, self.step_function(shrink, thresh)]
        if not self.shrink_with_sigmoid:
            outs.append(logits)
        return torch.cat(outs, dim=1)

    def step_function(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return 1.0 / (1.0 + torch.exp(-self.k * (x - y)))
