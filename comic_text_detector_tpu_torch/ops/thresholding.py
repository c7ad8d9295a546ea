"""Histogram and threshold primitives on the device (plain PyTorch).

Counterpart of the JAX package's ``ops/thresholding.py``: a 256-bin
histogram, Otsu's threshold, cv2.inRange, BGR -> grey and the byte-XOR sum
of the mask refinement.  No path of either package calls them; they are an
API of their own.  The float32 arithmetic follows XLA's CPU backend (the
fused multiply-adds and blocked cumsum of ``ops/refine.py``), so the
results are bit-equal to the JAX package's on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from comic_text_detector_tpu_torch.ops.refine import _otsu_from_hist, bgr2gray_u8


def histogram256(img: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """256-bin histogram of a uint8 image, optionally weighted by a mask ->
    (256,) int32."""
    flat = img.reshape(-1).long()
    weights = torch.ones_like(flat, dtype=torch.int32) if mask is None else mask.reshape(-1).to(torch.int32)
    return torch.zeros(256, dtype=torch.int32, device=img.device).scatter_add_(0, flat, weights)


def otsu_threshold(img: torch.Tensor, mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Otsu threshold (maximise the between-class variance; the first
    maximum wins) and the binarized map, (img > t) * 255 as uint8."""
    hist = histogram256(img, mask).to(torch.float32)
    t = _otsu_from_hist(hist[None])[0]
    binary = torch.where(img > t.to(img.dtype), 255, 0).to(torch.uint8)
    return t, binary


def in_range(img: torch.Tensor, low, high) -> torch.Tensor:
    """cv2.inRange: the inclusive band -> 0/255 uint8."""
    return torch.where((img >= low) & (img <= high), 255, 0).to(torch.uint8)


def bgr2gray(img: torch.Tensor) -> torch.Tensor:
    """cv2 BGR -> GRAY weights, rounded to uint8, in XLA's fused order (the
    device refine's ``bgr2gray_u8``)."""
    return bgr2gray_u8(img)


def xor_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Byte-level XOR sum (the reference's refine objective,
    utils/textmask.py:36-37) -> int32."""
    return torch.bitwise_xor(a, b).to(torch.int32).sum(dtype=torch.int32)
