"""Bit-packing for 1-bpp mask transfers.

Counterpart of the JAX package's ``ops/bits.py``.  Output is byte-identical
to ``np.packbits(x, axis=-1)`` (MSB-first, zero-padded to a byte), which the
host unpacks with ``np.unpackbits``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def packbits_rows(bits: torch.Tensor) -> torch.Tensor:
    """(..., W) bool/int -> (..., ceil(W/8)) uint8, MSB-first per byte."""
    x = (bits != 0).to(torch.uint8)
    pad = (-x.shape[-1]) % 8
    if pad:
        x = F.pad(x, (0, pad))
    acc = x[..., 0::8] << 7
    for k in range(1, 8):
        acc = acc | (x[..., k::8] << (7 - k))
    return acc
