"""Weight initialization transforms (reference utils/weight_init.py).

Counterpart of the JAX package's ``training/init.py``: the bilinear
transposed-convolution kernel (:75-88).  The reference's explicit init
recipe (init_weights :91-103) is ``models/init.py::apply_reference_init``,
which inference's ``random_init`` uses too.
"""

from __future__ import annotations

import numpy as np


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
