"""The letterbox arithmetic and the cv2-exact uint8 bilinear resize in
NumPy (11-bit fixed point, bit-equal to cv2.resize INTER_LINEAR): frozen
copy of the port's ``ops/resize.py`` parts the reference's page path uses.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# --- cv2 bit-exact uint8 bilinear ------------------------------------------------
#
# cv2.resize(..., INTER_LINEAR) on uint8 runs in 11-bit fixed point: per-axis
# coefficients `saturate_cast<short>(f * 2048)` (float32 products, round half
# to even), an integer horizontal pass, and the 8U vertical specialization
#   dst = ((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2.
# All intermediates fit int32 (coef pairs sum to 2048).


def _cv2_linear_coefs(dst: int, src: int):
    """(src index, coef0, coef1) per dst sample, cv2 INTER_LINEAR 8U rules."""
    scale = src / dst
    x = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    sx = np.floor(x).astype(np.int64)
    fx = (x - sx).astype(np.float32)
    fx = np.where(sx < 0, np.float32(0.0), fx)
    sx = np.maximum(sx, 0)
    if src > 1:
        fx = np.where(sx >= src - 1, np.float32(1.0), fx)
        sx = np.minimum(sx, src - 2)
    else:
        fx = np.zeros_like(fx)
        sx = np.zeros_like(sx)
    a0 = np.rint((np.float32(1.0) - fx) * np.float32(2048)).astype(np.int32)
    a1 = np.rint(fx * np.float32(2048)).astype(np.int32)
    return sx.astype(np.int32), a0, a1


def _vertical_8u(s0, s1, b0, b1, clip, where):
    """cv2's 8U vertical pass on int32 rows ``s0``/``s1``.  Rows copied
    vertically (coef 2048/0) take cv2's 1-D cast, (S + 1023) >> 11."""
    t = ((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16)
    out = clip((t + 2) >> 2)
    out = where(b0 == 2048, clip((s0 + 1023) >> 11), out)
    return where(b1 == 2048, clip((s1 + 1023) >> 11), out)


def resize_cv2exact_u8_np(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bit-exact cv2.resize INTER_LINEAR for uint8 (H, W[, C]) images."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img.copy()
    sx, a0, a1 = _cv2_linear_coefs(ow, w)
    sy, b0, b1 = _cv2_linear_coefs(oh, h)
    sx1 = np.minimum(sx + 1, w - 1)
    sy1 = np.minimum(sy + 1, h - 1)
    im = img.astype(np.int32)
    if img.ndim == 3:
        row = im[:, sx] * a0[None, :, None] + im[:, sx1] * a1[None, :, None]
        b0, b1 = b0[:, None, None], b1[:, None, None]
    else:
        row = im[:, sx] * a0[None, :] + im[:, sx1] * a1[None, :]
        b0, b1 = b0[:, None], b1[:, None]
    out = _vertical_8u(row[sy], row[sy1], b0, b1, lambda v: np.clip(v, 0, 255), np.where)
    return out.astype(np.uint8)


def letterbox_shape(h: int, w: int, new_shape: int | Tuple[int, int]) -> Tuple[int, int, int, int, float]:
    """(resized_h, resized_w, dw, dh, r) for a letterbox to ``new_shape``.

    Mirrors reference letterbox math (imgproc_utils.py:93-110, auto=False):
    scale r=min(target/h, target/w), round to nearest, pad bottom/right only.
    """
    if not isinstance(new_shape, tuple):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / h, new_shape[1] / w)
    nw, nh = int(round(w * r)), int(round(h * r))
    dw, dh = new_shape[1] - nw, new_shape[0] - nh
    return nh, nw, dw, dh, r


# --- Pillow bit-exact uint8 bilinear upscale ------------------------------------
#
# Pillow's ImagingResample (libImaging/Resample.c) with the bilinear filter:
# per output sample, taps over [xmin, xmin + xmax) of the triangle filter
# centred at (x + 0.5) * scale, normalised in double, then rounded to 22-bit
# fixed point; a horizontal pass into a uint8 image (rounding bias 1 << 21,
# clipped to [0, 255]), then the same vertical pass over it.

_PIL_PRECISION_BITS = 32 - 8 - 2


