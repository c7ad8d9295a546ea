"""Bilinear resize + letterbox with OpenCV INTER_LINEAR semantics.

Counterpart of the JAX package's ``ops/resize.py``: the letterbox
arithmetic, the cv2-exact uint8 resize as torch on the device (11-bit fixed
point, bit-equal to cv2.resize INTER_LINEAR), its NumPy twin, the host
resize the JAX package uses for the grey mask (``resize_bilinear_fast``:
Pillow's bilinear upscale, reproduced in NumPy, or cv2-exact), and the
training loaders' host letterbox and aspect-keeping resize, whose uint8
path is Pillow's bilinear resample up or down, reproduced in NumPy; and
the device float bilinear resize test-time augmentation scales with
(``resize_bilinear``).  No PIL.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from comic_text_detector_tpu_torch.utils.profiling import count

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


def resize_cv2exact_u8(img_u8: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Device twin of :func:`resize_cv2exact_u8_np` for (H, W[, C]) uint8
    tensors: gathers of precomputed taps and int32 arithmetic."""
    h, w = img_u8.shape[0], img_u8.shape[1]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img_u8
    dev = img_u8.device
    sx, a0, a1 = _cv2_linear_coefs(ow, w)
    sy, b0, b1 = _cv2_linear_coefs(oh, h)

    def t(a):
        count("host_syncs")  # a blocking copy from pageable memory: waits for the stream
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sx, sy = t(sx).long(), t(sy).long()
    sx1, sy1 = (sx + 1).clamp_max(w - 1), (sy + 1).clamp_max(h - 1)
    im = img_u8.to(torch.int32)
    tail = (1,) * (img_u8.dim() - 2)
    a0, a1 = t(a0).view(1, ow, *tail), t(a1).view(1, ow, *tail)
    b0, b1 = t(b0).view(oh, 1, *tail), t(b1).view(oh, 1, *tail)
    row = im.index_select(1, sx) * a0 + im.index_select(1, sx1) * a1
    out = _vertical_8u(
        row.index_select(0, sy), row.index_select(0, sy1), b0, b1,
        lambda v: v.clamp(0, 255), torch.where,
    )
    return out.to(torch.uint8)


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


def letterbox_device_u8(img_u8: torch.Tensor, new_shape: int) -> torch.Tensor:
    """uint8 (H, W, 3) -> uint8 (new, new, 3): cv2-exact resize + bottom/right
    zero pad, staying uint8."""
    h, w = img_u8.shape[0], img_u8.shape[1]
    nh, nw, dw, dh, _ = letterbox_shape(h, w, new_shape)
    x = resize_cv2exact_u8(img_u8, (nh, nw))
    return F.pad(x, (0, 0, 0, dw, 0, dh))


def letterbox_device(img_u8: torch.Tensor, new_shape: int) -> torch.Tensor:
    """uint8 (H, W, 3) -> float32 (new, new, 3) in [0, 1]: the cv2-exact
    letterbox of :func:`letterbox_device_u8`, then / 255."""
    return letterbox_device_u8(img_u8, new_shape).to(torch.float32) / 255.0


def resize_bilinear_np(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Host bilinear resize matching cv2.resize(..., INTER_LINEAR): bit-exact
    for uint8, float arithmetic otherwise."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img.copy()
    if img.dtype == np.uint8:
        return resize_cv2exact_u8_np(img, out_hw)
    x = img.astype(np.float32)
    r0, r1, rf = _lerp_weights(oh, h)
    c0, c1, cf = _lerp_weights(ow, w)
    extra = (None,) * (x.ndim - 2)
    cf = cf[(None, slice(None)) + extra]
    rf = rf[(slice(None), None) + extra]
    top = x[r0][:, c0] * (1 - cf) + x[r0][:, c1] * cf
    bot = x[r1][:, c0] * (1 - cf) + x[r1][:, c1] * cf
    out = top * (1 - rf) + bot * rf
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.round(out), 0, 255).astype(img.dtype)
    return out.astype(img.dtype)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Device bilinear resize of a float NCHW batch to ``out_hw`` (the JAX
    package's ``resize_bilinear`` takes (H, W[, C])): cv2's half-pixel
    sampling, no antialias, edges clamped."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)


def _lerp_weights(dst: int, src: int):
    """Source indices + weights for cv2-style half-pixel bilinear sampling."""
    x = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    x0 = np.floor(x)
    frac = (x - x0).astype(np.float32)
    i0 = np.clip(x0, 0, src - 1).astype(np.int32)
    i1 = np.clip(x0 + 1, 0, src - 1).astype(np.int32)
    frac = np.where(x < 0, 0.0, frac).astype(np.float32)
    return i0, i1, frac


# --- Pillow bit-exact uint8 bilinear upscale ------------------------------------
#
# Pillow's ImagingResample (libImaging/Resample.c) with the bilinear filter:
# per output sample, taps over [xmin, xmin + xmax) of the triangle filter
# centred at (x + 0.5) * scale, normalised in double, then rounded to 22-bit
# fixed point; a horizontal pass into a uint8 image (rounding bias 1 << 21,
# clipped to [0, 255]), then the same vertical pass over it.

_PIL_PRECISION_BITS = 32 - 8 - 2


def _pil_bilinear_coefs(in_size: int, out_size: int):
    """(first tap (out,), fixed-point coefs (out, ksize)) of Pillow's
    precompute_coeffs + normalize_coeffs_8bpc for the bilinear filter."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)[None, :]
    w = 1.0 - np.abs((taps + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where((taps < xmax[:, None]) & (w > 0.0), w, 0.0)
    ww = np.zeros((out_size, 1))
    for t in range(ksize):  # in tap order, as Pillow sums them
        ww[:, 0] += w[:, t]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = w * (1 << _PIL_PRECISION_BITS)
    k = np.where(fixed < 0, np.trunc(-0.5 + fixed), np.trunc(0.5 + fixed)).astype(np.int64)
    return xmin, k


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One Pillow 8bpc resample pass of uint8 ``img`` along ``axis``.  The
    bilinear coefficients are >= 0 and sum to about 2**22, so the sums fit
    int32; taps whose coefficient is 0 for every sample are skipped."""
    in_size = img.shape[axis]
    xmin, k = _pil_bilinear_coefs(in_size, out_size)
    src = img.astype(np.int32)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full((), 1 << (_PIL_PRECISION_BITS - 1), np.int32)
    for t in range(k.shape[1]):
        if not k[:, t].any():
            continue
        idx = np.minimum(xmin + t, in_size - 1)
        acc = acc + np.take(src, idx, axis=axis) * k[:, t].astype(np.int32).reshape(shape)
    return np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_pil_bilinear_u8_np(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bit-exact ``PIL.Image.resize((w, h), BILINEAR)`` of a uint8 (H, W[, C])
    image, up or down (a downscale widens the triangle filter by the scale,
    so it antialiases as Pillow does).  Horizontal pass first, as Pillow
    runs it."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if img.dtype != np.uint8:
        raise ValueError(f"resize_pil_bilinear_u8_np: expected uint8, got {img.dtype}")
    out = img
    if ow != w:
        out = _pil_pass(out, ow, axis=1)
    if oh != h:
        out = _pil_pass(out, oh, axis=0)
    return out.copy() if out is img else out


def resize_bilinear_fast(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Host bilinear resize routed as the JAX package's
    ``resize_bilinear_fast``: Pillow's bilinear where both axes scale up
    and the image is uint8, cv2-exact otherwise."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img.copy()
    if oh >= h and ow >= w and img.dtype == np.uint8:
        return resize_pil_bilinear_u8_np(img, out_hw)
    return resize_bilinear_np(img, out_hw)


def letterbox_np(img: np.ndarray, new_shape: int | Tuple[int, int]) -> Tuple[np.ndarray, Tuple[float, float], Tuple[int, int]]:
    """Host letterbox mirroring the reference API, cv2-exact: returns
    (img, (r, r), (dw, dh))."""
    h, w = img.shape[:2]
    nh, nw, dw, dh, r = letterbox_shape(h, w, new_shape)
    out = resize_bilinear_np(img, (nh, nw))
    pad = ((0, dh), (0, dw), (0, 0)) if img.ndim == 3 else ((0, dh), (0, dw))
    return np.pad(out, pad), (r, r), (dw, dh)


def resize_keepasp_np(img: np.ndarray, max_size: int, fast: bool = False) -> np.ndarray:
    """Aspect-keeping resize (reference resize_keepasp, imgproc_utils.py:119).
    ``fast=True`` takes Pillow's bilinear resample for uint8 images, as the
    JAX package's training loaders do; cv2-exact otherwise."""
    h, w = img.shape[:2]
    r = min(max_size / h, max_size / w)
    out_hw = (int(round(h * r)), int(round(w * r)))
    if fast and img.dtype == np.uint8:
        if out_hw == (h, w):
            return img.copy()
        return resize_pil_bilinear_u8_np(img, out_hw)
    return resize_bilinear_np(img, out_hw)


def letterbox_fast_np(img: np.ndarray, new_shape) -> Tuple[np.ndarray, Tuple[float, float], Tuple[int, int]]:
    """Letterbox with Pillow's bilinear resample for uint8 images (the
    training loaders'), cv2-exact otherwise: returns (img, (r, r), (dw, dh))."""
    h, w = img.shape[:2]
    nh, nw, dw, dh, r = letterbox_shape(h, w, new_shape)
    if img.dtype == np.uint8:
        out = img.copy() if (nh, nw) == (h, w) else resize_pil_bilinear_u8_np(img, (nh, nw))
    else:
        out = resize_bilinear_np(img, (nh, nw))
    pad = ((0, dh), (0, dw), (0, 0)) if img.ndim == 3 else ((0, dh), (0, dw))
    return np.pad(out, pad), (r, r), (dw, dh)
