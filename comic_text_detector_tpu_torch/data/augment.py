"""Image augmentations for the training loaders (host, NumPy).

Own copy of the JAX package's ``data/augment.py``: HSV LUT jitter
(reference seg_dataset.py:37-50), lr-flip, negation, and rotation with
polygon rotation (db_dataset.py:160-174).  The HSV jitter draws from the
``np.random.RandomState`` it is given (the JAX package's defaults to
NumPy's global one).  The rotation computes what Pillow's
``Image.rotate(degrees, resample=BILINEAR, expand=1)`` computes, bit for
bit, in NumPy (``rotate_bilinear_expand``): it needs no Pillow.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from comic_text_detector_tpu_torch.utils.imgproc import rotate_polygons


def _bgr_to_hsv_u8(im: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2 BGR->HSV for uint8: H in [0,180), S,V in [0,255]."""
    b, g, r = im[..., 0].astype(np.float32), im[..., 1].astype(np.float32), im[..., 2].astype(np.float32)
    maxc = np.maximum(np.maximum(b, g), r)
    minc = np.minimum(np.minimum(b, g), r)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-9) * 255.0, 0.0)
    h = np.zeros_like(maxc)
    m = delta > 0
    rc = np.where(m, (maxc - r) / np.maximum(delta, 1e-9), 0)
    gc = np.where(m, (maxc - g) / np.maximum(delta, 1e-9), 0)
    bc = np.where(m, (maxc - b) / np.maximum(delta, 1e-9), 0)
    h = np.where(maxc == r, bc - gc, h)
    h = np.where((maxc == g) & m, 2.0 + rc - bc, h)
    h = np.where((maxc == b) & m, 4.0 + gc - rc, h)
    h = (h * 30.0) % 180.0
    return (
        np.round(h).astype(np.uint8) % 180,
        np.clip(np.round(s), 0, 255).astype(np.uint8),
        np.clip(np.round(v), 0, 255).astype(np.uint8),
    )


def _hsv_to_bgr_u8(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    hf = h.astype(np.float32) / 30.0  # sector in [0,6)
    sf = s.astype(np.float32) / 255.0
    vf = v.astype(np.float32)
    i = np.floor(hf).astype(np.int32) % 6
    f = hf - np.floor(hf)
    p = vf * (1 - sf)
    q = vf * (1 - sf * f)
    t = vf * (1 - sf * (1 - f))
    r = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [vf, q, p, p, t, vf])
    g = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [t, vf, vf, q, p, p])
    b = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [p, p, t, vf, vf, q])
    out = np.stack([b, g, r], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def augment_hsv(im: np.ndarray, hgain: float = 0.5, sgain: float = 0.5, vgain: float = 0.5, *,
                rng: np.random.RandomState) -> np.ndarray:
    """Random HSV gains via LUTs, three draws from ``rng`` (in place
    semantics of the reference)."""
    r = rng.uniform(-1, 1, 3) * np.array([hgain, sgain, vgain]) + 1
    hue, sat, val = _bgr_to_hsv_u8(im)
    x = np.arange(256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(np.uint8)
    lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8)
    out = _hsv_to_bgr_u8(lut_hue[hue], lut_sat[sat], lut_val[val])
    if im.flags.writeable:
        im[:] = out  # in-place like the reference (cv2 dst=im)
        return im
    return out


def flip_lr(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[:, ::-1])


def negate(img: np.ndarray) -> np.ndarray:
    return 255 - img


def _rotate_matrix(w: int, h: int, degrees: float):
    """Pillow's ``rotate`` with ``expand``: the inverse affine matrix (the
    output pixel to its source point) and the expanded size, in its float
    order (entries rounded to 15 digits, the size from the transformed
    corners, the translation moved onto the new centre)."""
    a = -math.radians(degrees)
    m = [round(math.cos(a), 15), round(math.sin(a), 15), 0.0, round(-math.sin(a), 15), round(math.cos(a), 15), 0.0]

    def transform(x, y):
        return m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]

    m[2], m[5] = transform(-w / 2, -h / 2)
    m[2] += w / 2
    m[5] += h / 2
    xx, yy = zip(*(transform(x, y) for x, y in ((0, 0), (w, 0), (w, h), (0, h))))
    nw = math.ceil(max(xx)) - math.floor(min(xx))
    nh = math.ceil(max(yy)) - math.floor(min(yy))
    m[2], m[5] = transform(-(nw - w) / 2.0, -(nh - h) / 2.0)
    return m, nw, nh


def rotate_bilinear_expand(img: np.ndarray, degrees: float) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).rotate(degrees, Image.BILINEAR,
    expand=1))`` for a uint8 (H, W) or (H, W, C) image, C <= 3, without
    Pillow.

    The angle is taken mod 360; 0, 90, 180 and 270 are a copy or a
    transpose.  Otherwise each output pixel samples its source point at
    (x + 0.5, y + 0.5) through the inverse matrix in float64; a point outside
    [0, W) x [0, H) is 0.  The bilinear filter subtracts 0.5, floors, clamps
    the neighbours' columns and the upper row, interpolates the two rows in
    x and then in y as ``a + (b - a) * d`` (the bottom row, with no row
    below, interpolates in x alone) and truncates to uint8, as Pillow's
    ``bilinear_filter8`` / ``bilinear_filter32RGB`` do."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] > 3):
        raise ValueError(f"rotate takes a uint8 (H, W) or (H, W, C<=3) image, not {img.dtype} {img.shape}")
    angle = float(degrees) % 360.0
    if angle == 0:
        return img.copy()
    if angle in (90.0, 180.0, 270.0):
        return np.ascontiguousarray(np.rot90(img, int(angle) // 90))
    h, w = img.shape[:2]
    m, nw, nh = _rotate_matrix(w, h, angle)
    xin = np.arange(nw, dtype=np.float64) + 0.5
    yin = (np.arange(nh, dtype=np.float64) + 0.5)[:, None]
    xs = m[0] * xin + m[1] * yin
    xs += m[2]
    ys = m[3] * xin + m[4] * yin
    ys += m[5]
    sel = np.flatnonzero((xs >= 0.0) & (xs < w) & (ys >= 0.0) & (ys < h))
    xs = xs.ravel()[sel]
    xs -= 0.5
    ys = ys.ravel()[sel]
    ys -= 0.5
    x0, y0 = np.floor(xs), np.floor(ys)
    dx, dy = xs - x0, ys - y0
    x0, y0 = x0.astype(np.intp), y0.astype(np.intp)
    alone = y0 >= h - 1  # y0 >= -1 always: only the bottom row lacks a row below
    xa, xb = np.maximum(x0, 0), np.minimum(x0 + 1, w - 1)
    ra, rb = np.maximum(y0, 0) * w, np.minimum(y0 + 1, h - 1) * w
    corners = (ra + xa, ra + xb, rb + xa, rb + xb)
    planes = img[None] if img.ndim == 2 else np.moveaxis(img, 2, 0)
    out = np.zeros((nh * nw, len(planes)), np.uint8)
    for k, plane in enumerate(planes):  # a loop over channels, not pixels
        g00, g01, g10, g11 = (np.ascontiguousarray(plane).ravel().take(i).astype(np.float64) for i in corners)
        v1 = (g01 - g00) * dx
        v1 += g00
        v2 = (g11 - g10) * dx
        v2 += g10
        np.copyto(v2, v1, where=alone)
        v2 -= v1
        v2 *= dy
        v2 += v1
        out[sel, k] = v2  # float -> uint8 truncates, as Pillow's cast
    out = out.reshape(nh, nw, len(planes))
    return out if img.ndim == 3 else out[..., 0]


def rotate_image_and_polys(img: np.ndarray, ann: np.ndarray, degrees: float):
    """Pillow's bilinear rotate with expand (``rotate_bilinear_expand``) and
    the polygons rotated with it, normalized coords in/out (reference
    db_dataset.py:160-174)."""
    rotated = rotate_bilinear_expand(img, degrees)
    if len(ann) == 0:  # textless page: rotate the image alone
        return rotated, ann
    h, w = img.shape[:2]
    nh, nw = rotated.shape[:2]
    ann = ann.copy()
    ann[:, :, 0] *= w
    ann[:, :, 1] *= h
    flat = ann.reshape(len(ann), -1)
    flat = rotate_polygons((w / 2, h / 2), flat, degrees, (nw / 2, nh / 2), to_int=False)
    ann = flat.reshape(len(ann), -1, 2)
    ann[:, :, 0] /= nw
    ann[:, :, 1] /= nh
    return rotated, ann
