"""Image augmentations for the training loaders (host, NumPy).

Own copy of the JAX package's ``data/augment.py``: HSV LUT jitter
(reference seg_dataset.py:37-50), lr-flip, negation, and rotation with
polygon rotation (db_dataset.py:160-174).  The HSV jitter draws from the
``np.random.RandomState`` it is given (the JAX package's defaults to
NumPy's global one).  The rotation is Pillow's and imports it inside the
call: it does not run where Pillow is absent.
"""

from __future__ import annotations

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


def rotate_image_and_polys(img: np.ndarray, ann: np.ndarray, degrees: float):
    """PIL rotate with expand + polygon rotation, normalized coords in/out
    (reference db_dataset.py:160-174).  Needs Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("rotate augmentation needs Pillow, which is not installed: set aug_param "
                           "rotate to 0") from e

    pil = Image.fromarray(img)
    if len(ann) == 0:  # textless page: rotate the image alone
        pil = pil.rotate(degrees, resample=Image.BILINEAR, expand=1)
        return np.asarray(pil), ann
    center = (pil.width / 2, pil.height / 2)
    ann = ann.copy()
    ann[:, :, 0] *= pil.width
    ann[:, :, 1] *= pil.height
    flat = ann.reshape(len(ann), -1)
    pil = pil.rotate(degrees, resample=Image.BILINEAR, expand=1)
    new_center = (pil.width / 2, pil.height / 2)
    flat = rotate_polygons(center, flat, degrees, new_center, to_int=False)
    ann = flat.reshape(len(ann), -1, 2)
    ann[:, :, 0] /= pil.width
    ann[:, :, 1] /= pil.height
    return np.asarray(pil), ann
