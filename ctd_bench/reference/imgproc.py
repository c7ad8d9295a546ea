"""Host image/box utilities (NumPy + scipy, no OpenCV).

Functional equivalents of the reference's utils/imgproc_utils.py helpers and
the cv2 filter/threshold primitives its mask refinement leans on
(utils/textmask.py).  All uint8 semantics (0/255 masks, byte-level XOR) are
preserved — the refinement's greedy XOR objective operates on raw bytes.

Own copy of the JAX package's ``utils/imgproc.py``.

Frozen copy of the port's ``utils/imgproc.py`` for the benchmark's plain reference,
which imports nothing of the port.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

# --- box format conversions (reference imgproc_utils.py:31-66) ---


def intersect_area(bboxa: Sequence[float], bboxb: Sequence[float]) -> float:
    """Intersection area of two xyxy boxes, -1 when disjoint (the reference
    calls this ``union_area``, imgproc_utils.py:13 — name kept off to avoid
    propagating the misnomer)."""
    x1 = max(bboxa[0], bboxb[0])
    y1 = max(bboxa[1], bboxb[1])
    x2 = min(bboxa[2], bboxb[2])
    y2 = min(bboxa[3], bboxb[3])
    if y2 < y1 or x2 < x1:
        return -1
    return (y2 - y1) * (x2 - x1)


def xywh2xyxypoly(xywh: np.ndarray, to_int: bool = True) -> np.ndarray:
    """(N,4) xywh -> (N,8) 4-corner polys [tl, tr, br, bl]."""
    poly = np.tile(xywh[:, [0, 1]], 4)
    poly[:, [2, 4]] += xywh[:, [2]]
    poly[:, [5, 7]] += xywh[:, [3]]
    return poly.astype(np.int64) if to_int else poly


def xyxy2yolo(xyxy, w: int, h: int) -> Optional[np.ndarray]:
    """(N, 4) pixel xyxy boxes -> (N, 4) YOLO (cx, cy, w, h) normalised by
    the page's ``w`` and ``h``; None for no boxes."""
    if xyxy is None or len(xyxy) == 0:
        return None
    xyxy = np.asarray(xyxy, np.float64)
    if xyxy.ndim == 1:
        xyxy = xyxy[None]
    yolo = xyxy.copy()
    yolo[:, [0, 2]] /= w
    yolo[:, [1, 3]] /= h
    yolo[:, [2, 3]] -= yolo[:, [0, 1]]
    yolo[:, [0, 1]] += yolo[:, [2, 3]] / 2
    return yolo


def yolo_xywh2xyxy(xywh: np.ndarray, w: int, h: int, to_int: bool = True) -> Optional[np.ndarray]:
    """Inverse of :func:`xyxy2yolo`: normalised (cx, cy, w, h) -> pixel
    xyxy, int64 with ``to_int``; None for no boxes."""
    if xywh is None or len(xywh) == 0:
        return None
    xywh = np.asarray(xywh, np.float64)
    if xywh.ndim == 1:
        xywh = xywh[None]
    xywh = xywh.copy()
    xywh[:, [0, 2]] *= w
    xywh[:, [1, 3]] *= h
    xywh[:, [0, 1]] -= xywh[:, [2, 3]] / 2
    xywh[:, [2, 3]] += xywh[:, [0, 1]]
    return xywh.astype(np.int64) if to_int else xywh


def get_yololabel_strings(clslist, labellist) -> str:
    """YOLO label file text: one ``cls cx cy w h`` line a box."""
    lines = [str(int(c)) + " " + " ".join(str(e) for e in xywh) for c, xywh in zip(clslist, labellist)]
    return "\n".join(lines)


def rotate_polygons(center, polygons: np.ndarray, rotation: float, new_center=None, to_int: bool = True):
    """Rotate (N,8) flat polygons about ``center`` by ``rotation`` degrees.

    Matches the reference's (transposed) rotation convention
    (imgproc_utils.py:68-84)."""
    if new_center is None:
        new_center = center
    r = np.deg2rad(rotation)
    s, c = np.sin(r), np.cos(r)
    poly = np.asarray(polygons, np.float32).copy()
    poly[:, 1::2] -= center[1]
    poly[:, ::2] -= center[0]
    rotated = poly.copy()
    rotated[:, 1::2] = poly[:, 1::2] * c - poly[:, ::2] * s
    rotated[:, ::2] = poly[:, 1::2] * s + poly[:, ::2] * c
    rotated[:, 1::2] += new_center[1]
    rotated[:, ::2] += new_center[0]
    return rotated.astype(np.int64) if to_int else rotated


def expand_textwindow(img_size, xyxy, expand_r: int = 8, shrink: bool = False) -> List[int]:
    """Grow a block bbox by a size-relative padding (imgproc_utils.py:151)."""
    im_h, im_w = img_size[:2]
    x1, y1, x2, y2 = xyxy
    w, h = x2 - x1, y2 - y1
    pad = int(round((max(h, w) * 0.25 + min(h, w) * 0.75) / expand_r))
    if shrink:
        pad = -pad
    return [max(0, x1 - pad), max(0, y1 - pad), min(im_w - 1, x2 + pad), min(im_h - 1, y2 + pad)]


# --- cv2 primitive equivalents (uint8 semantics) ---

KERNEL_RECT3 = np.ones((3, 3), bool)
KERNEL_ELLIPSE3 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)  # cv2 MORPH_ELLIPSE (3,3)


def bgr2gray(img: np.ndarray) -> np.ndarray:
    """cv2.COLOR_BGR2GRAY: 0.114 B + 0.587 G + 0.299 R with rounding."""
    g = img[..., 0] * 0.114 + img[..., 1] * 0.587 + img[..., 2] * 0.299
    return np.clip(np.round(g), 0, 255).astype(np.uint8)


def grey_erode(img: np.ndarray, footprint: np.ndarray = KERNEL_RECT3, iterations: int = 1) -> np.ndarray:
    """cv2.erode (min filter) with replicate border."""
    out = img
    for _ in range(iterations):
        out = ndimage.minimum_filter(out, footprint=footprint, mode="nearest")
    return out


def grey_dilate(img: np.ndarray, footprint: np.ndarray = KERNEL_RECT3, iterations: int = 1) -> np.ndarray:
    out = img
    for _ in range(iterations):
        out = ndimage.maximum_filter(out, footprint=footprint, mode="nearest")
    return out


def threshold_binary(img: np.ndarray, thresh: float, maxval: int = 255) -> np.ndarray:
    """cv2.threshold(..., THRESH_BINARY): img > thresh -> maxval."""
    return np.where(img > thresh, np.uint8(maxval), np.uint8(0))


def otsu_threshold(img: np.ndarray) -> Tuple[float, np.ndarray]:
    """cv2 THRESH_OTSU + THRESH_BINARY on a uint8 single-channel image.

    Returns (threshold, binary 0/255).  Threshold maximizes inter-class
    variance over the 256-bin histogram, ties resolved like cv2 (average of
    the plateau is not taken — cv2 keeps the max-variance bin scanning up)."""
    hist = np.bincount(img.reshape(-1), minlength=256).astype(np.float64)
    total = hist.sum()
    if total == 0:
        return 0.0, np.zeros_like(img)
    idx = np.arange(256, dtype=np.float64)
    w0 = np.cumsum(hist)
    w1 = total - w0
    s0 = np.cumsum(hist * idx)
    mu = s0[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        m0 = s0 / w0
        m1 = (mu - s0) / w1
        between = w0 * w1 * (m0 - m1) ** 2
    between = np.nan_to_num(between)
    t = float(np.argmax(between))
    return t, threshold_binary(img, t)


def in_range(img: np.ndarray, low: float, high: float) -> np.ndarray:
    """cv2.inRange (inclusive bounds) -> 0/255 uint8."""
    return np.where((img >= low) & (img <= high), np.uint8(255), np.uint8(0))


def connected_components_with_stats(mask: np.ndarray, connectivity: int = 8):
    """cv2.connectedComponentsWithStats equivalent via scipy.ndimage.

    Returns (num_labels, labels int32, stats (N,5) [x,y,w,h,area],
    centroids (N,2)).  Label order = first row-major encounter; stats[0] is
    the background row, like cv2.
    """
    structure = np.ones((3, 3)) if connectivity == 8 else None
    labels, n = ndimage.label(mask > 0, structure=structure)
    num = n + 1
    stats = np.zeros((num, 5), np.int32)
    centroids = np.zeros((num, 2), np.float64)
    flat = labels.reshape(-1)
    area = np.bincount(flat, minlength=num)
    h, w = mask.shape
    ys = np.repeat(np.arange(h), w)
    xs = np.tile(np.arange(w), h)
    sum_x = np.bincount(flat, weights=xs, minlength=num)
    sum_y = np.bincount(flat, weights=ys, minlength=num)
    with np.errstate(divide="ignore", invalid="ignore"):
        centroids[:, 0] = sum_x / area
        centroids[:, 1] = sum_y / area
    xmin = np.full(num, w, np.int64)
    xmax = np.full(num, -1, np.int64)
    ymin = np.full(num, h, np.int64)
    ymax = np.full(num, -1, np.int64)
    np.minimum.at(xmin, flat, xs)
    np.maximum.at(xmax, flat, xs)
    np.minimum.at(ymin, flat, ys)
    np.maximum.at(ymax, flat, ys)
    stats[:, 0] = xmin
    stats[:, 1] = ymin
    stats[:, 2] = xmax - xmin + 1
    stats[:, 3] = ymax - ymin + 1
    stats[:, 4] = area
    return num, labels.astype(np.int32), stats, centroids


def warp_perspective(img: np.ndarray, M: np.ndarray, out_wh: Tuple[int, int]) -> np.ndarray:
    """cv2.warpPerspective equivalent (inverse-map bilinear sampling)."""
    w, h = out_wh
    Minv = np.linalg.inv(M)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones], axis=-1) @ Minv.T
    sx = pts[..., 0] / pts[..., 2]
    sy = pts[..., 1] / pts[..., 2]
    H, W = img.shape[:2]
    x0 = np.clip(np.floor(sx).astype(int), 0, W - 1)
    y0 = np.clip(np.floor(sy).astype(int), 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    fx = np.clip(sx - x0, 0, 1)[..., None] if img.ndim == 3 else np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)[..., None] if img.ndim == 3 else np.clip(sy - y0, 0, 1)
    imgf = img.astype(np.float64)
    out = (
        imgf[y0, x0] * (1 - fx) * (1 - fy)
        + imgf[y0, x1] * fx * (1 - fy)
        + imgf[y1, x0] * (1 - fx) * fy
        + imgf[y1, x1] * fx * fy
    )
    oob = (sx < -1) | (sx > W) | (sy < -1) | (sy > H)
    out[oob] = 0
    return np.clip(np.round(out), 0, 255).astype(img.dtype) if np.issubdtype(img.dtype, np.integer) else out


def perspective_transform_matrix(src_pts: np.ndarray, dst_pts: np.ndarray) -> np.ndarray:
    """3x3 homography from 4 point correspondences (DLT, exact for 4 pts) —
    replaces cv2.findHomography for the quad case."""
    A = []
    for (x, y), (u, v) in zip(np.asarray(src_pts, np.float64), np.asarray(dst_pts, np.float64)):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    A = np.asarray(A)
    _, _, vt = np.linalg.svd(A)
    Hm = vt[-1].reshape(3, 3)
    return Hm / Hm[2, 2]
