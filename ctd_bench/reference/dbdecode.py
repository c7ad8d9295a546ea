"""DB shrink map -> text-line quads, in NumPy (float64).

The semantics of the port's ``ops/db_decode.py`` (and of the reference
``SegDetectorRepresenter``'s boxes): the map binarized at ``thresh``,
8-connected components numbered in raster order of their first pixel (at
most ``capacity - 1`` of them), the boundary pixels (a 4-neighbour with
another label, the image border counting as one) taken in (component,
raster) order and cut after ``max_boundary`` of them, the minimum-area
rectangle of each component's boundary over ``angle_steps`` angles of a
quarter turn, inflated by area * ``unclip_ratio`` / perimeter; a component
whose short side is under 2 px is dropped, and its score is the map's mean
over its pixels.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

from ctd_bench.reference import geometry as geo


def decode(shrink: np.ndarray, thresh: float, capacity: int = 256, angle_steps: int = 90,
           max_boundary: int = 8192, unclip_ratio: float = 1.5):
    """(H, W) float32 map -> (quads (N, 4, 2) int32 in map pixels, scores (N,))."""
    h, w = shrink.shape
    bitmap = shrink > np.float32(thresh)
    labels, n = ndimage.label(bitmap, structure=np.ones((3, 3), bool))
    pad = np.pad(labels, 1, constant_values=-1)
    same = ((pad[:-2, 1:-1] == labels) & (pad[2:, 1:-1] == labels)
            & (pad[1:-1, :-2] == labels) & (pad[1:-1, 2:] == labels))
    boundary = (labels > 0) & ~same
    idx = np.flatnonzero(boundary)
    ids = labels.reshape(-1)[idx]
    order = np.lexsort((idx, ids))[:max_boundary]
    idx, ids = idx[order], ids[order]
    keep = ids < capacity
    idx, ids = idx[keep], ids[keep]
    xs, ys = (idx % w).astype(np.float64), (idx // w).astype(np.float64)
    angles = np.arange(angle_steps, dtype=np.float64) * (math.pi / 2 / angle_steps)
    ca, sa = np.cos(angles), np.sin(angles)
    flat = labels.reshape(-1)
    area = np.bincount(flat, minlength=n + 1)
    vsum = np.bincount(flat, weights=shrink.reshape(-1).astype(np.float64), minlength=n + 1)
    quads, scores = [], []
    for comp in np.unique(ids):
        sel = ids == comp
        px, py = xs[sel], ys[sel]
        u = px[:, None] * ca[None] + py[:, None] * sa[None]
        v = -px[:, None] * sa[None] + py[:, None] * ca[None]
        umin, umax, vmin, vmax = u.min(0), u.max(0), v.min(0), v.max(0)
        best = int(np.argmin((umax - umin) * (vmax - vmin)))
        bw, bh = umax[best] - umin[best], vmax[best] - vmin[best]
        if min(bw, bh) < 2.0:
            continue
        per = 2.0 * (bw + bh)
        dist = bw * bh * unclip_ratio / per if per > 0 else 0.0
        u0, u1 = umin[best] - dist, umax[best] + dist
        v0, v1 = vmin[best] - dist, vmax[best] + dist
        c, s = ca[best], sa[best]
        cu = np.array([u0, u1, u1, u0])
        cv = np.array([v0, v0, v1, v1])
        box = np.stack([cu * c - cv * s, cu * s + cv * c], axis=-1)
        box = geo.order_rect_points(box)
        box[:, 0] = np.clip(np.round(box[:, 0]), 0, w)
        box[:, 1] = np.clip(np.round(box[:, 1]), 0, h)
        quads.append(box.astype(np.int32))
        scores.append(vsum[comp] / area[comp])
    if not quads:
        return np.zeros((0, 4, 2), np.int32), np.zeros((0,), np.float64)
    return np.stack(quads), np.asarray(scores)
