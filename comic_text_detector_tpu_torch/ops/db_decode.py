"""DB (differentiable binarization) shrink map -> text-line boxes.

Counterpart of the JAX package's ``ops/db_decode.py``.  The map is
binarized by K6 (``ops/finalize.py::binarize``) and its components are
labelled on the device by one of two routes, as in the JAX package:

* rank ids (maps of at most 1024x1024 elements by default): dense
  raster-order ids straight from the CC kernels
  (``ops/cc_kernels.py::cc_ids_windows_local``, K2 -> cumsum -> K3);
* labels (larger maps, or ``rank_ids=False``): raw labels from
  ``ops/cc.py::connected_components`` (K2 on the card at every size),
  then dense ids from the first appearances of each label in the sorted
  boundary table.

A sorted table of boundary pixels feeds a 90-angle min-area-rect scan.  The
component areas and probability sums are segmented reductions over the
pixels sorted by id (``ops/cc.py::component_sums``), so neither depends on
the order of the card's atomics: repeated runs give the same bits.
``db_decode_batch`` binarizes and labels a stack of maps with one call of
each; ``boxes_from_device_rects`` is the host finisher.

The host half of ``SegDetectorRepresenter`` is here too:
``db_device_decode`` (labels and component statistics on the device),
``boxes_from_stats`` (quads, through the port's host library,
``native.py``, as the JAX package's route through its native extension;
the NumPy route stays as its plain version) and ``polygons_from_stats``
(boundary trace, Douglas-Peucker, round-join offset).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from comic_text_detector_tpu_torch import native
from comic_text_detector_tpu_torch.constants import MAX_DB_COMPONENTS
from comic_text_detector_tpu_torch.ops import geometry as geo
from comic_text_detector_tpu_torch.ops.cc import (
    ComponentStats,
    component_stats,
    component_sums,
    connected_components,
)
from comic_text_detector_tpu_torch.ops.cc_kernels import IDS_MAX_ELEMS, cc_ids_windows_local
from comic_text_detector_tpu_torch.ops.finalize import binarize
from comic_text_detector_tpu_torch.utils.profiling import count


def db_device_decode(shrink_map: torch.Tensor, thresh: float, capacity: int = MAX_DB_COMPONENTS) -> ComponentStats:
    """Device half: an (H, W) probability map -> its components' statistics
    (and the compact label map)."""
    bitmap = binarize(shrink_map.to(torch.float32), thresh)
    labels = connected_components(bitmap, 8)
    return component_stats(labels, shrink_map, capacity)


def _segment_reduce(values: torch.Tensor, ids: torch.Tensor, n: int, reduce: str) -> torch.Tensor:
    """``jax.ops.segment_min``/``max`` over rows: empty segments hold the
    reduction's identity (+inf for min, -inf for max)."""
    fill = math.inf if reduce == "amin" else -math.inf
    out = torch.full((n, values.shape[1]), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, ids[:, None].expand_as(values), values, reduce)


def db_decode_batch(
    shrink_maps: torch.Tensor,
    thresh: float,
    capacity: int = MAX_DB_COMPONENTS,
    angle_steps: int = 90,
    max_boundary: int = 8192,
    rank_ids: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) float32 probability maps -> (boxes (B, C, 4, 2) f32, scores
    (B, C), valid (B, C)), each page as :func:`db_decode_full_device` decodes
    it.  One K6 launch binarizes the stack, reading page-strided planes in
    place (``lines[:, 0]`` of the DB head's output is not copied), and one
    ``cc_ids_windows_local`` or ``connected_components`` call labels it; the
    boundary table and angle scan run page by page on views of each plane."""
    h, w = shrink_maps.shape[-2:]
    if rank_ids is None:
        rank_ids = h * w <= IDS_MAX_ELEMS
    bitmaps = binarize(shrink_maps, thresh)
    labels = cc_ids_windows_local(bitmaps) if rank_ids else connected_components(bitmaps, 8)
    outs = [
        _decode_labeled(shrink_maps[i], labels[i], capacity, angle_steps, max_boundary, rank_ids)
        for i in range(shrink_maps.shape[0])
    ]
    return tuple(torch.stack(t) for t in zip(*outs))


def db_decode_full_device(
    shrink_map: torch.Tensor,
    thresh: float,
    capacity: int = MAX_DB_COMPONENTS,
    angle_steps: int = 90,
    max_boundary: int = 8192,
    rank_ids: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W) probability map -> (boxes (C, 4, 2) f32 inflated by the DB
    unclip rule, scores (C,), valid (C,)).

    Components whose dense id is ``capacity`` or more, and boundary points
    past the first ``max_boundary`` of the (id, linear index) order, are
    dropped, as in the JAX package.  Exact for axis-aligned text (angle 0 is
    on the grid), within (90/angle_steps)° otherwise.  ``rank_ids=None``
    takes the rank-ids route for maps of at most 1024x1024 elements and the
    labels route above; both give the same outputs.
    """
    boxes, scores, valid = db_decode_batch(shrink_map[None], thresh, capacity, angle_steps, max_boundary, rank_ids)
    return boxes[0], scores[0], valid[0]


def _decode_labeled(
    shrink_map: torch.Tensor, labels: torch.Tensor, capacity: int, angle_steps: int, max_boundary: int,
    rank_ids: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One page's decode from its map and its labels: dense component ids
    (``rank_ids``) or raw labels, the minimum linear index + 1."""
    h, w = shrink_map.shape
    dev = shrink_map.device

    # boundary pixels: any 4-neighbour differs (the image border counts)
    big = h * w + 1
    pad = F.pad(labels, (1, 1, 1, 1), value=-1)
    nbr_same = (
        (pad[:-2, 1:-1] == labels)
        & (pad[2:, 1:-1] == labels)
        & (pad[1:-1, :-2] == labels)
        & (pad[1:-1, 2:] == labels)
    )
    boundary = (labels > 0) & ~nbr_same
    key = torch.where(boundary, labels, big).reshape(-1)
    # a stable sort of the id keeps linear-index order within each id
    skey, sidx = torch.sort(key, stable=True)
    k = min(max_boundary, skey.numel())
    skey, sidx = skey[:k], sidx[:k]
    bx = (sidx % w).to(torch.float32)
    by = (sidx // w).to(torch.float32)
    valid_pt = skey < big
    if rank_ids:
        # the kernel's ids are the dense numbering: roots ascend in raster
        # order, as first appearances do in the sorted table
        dense = torch.where(valid_pt & (skey < capacity), skey, 0).long()
        ids = labels
    else:
        # dense ids in sorted (minimum linear index) order, and a small
        # label -> dense table for the pixels
        first = valid_pt.clone()
        first[1:] &= skey[1:] != skey[:-1]
        dense = torch.cumsum(first, 0)
        dense = torch.where(valid_pt & (dense < capacity), dense, 0)
        lut = torch.zeros(h * w + 2, dtype=torch.int64, device=dev)
        lut.scatter_reduce_(0, torch.where(valid_pt, skey, 0).long(), dense, "amax")
        count("host_syncs")
        lut[0] = 0
        ids = lut[labels.reshape(-1).long()].view(h, w)

    # batched angle scan over the boundary table: extents per (comp, angle)
    angles = torch.arange(angle_steps, dtype=torch.float32, device=dev) * (math.pi / 2 / angle_steps)
    ca, sa = torch.cos(angles), torch.sin(angles)
    u = bx[:, None] * ca[None, :] + by[:, None] * sa[None, :]  # (K, A)
    v = -bx[:, None] * sa[None, :] + by[:, None] * ca[None, :]
    uv = torch.cat([u, v], dim=1)  # (K, 2A)
    uv_min = _segment_reduce(uv, dense, capacity, "amin")
    uv_max = _segment_reduce(uv, dense, capacity, "amax")
    umin, vmin = uv_min[:, :angle_steps], uv_min[:, angle_steps:]
    umax, vmax = uv_max[:, :angle_steps], uv_max[:, angle_steps:]
    areas = (umax - umin) * (vmax - vmin)  # (C, A)
    best = torch.argmin(areas, dim=1, keepdim=True)
    e0, e1 = umin.gather(1, best)[:, 0], umax.gather(1, best)[:, 0]
    e2, e3 = vmin.gather(1, best)[:, 0], vmax.gather(1, best)[:, 0]
    a = angles[best[:, 0]]
    bw = e1 - e0
    bh = e3 - e2

    # component area & probability sum over the full map
    counts, vsum = component_sums(shrink_map.to(torch.float32), ids, capacity)
    area = counts.to(torch.float32)
    # ids past the truncated boundary table have no extents: zero their
    # area so `valid` drops them (table ids are contiguous 1..max)
    in_table = torch.arange(capacity, device=dev) <= dense.max()
    area = torch.where(in_table, area, 0.0)
    count("host_syncs")  # a Python scalar set into a device tensor: a blocking upload
    area[0] = 0.0

    per = 2.0 * (bw + bh)
    dist = torch.where(per > 0, bw * bh * 1.5 / per, 0.0)
    u0, u1 = e0 - dist, e1 + dist
    v0, v1 = e2 - dist, e3 + dist
    cu = torch.stack([u0, u1, u1, u0], dim=-1)  # (C, 4)
    cv = torch.stack([v0, v0, v1, v1], dim=-1)
    cb, sb = torch.cos(a)[:, None], torch.sin(a)[:, None]
    boxes = torch.stack([cu * cb - cv * sb, cu * sb + cv * cb], dim=-1)  # (C, 4, 2)
    sside = torch.minimum(bw, bh)
    valid = (area > 0) & (sside >= 2.0)
    boxes = torch.where(valid[:, None, None], boxes, 0.0)
    scores = torch.where(area > 0, vsum / area.clamp_min(1.0), 0.0)
    return boxes, scores, valid


def _scale_clip(pts: np.ndarray, dest_width: int, dest_height: int, src_width: int, src_height: int) -> np.ndarray:
    """Rescale (N, 2) points from the source to the destination size, round
    and clip to it -> int32; ``pts`` is overwritten."""
    pts[:, 0] = np.clip(np.round(pts[:, 0] / src_width * dest_width), 0, dest_width)
    pts[:, 1] = np.clip(np.round(pts[:, 1] / src_height * dest_height), 0, dest_height)
    return pts.astype(np.int32)


def boxes_from_device_rects(
    boxes: np.ndarray,
    scores: np.ndarray,
    valid: np.ndarray,
    dest_width: int,
    dest_height: int,
    src_width: int,
    src_height: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host finisher: reference corner ordering, rescale, round + clip."""
    out_boxes: List[np.ndarray] = []
    out_scores: List[float] = []
    for i in range(len(scores)):
        if not valid[i]:
            continue
        box = geo.order_rect_points(boxes[i].astype(np.float64))
        out_boxes.append(_scale_clip(box, dest_width, dest_height, src_width, src_height))
        out_scores.append(float(scores[i]))
    if out_boxes:
        return np.stack(out_boxes), np.asarray(out_scores, np.float32)
    return np.zeros((0, 4, 2), np.int32), np.zeros((0,), np.float32)


def _component_points(labels_np: np.ndarray, idx: int, bbox) -> np.ndarray:
    x0, y0, x1, y1 = bbox
    win = labels_np[y0 : y1 + 1, x0 : x1 + 1] == idx
    ys, xs = np.nonzero(win)
    return np.stack([xs + x0, ys + y0], axis=1).astype(np.float64)


def _stats_np(stats: ComponentStats):
    """(compact labels, area, value sum, xmin, ymin, xmax, ymax) as NumPy."""
    return tuple(
        np.asarray(t.cpu()) for t in (stats.compact_labels, stats.area, stats.value_sum,
                                      stats.xmin, stats.ymin, stats.xmax, stats.ymax)
    )


def boxes_from_stats(
    stats: ComponentStats,
    dest_width: int,
    dest_height: int,
    src_width: int,
    src_height: int,
    unclip_ratio: float = 1.5,
    min_sside: float = 2.0,
    max_candidates: int = 1000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host half: stats -> (N, 4, 2) int32 quads + (N,) float32 scores.

    Mirrors the reference's boxes_from_bitmap (db_utils.py:123-166): the
    min-area rect of each component, short sides under ``min_sside``
    skipped, unclip by area * ratio / perimeter, rescale to the destination
    size, round and clip.  The rects come from the host library
    (``native.get_native()``, which raises where it cannot be built), as
    the JAX package's native route; where ``get_native`` returns None (a
    test's monkeypatch) the NumPy route runs, the JAX package's route
    without its extension.
    """
    labels_np, area, vsum, xmin, ymin, xmax, ymax = _stats_np(stats)
    lib = native.get_native()
    rects = None  # (boxes already unclipped, short sides) of every component, from the library
    if lib is not None and (area[1:] > 0).any():
        rects = lib.component_min_area_rects(labels_np, len(area) - 1, None, unclip_ratio)
    boxes: List[np.ndarray] = []
    scores: List[float] = []
    n = 0
    for i in range(1, len(area)):
        if area[i] <= 0:
            continue
        n += 1
        if n > max_candidates:
            break
        if rects is not None:
            box, sside = rects[0][i - 1], rects[1][i - 1]
        else:
            pts = _component_points(labels_np, i, (xmin[i], ymin[i], xmax[i], ymax[i]))
            box, sside = geo.mini_box(pts)
        if sside < min_sside:
            continue
        if rects is None:
            _, (w, h) = geo.min_area_rect(pts)
            per = 2.0 * (w + h)
            distance = (w * h) * unclip_ratio / per if per > 0 else 0.0
            box = geo.inflate_rect(box, distance)
        boxes.append(_scale_clip(geo.order_rect_points(box), dest_width, dest_height, src_width, src_height))
        scores.append(float(vsum[i] / area[i]))
    if boxes:
        return np.stack(boxes), np.asarray(scores, np.float32)
    return np.zeros((0, 4, 2), np.int32), np.zeros((0,), np.float32)


def polygons_from_stats(
    stats: ComponentStats,
    dest_width: int,
    dest_height: int,
    src_width: int,
    src_height: int,
    unclip_ratio: float = 1.5,
    box_thresh: float = 0.7,
    min_size: float = 3.0,
    max_candidates: int = 1000,
) -> Tuple[List[np.ndarray], List[float]]:
    """Polygon mode (the reference's polygons_from_bitmap, db_utils.py:74-121):
    boundary trace -> Douglas-Peucker simplify (0.5% of the arc length) ->
    score filter -> round-join polygon offset -> rescale."""
    labels_np, area, vsum, xmin, ymin, xmax, ymax = _stats_np(stats)
    polys: List[np.ndarray] = []
    scores: List[float] = []
    n = 0
    for i in range(1, len(area)):
        if area[i] <= 0:
            continue
        n += 1
        if n > max_candidates:
            break
        x0, y0, x1, y1 = xmin[i], ymin[i], xmax[i], ymax[i]
        win = labels_np[y0 : y1 + 1, x0 : x1 + 1] == i
        contour = trace_boundary(win)
        if len(contour) < 4:
            continue
        contour = contour + np.array([x0, y0])
        eps = 0.005 * geo.perimeter(contour.astype(np.float64))
        approx = douglas_peucker_closed(contour.astype(np.float64), eps)
        if len(approx) < 4:
            continue
        score = float(vsum[i] / area[i])
        if score < box_thresh:
            continue
        expanded = geo.offset_polygon(approx, _poly_unclip_distance(approx, unclip_ratio))
        if len(expanded) < 3:
            continue
        _, sside = geo.mini_box(expanded)
        if sside < min_size + 2:
            continue
        polys.append(_scale_clip(expanded.copy(), dest_width, dest_height, src_width, src_height))
        scores.append(score)
    return polys, scores


def _poly_unclip_distance(poly: np.ndarray, unclip_ratio: float) -> float:
    a = abs(geo.shoelace_area(poly))
    p = geo.perimeter(poly)
    return a * unclip_ratio / p if p > 0 else 0.0


_MOORE = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]


def trace_boundary(mask: np.ndarray) -> np.ndarray:
    """Moore-neighbour boundary trace of the region of ``mask`` that holds
    its first set pixel in raster order.

    Returns (N, 2) int64 (x, y) boundary pixel coordinates in order, the
    analogue of cv2.findContours' outer contour.
    """
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros((0, 2), np.int64)
    start = (ys[0], xs[0])  # topmost, then leftmost
    h, w = mask.shape

    def at(p):
        y, x = p
        return 0 <= y < h and 0 <= x < w and mask[y, x]

    contour = [start]
    prev_dir = 6  # the trace enters the start pixel from the left
    cur = start
    for _ in range(4 * mask.size):
        found = False
        for k in range(8):
            d = (prev_dir + 1 + k) % 8
            ny, nx = cur[0] + _MOORE[d][0], cur[1] + _MOORE[d][1]
            if at((ny, nx)):
                if (ny, nx) == start and len(contour) > 1:
                    return np.array([(x, y) for y, x in contour], np.int64)
                contour.append((ny, nx))
                cur = (ny, nx)
                prev_dir = (d + 4) % 8  # the new backtrack points back where it came from
                found = True
                break
        if not found:  # an isolated pixel
            break
    return np.array([(x, y) for y, x in contour], np.int64)


def douglas_peucker_closed(poly: np.ndarray, eps: float) -> np.ndarray:
    """Ramer-Douglas-Peucker simplification of a closed polygon (the
    analogue of cv2.approxPolyDP(closed=True)): split at the point farthest
    from the first, simplify both open chains."""
    n = len(poly)
    if n < 3:
        return poly
    i0 = 0
    d = np.linalg.norm(poly - poly[i0], axis=1)
    i1 = int(np.argmax(d))
    if i1 == 0:
        return poly[:1]
    chain1 = poly[i0 : i1 + 1]
    chain2 = np.vstack([poly[i1:], poly[:1]])
    s1 = _dp_open(chain1, eps)
    s2 = _dp_open(chain2, eps)
    return np.vstack([s1[:-1], s2[:-1]])


def _dp_open(pts: np.ndarray, eps: float) -> np.ndarray:
    if len(pts) < 3:
        return pts
    a, b = pts[0], pts[-1]
    ab = b - a
    nrm = np.linalg.norm(ab)
    if nrm < 1e-12:
        d = np.linalg.norm(pts - a, axis=1)
    else:
        rel = pts - a
        d = np.abs(ab[0] * rel[:, 1] - ab[1] * rel[:, 0]) / nrm
    i = int(np.argmax(d))
    if d[i] > eps:
        left = _dp_open(pts[: i + 1], eps)
        right = _dp_open(pts[i:], eps)
        return np.vstack([left[:-1], right])
    return np.vstack([a, b])
