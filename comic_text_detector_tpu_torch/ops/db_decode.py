"""DB (differentiable binarization) shrink map -> rotated text-line boxes.

Counterpart of the JAX package's ``ops/db_decode.py`` on its rank-ids
contract (``db_decode_full_device(..., rank_ids=True)``): the map is
binarized by K6 (``ops/finalize.py::binarize``), its components come as
dense raster-order ids from the CC kernels
(``ops/cc_kernels.py::cc_ids_windows_local``, K2 -> cumsum -> K3); a
sorted table of boundary pixels feeds a 90-angle min-area-rect scan.  The
component areas are integer scatter-adds and the probability sums a
segmented reduction over the pixels sorted by id, so neither depends on the
order of the card's atomics: repeated runs give the same bits.
``db_decode_batch`` binarizes and labels a stack of maps with one launch of
each kernel; ``boxes_from_device_rects`` is the host finisher.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from comic_text_detector_tpu_torch.constants import MAX_DB_COMPONENTS
from comic_text_detector_tpu_torch.ops import geometry as geo
from comic_text_detector_tpu_torch.ops.cc_kernels import cc_ids_windows_local
from comic_text_detector_tpu_torch.ops.finalize import binarize

_REST_SEGMENTS = 1024  # short segments that share the pixels outside every counted id


def _segment_reduce(values: torch.Tensor, ids: torch.Tensor, n: int, reduce: str) -> torch.Tensor:
    """``jax.ops.segment_min``/``max`` over rows: empty segments hold the
    reduction's identity (+inf for min, -inf for max)."""
    fill = math.inf if reduce == "amin" else -math.inf
    out = torch.full((n, values.shape[1]), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, ids[:, None].expand_as(values), values, reduce)


def _component_sums(values: torch.Tensor, labels: torch.Tensor, capacity: int):
    """(area int64 (C,), probability sum float32 (C,)) of ids 1..C-1; id 0
    holds 0.  The areas are the runs of each id among the pixels stably
    sorted by id, and the sums a segmented reduction over those runs: no
    atomics, so the card gives the same bits on every run, and on the CPU
    each sum is the sequential float32 sum in raster order, the order of
    the JAX package's scatter-add.  Pixels of no counted id (background,
    ids >= C) fill ``_REST_SEGMENTS`` short segments at the end, so that no
    segment spans most of the map."""
    dev = values.device
    flat = labels.reshape(-1).long()
    key = torch.where((flat > 0) & (flat < capacity), flat, capacity)
    skey, order = torch.sort(key, stable=True)
    # segment lengths from the sorted ids: no atomics on the crowded rest slot
    bounds = torch.searchsorted(skey, torch.arange(capacity + 2, device=dev))
    counts = bounds[1:] - bounds[:-1]
    ordered = values.reshape(-1)[order]
    rest = counts[capacity]
    step = (rest + _REST_SEGMENTS - 1) // _REST_SEGMENTS
    starts = torch.arange(_REST_SEGMENTS, device=dev) * step
    rest_lengths = torch.minimum((rest - starts).clamp_min(0), step)
    lengths = torch.cat([counts[:capacity], rest_lengths])
    sums = torch.segment_reduce(ordered, "sum", lengths=lengths, unsafe=True)
    return counts[:capacity], sums[:capacity]


def db_decode_batch(
    shrink_maps: torch.Tensor,
    thresh: float,
    capacity: int = MAX_DB_COMPONENTS,
    angle_steps: int = 90,
    max_boundary: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W) probability maps -> (boxes (B, C, 4, 2) f32, scores (B, C),
    valid (B, C)), each page as :func:`db_decode_full_device` decodes it.
    One K6 launch binarizes the stack and one ``cc_ids_windows_local`` call
    labels it; the boundary table and angle scan run page by page."""
    bitmaps = binarize(shrink_maps, thresh)
    labels = cc_ids_windows_local(bitmaps)
    outs = [
        _decode_labeled(shrink_maps[i], labels[i], capacity, angle_steps, max_boundary)
        for i in range(shrink_maps.shape[0])
    ]
    return tuple(torch.stack(t) for t in zip(*outs))


def db_decode_full_device(
    shrink_map: torch.Tensor,
    thresh: float,
    capacity: int = MAX_DB_COMPONENTS,
    angle_steps: int = 90,
    max_boundary: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W) probability map -> (boxes (C, 4, 2) f32 inflated by the DB
    unclip rule, scores (C,), valid (C,)).

    Components whose id is ``capacity`` or more, and boundary points past the
    first ``max_boundary`` of the (id, linear index) order, are dropped, as
    in the JAX package.  Exact for axis-aligned text (angle 0 is on the
    grid), within (90/angle_steps)° otherwise.
    """
    boxes, scores, valid = db_decode_batch(shrink_map[None], thresh, capacity, angle_steps, max_boundary)
    return boxes[0], scores[0], valid[0]


def _decode_labeled(
    shrink_map: torch.Tensor, labels: torch.Tensor, capacity: int, angle_steps: int, max_boundary: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One page's decode from its map and its dense component ids."""
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
    dense = torch.where(valid_pt & (skey < capacity), skey, 0).long()

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
    counts, vsum = _component_sums(shrink_map.to(torch.float32), labels, capacity)
    area = counts.to(torch.float32)
    # ids past the truncated boundary table have no extents: zero their
    # area so `valid` drops them (table ids are contiguous 1..max)
    in_table = torch.arange(capacity, device=dev) <= dense.max()
    area = torch.where(in_table, area, 0.0)
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
        box[:, 0] = np.clip(np.round(box[:, 0] / src_width * dest_width), 0, dest_width)
        box[:, 1] = np.clip(np.round(box[:, 1] / src_height * dest_height), 0, dest_height)
        out_boxes.append(box.astype(np.int32))
        out_scores.append(float(scores[i]))
    if out_boxes:
        return np.stack(out_boxes), np.asarray(out_scores, np.float32)
    return np.zeros((0, 4, 2), np.int32), np.zeros((0,), np.float32)
