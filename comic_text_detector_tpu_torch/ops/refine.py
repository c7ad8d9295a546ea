"""Device mask refinement: the JAX package's ``ops/refine.py`` in PyTorch.

The reference refits a colour model per text block on the host
(``postproc/textmask.py``): grey-histogram bands and per-channel Otsu
candidate masks, a merge of the candidates' connected components that
reduces the byte-XOR distance to the predicted mask, then hole filling.
This module runs all of a page's block windows in batched dispatches at
the original page resolution:

* windows go to the smallest shape bucket (``BUCKETS``) that holds them and
  are copied 1:1, so the per-window pipeline is bit-exact against the host
  merge; only windows larger than every bucket are resampled (bilinear)
  into the last bucket;
* histograms are 256-level counts (scatter-adds of 0/1 weights), rebinned
  to ``np.histogram``'s 255 data-range bins;
* connected components of all 4*K candidates, and of the K inverted
  merges, are labelled by ``ops/cc_kernels.py::cc_ids_windows_local``
  (kernel K1 on the card);
* per-component sums are scatter-adds, accepted components a gather;
* candidates are merged in stable XOR-score order; within one candidate the
  accept tests commute (components are disjoint), so they run in parallel.

Bit-equality with the JAX package on the CPU rests on doing each float32
operation as XLA's CPU backend does it: XLA contracts ``a * b + c`` into a
fused multiply-add (one rounding), which :func:`_fma` reproduces exactly,
and it sums the Otsu cumsum in blocks of 16 (:func:`_cumsum_f32`).

Two routes, chosen by the tensors' device.  On the CPU :func:`refine_pages`
runs the plain PyTorch ops above (:func:`_refine_windows`), one dispatch
per ``slots`` windows of a bucket.  On the card it runs the hand-written
stages of ``csrc/refine.cu`` (:func:`_refine_pages_cuda`): the host builds
one table of every window of the call in NumPy (:func:`window_table`: box,
bucket, sampling grid, in-window rectangle, where each window's state
lives), uploads it in one pinned copy, and about twenty launches refine all
windows at once, K1 labelling between them; each stage repeats the plain
ops' arithmetic with explicit rounding, so the card's canvases are the
CPU's byte for byte.  Nothing is read back there: K1's loop-bound flags
are OR-ed into one device word that reaches pinned host memory with the
stream, and :func:`check_bounds` reads it after the canvas's download.

Window boxes stay on the host (NumPy) for grouping, slicing and sampling
coordinates, so no value is read back from the device per window.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from comic_text_detector_tpu_torch.constants import REFINEMASK_INPAINT
from comic_text_detector_tpu_torch.ops import cuda_build
from comic_text_detector_tpu_torch.ops.cc_kernels import (
    FUSED_IDS_MAX_ELEMS,
    cc_ids_fused_into,
    cc_ids_windows_local,
    ids_chunk_count,
)
from comic_text_detector_tpu_torch.utils.profiling import count

S = 256  # the smallest bucket's side
CAP = 2048  # default per-window component capacity

# (win_h, win_w, slots_per_dispatch, component_capacity), smallest first.
# Component ids >= capacity are never accepted, so the caps change outputs
# and are kept as the JAX package audited them.
BUCKETS = (
    (256, 256, 8, 1024),
    (256, 512, 6, 2048),
    (512, 256, 6, 2048),
    (256, 640, 4, 8192),
    (640, 256, 4, 8192),
    (512, 512, 3, 4096),  # also the resample fallback
)

# CTD_REFINE_CAPS overrides the caps: a preset name or a comma list in
# BUCKETS order, each a positive multiple of 64.  Malformed values raise.
_CAP_PRESETS = {
    # (256x256, 256x512, 512x256, 256x640, 640x256, 512x512)
    "audit": (1024, 2048, 2048, 8192, 8192, 4096),
    "r4": (2048, 8192, 8192, 8192, 8192, 8192),
}


def _parse_caps(spec: str, n: int):
    """Parse a CTD_REFINE_CAPS value: preset name or comma list of n caps,
    each a positive multiple of 64.  Raises on anything else."""
    caps = _CAP_PRESETS.get(spec)
    if caps is None:
        try:
            caps = tuple(int(v) for v in spec.split(","))
        except ValueError:
            caps = ()
    if len(caps) != n or any(c <= 0 or c % 64 for c in caps):
        raise ValueError(
            f"CTD_REFINE_CAPS={spec!r}: need {n} positive multiples of 64 "
            f"(or a preset in {sorted(_CAP_PRESETS)})"
        )
    return caps


_caps_env = os.environ.get("CTD_REFINE_CAPS", "")
if _caps_env:
    _caps = _parse_caps(_caps_env, len(BUCKETS))
    BUCKETS = tuple((h, w, s, c) for (h, w, s, _), c in zip(BUCKETS, _caps))


# ---------------------------------------------------------------------------
# float32 arithmetic as XLA's CPU backend does it
# ---------------------------------------------------------------------------


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with a single rounding.

    The product of two float32 values is exact in float64; the float64 sum
    is rounded to odd (the TwoSum error says whether it was inexact), and a
    round-to-odd value of 53 bits rounds to float32 exactly as the exact sum
    would."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float32).double() for v in (a, b, c))
    p = a * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, s + err), s)
    return s.float()


def _cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 cumsum over the last axis of length 256, summed in XLA's CPU
    order: sequential sums within blocks of 16, plus the sequential sum of
    the blocks before."""
    *lead, n = x.shape
    if n != 256:
        raise ValueError(f"_cumsum_f32 takes 256 columns, got {n}")
    blocks = x.reshape(*lead, 16, 16)
    cols = [blocks[..., 0]]
    for j in range(1, 16):
        cols.append(cols[-1] + blocks[..., j])
    within = torch.stack(cols, dim=-1)
    totals = within[..., 15]
    offs = [torch.zeros_like(totals[..., 0])]
    for b in range(1, 16):
        offs.append(offs[-1] + totals[..., b - 1])
    return (within + torch.stack(offs, dim=-1)[..., None]).reshape(*lead, n)


# ---------------------------------------------------------------------------
# Window extraction / paste-back
# ---------------------------------------------------------------------------


def _to(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    count("host_syncs")  # a blocking copy from pageable memory: waits for the stream
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _ext_hi(b: np.ndarray, win_hw):
    """Source extents (x_hi, y_hi): a window no larger than its bucket is
    copied 1:1 and zero-padded; only a larger one is resampled."""
    sh, sw = win_hw
    return np.maximum(b[..., 2], b[..., 0] + sw), np.maximum(b[..., 3], b[..., 1] + sh)


def _sample_coords(lo: np.ndarray, hi: np.ndarray, n_src: int, n_dst: int):
    """2-tap bilinear sampling grid for [lo, hi) -> n_dst samples (cv2
    INTER_LINEAR grid convention), for (K,) int32 extents: (i0, i1, frac),
    each (K, n_dst), in float32 NumPy arithmetic."""
    f32 = np.float32
    lo = np.asarray(lo, np.int32)[:, None]
    hi = np.asarray(hi, np.int32)[:, None]
    span = (hi - lo).astype(f32)
    d = np.arange(n_dst, dtype=f32)[None, :]
    src = lo.astype(f32) + (d + f32(0.5)) * span / f32(n_dst) - f32(0.5)
    src = np.clip(src, lo.astype(f32), (hi - 1).astype(f32)).astype(f32)
    i0f = np.floor(src)
    frac = src - i0f
    i0 = np.clip(i0f, 0, n_src - 1).astype(np.int32)
    i1 = np.clip(i0f + f32(1.0), 0, n_src - 1).astype(np.int32)
    # i0 + 1 can equal hi after the hi - 1 clamp; its weight is 0 there
    frac = np.where(i1.astype(f32) <= i0f, f32(0.0), frac).astype(f32)
    return i0, i1, frac


def _in_window(boxes: np.ndarray, win_hw) -> np.ndarray:
    """(K, sh, sw) bool: the window pixels that lie inside the true box."""
    sh, sw = win_hw
    b = boxes.astype(np.int64)
    dy, dx = np.arange(sh), np.arange(sw)
    vy = (b[:, 1:2] + dy < b[:, 3:4]) | (b[:, 3:4] - b[:, 1:2] > sh)
    vx = (b[:, 0:1] + dx < b[:, 2:3]) | (b[:, 2:3] - b[:, 0:1] > sw)
    return vy[:, :, None] & vx[:, None, :]


def extract_windows(
    img: torch.Tensor,
    mask: torch.Tensor,
    boxes: np.ndarray,
    page_ids: np.ndarray | None = None,
    win_hw: Tuple[int, int] = (S, S),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Extract K boxes of (img, mask) into fixed (K, sh, sw[, 3]) uint8 windows.

    img (H, W, 3) or (P, H, W, 3) uint8 BGR, mask (H, W) or (P, H, W) uint8,
    boxes (K, 4) int xyxy on the host, page_ids (K,) into the page stack
    (None: one page).  Returns (window images, window masks, in-window
    validity (K, sh, sw) bool); pixels outside the true box are 0.

    A window that fits the bucket is a 1:1 copy (clamped source indices);
    a larger one is sampled bilinearly from its 2x2 source taps."""
    sh, sw = win_hw
    if mask.dim() == 2:
        img, mask = img[None], mask[None]
    _, h, w = mask.shape
    dev = mask.device
    boxes = np.asarray(boxes, np.int32).reshape(-1, 4)
    k = boxes.shape[0]
    pids = np.zeros((k,), np.int64) if page_ids is None else np.asarray(page_ids, np.int64)
    x_hi, y_hi = _ext_hi(boxes, win_hw)
    y0, y1, fy = _sample_coords(boxes[:, 1], y_hi, h, sh)
    x0, x1, fx = _sample_coords(boxes[:, 0], x_hi, w, sw)
    in_window = _to(_in_window(boxes, win_hw), dev)
    p = _to(pids, dev).view(k, 1, 1)

    def taps(rows, cols):  # (K, sh, sw, 4) uint8: B, G, R, mask
        return torch.cat([img[p, rows, cols], mask[p, rows, cols][..., None]], dim=-1)

    rows0, cols0 = _to(y0, dev).long().view(k, sh, 1), _to(x0, dev).long().view(k, 1, sw)
    if not (fy.any() or fx.any()):
        out = taps(rows0, cols0)
    else:
        rows1, cols1 = _to(y1, dev).long().view(k, sh, 1), _to(x1, dev).long().view(k, 1, sw)
        fy_t, fx_t = _to(fy, dev).view(k, sh, 1, 1), _to(fx, dev).view(k, 1, sw, 1)
        # rows first (at both column taps), then columns, as the JAX package blends
        at_x0 = _fma(taps(rows0, cols0).float(), 1.0 - fy_t, taps(rows1, cols0).float() * fy_t)
        at_x1 = _fma(taps(rows0, cols1).float(), 1.0 - fy_t, taps(rows1, cols1).float() * fy_t)
        out = _fma(at_x0, 1.0 - fx_t, at_x1 * fx_t)
        out = out.round().clamp(0, 255).to(torch.uint8)
    out = torch.where(in_window[..., None], out, 0)
    return out[..., :3], out[..., 3], in_window


def _clamped_start(v: int, limit: int) -> int:
    return min(max(int(v), 0), limit)


def paste_windows_exact(
    canvas: torch.Tensor, merged: torch.Tensor, boxes: np.ndarray, valid: np.ndarray, page_ids: np.ndarray,
) -> None:
    """OR 1:1-extracted (K, sh, sw) uint8 window masks into ``canvas`` in
    place, at their box positions.  ``canvas`` is (P, H + sh, W + sw): the
    padding keeps every start inside it.  ``merged`` is already zero outside
    each window's true box, so nothing outside the box changes."""
    _, hp, wp = canvas.shape
    _, sh, sw = merged.shape
    for i in np.flatnonzero(valid):
        y = _clamped_start(boxes[i, 1], hp - sh)
        x = _clamped_start(boxes[i, 0], wp - sw)
        region = canvas[int(page_ids[i]), y:y + sh, x:x + sw]
        region |= merged[i]


def _paste_coords(box: np.ndarray, x_hi: int, y_hi: int, win_hw, out_hw):
    """Where a resampled window pastes back: the page region [ry0, ry1) x
    [rx0, rx1) of its box and, for each of its rows and columns, the 2 taps
    in the window and the weight of the second, as ((ry0, ry1, rx0, rx1),
    (y0, y1, fy), (x0, x1, fx)) in float32 NumPy arithmetic; None where the
    box misses the page."""
    h, w = out_hw
    sh, sw = win_hw
    f32 = np.float32
    b = np.asarray(box).astype(np.int64)
    ry0, ry1 = max(b[1], 0), min(b[3], h)
    rx0, rx1 = max(b[0], 0), min(b[2], w)
    if ry1 <= ry0 or rx1 <= rx0:
        return None
    span_y = np.maximum(f32(y_hi - b[1]), f32(1.0))
    span_x = np.maximum(f32(x_hi - b[0]), f32(1.0))
    yy = (np.arange(ry0, ry1, dtype=f32) - f32(b[1]) + f32(0.5)) * f32(sh) / span_y - f32(0.5)
    xx = (np.arange(rx0, rx1, dtype=f32) - f32(b[0]) + f32(0.5)) * f32(sw) / span_x - f32(0.5)
    yy = np.clip(yy, f32(0.0), f32(sh - 1.0))
    xx = np.clip(xx, f32(0.0), f32(sw - 1.0))
    y0, x0 = np.floor(yy), np.floor(xx)
    fy, fx = (yy - y0).astype(f32), (xx - x0).astype(f32)
    y0i, x0i = y0.astype(np.int64), x0.astype(np.int64)
    y1i, x1i = np.minimum(y0i + 1, sh - 1), np.minimum(x0i + 1, sw - 1)
    return (int(ry0), int(ry1), int(rx0), int(rx1)), (y0i, y1i, fy), (x0i, x1i, fx)


def paste_windows(
    canvas: torch.Tensor, merged: torch.Tensor, boxes: np.ndarray, valid: np.ndarray, page_ids: np.ndarray,
    out_hw,
) -> None:
    """OR (K, sh, sw) uint8 0/255 window masks into ``canvas`` in place,
    resampling each window back to its box (bilinear, > 127).  Only the
    box's own pixels can be set, so only they are computed."""
    _, sh, sw = merged.shape
    dev = canvas.device
    x_his, y_his = _ext_hi(boxes, (sh, sw))
    for i in np.flatnonzero(valid):
        at = _paste_coords(boxes[i], x_his[i], y_his[i], (sh, sw), out_hw)
        if at is None:
            continue
        (ry0, ry1, rx0, rx1), (y0i, y1i, fy), (x0i, x1i, fx) = at
        mk = merged[i].float()
        r0, r1 = mk[_to(y0i, dev)], mk[_to(y1i, dev)]
        c0, c1 = _to(x0i, dev), _to(x1i, dev)
        fx_t, fy_t = _to(fx, dev)[None, :], _to(fy, dev)[:, None]
        top = _fma(r0[:, c0], 1 - fx_t, r0[:, c1] * fx_t)
        bot = _fma(r1[:, c0], 1 - fx_t, r1[:, c1] * fx_t)
        v = _fma(top, 1 - fy_t, bot * fy_t)
        region = canvas[int(page_ids[i]), ry0:ry1, rx0:rx1]
        region |= (v > 127.0).to(torch.uint8) * 255


# ---------------------------------------------------------------------------
# Histograms / thresholds
# ---------------------------------------------------------------------------


def _hist256(plane: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(K, N) uint8 values + (K, N) 0/1 weights -> (K, 256) float32 counts
    (integer sums, exact in any order)."""
    out = torch.zeros((plane.shape[0], 256), dtype=torch.float32, device=plane.device)
    return out.scatter_add_(1, plane.long(), weight.float())


def bgr2gray_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2 BGR->GRAY (rounded uint8), in XLA's fused order."""
    b, g, r = (img[..., i].float() for i in range(3))
    grey = _fma(r, 0.299, _fma(b, 0.114, g * np.float32(0.587)))
    return grey.round().clamp(0, 255).to(torch.uint8)


def _otsu_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """(K, 256) counts -> (K,) Otsu thresholds (maximise the between-class
    variance; the first maximum wins)."""
    total = hist.sum(dim=1, keepdim=True)
    idx = torch.arange(256, dtype=torch.float32, device=hist.device)
    w0 = _cumsum_f32(hist)
    w1 = total - w0
    s0 = _cumsum_f32(hist * idx)
    mu = s0[:, -1:]
    m0 = torch.where(w0 > 0, s0 / w0.clamp_min(1), 0.0)
    m1 = torch.where(w1 > 0, (mu - s0) / w1.clamp_min(1), 0.0)
    d = m0 - m1
    between = w0 * w1 * (d * d)
    return torch.argmax(between, dim=1)


_XOR_INVALID = 2**30  # above any real score (at most 255 * 640 * 256)


def _xor_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Byte-XOR objective over the trailing 2 axes (reference textmask.py:36)."""
    return torch.bitwise_xor(a, b).to(torch.int32).sum(dim=(-2, -1), dtype=torch.int32)


def _pick_polarity(threshed: torch.Tensor, mask: torch.Tensor, in_window: torch.Tensor):
    """minxor_thresh: keep the polarity closer to the predicted mask, with
    pixels outside the true window excluded from both."""
    threshed = torch.where(in_window, threshed, 0)
    neg = torch.where(in_window, 255 - threshed, 0)
    x_pos = _xor_sum(threshed, mask)
    x_neg = _xor_sum(neg, mask)
    take_neg = x_neg < x_pos
    out = torch.where(take_neg[:, None, None], neg, threshed)
    return out, torch.minimum(x_pos, x_neg)


def _topk_colors(counts255: torch.Tensor, edges_lo: torch.Tensor, edges_step: torch.Tensor):
    """Reference get_topk_color (textmask.py:16-27) over windows.

    counts255 (K, 255) -> (K, 3) band-centre colours (1e9 where unused) and
    (K,) counts of valid colours.  Bins are visited in stable descending
    count order.  The JAX package walks bins 1..254 keeping a colour when it
    lies more than 10 from every kept one, and stops after a bin whose count
    is under the tolerance or once three are kept; the first bin i that
    passes the distance test is the second colour and the next one past it
    that also clears the second colour is the third, so both are found by
    first-index searches."""
    k, nb = counts255.shape
    dev = counts255.device
    sorted_counts, order = torch.sort(counts255, dim=1, descending=True, stable=True)
    colors = _fma(order.float(), edges_step[:, None], edges_lo[:, None])
    tol = counts255.sum(dim=1) * np.float32(0.001)
    pos = torch.arange(nb, device=dev)
    # bin i may add only if no bin 1..i-1 fell under the tolerance
    under = (sorted_counts < tol[:, None]) & (pos >= 1)
    under_before = (torch.cumsum(under.int(), dim=1) - under.int()) > 0
    open_ = (pos >= 1) & ~under_before

    def first(cond):
        hit = cond.any(dim=1)
        i = torch.argmax(cond.int(), dim=1)
        return hit, i

    c0 = colors[:, 0]
    far0 = (colors - c0[:, None]).abs() > 10.0
    has2, i2 = first(open_ & far0)
    c2 = colors.gather(1, i2[:, None])[:, 0]
    far2 = (colors - c2[:, None]).abs() > 10.0
    has3, i3 = first(open_ & far0 & far2 & (pos[None, :] > i2[:, None]) & has2[:, None])
    c3 = colors.gather(1, i3[:, None])[:, 0]
    unused = torch.full_like(c0, 1e9)
    sel = torch.stack([c0, torch.where(has2, c2, unused), torch.where(has3, c3, unused)], dim=1)
    n = 1 + has2.int() + has3.int()
    return sel, n


# ---------------------------------------------------------------------------
# Connected components + per-component sums
# ---------------------------------------------------------------------------


def _component_ids(fg: torch.Tensor) -> torch.Tensor:
    """fg (K, sh, sw) bool -> 1-based component ids in raster order of the
    component roots, 0 on background (kernel K1 on the card)."""
    return cc_ids_windows_local(fg.to(torch.uint8).contiguous())


def _component_sums(ids: torch.Tensor, quantities: torch.Tensor, cap: int = CAP) -> torch.Tensor:
    """Per-component sums of (Q, K, sh, sw) float32 quantities in {-1, 0, 1}
    over ids (K, sh, sw) -> (Q, K, cap).  Ids >= cap count as 0 (background),
    so components beyond the capacity are never accepted.  The sums are
    integers below 2**24, exact in any order of float32 atomics."""
    q, k = quantities.shape[0], ids.shape[0]
    flat = torch.where(ids < cap, ids, 0).reshape(k, -1).long()
    gid = (torch.arange(k, device=ids.device)[:, None] * cap + flat).reshape(-1)
    vals = quantities.reshape(q, -1).T
    out = torch.zeros((k * cap, q), dtype=torch.float32, device=ids.device)
    out.index_add_(0, gid, vals)
    return out.reshape(k, cap, q).permute(2, 0, 1)


def _take_accept(ids: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    """(K, cap) per-component accept bits -> (K, sh, sw) pixel mask; slot 0
    (background and ids beyond the capacity) is never accepted."""
    k, cap = accept.shape
    acc = accept.clone()
    acc[:, 0] = False
    flat = torch.where(ids < cap, ids, 0).reshape(k, -1).long()
    return acc.gather(1, flat).reshape(ids.shape)


def _shifted(p: torch.Tensor, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    return p[:, dy:dy + h, dx:dx + w]


def _count_neighbors(fg: torch.Tensor, offsets) -> torch.Tensor:
    _, h, w = fg.shape
    p = F.pad(fg.to(torch.int32), (1, 1, 1, 1))
    acc = torch.zeros(fg.shape, dtype=torch.int32, device=fg.device)
    for dy, dx in offsets:
        acc = acc + _shifted(p, dy, dx, h, w)
    return acc


_CROSS = ((0, 1), (2, 1), (1, 0), (1, 2))


def _drop_tiny_components(fg: torch.Tensor) -> torch.Tensor:
    """Remove the components the reference's ``w*h < 3`` bbox test skips
    (textmask.py:100-101): singletons and straight 2-pixel pairs; diagonal
    pairs have a 2x2 bbox and stay."""
    _, h, w = fg.shape
    n8 = _count_neighbors(fg, [(a, b) for a in range(3) for b in range(3) if (a, b) != (1, 1)])
    n4 = _count_neighbors(fg, _CROSS)
    # a straight pair: both ends have exactly one 8-neighbour, 4-adjacent
    p = F.pad(((n8 == 1) & fg).to(torch.uint8), (1, 1, 1, 1))
    partner_lone = torch.zeros(fg.shape, dtype=torch.bool, device=fg.device)
    for dy, dx in _CROSS:
        partner_lone |= _shifted(p, dy, dx, h, w) != 0
    singleton = n8 == 0
    straight_pair = (n8 == 1) & (n4 == 1) & partner_lone
    return fg & ~(singleton | straight_pair)


def _merge_labeled(
    merged: torch.Tensor, fg: torch.Tensor, ids: torch.Tensor, pred: torch.Tensor, cap: int = CAP
) -> torch.Tensor:
    """Absorb every component of a labelled candidate whose un-merged pixels
    match the predicted mask more than they miss it (the reference's
    xor_merged < xor_origin test, textmask.py:95-110), as one signed sum."""
    new = fg & ~merged
    signed = torch.where(new, torch.where(pred, 1.0, -1.0), 0.0)
    sums = _component_sums(ids, signed[None], cap=cap)
    take = _take_accept(ids, sums[0] > 0)
    return merged | (fg & take)


def _merge_candidate(merged: torch.Tensor, cand: torch.Tensor, pred: torch.Tensor, cap: int = CAP) -> torch.Tensor:
    """CC + tiny-drop + :func:`_merge_labeled` for one candidate set."""
    fg = _drop_tiny_components(cand)
    return _merge_labeled(merged, fg, _component_ids(fg), pred, cap=cap)


def _fill_holes(merged: torch.Tensor, pred: torch.Tensor, in_window: torch.Tensor, cap: int = CAP) -> torch.Tensor:
    """Adopt small components of the inverse mask that reduce the XOR
    objective (reference textmask.py:113-131).  The area threshold is the
    second-largest area among {merged region, inverse components}, each
    counted inside the window only."""
    inv = ~merged
    ids = _component_ids(inv)
    inside = inv & in_window
    signed = torch.where(inside, torch.where(pred, 1.0, -1.0), 0.0)
    sums = _component_sums(ids, torch.stack([signed, inside.float()]), cap=cap)
    eff_area = sums[1]
    merged_area = (merged & in_window).sum(dim=(1, 2)).float()
    all_areas = torch.cat([merged_area[:, None], eff_area[:, 1:]], dim=1)
    thresh = torch.topk(all_areas, 2, dim=1).values[:, 1]
    accept = (sums[0] > 0) & (eff_area < thresh[:, None])
    take = _take_accept(ids, accept)
    return merged | (inv & take & in_window)


# ---------------------------------------------------------------------------
# 3x3 morphology on window batches, constant border (cv2 on crops)
# ---------------------------------------------------------------------------


def _stencil(x: torch.Tensor, offsets, border: int, reduce) -> torch.Tensor:
    _, h, w = x.shape
    p = F.pad(x, (1, 1, 1, 1), value=border)
    acc = x
    for dy, dx in offsets:
        acc = reduce(acc, _shifted(p, dy, dx, h, w))
    return acc


_RECT3 = tuple((a, b) for a in range(3) for b in range(3))


def _erode_rect3(x: torch.Tensor) -> torch.Tensor:
    return _stencil(x, _RECT3, 255, torch.minimum)


def _dilate_rect3(x: torch.Tensor) -> torch.Tensor:
    return _stencil(x, _RECT3, 0, torch.maximum)


def _erode_ellipse3(x: torch.Tensor) -> torch.Tensor:
    return _stencil(x, _CROSS, 255, torch.minimum)


# ---------------------------------------------------------------------------
# One dispatch
# ---------------------------------------------------------------------------


def _candidates(win_img: torch.Tensor, win_msk: torch.Tensor, in_window: torch.Tensor):
    """The 4 candidate masks per window: 3 grey-histogram bands and the best
    per-channel Otsu (reference get_topk_masklist / get_otsuthresh_masklist).

    Returns (4, K, sh, sw) uint8 candidates and (4, K) int32 XOR scores;
    unused band slots are all zero with score ``_XOR_INVALID``."""
    k, sh, sw = win_msk.shape
    n = sh * sw
    dev = win_msk.device
    grey = bgr2gray_u8(win_img)
    # the window edge does not erode (cv2's erode border is +inf)
    eroded = _erode_rect3(torch.where(in_window, win_msk, 255))
    sel = ((eroded > 127) & in_window).reshape(k, n).float()
    any_sel = sel.sum(dim=1) > 0
    weights = torch.where(any_sel[:, None], sel, in_window.reshape(k, n).float())

    hist = _hist256(grey.reshape(k, n), weights)
    present = hist > 0
    lvl = torch.arange(256, dtype=torch.float32, device=dev)
    lo = torch.where(present, lvl, 256.0).amin(dim=1)
    hi = torch.where(present, lvl, -1.0).amax(dim=1)
    # np.histogram's 255 bins over [lo, hi]; one level alone gets a span
    width = (hi - lo).clamp_min(1e-6) / 255.0
    # rebin the 256 levels (clamped before the cast, which then truncates
    # exactly as the clipped int32 cast does)
    bin_of = ((lvl[None, :] - lo[:, None]) / width[:, None]).clamp(0, 254).to(torch.int64)
    counts255 = torch.zeros((k, 255), dtype=torch.float32, device=dev).scatter_add_(1, bin_of, hist)
    colors, n_colors = _topk_colors(counts255, lo, width)

    cands, xors = [], []
    g = grey.float()
    for b in range(3):
        c_top = torch.clamp_max(colors[:, b] + 30.0, 255.0)
        c_bot = c_top - 60.0
        band = ((g >= c_bot[:, None, None]) & (g <= c_top[:, None, None])).to(torch.uint8) * 255
        band, x = _pick_polarity(band, win_msk, in_window)
        ok = n_colors > b
        cands.append(torch.where(ok[:, None, None], band, 0))
        xors.append(torch.where(ok, x, _XOR_INVALID))

    # per-channel Otsu, the three channels in one batch; keep the best
    planes = win_img.permute(3, 0, 1, 2)  # (3, K, sh, sw)
    hist_c = _hist256(planes.reshape(3 * k, n), in_window.reshape(1, k, n).expand(3, k, n).reshape(3 * k, n))
    thresh = _otsu_from_hist(hist_c).view(3, k).to(torch.uint8)
    best_x = torch.full((k,), _XOR_INVALID, dtype=torch.int32, device=dev)
    best_m = torch.zeros((k, sh, sw), dtype=torch.uint8, device=dev)
    for ch in range(3):
        th = (planes[ch] > thresh[ch][:, None, None]).to(torch.uint8) * 255
        th, x = _pick_polarity(th, win_msk, in_window)
        better = x < best_x
        best_x = torch.where(better, x, best_x)
        best_m = torch.where(better[:, None, None], th, best_m)
    cands.append(best_m)
    xors.append(best_x)
    return torch.stack(cands), torch.stack(xors)


def _refine_windows(
    imgs: torch.Tensor,
    masks: torch.Tensor,
    boxes: np.ndarray,
    valid: np.ndarray,
    page_ids: np.ndarray,
    refine_mode: int,
    win_hw: Tuple[int, int],
    cap: int,
    exact: bool,
    canvas: torch.Tensor,
) -> None:
    """Refine K block windows (possibly of several pages) in one dispatch
    and OR the 0/255 results into ``canvas`` in place.

    imgs (P, H, W, 3) uint8 BGR at the original resolution, masks (P, H, W)
    uint8 raw predicted masks; boxes (K, 4) int xyxy, valid (K,) bool and
    page_ids (K,) on the host.  ``exact``: every window fits the bucket, so
    the 1:1 paste serves (canvas padded by the bucket's size); otherwise the
    resampling paste (canvas of any padding)."""
    sh, sw = win_hw
    k = boxes.shape[0]
    win_img, win_msk, in_window = extract_windows(imgs, masks, boxes, page_ids, win_hw)
    cands, xors = _candidates(win_img, win_msk, in_window)

    # eroded, binarised prediction target (textmask.py:88-91)
    pred = (_erode_ellipse3(torch.where(in_window, win_msk, 255)) > 60) & in_window
    order = torch.sort(xors, dim=0, stable=True).indices  # bands before Otsu on ties

    # one CC pass over all 4*K candidates; only the merge is sequential
    fgs = _drop_tiny_components((cands > 0).reshape(4 * k, sh, sw))
    ids_all = _component_ids(fgs).reshape(4, k, sh, sw)
    fgs = fgs.reshape(4, k, sh, sw)
    slot = torch.arange(k, device=fgs.device)
    merged = torch.zeros((k, sh, sw), dtype=torch.bool, device=fgs.device)
    for rank in range(4):
        idx = order[rank]
        merged = _merge_labeled(merged, fgs[idx, slot], ids_all[idx, slot], pred, cap=cap)

    if refine_mode == REFINEMASK_INPAINT:
        merged = (_dilate_rect3(merged.to(torch.uint8) * 255) > 0) & in_window
    merged = _fill_holes(merged, pred, in_window, cap=cap)

    out = merged.to(torch.uint8) * 255
    if exact:
        paste_windows_exact(canvas, out, boxes, valid, page_ids)
    else:
        paste_windows(canvas, out, boxes, valid, page_ids, masks.shape[-2:])


def refine_windows(
    img: torch.Tensor,
    mask: torch.Tensor,
    boxes: np.ndarray,
    valid: np.ndarray,
    refine_mode: int = REFINEMASK_INPAINT,
    win_hw: Tuple[int, int] = (S, S),
    cap: int = CAP,
) -> torch.Tensor:
    """Refine K windows of one page in one dispatch with the resampling
    paste (any window size) -> (H, W) uint8 canvas."""
    boxes = np.asarray(boxes, np.int32).reshape(-1, 4)
    canvas = torch.zeros(mask.shape, dtype=torch.uint8, device=mask.device)
    _refine_windows(
        img[None], mask[None], boxes, np.asarray(valid, bool), np.zeros((len(boxes),), np.int64),
        refine_mode, win_hw, cap, False, canvas[None],
    )
    return canvas


def _bucket_index(w: int, h: int) -> int:
    """Smallest BUCKETS entry that holds a (w, h) box 1:1; -1 = none (the
    resample fallback into the last bucket)."""
    for bi, (bh, bw, _slots, _cap) in enumerate(BUCKETS):
        if h <= bh and w <= bw:
            return bi
    return -1


def refine_pages(
    imgs: torch.Tensor,
    masks: torch.Tensor,
    window_boxes,
    page_ids,
    refine_mode: int = REFINEMASK_INPAINT,
) -> torch.Tensor:
    """Refine any number of block windows across a page stack.

    imgs (P, H, W, 3) uint8, masks (P, H, W) uint8 (on the device),
    window_boxes (N, 4) int xyxy in page coordinates (expanded and clamped),
    page_ids (N,) int, both on the host.  Windows go to the smallest bucket
    that holds them 1:1 (bit-exact against the host merge), resampled only
    beyond the largest.  Returns (P, H, W) uint8 0/255 canvases, the OR of
    each page's windows.

    On the CPU each bucket's windows, from all pages, run in dispatches of
    its slot count, padded with degenerate boxes (:func:`_refine_pages_plain`).
    On the card the call's windows run in one chain of hand-written stages
    (``csrc/refine.cu``, :func:`_refine_pages_cuda`; one chain a
    ``_CHAIN_WINDOWS`` windows), byte-equal to the CPU's; its loop-bound flag reaches the host with the canvas, and
    :func:`check_bounds` reads it after the canvas's download."""
    boxes = np.asarray(window_boxes, np.int32).reshape(-1, 4)
    pids = np.asarray(page_ids, np.int64).reshape(-1)
    pad_h = max(bh for bh, _, _, _ in BUCKETS)
    pad_w = max(bw for _, bw, _, _ in BUCKETS)
    if masks.device.type == "cpu":
        return _refine_pages_plain(imgs, masks, boxes, pids, refine_mode, (pad_h, pad_w))
    if masks.device.type != "cuda":
        raise ValueError(f"refine_pages: unsupported device {masks.device}")
    return _refine_pages_cuda(imgs, masks, boxes, pids, refine_mode, (pad_h, pad_w))


def _refine_pages_plain(imgs, masks, boxes, pids, refine_mode, pad_hw) -> torch.Tensor:
    """:func:`refine_pages` in plain PyTorch ops (the CPU's route, and the
    card route's yardstick on any device): each bucket's windows, from all
    pages, in dispatches of its slot count."""
    p, h, w = masks.shape
    pad_h, pad_w = pad_hw
    canvas = torch.zeros((p, h + pad_h, w + pad_w), dtype=torch.uint8, device=masks.device)

    groups: dict[int, list[int]] = {}
    for j, (x1, y1, x2, y2) in enumerate(boxes):
        groups.setdefault(_bucket_index(int(x2 - x1), int(y2 - y1)), []).append(j)

    for bi, idxs in groups.items():
        exact = bi >= 0
        bh, bw, slots, cap = BUCKETS[bi if exact else -1]
        for start in range(0, len(idxs), slots):
            sel = idxs[start:start + slots]
            valid = np.zeros((slots,), bool)
            valid[: len(sel)] = True
            padded = np.zeros((slots, 4), np.int32)
            padded[:, 2:] = 1  # degenerate but valid geometry for empty slots
            padded[: len(sel)] = boxes[sel]
            pchunk = np.zeros((slots,), np.int64)
            pchunk[: len(sel)] = pids[sel]
            # the exact paste clamps starts to the bucket's own padding, as
            # the JAX package's canvas padded by (bh, bw) does
            target = canvas[:, : h + bh, : w + bw] if exact else canvas
            _refine_windows(imgs, masks, padded, valid, pchunk, refine_mode, (bh, bw), cap, exact, target)
    return canvas[:, :h, :w]


def refine_page(img: torch.Tensor, mask: torch.Tensor, window_boxes, refine_mode: int = REFINEMASK_INPAINT):
    """Single-page :func:`refine_pages` (returns the (H, W) canvas)."""
    n = len(np.asarray(window_boxes).reshape(-1, 4))
    canvases = refine_pages(img[None], mask[None], window_boxes, np.zeros((n,), np.int64), refine_mode)
    return _carry_flag(canvases, canvases[0])


# ---------------------------------------------------------------------------
# The card's route: the windows of a call in one chain of stages
# ---------------------------------------------------------------------------

# Columns of a window's row in the table (enum Col in csrc/refine.cu).
_TABLE_COLS = (
    "page", "x0", "y0", "x1", "y1", "sh", "sw", "ny", "nx", "plane_h", "stride", "exact", "cap", "px",
    "cand", "cand_step", "rows", "cols", "acc", "paste_rows", "paste_cols", "ry0", "ry1", "rx0", "rx1",
)
_COL = {name: i for i, name in enumerate(_TABLE_COLS)}
_TILE = 32  # a block's tile of a window plane (kTile)
_ACC_HEADER = 1536  # a window's accumulator words before its component sums (kHeader)
_ACC_BASE = 64  # words before the first window's accumulators; word 0 is K1's loop-bound flag
_ALIGN = 256  # bytes: every buffer of the scratch starts on this
# windows a chain at most: bounds a chain's scratch (about 50 bytes a plane
# pixel, 1.7 GB at 128 windows of 512 x 512) and keeps the table's offsets
# in int32; a stream batch's calls hold 3-12 windows
_CHAIN_WINDOWS = 128


class WindowTable(NamedTuple):
    """The table of windows of one :func:`refine_pages` call on the card.

    ``data`` is the one int32 upload: ``rows`` (one row of ``_TABLE_COLS``
    a window, in K1-group order; ``index`` maps each row to its box), then
    ``tile_start`` (each window's first tile, and the total), ``resampled``
    (the rows of the resampled windows), ``coords`` (each window's
    sampling rows and columns, then a resampled window's paste rows and
    columns, as (i0, i1, float32 bits of frac) triples).  ``offsets`` are
    the int32 offsets of the last three sections in ``data``.  ``groups``
    are the K1 launches: (plane_h, stride, windows, first plane pixel) each;
    a group's candidate planes start at 4 x its first plane pixel.
    ``n_px`` is the pixels of all planes, ``acc_words`` the accumulators'
    int32 words."""

    data: np.ndarray
    rows: np.ndarray
    index: np.ndarray
    tile_start: np.ndarray
    resampled: np.ndarray
    coords: np.ndarray
    offsets: Tuple[int, int, int]
    groups: Tuple[Tuple[int, int, int, int], ...]
    n_px: int
    acc_words: int


def _triples(i0: np.ndarray, i1: np.ndarray, frac: np.ndarray) -> np.ndarray:
    """(..., n) taps and float32 weights -> (..., 3n) int32 (i0, i1, frac bits)."""
    out = np.stack([i0.astype(np.int32), i1.astype(np.int32), frac.astype(np.float32).view(np.int32)], axis=-1)
    return out.reshape(*out.shape[:-2], -1)


def window_table(window_boxes, page_ids, page_hw) -> WindowTable:
    """Build the card route's table for one :func:`refine_pages` call, in
    NumPy: boxes and page ids as ``refine_pages`` takes them, ``page_hw``
    the pages' (H, W).

    Each window takes the bucket :func:`_bucket_index` gives (the last
    one, resampled, beyond every bucket), its sampling grid from
    :func:`_sample_coords` and its in-window rectangle as
    :func:`_in_window` gives it.  Buckets join K1 groups in ``BUCKETS``
    order, each the first group whose common plane stays within K1's
    512 x 512 (one group for the buckets up to 512 x 512); a window sits at
    the top-left of its group's plane."""
    h, w = page_hw
    boxes = np.asarray(window_boxes, np.int32).reshape(-1, 4)
    pids = np.asarray(page_ids, np.int64).reshape(-1)
    buckets = np.asarray([_bucket_index(int(x2 - x1), int(y2 - y1)) for x1, y1, x2, y2 in boxes], np.int64)
    slots = np.where(buckets < 0, len(BUCKETS) - 1, buckets)
    shapes: list = []
    group_of: dict = {}
    for s in sorted(set(slots.tolist())):
        bh, bw = BUCKETS[s][:2]
        for gi, (gh, gw) in enumerate(shapes):
            if max(gh, bh) * max(gw, bw) <= FUSED_IDS_MAX_ELEMS:
                shapes[gi] = (max(gh, bh), max(gw, bw))
                group_of[s] = gi
                break
        else:
            if bh * bw > FUSED_IDS_MAX_ELEMS:
                raise ValueError(f"window_table: bucket {bh}x{bw} exceeds K1's 512*512 elements")
            group_of[s] = len(shapes)
            shapes.append((bh, bw))
    grp = np.asarray([group_of[s] for s in slots.tolist()], np.int64)
    index = np.argsort(grp, kind="stable")
    n = len(index)
    b = boxes[index].astype(np.int64)
    slot, grp = slots[index], grp[index]
    spec = np.asarray(BUCKETS, np.int64)
    sh, sw, cap = spec[slot, 0], spec[slot, 1], spec[slot, 3]
    plane_hw = np.asarray(shapes, np.int64).reshape(-1, 2)[grp]
    plane = plane_hw[:, 0] * plane_hw[:, 1]
    px = np.cumsum(plane) - plane
    rows = np.zeros((n, len(_TABLE_COLS)), np.int64)
    for name, col in (("page", pids[index]), ("x0", b[:, 0]), ("y0", b[:, 1]), ("x1", b[:, 2]), ("y1", b[:, 3]),
                      ("sh", sh), ("sw", sw), ("plane_h", plane_hw[:, 0]), ("stride", plane_hw[:, 1]),
                      ("exact", buckets[index] >= 0), ("cap", cap), ("px", px),
                      ("acc", _ACC_BASE + np.cumsum(_ACC_HEADER + 6 * cap) - (_ACC_HEADER + 6 * cap))):
        rows[:, _COL[name]] = col
    # the in-window rectangle (_in_window): rows dy < y1 - y0, all where the box is taller than the window
    for lo, hi, size, col in ((1, 3, sh, "ny"), (0, 2, sw, "nx")):
        ext = b[:, hi] - b[:, lo]
        rows[:, _COL[col]] = np.where(ext > size, size, np.clip(ext, 0, size))
    groups = []
    for gi in range(len(shapes)):
        members = np.flatnonzero(grp == gi)
        first, k = int(px[members[0]]), len(members)
        rows[members, _COL["cand"]] = 4 * first + np.arange(k) * plane[members]
        rows[members, _COL["cand_step"]] = k * plane[members]
        groups.append((int(plane_hw[members[0], 0]), int(plane_hw[members[0], 1]), k, first))
    tiles = -(-plane_hw[:, 0] // _TILE) * -(-plane_hw[:, 1] // _TILE)
    tile_start = np.concatenate([[0], np.cumsum(tiles)])

    parts, used = [], 0
    for s in np.unique(slot):
        at = np.flatnonzero(slot == s)
        bh, bw = BUCKETS[s][:2]
        x_hi, y_hi = _ext_hi(b[at], (bh, bw))
        sampled = np.concatenate([_triples(*_sample_coords(b[at, 1], y_hi, h, bh)),
                                  _triples(*_sample_coords(b[at, 0], x_hi, w, bw))], axis=1)
        rows[at, _COL["rows"]] = used + np.arange(len(at)) * sampled.shape[1]
        rows[at, _COL["cols"]] = rows[at, _COL["rows"]] + 3 * bh
        parts.append(sampled.reshape(-1))
        used += sampled.size
    resampled = np.flatnonzero(rows[:, _COL["exact"]] == 0)
    for i in resampled:
        bh, bw = int(sh[i]), int(sw[i])
        x_hi, y_hi = _ext_hi(b[i], (bh, bw))
        at = _paste_coords(b[i], x_hi, y_hi, (bh, bw), (h, w))
        if at is None:
            continue
        region, ys, xs = at
        rows[i, [_COL["ry0"], _COL["ry1"], _COL["rx0"], _COL["rx1"]]] = region
        ty, tx = _triples(*ys), _triples(*xs)
        rows[i, _COL["paste_rows"]], rows[i, _COL["paste_cols"]] = used, used + ty.size
        parts += [ty, tx]
        used += ty.size + tx.size

    coords = np.concatenate(parts).astype(np.int32) if parts else np.zeros((0,), np.int32)
    data = np.concatenate([rows.reshape(-1), tile_start, resampled, coords]).astype(np.int32)
    o1 = rows.size
    o2 = o1 + len(tile_start)
    o3 = o2 + len(resampled)
    acc_words = _ACC_BASE + int(np.sum(_ACC_HEADER + 6 * cap))
    return WindowTable(data, data[:o1].reshape(n, len(_TABLE_COLS)), index, data[o1:o2], data[o2:o3], data[o3:],
                       (o1, o2, o3), tuple(groups), int(plane.sum()), acc_words)


class _RefineArgs(ctypes.Structure):
    """``RefineArgs`` of ``csrc/refine.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "table", "tile_start", "coords", "resampled", "img", "mask", "canvas", "acc",
        "px", "merged", "fgs", "ids", "inv", "ids_inv",
    )] + [(name, ctypes.c_int) for name in (
        "n_win", "n_tiles", "n_resampled", "img_h", "img_w", "canvas_h", "canvas_w", "inpaint",
    )]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("refine.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("ctd_refine_candidates", "ctd_refine_merge", "ctd_refine_fill"):
        getattr(lib, name).argtypes = [ctypes.POINTER(_RefineArgs), p]
        getattr(lib, name).restype = i
    lib.ctd_refine_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.ctd_refine_layout.restype = i
    lib.ctd_refine_error_string.argtypes = [i]
    lib.ctd_refine_error_string.restype = ctypes.c_char_p
    layout = (ctypes.c_int * 3)()
    lib.ctd_refine_layout(layout)
    if tuple(layout) != (len(_TABLE_COLS), _ACC_HEADER, _TILE):
        raise RuntimeError(f"csrc/refine.cu's layout {tuple(layout)} differs from ops/refine.py's")
    return lib


def _launch(name: str, args: _RefineArgs, stream: int) -> None:
    lib = _lib()
    rc = getattr(lib, name)(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: {lib.ctd_refine_error_string(rc).decode()}")


def launch_candidates(args: _RefineArgs, stream: int) -> None:
    """Enqueue window_in, xor and candidates (no sync)."""
    _launch("ctd_refine_candidates", args, stream)
    launch_candidates.launches += 1


def launch_merge(args: _RefineArgs, stream: int) -> None:
    """Enqueue merge 0..3 and finish (no sync)."""
    _launch("ctd_refine_merge", args, stream)
    launch_merge.launches += 1


def launch_fill(args: _RefineArgs, stream: int) -> None:
    """Enqueue fill_sums, fill_paste and the resampled paste (no sync)."""
    _launch("ctd_refine_fill", args, stream)
    launch_fill.launches += 1


launch_candidates.launches = 0
launch_merge.launches = 0
launch_fill.launches = 0


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One pinned, non-blocking copy of a host array to the device."""
    return torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """A non-blocking copy of a device tensor into pinned host memory; it
    holds the value once the stream has passed the copy."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


def _on_device(dev: torch.device):
    return torch.cuda.device(dev)


def _carry_flag(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    flag = getattr(src, "_bound_flag", None)
    if flag is not None:
        dst._bound_flag = flag
    return dst


def check_bounds(*canvases: torch.Tensor) -> None:
    """Raise if K1 hit a loop bound while :func:`refine_pages` (or
    :func:`refine_page`) made any of ``canvases``.  A card canvas carries
    its flag in pinned host memory, copied in the stream after the refine,
    so call this after a download of the canvas (which waited for the
    stream); a CPU canvas carries none."""
    for canvas in canvases:
        flag = getattr(canvas, "_bound_flag", None)
        if flag is not None and int(flag[0]) != 0:
            raise RuntimeError("refine_pages: a union-find loop exceeded its bound")


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _refine_pages_cuda(imgs, masks, boxes, pids, refine_mode, pad_hw) -> torch.Tensor:
    """:func:`refine_pages` on the card: the windows in chains of at most
    ``_CHAIN_WINDOWS`` (one for any page's blocks), each one table upload,
    the stages of ``csrc/refine.cu`` over all its windows at once and K1
    twice a group; one zeroed buffer holds the canvas and every chain's
    accumulators.  All enqueued, nothing read back: the loop-bound flag
    goes to pinned memory for :func:`check_bounds`."""
    p, h, w = masks.shape
    if imgs.dtype != torch.uint8 or masks.dtype != torch.uint8 or tuple(imgs.shape) != (p, h, w, 3):
        raise ValueError(f"refine_pages: expected uint8 (P, H, W, 3) and (P, H, W), got {tuple(imgs.shape)} "
                         f"{imgs.dtype}, {tuple(masks.shape)} {masks.dtype}")
    if imgs.device != masks.device:
        raise ValueError("refine_pages: images and masks on different devices")
    dev = masks.device
    imgs, masks = imgs.contiguous(), masks.contiguous()
    tabs = [window_table(boxes[i:i + _CHAIN_WINDOWS], pids[i:i + _CHAIN_WINDOWS], (h, w))
            for i in range(0, len(boxes), _CHAIN_WINDOWS)]
    acc_at = np.cumsum([0] + [tab.acc_words for tab in tabs])
    hc, wc = h + pad_hw[0], w + pad_hw[1]
    canvas_bytes = _aligned(p * hc * wc)
    with _on_device(dev):
        zeroed = torch.zeros(canvas_bytes + 4 * int(acc_at[-1]), dtype=torch.uint8, device=dev)
        canvas = zeroed[: p * hc * wc].view(p, hc, wc)
        out = canvas[:, :h, :w]
        if not tabs:
            return out
        acc = zeroed[canvas_bytes:].view(torch.int32)
        for tab, at in zip(tabs, acc_at):
            _chain(tab, imgs, masks, canvas, acc[at:], acc[:1], refine_mode)
        out._bound_flag = _to_pinned(acc[:1])
    return out


def _chain(tab: WindowTable, imgs, masks, canvas, acc, err, refine_mode) -> None:
    """Enqueue one chain: upload ``tab``, then the stages and K1 on scratch
    of its size; K1 ORs its loop-bound flags into ``err``."""
    dev = masks.device
    _, h, w = masks.shape
    _, hc, wc = canvas.shape
    n_win, n_res = len(tab.index), len(tab.resampled)
    count("refine_windows", n_win)
    count("refine_windows_exact", n_win - n_res)
    count("refine_windows_resampled", n_res)
    count("refine_dispatches")
    table = _upload(tab.data, dev)
    k1_px = max(4 * k * ph * pw for ph, pw, k, _ in tab.groups)
    k1_chunks = max(4 * k * ids_chunk_count(ph, pw) for ph, pw, k, _ in tab.groups)
    sizes = {"px": 8 * tab.n_px, "merged": tab.n_px, "fgs": 4 * tab.n_px, "ids": 16 * tab.n_px,
             "inv": tab.n_px, "ids_inv": 4 * tab.n_px, "parent": 4 * k1_px, "counts": 4 * k1_chunks}
    offs, total = {}, 0
    for name, size in sizes.items():
        offs[name] = total
        total += _aligned(size)
    scratch = torch.empty(total, dtype=torch.uint8, device=dev)
    base, tbase = scratch.data_ptr(), table.data_ptr()
    o1, o2, o3 = tab.offsets
    args = _RefineArgs(
        tbase, tbase + 4 * o1, tbase + 4 * o3, tbase + 4 * o2, imgs.data_ptr(), masks.data_ptr(),
        canvas.data_ptr(), acc.data_ptr(), *(base + offs[k] for k in ("px", "merged", "fgs", "ids", "inv", "ids_inv")),
        n_win, int(tab.tile_start[-1]), n_res, h, w, hc, wc, int(refine_mode == REFINEMASK_INPAINT),
    )
    stream = _stream(dev)

    def plane(name, at, n, hw, dtype=torch.uint8):
        size = 4 if dtype == torch.int32 else 1
        start = offs[name] + size * at
        return scratch[start: start + size * n * hw[0] * hw[1]].view(dtype).view(n, *hw)

    def label(src, dst, planes):
        for ph, pw, k, first in tab.groups:
            n, at = planes * k, planes * first
            cc_ids_fused_into(plane(src, at, n, (ph, pw)), plane("parent", 0, n, (ph, pw), torch.int32),
                              plane("counts", 0, 1, (n, ids_chunk_count(ph, pw)), torch.int32)[0],
                              plane(dst, at, n, (ph, pw), torch.int32), err)

    launch_candidates(args, stream)
    label("fgs", "ids", 4)
    launch_merge(args, stream)
    label("inv", "ids_inv", 1)
    launch_fill(args, stream)
