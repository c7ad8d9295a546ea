"""Connected-component labelling and per-component statistics.

Counterpart of the JAX package's ``ops/cc.py``.  ``connected_components``
keeps its contract: int32 labels equal to the minimum linear index of each
pixel's component + 1, and 0 on background.  Its routes:

* ``"vmem"``: kernel K2 (``ops/cc_kernels.py::cc_windows_local``) on the
  stack of maps as one window each, 8-connectivity only (the JAX route
  ignores ``connectivity`` there; this one raises for 4);
* ``"pallas"``: kernel K4's row and column sweeps
  (``ops/scan_kernels.py``), then the diagonal hop and the re-mask in plain
  PyTorch, iterated to the fixpoint: two rounds, then a test of whether the
  second changed anything, read on the host;
* ``"xla"``: the plain route, a hook-to-min union-find
  (``cc_kernels.cc_windows_local_plain``) on any device;
* ``"auto"`` (``auto_backend``): on the card, 8-connected maps take K2 at
  every size; 4-connected maps take K4 where its row kernel takes the width
  (``MAX_ROW``) and the plain route where they are wider; on the CPU, the
  plain route.

The card's ``"auto"`` departs from the JAX routing, which on the TPU sends
8-connected maps of more than 1M elements to the sweep fixpoint
(``comic_text_detector_tpu/ops/cc.py::_use_vmem``).  That limit is the TPU
kernel's scoped-VMEM budget, a schedule of that chip; K2 keeps its labels in
device memory and takes any size, and every route gives the same labels, so
the card takes the one that labels a map in one call rather than a host-read
fixpoint of many rounds.

``component_stats`` compacts raw labels to ids 1..C-1 and reduces each
component's bounding box, area and value sum.  Its minima and maxima are
scatter reductions; its areas and sums are sorted-id segmented sums
(``component_sums``, shared with the DB decode), the same bits on every run
on the card and, on the CPU, the same bits as the JAX package's
raster-order scatter-add.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from comic_text_detector_tpu_torch.constants import MAX_DB_COMPONENTS
from comic_text_detector_tpu_torch.ops.cc_kernels import CC_BIG, cc_windows_local, cc_windows_local_plain
from comic_text_detector_tpu_torch.ops.scan_kernels import MAX_ROW, cc_col_sweep, cc_row_sweep

BACKENDS = ("auto", "vmem", "pallas", "xla")
_REST_SEGMENTS = 1024  # short segments that share the pixels outside every counted id


def _diag_hop(labels: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """8-connectivity's diagonal step on an (N, H, W) stack: each set pixel
    takes the minimum of itself and its four diagonal neighbours; the
    background is reset to 2**30."""
    p = F.pad(labels, (1, 1, 1, 1), value=CC_BIG)
    diag = torch.minimum(torch.minimum(p[:, :-2, :-2], p[:, :-2, 2:]), torch.minimum(p[:, 2:, :-2], p[:, 2:, 2:]))
    return torch.where(fg, torch.minimum(labels, diag), CC_BIG)


def _sweep_round(labels: torch.Tensor, mask_u8: torch.Tensor, fg: torch.Tensor, connectivity: int) -> torch.Tensor:
    labels = cc_col_sweep(cc_row_sweep(labels, mask_u8), mask_u8)
    return _diag_hop(labels, fg) if connectivity == 8 else labels


def _sweep_fixpoint(mask_u8: torch.Tensor, connectivity: int) -> torch.Tensor:
    """K4 route on an (N, H, W) stack -> the component-min linear index of
    each set pixel, 2**30 on background.  Returns after the first pair of
    rounds whose second round changed nothing; a min-propagation round that
    changes nothing has reached the fixpoint."""
    n, h, w = mask_u8.shape
    fg = mask_u8 != 0
    lin = torch.arange(h * w, dtype=torch.int32, device=mask_u8.device).view(1, h, w)
    labels = torch.where(fg, lin, CC_BIG)
    # every changing round spreads a component's minimum to at least one more
    # pixel, so no map needs more rounds than it has pixels
    bound = h * w + 2
    rounds = 0
    while rounds < bound:
        mid = _sweep_round(labels, mask_u8, fg, connectivity)
        labels = _sweep_round(mid, mask_u8, fg, connectivity)
        rounds += 2
        if not bool((labels != mid).any()):
            connected_components.rounds = rounds
            return labels
    raise RuntimeError(f"connected_components: no fixpoint after {rounds} rounds")


def auto_backend(device_type: str, connectivity: int, h: int, w: int) -> str:
    """The route ``backend="auto"`` takes for (N, h, w) maps on a device of
    ``device_type``: K2 (``"vmem"``) for every 8-connected map on the card,
    K4 (``"pallas"``) for 4-connected maps whose rows K4 takes, else the
    plain route (``"xla"``)."""
    if device_type != "cuda":
        return "xla"
    if connectivity == 8:
        return "vmem"
    return "pallas" if w <= MAX_ROW else "xla"


def connected_components(mask: torch.Tensor, connectivity: int = 8, backend: str = "auto") -> torch.Tensor:
    """Label the set pixels of an (H, W) mask, or of each page of an
    (N, H, W) stack, bool or uint8.

    Returns int32 of the same shape: 0 on background, else the minimum
    linear index (within the page) of the pixel's component + 1.  The
    ``"pallas"`` route leaves its number of rounds in
    ``connected_components.rounds``."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if mask.dim() not in (2, 3) or mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"expected an (H, W) or (N, H, W) bool or uint8 mask, got {tuple(mask.shape)} {mask.dtype}")
    if mask.shape[-2] * mask.shape[-1] >= CC_BIG:
        raise ValueError(f"map {tuple(mask.shape[-2:])} too large for int32 labels")
    m = (mask != 0).to(torch.uint8).contiguous().view(-1, *mask.shape[-2:])
    h, w = m.shape[-2:]
    if backend == "auto":
        backend = auto_backend(m.device.type, connectivity, h, w)
    if backend == "xla":
        root = cc_windows_local_plain(m, connectivity)
    elif backend == "vmem":
        if connectivity != 8:
            raise ValueError("backend 'vmem' (kernel K2) labels 8-connected components only")
        root = cc_windows_local(m)
    else:
        root = _sweep_fixpoint(m, connectivity)
    return torch.where(m != 0, root + 1, 0).to(torch.int32).view(mask.shape)


connected_components.rounds = 0


def component_sums(values: torch.Tensor, labels: torch.Tensor, capacity: int):
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


class ComponentStats(NamedTuple):
    """Fixed-capacity per-component statistics (index 0 is the background)."""

    count: torch.Tensor  # () int32: the number of components (may exceed capacity-1: truncated)
    area: torch.Tensor  # (C,) int32
    xmin: torch.Tensor  # (C,) int32
    ymin: torch.Tensor  # (C,) int32
    xmax: torch.Tensor  # (C,) int32
    ymax: torch.Tensor  # (C,) int32
    value_sum: torch.Tensor  # (C,) float32: the sum of ``values`` over the component
    compact_labels: torch.Tensor  # (H, W) int32 in [0, C)


def component_stats(
    labels: torch.Tensor, values: Optional[torch.Tensor] = None, capacity: int = MAX_DB_COMPONENTS
) -> ComponentStats:
    """Compact the raw labels of an (H, W) map to ids 1..C-1 in label order
    and reduce each component's statistics.  Components past ``capacity``-1
    are dropped; ``count`` still gives the true total."""
    h, w = labels.shape
    dev = labels.device
    flat = labels.reshape(-1).long()
    present = torch.zeros(h * w + 1, dtype=torch.int32, device=dev)
    present.scatter_reduce_(0, flat, (flat > 0).to(torch.int32), "amax")
    comp_id_full = torch.cumsum(present, 0, dtype=torch.int32)  # label value -> compact id (1-based)
    comp_id = torch.where(present > 0, comp_id_full, 0)
    compact = comp_id[flat]
    compact = torch.where(compact < capacity, compact, 0)

    ys = torch.arange(h, dtype=torch.int32, device=dev).repeat_interleave(w)
    xs = torch.arange(w, dtype=torch.int32, device=dev).repeat(h)
    cl = compact.long()

    def reduce(init: int, src: torch.Tensor, how: str) -> torch.Tensor:
        out = torch.full((capacity,), init, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, cl, src, how)

    xmin, ymin = reduce(w, xs, "amin"), reduce(h, ys, "amin")
    xmax, ymax = reduce(-1, xs, "amax"), reduce(-1, ys, "amax")
    vals = torch.zeros((h, w), dtype=torch.float32, device=dev) if values is None else values.to(torch.float32)
    area, vsum = component_sums(vals, compact, capacity)
    area = area.to(torch.int32)
    area[0] = 0
    vsum[0] = 0.0
    return ComponentStats(
        count=comp_id_full[-1],
        area=area,
        xmin=xmin,
        ymin=ymin,
        xmax=xmax,
        ymax=ymax,
        value_sum=vsum,
        compact_labels=compact.view(h, w),
    )
