"""The port's host library (``csrc/ctdnative.cpp``): the DB decode's quad
route on the host.

Counterpart of the JAX package's ``native.py``: union-find labelling
(``label_components``) and, in one pass over a label map, each component's
boundary, convex hull, rotating-calipers min-area rect and closed-form
unclip (``component_min_area_rects``), with the JAX extension's shapes,
dtypes and bits.  ``ops/db_decode.py::boxes_from_stats`` takes this route.

The library is built at first use, never at import: one call of the host
C++ compiler (``c++`` or ``g++`` from ``PATH``) into
``comic_text_detector_tpu_torch/build/``, its name carrying a hash of the
source and the flags (``ops/cuda_build.py``'s scheme).  Where the JAX
package falls back to NumPy when its extension is missing, the port does
not: a missing compiler or a failed build raises with the compiler's
message.  The NumPy route of ``boxes_from_stats`` stays as its plain
version; tests reach it by monkeypatching ``get_native`` to return None.

``label_components_plain`` and ``component_min_area_rects_plain`` are the
library's plain versions: the first through ``ops/cc.py``'s plain
union-find, the second in NumPy and Python floats in the library's order
of operations (the same libm calls), so both equal the library bit for bit.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import time
from typing import Optional, Tuple

import numpy as np

from comic_text_detector_tpu_torch.ops import cuda_build

SOURCE = "ctdnative.cpp"
# native/setup.py's flags, a shared library, and no contraction into fused
# multiply-adds (the default of GCC where the target has them)
CXX_FLAGS = ("-O3", "-std=c++17", "-fno-exceptions", "-ffp-contract=off", "-shared", "-fPIC")

_NATIVE = None
build_seconds = None  # the seconds of the build this process made, or 0.0


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the port's host library "
                       f"(csrc/{SOURCE}) cannot be built")


def library_path() -> str:
    return cuda_build.hashed_path(SOURCE, CXX_FLAGS)


def build() -> float:
    """Compile ``csrc/ctdnative.cpp`` unless its library exists; returns the
    seconds taken (0.0 if it was built already).  Raises with the
    compiler's output if the build fails."""
    out = library_path()
    if os.path.exists(out):
        return 0.0
    t0 = time.perf_counter()
    log = cuda_build.finish_build(cuda_build.start_build(_cxx(), CXX_FLAGS, SOURCE, out), out)
    if log:
        raise RuntimeError(f"building the port's host library (csrc/{SOURCE}) failed:\n{log}")
    return time.perf_counter() - t0


_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


class NativeLib:
    """The library's two functions on NumPy arrays, with the JAX extension's
    signatures."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        lib.ctd_label_components.restype = ctypes.c_int32
        lib.ctd_label_components.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_int32, _I32P]
        lib.ctd_component_min_area_rects.restype = None
        lib.ctd_component_min_area_rects.argtypes = [_I32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                                                     ctypes.POINTER(ctypes.c_float), ctypes.c_double,
                                                     _F64P, _F64P, _F64P]
        self._lib = lib

    def label_components(self, mask: np.ndarray, connectivity: int = 8) -> Tuple[np.ndarray, int]:
        """(H, W) mask (nonzero = set) -> (int32 labels, n): components 1..n
        in raster order of their first pixel."""
        m = np.ascontiguousarray(mask, dtype=np.uint8)
        if m.ndim != 2:
            raise ValueError("mask must be 2-D")
        labels = np.empty(m.shape, np.int32)
        n = self._lib.ctd_label_components(_ptr(m, ctypes.POINTER(ctypes.c_uint8)), m.shape[0], m.shape[1],
                                           int(connectivity), _ptr(labels, _I32P))
        if n < 0:
            raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
        return labels, int(n)

    def component_min_area_rects(self, labels: np.ndarray, n: int, prob: Optional[np.ndarray] = None,
                                 unclip_ratio: float = 1.5) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Label map (1..n) -> (boxes (n, 4, 2) float64, ssides (n,), scores
        (n,)): each component's min-area rect, unclipped and ordered [tl, tr,
        br, bl], its short side before the unclip, its mean of ``prob``
        (0 without it)."""
        lab = np.ascontiguousarray(labels, dtype=np.int32)
        if lab.ndim != 2:
            raise ValueError("labels must be 2-D")
        p = None if prob is None else np.ascontiguousarray(prob, dtype=np.float32)
        if p is not None and p.shape != lab.shape:
            raise ValueError(f"prob {p.shape} and labels {lab.shape} differ in shape")
        n = int(n)
        boxes = np.empty((n, 4, 2), np.float64)
        ssides = np.empty((n,), np.float64)
        scores = np.empty((n,), np.float64)
        self._lib.ctd_component_min_area_rects(
            _ptr(lab, _I32P), lab.shape[0], lab.shape[1], n,
            None if p is None else _ptr(p, ctypes.POINTER(ctypes.c_float)), float(unclip_ratio),
            _ptr(boxes, _F64P), _ptr(ssides, _F64P), _ptr(scores, _F64P))
        return boxes, ssides, scores


def get_native() -> NativeLib:
    """The host library, built on the first call of the process; raises if
    it cannot be built."""
    global _NATIVE, build_seconds
    if _NATIVE is None:
        build_seconds = build()
        _NATIVE = NativeLib(library_path())
    return _NATIVE


def available() -> bool:
    """Whether the host library builds and loads here.  The port's routes
    call ``get_native`` and let its error stand; this is for callers that
    want to ask first."""
    try:
        get_native()
    except (RuntimeError, OSError):
        return False
    return True


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def label_components_plain(mask: np.ndarray, connectivity: int = 8) -> Tuple[np.ndarray, int]:
    """``label_components`` through ``ops/cc.py``'s plain union-find: its
    labels are each component's first raster index + 1, so their rank is
    the raster order of the first pixels."""
    import torch

    from comic_text_detector_tpu_torch.ops.cc import connected_components

    m = torch.from_numpy(np.ascontiguousarray(mask, dtype=np.uint8))
    raw = connected_components(m, connectivity, "xla").numpy()
    firsts = np.unique(raw[raw > 0])
    labels = np.where(raw > 0, np.searchsorted(firsts, raw) + 1, 0).astype(np.int32)
    return labels, len(firsts)


def _hull(xs: np.ndarray, ys: np.ndarray):
    """The library's ``convex_hull`` (monotone chain, collinear points
    dropped, counter-clockwise from the least (x, y)) of a component's
    pixels.  Only the top and bottom pixel of each column can be a vertex,
    so the chain runs over those."""
    order = np.lexsort((ys, xs))
    xs, ys = xs[order], ys[order]
    first = np.r_[True, xs[1:] != xs[:-1]]
    last = np.r_[xs[1:] != xs[:-1], True]
    keep = first | last
    pts = list(zip(xs[keep].tolist(), ys[keep].tolist()))
    if len(pts) <= 2:
        return pts

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    h = []
    for p in pts:
        while len(h) >= 2 and cross(h[-2], h[-1], p) <= 0:
            h.pop()
        h.append(p)
    lower = len(h) + 1
    for p in reversed(pts[:-1]):
        while len(h) >= lower and cross(h[-2], h[-1], p) <= 0:
            h.pop()
        h.append(p)
    return h[:-1]


def _min_area_rect(hull):
    """The library's ``min_area_rect``: (4 corners, w, h)."""
    n = len(hull)
    if n == 1:
        return [hull[0]] * 4, 0.0, 0.0
    if n == 2:
        (x0, y0), (x1, y1) = hull
        return [hull[0], hull[1], hull[1], hull[0]], float(np.hypot(x1 - x0, y1 - y0)), 0.0
    hx = np.array([p[0] for p in hull])
    hy = np.array([p[1] for p in hull])
    best_area, best = 1e300, (0.0, 0.0, 0.0, 0.0, 0.0)
    for i in range(n):
        j = (i + 1) % n
        a = math.fmod(math.atan2(hull[j][1] - hull[i][1], hull[j][0] - hull[i][0]), math.pi / 2)
        if a < 0:
            a += math.pi / 2
        c, s = math.cos(a), math.sin(a)
        rx = hx * c + hy * s
        ry = -hx * s + hy * c
        mnx, mxx, mny, mxy = float(rx.min()), float(rx.max()), float(ry.min()), float(ry.max())
        area = (mxx - mnx) * (mxy - mny)
        if area < best_area - 1e-12:
            best_area, best = area, (a, mnx, mny, mxx, mxy)
    a, mnx, mny, mxx, mxy = best
    c, s = math.cos(a), math.sin(a)
    corners = [(x * c - y * s, x * s + y * c) for x, y in ((mnx, mny), (mxx, mny), (mxx, mxy), (mnx, mxy))]
    return corners, mxx - mnx, mxy - mny


def _order_rect(box):
    p = sorted(box)
    i1, i4 = (0, 1) if p[1][1] > p[0][1] else (1, 0)
    i2, i3 = (2, 3) if p[3][1] > p[2][1] else (3, 2)
    return [p[i1], p[i2], p[i3], p[i4]]


def _outward(nx: float, ny: float, p, cx: float, cy: float):
    length = float(np.hypot(nx, ny))
    if not length > 1e-12:
        return 0.0, 0.0
    nx, ny = nx / length, ny / length
    if nx * (p[0] - cx) + ny * (p[1] - cy) < 0:
        return -nx, -ny
    return nx, ny


def _inflate_rect(box, d: float):
    cx = cy = 0.0
    for x, y in box:
        cx += x / 4
        cy += y / 4
    out = []
    for i, p in enumerate(box):
        prv, nxt = box[(i + 3) % 4], box[(i + 1) % 4]
        n1x, n1y = _outward(p[1] - prv[1], -(p[0] - prv[0]), p, cx, cy)
        n2x, n2y = _outward(nxt[1] - p[1], -(nxt[0] - p[0]), p, cx, cy)
        out.append((p[0] + (n1x + n2x) * d, p[1] + (n1y + n2y) * d))
    return out


def component_min_area_rects_plain(labels: np.ndarray, n: int, prob: Optional[np.ndarray] = None,
                                   unclip_ratio: float = 1.5) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``component_min_area_rects`` in NumPy and Python floats, in the
    library's order of operations: areas and probability sums in raster
    order (``np.bincount``), the hull of each component, the calipers over
    its edges, the corner order, the unclip and the order again.  One-pixel
    components, most of a noisy map's, take one vectorised step."""
    lab = np.ascontiguousarray(labels, dtype=np.int32)
    n = int(n)
    boxes = np.zeros((n, 4, 2), np.float64)
    ssides = np.zeros((n,), np.float64)
    scores = np.zeros((n,), np.float64)
    flat = lab.ravel()
    inside = (flat > 0) & (flat <= n)
    idx = np.flatnonzero(inside)
    comp = flat[idx]
    area = np.bincount(comp, minlength=n + 1)
    if prob is not None:
        psum = np.bincount(comp, weights=np.ascontiguousarray(prob, np.float32).ravel()[idx].astype(np.float64),
                           minlength=n + 1)
    # boundary pixels: on the map's border (the -1 pad) or with a 4-neighbour
    # of another label
    w = lab.shape[1]
    pad = np.pad(lab, 1, constant_values=-1)
    edge = (pad[1:-1, :-2] != lab) | (pad[1:-1, 2:] != lab) | (pad[:-2, 1:-1] != lab) | (pad[2:, 1:-1] != lab)
    bidx = idx[edge.ravel()[idx]]
    bcomp = flat[bidx]
    order = np.argsort(bcomp, kind="stable")
    bidx, bcomp = bidx[order], bcomp[order]
    starts = np.searchsorted(bcomp, np.arange(1, n + 2))
    counts = np.diff(starts)
    if prob is not None:
        some = area[1:] > 0
        scores[some] = psum[1:][some] / area[1:][some]
    # a one-pixel component's rect is its pixel four times, with no unclip
    one = np.flatnonzero(counts == 1)
    px = bidx[starts[one]]
    boxes[one] = np.stack([px % w, px // w], axis=1)[:, None, :]
    for i in np.flatnonzero(counts > 1) + 1:
        sl = bidx[starts[i - 1]:starts[i]]
        hull = _hull((sl % w).astype(np.float64), (sl // w).astype(np.float64))
        box, rw, rh = _min_area_rect(hull)
        per = 2 * (rw + rh)
        d = rw * rh * unclip_ratio / per if per > 0 else 0.0
        boxes[i - 1] = _order_rect(_inflate_rect(_order_rect(box), d))
        ssides[i - 1] = min(rw, rh)
    return boxes, ssides, scores
