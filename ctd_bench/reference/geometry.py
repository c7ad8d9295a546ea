"""Host-side polygon geometry (NumPy), built without shapely, pyclipper or
cv2.

Own copy of the JAX package's ``ops/geometry.py`` functions of the same
names that the port's host stages call: the DB decode's corner ordering,
the text-line merge's convex overlap test, what ``boxes_from_stats`` and
``polygons_from_stats`` need, and what the training metrics and the DB
ground-truth maps need:

* shoelace area and perimeter                (shapely Polygon.area/.length)
* convex hull (monotone chain)               (cv2.convexHull)
* min-area rotated rect (rotating calipers)  (cv2.minAreaRect/boxPoints)
* polygon offset with round joins            (pyclipper.PyclipperOffset)
* convex clipping, intersection and IoU      (shapely intersection)
* polygon rasterization                      (cv2.fillPoly)

Frozen copy of the port's ``ops/geometry.py`` for the benchmark's plain reference,
which imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def shoelace_area(poly: np.ndarray) -> float:
    """Signed area (positive = counter-clockwise in y-up coords)."""
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def perimeter(poly: np.ndarray) -> float:
    d = np.diff(np.vstack([poly, poly[:1]]), axis=0)
    return float(np.sqrt((d**2).sum(-1)).sum())


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain. Returns CCW hull (in y-down image coords this
    iterates clockwise visually). Input (N,2) float; output (M,2)."""
    pts = np.unique(points.astype(np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    # lexicographic sort by (x, y)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: List[np.ndarray] = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: List[np.ndarray] = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.array(lower[:-1] + upper[:-1])


def min_area_rect(points: np.ndarray) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Minimum-area enclosing rotated rectangle via rotating calipers.

    Returns (corners (4,2) float64, (w, h)).  Equivalent to
    cv2.minAreaRect + cv2.boxPoints (same rectangle; corner order may be a
    rotation — callers normalize with :func:`order_rect_points`).
    """
    hull = convex_hull(points)
    if len(hull) == 0:
        return np.zeros((4, 2)), (0.0, 0.0)
    if len(hull) == 1:
        c = np.tile(hull[0], (4, 1))
        return c, (0.0, 0.0)
    if len(hull) == 2:
        p0, p1 = hull
        return np.array([p0, p1, p1, p0], np.float64), (float(np.linalg.norm(p1 - p0)), 0.0)

    edges = np.roll(hull, -1, axis=0) - hull
    ang = np.arctan2(edges[:, 1], edges[:, 0])
    best = None
    for a in np.unique(np.mod(ang, np.pi / 2)):
        c, s = math.cos(a), math.sin(a)
        rot = np.array([[c, s], [-s, c]])
        proj = hull @ rot.T
        mn, mx = proj.min(0), proj.max(0)
        area = (mx[0] - mn[0]) * (mx[1] - mn[1])
        if best is None or area < best[0] - 1e-12:
            best = (area, a, mn, mx)
    _, a, mn, mx = best
    c, s = math.cos(a), math.sin(a)
    rot = np.array([[c, s], [-s, c]])
    corners_r = np.array([[mn[0], mn[1]], [mx[0], mn[1]], [mx[0], mx[1]], [mn[0], mx[1]]])
    corners = corners_r @ rot
    return corners, (float(mx[0] - mn[0]), float(mx[1] - mn[1]))




def order_rect_points(box: np.ndarray) -> np.ndarray:
    """Order 4 rect corners as [top-left, top-right, bottom-right, bottom-left]
    using the reference's rule (db_utils.py get_mini_boxes :176-195: sort by x,
    then resolve each pair by y)."""
    pts = sorted(box.tolist(), key=lambda p: (p[0], p[1]))
    if pts[1][1] > pts[0][1]:
        i1, i4 = 0, 1
    else:
        i1, i4 = 1, 0
    if pts[3][1] > pts[2][1]:
        i2, i3 = 2, 3
    else:
        i2, i3 = 3, 2
    return np.array([pts[i1], pts[i2], pts[i3], pts[i4]], np.float64)


def mini_box(points: np.ndarray) -> Tuple[np.ndarray, float]:
    """get_mini_boxes equivalent: ordered min-area-rect corners + short side."""
    corners, (w, h) = min_area_rect(points)
    return order_rect_points(corners), float(min(w, h))


def inflate_rect(box: np.ndarray, distance: float) -> np.ndarray:
    """Grow an ordered rotated rect outward by ``distance`` on every side.

    Equals minAreaRect(round-join offset(rect, d)) — the reference's
    unclip-then-minAreaRect composition on quad outputs
    (db_utils.py:153-154): the Minkowski sum of a rect with a disk has the
    inflated rect as its min-area rect.
    """
    c = box.mean(0)
    out = np.empty_like(box, dtype=np.float64)
    for i in range(4):
        prv = box[(i - 1) % 4]
        nxt = box[(i + 1) % 4]
        p = box[i]
        # push the corner along both adjacent edge normals
        d1 = p - prv
        d2 = nxt - p
        n1 = _unit_normal_outward(d1, p, c)
        n2 = _unit_normal_outward(d2, p, c)
        out[i] = p + (n1 + n2) * distance
    return out


def _unit_normal_outward(edge: np.ndarray, p: np.ndarray, centroid: np.ndarray) -> np.ndarray:
    n = np.array([edge[1], -edge[0]], np.float64)
    norm = np.linalg.norm(n)
    if norm < 1e-12:
        return np.zeros(2)
    n = n / norm
    if np.dot(n, p - centroid) < 0:
        n = -n
    return n


def offset_polygon(poly: np.ndarray, delta: float, arc_step: float = math.pi / 9) -> np.ndarray:
    """Polygon offset with round joins (pyclipper JT_ROUND equivalent).

    Positive ``delta`` grows, negative shrinks.  Outward offset inserts arc
    points at convex corners; inward offset of a convex polygon clips with
    the shifted half-planes (exact).  Non-convex inward offsets fall back to
    the half-plane method of the convex hull region intersected with the
    edge-shifted polygon — adequate for the near-convex text quads this
    framework processes (GT generation, unclip).  Returns (M,2) or an empty
    array when the polygon vanishes.
    """
    poly = np.asarray(poly, np.float64)
    if len(poly) < 3:
        return np.zeros((0, 2))
    if shoelace_area(poly) < 0:
        poly = poly[::-1]
    if delta == 0:
        return poly.copy()
    if delta < 0:
        return _inward_offset(poly, -delta)
    return _outward_offset(poly, delta, arc_step)


def _outward_offset(poly: np.ndarray, d: float, arc_step: float) -> np.ndarray:
    n = len(poly)
    c = poly.mean(0)
    out: List[np.ndarray] = []
    for i in range(n):
        p = poly[i]
        prv = poly[(i - 1) % n]
        nxt = poly[(i + 1) % n]
        n1 = _unit_normal_outward(p - prv, (p + prv) / 2, c)
        n2 = _unit_normal_outward(nxt - p, (p + nxt) / 2, c)
        a1 = math.atan2(n1[1], n1[0])
        a2 = math.atan2(n2[1], n2[0])
        sweep = (a2 - a1) % (2 * math.pi)
        if sweep > math.pi:  # reflex corner: single join point
            out.append(p + (n1 + n2) / max(np.linalg.norm(n1 + n2), 1e-9) * d)
            continue
        steps = max(1, int(math.ceil(sweep / arc_step)))
        for s in range(steps + 1):
            a = a1 + sweep * s / steps
            out.append(p + np.array([math.cos(a), math.sin(a)]) * d)
    return np.array(out)


def _inward_offset(poly: np.ndarray, d: float) -> np.ndarray:
    n = len(poly)
    c = poly.mean(0)
    region = poly.copy()
    for i in range(n):
        p, q = poly[i], poly[(i + 1) % n]
        nrm = _unit_normal_outward(q - p, (p + q) / 2, c)
        # keep half-plane: dot(x - (p - nrm*d), nrm) <= 0
        region = clip_halfplane(region, p - nrm * d, nrm)
        if len(region) < 3:
            return np.zeros((0, 2))
    return region


def clip_halfplane(poly: np.ndarray, point: np.ndarray, normal: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman clip of ``poly`` against dot(x-point, normal) <= 0."""
    if len(poly) == 0:
        return poly
    out: List[np.ndarray] = []
    n = len(poly)
    dist = (poly - point) @ normal
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        da, db = dist[i], dist[(i + 1) % n]
        if da <= 0:
            out.append(a)
            if db > 0:
                out.append(a + (b - a) * (da / (da - db)))
        elif db <= 0:
            out.append(a + (b - a) * (da / (da - db)))
    return np.array(out) if out else np.zeros((0, 2))


def clip_polygon_convex(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Intersection of ``subject`` with convex ``clip`` (Sutherland–Hodgman)."""
    clip = np.asarray(clip, np.float64)
    if shoelace_area(clip) < 0:
        clip = clip[::-1]
    region = np.asarray(subject, np.float64)
    c = clip.mean(0)
    for i in range(len(clip)):
        p, q = clip[i], clip[(i + 1) % len(clip)]
        nrm = _unit_normal_outward(q - p, (p + q) / 2, c)
        region = clip_halfplane(region, p, nrm)
        if len(region) == 0:
            return region
    return region


def intersection_area_convex(a: np.ndarray, b: np.ndarray) -> float:
    inter = clip_polygon_convex(a, b)
    if len(inter) < 3:
        return 0.0
    return abs(shoelace_area(inter))


def iou_convex(a: np.ndarray, b: np.ndarray) -> float:
    ia = intersection_area_convex(a, b)
    ua = abs(shoelace_area(np.asarray(a, np.float64))) + abs(shoelace_area(np.asarray(b, np.float64))) - ia
    return ia / ua if ua > 0 else 0.0


def convex_polygons_intersect(a: np.ndarray, b: np.ndarray) -> bool:
    """Separating-axis test (touching counts as intersecting, like shapely)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    for poly in (a, b):
        n = len(poly)
        for i in range(n):
            edge = poly[(i + 1) % n] - poly[i]
            axis = np.array([-edge[1], edge[0]])
            pa = a @ axis
            pb = b @ axis
            if pa.max() < pb.min() or pb.max() < pa.min():
                return False
    return True


def fill_polygon(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    """Rasterize a polygon into a (h, w) uint8 mask (even-odd scanline with
    boundary-inclusive rounding, cv2.fillPoly-compatible within ±1 px)."""
    return fill_polygons([poly], h, w)


def fill_polygons(polys, h: int, w: int) -> np.ndarray:
    mask = np.zeros((h, w), np.uint8)
    for poly in polys:
        poly = np.asarray(poly, np.float64)
        if len(poly) < 3:
            continue
        ymin = max(int(math.floor(poly[:, 1].min())), 0)
        ymax = min(int(math.ceil(poly[:, 1].max())), h - 1)
        n = len(poly)
        for y in range(ymin, ymax + 1):
            xs = []
            for i in range(n):
                y1, y2 = poly[i, 1], poly[(i + 1) % n, 1]
                x1, x2 = poly[i, 0], poly[(i + 1) % n, 0]
                if (y1 <= y < y2) or (y2 <= y < y1):
                    t = (y - y1) / (y2 - y1)
                    xs.append(x1 + t * (x2 - x1))
                elif y1 == y2 == y:  # horizontal edge on this scanline
                    xs.extend([min(x1, x2), max(x1, x2)])
            xs.sort()
            for j in range(0, len(xs) - 1, 2):
                x0 = max(int(math.ceil(xs[j] - 0.5)), 0)
                x1_ = min(int(math.floor(xs[j + 1] + 0.5)), w - 1)
                if x1_ >= x0:
                    mask[y, x0 : x1_ + 1] = 1
        # cv2.fillPoly also paints the outline itself: rasterize edges
        for i in range(n):
            _draw_line(mask, poly[i], poly[(i + 1) % n])
    return mask


def _draw_line(mask: np.ndarray, p0, p1) -> None:
    """Bresenham-style edge rasterization (outline pixels, clipped)."""
    h, w = mask.shape
    x0, y0 = int(round(p0[0])), int(round(p0[1]))
    x1, y1 = int(round(p1[0])), int(round(p1[1]))
    steps = max(abs(x1 - x0), abs(y1 - y0), 1)
    xs = np.round(np.linspace(x0, x1, steps + 1)).astype(int)
    ys = np.round(np.linspace(y0, y1, steps + 1)).astype(int)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    mask[ys[keep], xs[keep]] = 1
