"""Host-side polygon geometry (NumPy): the two predicates the port's host
stages call.

Own copy of the JAX package's ``ops/geometry.py`` functions of the same
names; the DB decode's corner ordering and the text-line merge's convex
overlap test.
"""

from __future__ import annotations

import numpy as np


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
