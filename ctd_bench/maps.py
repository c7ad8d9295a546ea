"""DBNet ground-truth map generation.

Own copy of the JAX package's ``data/maps.py``.

Re-implementation of the reference's MakeShrinkMap (utils/db_utils.py:527-592)
and MakeBorderMap (:595-692) using this framework's polygon offset
(ops/geometry.py) in place of pyclipper, and vectorized NumPy distance
fields.  Runs in the input pipeline (host), not the hot path.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ctd_bench.reference import geometry as geo


def shrink_polygon(polygon: np.ndarray, shrink_ratio: float) -> np.ndarray:
    """Inward offset by area·(1-r²)/perimeter (DBNet shrink rule,
    reference shrink_polygon_pyclipper, db_utils.py:512-525)."""
    area = abs(geo.shoelace_area(np.asarray(polygon, np.float64)))
    length = geo.perimeter(np.asarray(polygon, np.float64))
    if length <= 0:
        return np.zeros((0, 2))
    distance = area * (1 - shrink_ratio**2) / length
    return geo.offset_polygon(polygon, -distance)


class MakeShrinkMap:
    """Shrunk-text binary GT + ignore mask."""

    def __init__(self, min_text_size: int = 4, shrink_ratio: float = 0.4):
        self.min_text_size = min_text_size
        self.shrink_ratio = shrink_ratio

    def __call__(self, data: Dict) -> Dict:
        image = data["imgs"]
        text_polys = data["text_polys"]
        ignore_tags = data["ignore_tags"]
        h, w = image.shape[:2]
        text_polys, ignore_tags = self.validate_polygons(text_polys, ignore_tags, h, w)
        gt = np.zeros((h, w), np.float32)
        mask = np.ones((h, w), np.float32)
        for i in range(len(text_polys)):
            polygon = text_polys[i]
            height = max(polygon[:, 1]) - min(polygon[:, 1])
            width = max(polygon[:, 0]) - min(polygon[:, 0])
            if ignore_tags[i] or min(height, width) < self.min_text_size:
                mask[geo.fill_polygon(polygon.astype(np.int32), h, w) > 0] = 0
                ignore_tags[i] = True
            else:
                shrunk = shrink_polygon(polygon, self.shrink_ratio)
                if shrunk.size == 0:
                    mask[geo.fill_polygon(polygon.astype(np.int32), h, w) > 0] = 0
                    ignore_tags[i] = True
                    continue
                gt[geo.fill_polygon(np.round(shrunk).astype(np.int32), h, w) > 0] = 1
        data["shrink_map"] = gt
        data["shrink_mask"] = mask
        return data

    def validate_polygons(self, polygons, ignore_tags, h, w):
        if len(polygons) == 0:
            return polygons, ignore_tags
        for polygon in polygons:
            polygon[:, 0] = np.clip(polygon[:, 0], 0, w - 1)
            polygon[:, 1] = np.clip(polygon[:, 1], 0, h - 1)
        for i in range(len(polygons)):
            area = geo.shoelace_area(np.asarray(polygons[i], np.float64))
            if abs(area) < 1:
                ignore_tags[i] = True
            if area > 0:  # enforce clockwise-in-image-coords like the reference
                polygons[i] = polygons[i][::-1, :]
        return polygons, ignore_tags


class MakeBorderMap:
    """Distance-field threshold GT in [thresh_min, thresh_max]."""

    def __init__(self, shrink_ratio: float = 0.4, thresh_min: float = 0.3, thresh_max: float = 0.7):
        self.shrink_ratio = shrink_ratio
        self.thresh_min = thresh_min
        self.thresh_max = thresh_max

    def __call__(self, data: Dict) -> Dict:
        im = data["imgs"]
        text_polys = data["text_polys"]
        ignore_tags = data["ignore_tags"]
        canvas = np.zeros(im.shape[:2], np.float32)
        mask = np.zeros(im.shape[:2], np.float32)
        for i in range(len(text_polys)):
            if ignore_tags[i]:
                continue
            self.draw_border_map(text_polys[i], canvas, mask)
        canvas = canvas * (self.thresh_max - self.thresh_min) + self.thresh_min
        data["threshold_map"] = canvas
        data["threshold_mask"] = mask
        return data

    def draw_border_map(self, polygon, canvas: np.ndarray, mask: np.ndarray) -> None:
        polygon = np.array(polygon, np.float64)
        if polygon.ndim != 2 or polygon.shape[1] != 2:
            return
        area = abs(geo.shoelace_area(polygon))
        if area <= 0:
            return
        length = geo.perimeter(polygon)
        distance = area * (1 - self.shrink_ratio**2) / length
        padded = geo.offset_polygon(polygon, distance)
        if len(padded) < 3:
            return
        mask[geo.fill_polygon(np.round(padded).astype(np.int32), mask.shape[0], mask.shape[1]) > 0] = 1.0

        xmin = int(padded[:, 0].min())
        xmax = int(np.ceil(padded[:, 0].max()))
        ymin = int(padded[:, 1].min())
        ymax = int(np.ceil(padded[:, 1].max()))
        width = xmax - xmin + 1
        height = ymax - ymin + 1
        poly = polygon.copy()
        poly[:, 0] -= xmin
        poly[:, 1] -= ymin

        xs = np.broadcast_to(np.linspace(0, width - 1, num=width).reshape(1, width), (height, width))
        ys = np.broadcast_to(np.linspace(0, height - 1, num=height).reshape(height, 1), (height, width))

        distance_map = np.zeros((poly.shape[0], height, width), np.float32)
        for i in range(poly.shape[0]):
            j = (i + 1) % poly.shape[0]
            absolute = self._point_segment_distance(xs, ys, poly[i], poly[j])
            distance_map[i] = np.clip(absolute / distance, 0, 1)
        distance_map = distance_map.min(axis=0)

        xmin_v = min(max(0, xmin), canvas.shape[1] - 1)
        xmax_v = min(max(0, xmax), canvas.shape[1] - 1)
        ymin_v = min(max(0, ymin), canvas.shape[0] - 1)
        ymax_v = min(max(0, ymax), canvas.shape[0] - 1)
        canvas[ymin_v : ymax_v + 1, xmin_v : xmax_v + 1] = np.fmax(
            1
            - distance_map[
                ymin_v - ymin : ymax_v - ymax + height,
                xmin_v - xmin : xmax_v - xmax + width,
            ],
            canvas[ymin_v : ymax_v + 1, xmin_v : xmax_v + 1],
        )

    @staticmethod
    def _point_segment_distance(xs, ys, p1, p2):
        """Distance from each grid point to the segment p1-p2 (the reference's
        law-of-cosines formulation, db_utils.py:674-692)."""
        sq1 = np.square(xs - p1[0]) + np.square(ys - p1[1])
        sq2 = np.square(xs - p2[0]) + np.square(ys - p2[1])
        sq = np.square(p1[0] - p2[0]) + np.square(p1[1] - p2[1])
        with np.errstate(divide="ignore", invalid="ignore"):
            cosin = (sq - sq1 - sq2) / (2 * np.sqrt(sq1 * sq2))
            square_sin = np.nan_to_num(1 - np.square(cosin))
            result = np.sqrt(sq1 * sq2 * square_sin / sq)
        result = np.nan_to_num(result)
        result[cosin < 0] = np.sqrt(np.fmin(sq1, sq2))[cosin < 0]
        return result
