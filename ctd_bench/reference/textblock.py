"""Text blocks: the ragged host-side output objects of the detector.

This module owns everything that happens after the device hands back compact
detections: the :class:`TextBlock` container (bbox + member line quads +
orientation/format metadata, field-compatible with the reference's serialized
block dicts), per-block geometry analysis, clustering of stray text lines,
distance-gap splitting of vertical/ja blocks, manga reading-order sorting, and
the :func:`group_output` routine that ties them together.

Behavioral contract: reference utils/textblock.py (TextBlock :12-265,
examine_textblk :302-342, merge :344-388, split :390-419, sort :267-300,
group_output :421-508).  The greedy passes are order-dependent, so their
iteration order and thresholds are preserved exactly; the implementation is
this framework's own — quad geometry is computed vectorized over (N, 4, 2)
arrays, line→block assignment is a broadcast intersection matrix rather than
a nested scan, and polygon predicates come from ``ops.geometry`` (SAT)
instead of shapely.

Own copy of the JAX package's ``postproc/textblock.py`` (without its PIL
visualizer).

Frozen copy of the port's ``postproc/textblock.py`` for the benchmark's plain reference,
which imports nothing of the port.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ctd_bench.reference.constants import LANG_LIST
from ctd_bench.reference import geometry as geo
from ctd_bench.reference.imgproc import (
    perspective_transform_matrix,
    rotate_polygons,
    warp_perspective,
    xywh2xyxypoly,
)

# Assignment thresholds of the grouping routine (reference :428-429).
_MIN_BOX_OVERLAP = 0.4  # line is claimed by a block above this overlap ratio
_MIN_MASK_DENSITY = 0.1  # stray lines/empty blocks below this mask mean are dropped


# ---------------------------------------------------------------------------
# Quad frame geometry
#
# Every text line is a quad [tl, tr, br, bl].  Its "frame" is the pair of
# axes through the edge midpoints: the column axis (top-mid -> bottom-mid,
# i.e. the direction characters stack in vertical text) and the row axis
# (left-mid -> right-mid, the direction of horizontal writing).  All block
# analysis derives from these frames, computed in one shot per block.
# ---------------------------------------------------------------------------


def quad_frames(quads: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-quad (column axis, row axis, center) for an (N, 4, 2) array."""
    edge_mids = (quads[:, [1, 2, 3, 0]] + quads) / 2
    col_axes = edge_mids[:, 2] - edge_mids[:, 0]
    row_axes = edge_mids[:, 1] - edge_mids[:, 3]
    centers = (quads[:, 0] + quads[:, 2]) / 2
    return col_axes, row_axes, centers


def _axis_angle_deg(axis: np.ndarray, rounded: bool) -> int:
    """Axis direction in integer degrees.  The reference truncates when first
    analyzing a block (:321) but rounds when re-deriving after a merge (:364);
    both behaviors are pinned by golden tests."""
    deg = np.rad2deg(math.atan2(axis[1], axis[0]))
    return int(round(deg)) if rounded else int(deg)


def _offsets_along(centers: np.ndarray, origin: np.ndarray, axis: np.ndarray,
                   axis_len: float) -> np.ndarray:
    """Unsigned distance of each center from the line through ``origin``
    directed along ``axis`` — the per-line "reading offset" used for
    ordering lines within a block."""
    rel = centers - origin
    radial = np.linalg.norm(rel, axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        cos_t = np.clip(rel @ axis / (radial * axis_len), -1.0, 1.0)
    return np.abs(np.sin(np.arccos(cos_t)) * radial)


def _boxes_intersection_matrix(boxes: np.ndarray, other: np.ndarray) -> np.ndarray:
    """(N, M) pixel intersection areas between two xyxy box sets."""
    lo = np.maximum(boxes[:, None, :2], other[None, :, :2])
    hi = np.minimum(boxes[:, None, 2:], other[None, :, 2:])
    wh = np.clip(hi - lo, 0, None)
    return wh[..., 0] * wh[..., 1]


# ---------------------------------------------------------------------------
# TextBlock
# ---------------------------------------------------------------------------


class TextBlock:
    """One detected text block.

    Carries detection geometry (``xyxy`` bbox, member ``lines`` quads),
    derived layout facts (``vertical``, ``angle``, ``font_size``, per-line
    ``distance`` offsets, aggregate ``vec``/``norm`` axis), and the rich-text
    fields downstream translator apps read.  The field set matches the
    reference TextBlock (:12-68) so ``to_dict`` output is interchangeable.
    """

    def __init__(
        self,
        xyxy: List,
        lines: Optional[List] = None,
        language: str = "unknown",
        vertical: bool = False,
        font_size: float = -1,
        distance: Optional[List] = None,
        angle: int = 0,
        vec: Optional[List] = None,
        norm: float = -1,
        merged: bool = False,
        weight: float = -1,
        text: Optional[List] = None,
        translation: str = "",
        fg_r=0,
        fg_g=0,
        fg_b=0,
        bg_r=0,
        bg_g=0,
        bg_b=0,
        line_spacing=1.0,
        font_family: str = "",
        bold: bool = False,
        underline: bool = False,
        italic: bool = False,
        alignment: int = -1,
        alpha: float = 255,
        rich_text: str = "",
        _bounding_rect: Optional[List] = None,
        accumulate_color=True,
        default_stroke_width=0.2,
        target_lang: str = "",
        **kwargs,
    ) -> None:
        self.xyxy = [int(num) for num in xyxy]
        self.lines = [] if lines is None else lines
        self.vertical = vertical
        self.language = language
        self.font_size = font_size
        self.distance = None if distance is None else np.array(distance, np.float64)
        self.angle = angle
        self.vec = None if vec is None else np.array(vec, np.float64)
        self.norm = norm
        self.merged = merged
        self.weight = weight
        self.text = text if text is not None else []
        self.prob = 1
        self.translation = translation
        self.fg_r = fg_r
        self.fg_g = fg_g
        self.fg_b = fg_b
        self.bg_r = bg_r
        self.bg_g = bg_g
        self.bg_b = bg_b
        self.font_family = font_family
        self.bold = bold
        self.underline = underline
        self.italic = italic
        self.alpha = alpha
        self.rich_text = rich_text
        self.line_spacing = line_spacing
        self._alignment = alignment
        self._target_lang = target_lang
        self._bounding_rect = _bounding_rect
        self.default_stroke_width = default_stroke_width
        self.accumulate_color = accumulate_color

    # -- container protocol --------------------------------------------------

    def __len__(self) -> int:
        return len(self.lines)

    def __getitem__(self, idx):
        return self.lines[idx]

    def to_dict(self) -> Dict:
        return copy.deepcopy(vars(self))

    # -- geometry -------------------------------------------------------------

    def lines_array(self, dtype=np.float64) -> np.ndarray:
        return np.array(self.lines, dtype=dtype)

    @property
    def pts(self) -> np.ndarray:
        return self.lines_array()

    def xywh(self) -> List:
        x1, y1, x2, y2 = self.xyxy
        return [x1, y1, x2 - x1, y2 - y1]

    def center(self) -> np.ndarray:
        xyxy = np.array(self.xyxy)
        return (xyxy[:2] + xyxy[2:]) / 2

    def adjust_bbox(self, with_bbox: bool = False) -> None:
        """Refit ``xyxy`` to the member lines (optionally only growing it)."""
        quads = self.lines_array().astype(np.int32)
        lx1, ly1 = int(quads[..., 0].min()), int(quads[..., 1].min())
        lx2, ly2 = int(quads[..., 0].max()), int(quads[..., 1].max())
        if with_bbox:
            self.xyxy = [
                min(lx1, self.xyxy[0]),
                min(ly1, self.xyxy[1]),
                max(lx2, self.xyxy[2]),
                max(ly2, self.xyxy[3]),
            ]
        else:
            self.xyxy = [lx1, ly1, lx2, ly2]

    def sort_lines(self) -> None:
        """Order lines by their reading offset (``distance``)."""
        if self.distance is not None:
            order = np.argsort(self.distance)
            self.distance = self.distance[order]
            self.lines = np.array(self.lines, dtype=np.int32)[order].tolist()

    def min_rect(self, rotate_back: bool = True) -> np.ndarray:
        """Angle-aware bounding quad of all member lines."""
        center = self.center()
        polys = self.lines_array().reshape(-1, 8)
        if self.angle != 0:
            polys = rotate_polygons(center, polys, self.angle)
        x1, y1 = polys[:, ::2].min(), polys[:, 1::2].min()
        x2, y2 = polys[:, ::2].max(), polys[:, 1::2].max()
        quad = np.array([[x1, y1, x2, y1, x2, y2, x1, y2]])
        if self.angle != 0 and rotate_back:
            quad = rotate_polygons(center, quad, -self.angle)
        return quad.reshape(-1, 4, 2).astype(np.int64)

    def bounding_rect(self) -> List:
        if self._bounding_rect is not None:
            return self._bounding_rect
        quad = self.min_rect(rotate_back=False)[0]
        x, y = quad[0]
        w, h = quad[2] - quad[0]
        return [int(x), int(y), int(w), int(h)]

    def aspect_ratio(self) -> float:
        """Column-axis length over row-axis length of the block's min_rect."""
        col_axes, row_axes, _ = quad_frames(self.min_rect().astype(np.float64))
        return np.linalg.norm(col_axes[0]) / np.linalg.norm(row_axes[0])

    def get_transformed_region(self, img: np.ndarray, idx: int, textheight: int) -> np.ndarray:
        """Rectify line ``idx`` to an axis-aligned strip of height
        ``textheight`` (reference :162-194); vertical lines come back
        rotated 90° CCW so text always reads horizontally."""
        im_h, im_w = img.shape[:2]
        quad = np.array(self.lines[idx], dtype=np.float64)
        if self.language == "eng" or (self.language == "unknown" and not self.vertical):
            # pad eng lines by a third of the font size before rectifying
            pad = self.font_size / 3
            quad[..., 0] = np.clip(quad[..., 0] + np.array([-pad, pad, pad, -pad]), 0, im_w)
            quad[..., 1] = np.clip(quad[..., 1] + np.array([-pad, -pad, pad, pad]), 0, im_h)
        col_axes, row_axes, _ = quad_frames(quad[None])
        ratio = np.linalg.norm(col_axes[0]) / max(np.linalg.norm(row_axes[0]), 1e-9)
        if self.vertical:
            w = int(textheight)
            h = max(int(round(textheight * ratio)), 1)
        else:
            h = int(textheight)
            w = max(int(round(textheight / max(ratio, 1e-9))), 1)
        dst = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float64)
        strip = warp_perspective(img, perspective_transform_matrix(quad, dst), (w, h))
        if self.vertical:
            strip = np.ascontiguousarray(np.rot90(strip, k=1))
        return strip

    # -- colors / formatting ---------------------------------------------------

    def set_font_colors(self, frgb, srgb, accumulate: bool = True) -> None:
        self.accumulate_color = accumulate
        scale = len(self.lines) if accumulate and len(self.lines) > 0 else 1
        self.fg_r, self.fg_g, self.fg_b = np.array(frgb) * scale
        self.bg_r, self.bg_g, self.bg_b = np.array(srgb) * scale

    def get_font_colors(self, bgr: bool = False):
        frgb = np.array([self.fg_r, self.fg_g, self.fg_b])
        brgb = np.array([self.bg_r, self.bg_g, self.bg_b])
        if self.accumulate_color:
            n = len(self.lines)
            if n == 0:
                return [0, 0, 0], [0, 0, 0]
            frgb = (frgb / n).astype(np.int32)
            brgb = (brgb / n).astype(np.int32)
            if bgr:
                return frgb[::-1], brgb[::-1]
        return frgb, brgb

    def alignment(self) -> int:
        """0 = left-aligned, 1 = centered, inferred from which of the
        line-left-edge / line-center x coordinates varies less."""
        if self._alignment >= 0:
            return self._alignment
        if self.vertical or len(self.lines) == 1:
            return 0
        polys = self.lines_array().reshape(-1, 8)
        if self.angle != 0:
            polys = rotate_polygons((0, 0), polys, self.angle)
        quads = polys.reshape(-1, 4, 2)
        left_spread = np.std(quads[:, 0, 0])
        center_spread = np.std((quads[:, 0, 0] + quads[:, 1, 0]) / 2)
        return 0 if left_spread < center_spread else 1

    def get_text(self) -> str:
        if isinstance(self.text, str):
            return self.text
        return " ".join(self.text).strip()

    def target_lang(self) -> str:
        return self._target_lang

    @property
    def stroke_width(self):
        fg_bg_gap = np.abs(
            np.array([self.fg_r, self.fg_g, self.fg_b])
            - np.array([self.bg_r, self.bg_g, self.bg_b])
        ).sum()
        return self.default_stroke_width if fg_bg_gap > 40 else 0


# ---------------------------------------------------------------------------
# Block analysis
# ---------------------------------------------------------------------------


def examine_textblk(blk: TextBlock, im_w: int, im_h: int, sort: bool = False) -> None:
    """Derive a block's layout facts from its line quads (reference :302-342).

    The orientation vote sums the column/row axes of every line frame;
    vertical wins outright for ja, but needs a 2x margin otherwise.  Reading
    offsets are measured from the page origin appropriate to the writing
    direction: top-right ``(im_w, 0)`` for vertical manga text, top-left for
    horizontal.
    """
    quads = blk.lines_array()
    n_lines = len(quads)
    col_axes, row_axes, centers = quad_frames(quads)
    col_sum, row_sum = col_axes.sum(axis=0), row_axes.sum(axis=0)
    col_len, row_len = np.linalg.norm(col_sum), np.linalg.norm(row_sum)
    row_margin = 1.0 if blk.language == "ja" else 2.0
    vertical = col_len > row_len * row_margin

    if vertical:
        axis, axis_len = col_sum, col_len
        origin = np.array([[im_w, 0]], dtype=np.float64)
        font_size = int(round(row_len / n_lines))
    else:
        axis, axis_len = row_sum, row_len
        origin = np.array([[0, 0]], dtype=np.float64)
        font_size = int(round(col_len / n_lines))

    blk.lines = quads.astype(np.int32).tolist()
    blk.distance = _offsets_along(centers, origin, axis, axis_len)
    blk.angle = _axis_angle_deg(axis, rounded=False) - (90 if vertical else 0)
    if abs(blk.angle) < 3:
        blk.angle = 0
    blk.font_size = font_size
    blk.vertical = vertical
    blk.vec = axis
    blk.norm = axis_len
    if sort:
        blk.sort_lines()


# ---------------------------------------------------------------------------
# Scattered-line clustering
#
# Lines no YOLO block claimed become single-line blocks; compatible
# neighbours are chained onto them greedily in reading-offset order.
# ---------------------------------------------------------------------------


def try_merge_textline(blk: TextBlock, blk2: TextBlock, fntsize_tol=1.3, distance_tol=2) -> bool:
    """Absorb ``blk2``'s line into ``blk`` if the two agree geometrically
    (reference :344-373).  Touching last-lines merge unconditionally;
    otherwise font size, axis alignment, and both offset gaps must all be
    within tolerance.  Returns True and marks ``blk2`` merged on success."""
    if blk2.merged:
        return False
    size_ratio = blk.font_size / blk2.font_size
    n1, n2 = len(blk), len(blk2)
    mean_font_size = (blk.font_size * n1 + blk2.font_size * n2) / (n1 + n2)
    joint_axis = blk.vec + blk2.vec
    axis_cos = (blk.vec @ blk2.vec) / blk.norm / blk2.norm
    offset_gap = blk2.distance[-1] - blk.distance[-1]
    anchor_gap = np.linalg.norm(np.array(blk2.lines[-1][0]) - np.array(blk.lines[-1][0]))

    tails_touch = geo.convex_polygons_intersect(
        np.asarray(blk.lines[-1], np.float64), np.asarray(blk2.lines[-1], np.float64)
    )
    if not tails_touch:
        compatible = (
            max(size_ratio, 1 / size_ratio) <= fntsize_tol
            and abs(axis_cos) >= 0.866  # axes within 30 degrees
            and offset_gap <= distance_tol * mean_font_size
            and anchor_gap <= mean_font_size * 2.5
        )
        if not compatible:
            return False

    blk.lines.append(blk2.lines[0])
    blk.vec = joint_axis
    blk.angle = _axis_angle_deg(joint_axis, rounded=True) - (90 if blk.vertical else 0)
    blk.norm = np.linalg.norm(joint_axis)
    blk.distance = np.append(blk.distance, blk2.distance[-1])
    blk.font_size = mean_font_size
    blk2.merged = True
    return True


def merge_textlines(blk_list: List[TextBlock]) -> List[TextBlock]:
    """Greedy forward chaining of single-line blocks, scanned in reading-
    offset order (reference :375-388)."""
    if len(blk_list) < 2:
        return blk_list
    blk_list.sort(key=lambda blk: blk.distance[0])
    chains: List[TextBlock] = []
    for ii, head in enumerate(blk_list):
        if head.merged:
            continue
        for cand in blk_list[ii + 1:]:
            try_merge_textline(head, cand)
        chains.append(head)
    for chain in chains:
        chain.adjust_bbox(with_bbox=False)
    return chains


# ---------------------------------------------------------------------------
# Block splitting
# ---------------------------------------------------------------------------


def split_textblk(blk: TextBlock):
    """Split a block wherever consecutive lines leave a reading-offset gap
    over two font sizes (reference :390-419).

    Quirk preserved from the reference: lines are re-sorted by proximity to
    the first line's anchor point, while ``blk.distance`` keeps its
    offset-sorted order — the gap test indexes the latter.
    """
    font_size, offsets, lines = blk.font_size, blk.distance, blk.lines
    anchor = np.array(blk.lines[0])
    lines.sort(key=lambda line: np.linalg.norm(np.array(line[0]) - anchor[0]))
    max_gap = font_size * 2

    head = copy.deepcopy(blk)
    head.lines = [anchor]
    pieces = [head]
    for jj, line in enumerate(lines[1:]):
        prev_quad = np.asarray(lines[jj], np.float64)
        cur_quad = np.asarray(line, np.float64)
        cut = False
        if not geo.convex_polygons_intersect(prev_quad, cur_quad):
            gap = abs(offsets[jj + 1] - offsets[jj])
            if gap > max_gap:
                cut = True
            elif blk.vertical and abs(blk.angle) < 15:
                # upright vertical text: also cut on a big top-edge y jump
                if len(head.lines) > 1 or gap > font_size:
                    cut = abs(lines[jj][0][1] - line[0][1]) > font_size
        if cut:
            head = copy.deepcopy(head)
            head.lines = [line]
            pieces.append(head)
        else:
            head.lines.append(line)

    did_split = len(pieces) > 1
    if did_split:
        for piece in pieces:
            piece.adjust_bbox(with_bbox=False)
    return did_split, pieces


# ---------------------------------------------------------------------------
# Reading order
# ---------------------------------------------------------------------------


def reading_order_weights(boxes_xyxy: np.ndarray, im_w: int, im_h: int,
                          rtl: bool) -> np.ndarray:
    """Scalar sort key per box: page cells of a 4x3 grid rank first, position
    inside the cell tie-breaks.  ``rtl`` mirrors x for right-to-left reading;
    landscape pages are treated as two-page spreads (right page read first
    when rtl) by halving the grid width (reference :267-300)."""
    n_rows, n_cols = 4, 3
    grid_w = im_w / 2 if im_w > im_h else im_w
    cell_area = im_h * grid_w
    cx = (boxes_xyxy[:, 0] + boxes_xyxy[:, 2]) / 2
    cy = (boxes_xyxy[:, 1] + boxes_xyxy[:, 3]) / 2
    if rtl:
        cx = im_w - cx
    col = (cx / grid_w * n_cols).astype(np.int32)
    row = (cy / im_h * n_rows).astype(np.int32)
    weights = (
        (row * n_cols + col) * cell_area
        + 1.2 * (cx - col * grid_w / n_cols)
        + (cy - row * im_h / n_rows)
    )
    if grid_w != im_w:
        # boxes on the second page of a spread sort after the whole first page
        weights[col >= n_cols] += cell_area * n_rows * n_cols
    return weights


def sort_textblk_list(blk_list: List[TextBlock], im_w: int, im_h: int) -> List[TextBlock]:
    if len(blk_list) == 0:
        return blk_list
    ja_majority = sum(blk.language == "ja" for blk in blk_list) > len(blk_list) / 2
    boxes = np.array([blk.xyxy for blk in blk_list])
    weights = reading_order_weights(boxes, im_w, im_h, rtl=ja_majority)
    for blk, weight in zip(blk_list, weights):
        blk.weight = weight
    blk_list.sort(key=lambda blk: blk.weight)
    return blk_list


# ---------------------------------------------------------------------------
# Grouping routine
# ---------------------------------------------------------------------------


def _assign_lines_to_blocks(lines: Sequence[np.ndarray],
                            blk_list: List[TextBlock]) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized line->block assignment.

    Each line goes to the block whose bbox covers the largest fraction of the
    line's AABB area (first block wins ties, matching the reference's strict-
    greater scan at :431-441).  Returns (claimed_fraction, block_index) per
    line; index is meaningless where the fraction never beat the initial -1.
    """
    line_boxes = np.array(
        [[l[:, 0].min(), l[:, 1].min(), l[:, 0].max(), l[:, 1].max()] for l in lines],
        np.float64,
    ).reshape(-1, 4)
    if not blk_list or not len(lines):
        return np.full(len(lines), -1.0), np.full(len(lines), -1, np.int64)
    blk_boxes = np.array([blk.xyxy for blk in blk_list], np.float64)
    areas = (line_boxes[:, 2] - line_boxes[:, 0]) * (line_boxes[:, 3] - line_boxes[:, 1])
    with np.errstate(invalid="ignore", divide="ignore"):
        overlap = _boxes_intersection_matrix(line_boxes, blk_boxes) / areas[:, None]
    # NaN (0-area line with 0 intersection) never beats the -1 sentinel in the
    # reference's scan; map it below everything so argmax skips it too.
    overlap = np.where(np.isnan(overlap), -np.inf, overlap)
    best = overlap.max(axis=1)
    best = np.where(np.isinf(best) & (best < 0), -1.0, best)
    return best, overlap.argmax(axis=1)


def _mask_density(mask: Optional[np.ndarray], box) -> float:
    x1, y1, x2, y2 = (int(v) for v in box)
    if x2 <= x1 or y2 <= y1:
        # the reference's empty-crop mean is NaN, whose `< thresh` veto test
        # is False — i.e. degenerate boxes are never vetoed; keep that
        return float("nan")
    return float(mask[y1:y2, x1:x2].mean()) / 255


def group_output(blks, lines, im_w: int, im_h: int, mask=None,
                 sort_blklist: bool = True) -> List[TextBlock]:
    """Fuse the three detector outputs into the final block list
    (reference :421-508).

    ``blks`` is the (boxes, classes, confs) triple from YOLO post-processing;
    ``lines`` the DB quads; ``mask`` the raw segmentation used to veto
    detections with no text pixels under them.  Phases: claim lines for
    blocks, analyze/split each block, cluster the unclaimed strays, sort the
    page in reading order, and finally pad slightly-tight eng line quads.
    """
    blk_list = [TextBlock(bbox, language=LANG_LIST[cls]) for bbox, cls, _ in zip(*blks)]
    strays: Dict[bool, List[TextBlock]] = {True: [], False: []}  # keyed by vertical

    # Phase 1: each line joins its best-overlapping block, or becomes a
    # single-line stray if overlap is weak and the mask shows text under it.
    claimed, owner = _assign_lines_to_blocks(lines, blk_list)
    for line, frac, idx in zip(lines, claimed, owner):
        if frac > _MIN_BOX_OVERLAP:
            blk_list[idx].lines.append(line)
            continue
        x1, y1 = line[:, 0].min(), line[:, 1].min()
        x2, y2 = line[:, 0].max(), line[:, 1].max()
        if mask is not None and _mask_density(mask, (x1, y1, x2, y2)) < _MIN_MASK_DENSITY:
            continue
        stray = TextBlock([x1, y1, x2, y2], [line])
        examine_textblk(stray, im_w, im_h, sort=False)
        strays[stray.vertical].append(stray)

    # Phase 2: analyze every block; ja/vertical multi-line blocks may split
    # on offset gaps, the rest just refit their bbox around their lines.
    final_blk_list: List[TextBlock] = []
    for blk in blk_list:
        if len(blk.lines) == 0:
            # lineless block: veto against the mask, then use its own bbox
            # as a single synthetic line
            if mask is not None and _mask_density(mask, blk.xyxy) < _MIN_MASK_DENSITY:
                continue
            blk.lines = xywh2xyxypoly(np.array([blk.xywh()])).reshape(-1, 4, 2).tolist()
        examine_textblk(blk, im_w, im_h, sort=True)

        splittable = len(blk.lines) > 1 and (blk.language == "ja" or blk.vertical)
        did_split, pieces = split_textblk(blk) if splittable else (False, [blk])
        if not did_split:
            for piece in pieces:
                piece.adjust_bbox(with_bbox=True)
        final_blk_list += pieces

    # Phase 3: cluster strays (horizontal first, as the reference does) and
    # sort everything in reading order.
    final_blk_list += merge_textlines(strays[False])
    final_blk_list += merge_textlines(strays[True])
    if sort_blklist:
        final_blk_list = sort_textblk_list(final_blk_list, im_w, im_h)

    # Phase 4: DB quads hug eng glyphs too tightly — grow them ~10% of the
    # font size along the block angle.
    for blk in final_blk_list:
        if blk.language != "eng" or blk.vertical or len(blk.lines) == 0:
            continue
        grow = max(int(blk.font_size * 0.1), 2)
        rad = np.deg2rad(blk.angle)
        corner_dirs = np.array([[[-1, -1], [1, -1], [1, 1], [-1, 1]]])
        shift = corner_dirs * np.array([[[np.sin(rad), np.cos(rad)]]]) * grow
        grown = blk.lines_array() + shift
        grown[..., 0] = np.clip(grown[..., 0], 0, im_w - 1)
        grown[..., 1] = np.clip(grown[..., 1], 0, im_h - 1)
        blk.lines = grown.astype(np.int64).tolist()
        blk.font_size += grow

    return final_blk_list



