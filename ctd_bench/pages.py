"""Synthetic comic pages, the benchmark's traffic and training data.

Frozen copy of ``chip_smoke.py::synthetic_page`` (light pages with 4-7
speech bubbles of glyph-like dark strokes, the flagship detects 3-5 blocks
on each), so that later edits of that script do not move the benchmark's
inputs.  The bubbles' ellipses are computed inside their bounding boxes
(the original computes them over the whole page): the pages are the same,
in a tenth of the time.
"""

from __future__ import annotations

import numpy as np


def synthetic_page(rng, h: int, w: int, colour: bool, truth: bool = False, bubbles: int | None = None):
    """Light page with speech bubbles of glyph-like dark strokes.  With
    ``truth``, also the text mask (uint8 0/255, the strokes left on the
    page), each text line's quad (x0, y0, x1, y0, x1, y1, x0, y1 around
    its remaining strokes) and each bubble's block (cls, x0, y0, x1, y1:
    the union of its lines' quads, class 1 (ja) for vertical text and 0
    (eng) for horizontal, bubbles with no stroke left skipped): (page,
    mask, quads, blocks).  The draws from ``rng`` are the same either
    way.  ``bubbles`` fixes the number of bubbles, which is otherwise
    drawn from ``rng`` (4-7), so that every seed gives a pool the same
    amount of text."""
    yy = np.arange(h, dtype=np.float64)[:, None]
    page = np.empty((h, w, 3), np.float64)
    page[:] = (205 + 30 * (yy / h))[..., None]
    if colour:
        page = page * np.array([0.85, 0.95, 1.0]) + np.array([10.0, 0.0, -15.0])
    lines = []  # the stroke rectangles (y0, y1, x0, x1) of each text line
    owner = []  # (bubble, vertical) of each line
    for bubble in range(int(rng.integers(4, 8)) if bubbles is None else bubbles):
        cy, cx = rng.integers(h // 8, h - h // 8), rng.integers(w // 8, w - w // 8)
        ry, rx = rng.integers(h // 14, h // 6), rng.integers(w // 14, w // 6)
        # the ellipse, computed inside its bounding box only
        y0b, y1b = max(cy - ry, 0), min(cy + ry + 1, h)
        x0b, x1b = max(cx - rx, 0), min(cx + rx + 1, w)
        by, bx = np.mgrid[y0b:y1b, x0b:x1b]
        inside = ((by - cy) / ry) ** 2 + ((bx - cx) / rx) ** 2 <= 1.0
        page[y0b:y1b, x0b:x1b][inside] = 250
        cell = int(rng.integers(14, 26))
        vertical = rng.random() < 0.5
        for r in range(-ry // 2, ry // 2 - cell, cell + cell // 3):
            rects = []
            for c in range(-rx // 2, rx // 2 - cell, cell + 2):
                y0, x0 = (cy + c, cx + r) if vertical else (cy + r, cx + c)
                if not (0 <= y0 < h - cell and 0 <= x0 < w - cell):
                    continue
                for _ in range(int(rng.integers(2, 5))):
                    t = int(rng.integers(2, 4))
                    if rng.random() < 0.5:  # horizontal stroke
                        y = y0 + int(rng.integers(0, cell - t))
                        a, b = sorted(rng.integers(0, cell, 2))
                        page[y:y + t, x0 + a:x0 + b + 1] = 25
                        rects.append((y, y + t, x0 + a, x0 + b + 1))
                    else:  # vertical stroke
                        x = x0 + int(rng.integers(0, cell - t))
                        a, b = sorted(rng.integers(0, cell, 2))
                        page[y0 + a:y0 + b + 1, x:x + t] = 25
                        rects.append((y0 + a, y0 + b + 1, x, x + t))
            lines.append(rects)
            owner.append((bubble, vertical))
    page = np.clip(page, 0, 255).astype(np.uint8)
    if not colour:
        page[..., 1] = page[..., 0]
        page[..., 2] = page[..., 0]
    if not truth:
        return page
    text = (page == 25).all(axis=2)
    quads = []
    blocks = {}  # bubble -> [cls, x0, y0, x1, y1]
    for rects, (bubble, vertical) in zip(lines, owner):
        if not rects:
            continue
        own = np.zeros_like(text)
        for y0, y1, x0, x1 in rects:
            own[y0:y1, x0:x1] = True
        ys, xs = np.nonzero(own & text)  # later bubbles paint over earlier strokes
        if len(ys):
            x0, y0, x1, y1 = int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1
            quads.append([x0, y0, x1, y0, x1, y1, x0, y1])
            b = blocks.setdefault(bubble, [int(vertical), x0, y0, x1, y1])
            b[1:] = [min(b[1], x0), min(b[2], y0), max(b[3], x1), max(b[4], y1)]
    return (page, text.astype(np.uint8) * 255, np.array(quads, np.int64).reshape(-1, 8),
            np.array(list(blocks.values()), np.int64).reshape(-1, 5))
