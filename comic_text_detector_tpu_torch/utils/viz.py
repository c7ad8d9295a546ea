"""Visualisation helpers (reference utils/yolov5_utils.py Colors :83 /
draw_bbox :230 and imgproc_utils draw_connected_labels :163).

Own copy of the JAX package's ``utils/viz.py``.  ``draw_bbox`` draws with
Pillow, imported inside the call, so that the package imports without it;
it cannot run where Pillow is not installed, and Pillow is not among the
packages the card's machine is stated to have.
The other helpers are NumPy.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np

DEFAULT_LANG_LIST = ["eng", "ja"]

_HEX = (
    "FF3838", "FF9D97", "FF701F", "FFB21D", "CFD231", "48F90A", "92CC17",
    "3DDB86", "1A9334", "00D4BB", "2C99A8", "00C2FF", "344593", "6473FF",
    "0018EC", "8438FF", "520085", "CB38FF", "FF95C8", "FF37C7",
)


class Colors:
    """Deterministic class-colour palette."""

    def __init__(self):
        self.palette = [tuple(int(h[i : i + 2], 16) for i in (0, 2, 4)) for h in _HEX]
        self.n = len(self.palette)

    def __call__(self, i, bgr: bool = False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


def draw_bbox(pred: np.ndarray, img: np.ndarray, lang_list: Optional[Sequence[str]] = None) -> np.ndarray:
    """Draw labelled detection boxes (rows x1, y1, x2, y2, ..., cls) on a
    BGR image; returns a copy.  Needs Pillow."""
    from PIL import Image, ImageDraw

    lang_list = lang_list or DEFAULT_LANG_LIST
    lw = max(round(sum(img.shape) / 2 * 0.003), 2)
    colors = Colors()
    pil = Image.fromarray(img[:, :, ::-1].copy())
    draw = ImageDraw.Draw(pil)
    for ii, obj in enumerate(np.asarray(pred).astype(np.int64)):
        cls = int(obj[-1])
        color = colors(cls)
        draw.rectangle([int(obj[0]), int(obj[1]), int(obj[2]), int(obj[3])], outline=color, width=lw)
        draw.text((int(obj[0]), int(obj[1]) + 2), f"{lang_list[cls % len(lang_list)]}{ii + 1}", fill=color)
    return np.asarray(pil)[:, :, ::-1].copy()


def hex2bgr(hexvals: np.ndarray) -> np.ndarray:
    """Packed 0xRRGGBB ints -> (N, 3) BGR (reference imgproc_utils.py:5-11)."""
    h = np.asarray(hexvals)
    b = h >> 16
    g = (h & (254 << 8)) >> 8
    r = h & 254
    return np.stack([b, g, r]).transpose()


def draw_connected_labels(num_labels, labels: np.ndarray, stats, centroids, seed: int = 0) -> np.ndarray:
    """Random-colour component visualisation; returns a BGR canvas."""
    rng = random.Random(seed)
    canvas = np.zeros((labels.shape[0], labels.shape[1], 3), np.uint8)
    rng_range = range(num_labels) if isinstance(num_labels, int) else num_labels
    for lab in rng_range:
        if lab == 0:
            continue
        color = (rng.randint(0, 255), rng.randint(0, 255), rng.randint(0, 255))
        canvas[labels == lab] = color
    return canvas
