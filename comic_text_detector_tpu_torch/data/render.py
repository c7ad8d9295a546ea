"""Synthetic comic-text renderer — the weak-supervision data factory.

Re-design of the reference's text_rendering.py (545 LoC): samplers for
fonts/sizes/strokes (FontSampler :202), multi-line text blocks with
horizontal/vertical/rotated layout (draw_textblk :55-128), collision-free
block placement (TextBlkSampler :251-297), adaptive max-contrast text color
(get_max_var_color :306), and a page compositor emitting image + mask +
YOLO labels + line polygons (ComicTextSampler :329-463) in the exact
filename contract the training datasets consume (``mask-*``, ``line-*``).

PIL-only (no trdg): text corpora come from a built-in word list or
user-supplied dictionary files; fonts default to the system TTFs.

Host-only copy of the JAX package's ``data/render.py``: Pillow is
imported inside the calls (``_pil``), so that the package imports
without it, and images go through the port's ``utils/io.py``.  It cannot
run where Pillow or the fonts are not installed; Pillow is not among the
packages the card's machine is stated to have.  For one seed it draws the JAX renderer's pages pixel for
pixel.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import random
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
from comic_text_detector_tpu_torch.utils.imgproc import rotate_polygons, xyxy2yolo
from comic_text_detector_tpu_torch.utils.io import find_all_imgs, imread, imwrite

ORIENTATION_HOR = 0
ORIENTATION_VER = 1

DEFAULT_FONT_DIRS = ["/usr/share/fonts/truetype/dejavu"]

# small built-in corpus so the renderer works with zero external assets
_BUILTIN_WORDS = (
    "the quick brown fox jumps over lazy dog what are you doing here it was "
    "a dark and stormy night suddenly everything changed nobody expected this "
    "wait stop look out behind you thanks sorry okay really why how when where "
    "hello goodbye maybe never always sometimes tomorrow yesterday today"
).split()


def _pil():
    """Pillow's ``Image``, ``ImageDraw`` and ``ImageFont``, imported on use."""
    from PIL import Image, ImageDraw, ImageFont

    return Image, ImageDraw, ImageFont


def load_word_dict(path: Optional[str] = None) -> List[str]:
    if path and osp.exists(path):
        with open(path, encoding="utf8") as f:
            words = [w.strip() for w in f if w.strip()]
        if words:
            return words
    return list(_BUILTIN_WORDS)


@dataclass
class FontSampler:
    """Random font file + pixel size + stroke width."""

    font_dirs: Sequence[str] = field(default_factory=lambda: list(DEFAULT_FONT_DIRS))
    size_range: Tuple[int, int] = (14, 48)
    stroke_prob: float = 0.4
    stroke_width_range: Tuple[int, int] = (1, 3)
    rng: random.Random = field(default_factory=lambda: random.Random(0))

    def __post_init__(self):
        self.font_paths: List[str] = []
        for d in self.font_dirs:
            self.font_paths += glob.glob(osp.join(d, "*.ttf")) + glob.glob(osp.join(d, "*.otf"))
        if not self.font_paths:
            raise FileNotFoundError(f"no fonts under {self.font_dirs}")

    def sample(self, size: Optional[int] = None) -> Tuple["ImageFont.FreeTypeFont", int]:
        _, _, ImageFont = _pil()
        path = self.rng.choice(self.font_paths)
        if size is None:
            size = self.rng.randint(*self.size_range)
        stroke = (
            self.rng.randint(*self.stroke_width_range) if self.rng.random() < self.stroke_prob else 0
        )
        return ImageFont.truetype(path, size), stroke


@dataclass
class TextLinesSampler:
    """Random text lines: word count per line, line count per block."""

    words: List[str] = field(default_factory=load_word_dict)
    num_lines_range: Tuple[int, int] = (1, 5)
    words_per_line_range: Tuple[int, int] = (1, 4)
    rng: random.Random = field(default_factory=lambda: random.Random(0))

    def sample(self) -> List[str]:
        n_lines = self.rng.randint(*self.num_lines_range)
        lines = []
        for _ in range(n_lines):
            k = self.rng.randint(*self.words_per_line_range)
            lines.append(" ".join(self.rng.choice(self.words) for _ in range(k)))
        return lines


def _text_size(draw: "ImageDraw.ImageDraw", text: str, font, stroke_width: int = 0) -> Tuple[int, int]:
    l, t, r, b = draw.textbbox((0, 0), text, font=font, stroke_width=stroke_width)
    return r - l, b - t


def draw_text_block(
    textlines: List[str],
    font: "ImageFont.FreeTypeFont",
    fill=(0, 0, 0, 255),
    stroke_width: int = 0,
    stroke_fill=(255, 255, 255, 255),
    spacing: int = 4,
    rotation: float = 0,
    orientation: int = ORIENTATION_HOR,
    align_center: bool = True,
):
    """Render a text block onto a transparent canvas.

    Returns (RGBA block image, uint8 text mask, (N,8) per-line polygons in
    block coordinates) or (None, None, None) if nothing rendered.
    """
    Image, ImageDraw, _ = _pil()
    probe = ImageDraw.Draw(Image.new("L", (1, 1)))
    if orientation == ORIENTATION_HOR:
        sizes = [_text_size(probe, ln, font, stroke_width) for ln in textlines]
        blk_w = max(s[0] for s in sizes) + 4 * stroke_width + 4
        blk_h = sum(s[1] for s in sizes) + spacing * (len(textlines) - 1) + 4 * stroke_width + 4
    else:
        char_w = max(_text_size(probe, ch, font, stroke_width)[0] for ln in textlines for ch in ln) if any(
            textlines
        ) else font.size
        blk_w = len(textlines) * (char_w + spacing) + 4 * stroke_width + 4
        blk_h = max(len(ln) for ln in textlines) * (font.size + 2) + 4 * stroke_width + 4

    img = Image.new("RGBA", (int(blk_w), int(blk_h)), (0, 0, 0, 0))
    mask = Image.new("L", img.size, 0)
    draw = ImageDraw.Draw(img)
    mdraw = ImageDraw.Draw(mask)
    polys: List[List[int]] = []

    if orientation == ORIENTATION_HOR:
        y = 2 + stroke_width
        for ln, (w, h) in zip(textlines, sizes):
            x = 2 + stroke_width + ((blk_w - w) // 2 if align_center else 0)
            probe_mask = Image.new("L", img.size, 0)
            pd = ImageDraw.Draw(probe_mask)
            pd.text((x, y), ln, font=font, fill=255, stroke_width=stroke_width, stroke_fill=255)
            bbox = probe_mask.getbbox()
            if bbox is None:
                continue
            draw.text((x, y), ln, font=font, fill=fill, stroke_width=stroke_width, stroke_fill=stroke_fill)
            mdraw.text((x, y), ln, font=font, fill=255, stroke_width=stroke_width, stroke_fill=255)
            x0, y0, x1, y1 = bbox
            polys.append([x0, y0, x1, y0, x1, y1, x0, y1])
            y += h + spacing
    else:  # vertical: columns right-to-left, chars top-down
        col_w = (blk_w - 4 - 4 * stroke_width) // max(len(textlines), 1)
        for ci, ln in enumerate(textlines):
            x = int(blk_w - (ci + 1) * col_w)
            probe_mask = Image.new("L", img.size, 0)
            pd = ImageDraw.Draw(probe_mask)
            for ri, ch in enumerate(ln.replace(" ", "")):
                pos = (x, 2 + stroke_width + ri * (font.size + 2))
                pd.text(pos, ch, font=font, fill=255, stroke_width=stroke_width, stroke_fill=255)
                draw.text(pos, ch, font=font, fill=fill, stroke_width=stroke_width, stroke_fill=stroke_fill)
                mdraw.text(pos, ch, font=font, fill=255, stroke_width=stroke_width, stroke_fill=255)
            bbox = probe_mask.getbbox()
            if bbox is None:
                continue
            x0, y0, x1, y1 = bbox
            polys.append([x0, y0, x1, y0, x1, y1, x0, y1])

    return _finalize_block(img, mask, polys, rotation)


def _finalize_block(img: "Image.Image", mask: "Image.Image", polys, rotation: float):
    """Shared tail of the block drawers: tight crop, poly shift, rotation."""
    Image, _, _ = _pil()
    bbox = mask.getbbox()
    if bbox is None or not polys:
        return None, None, None
    img, mask = img.crop(bbox), mask.crop(bbox)
    poly_arr = np.array(polys, np.float64)
    poly_arr[:, ::2] = np.clip(poly_arr[:, ::2] - bbox[0], 0, mask.width - 1)
    poly_arr[:, 1::2] = np.clip(poly_arr[:, 1::2] - bbox[1], 0, mask.height - 1)

    if rotation:
        center = (img.width / 2, img.height / 2)
        img = img.rotate(rotation, resample=Image.BILINEAR, expand=1)
        mask = mask.rotate(rotation, resample=Image.BILINEAR, expand=1)
        new_center = (img.width / 2, img.height / 2)
        poly_arr = rotate_polygons(center, poly_arr, -rotation, new_center, to_int=False)
        poly_arr[:, ::2] = np.clip(poly_arr[:, ::2], 0, img.width - 1)
        poly_arr[:, 1::2] = np.clip(poly_arr[:, 1::2], 0, img.height - 1)

    return img, mask, poly_arr.astype(np.int64)


def _draw_kana_char(draw, mdraw, x: int, y: int, s: int, rng: random.Random,
                    fill, stroke_width: int, stroke_fill) -> None:
    """One synthetic kana-like glyph inside the s-square cell at (x, y):
    2-5 strokes (axis-biased lines, shallow arcs, hooks, dots) matching the
    stroke-count/density statistics of Japanese kana.  The image has no CJK
    fonts (only DejaVu), so the 'ja' class would otherwise train purely on
    vertically-stacked latin glyphs."""
    m = max(1, int(s * 0.12))
    lw = max(1, round(s * 0.09))

    def _line(x0, y0, x1, y1):
        if stroke_width:
            draw.line([x0, y0, x1, y1], fill=stroke_fill, width=lw + 2 * stroke_width)
        draw.line([x0, y0, x1, y1], fill=fill, width=lw)
        mdraw.line([x0, y0, x1, y1], fill=255, width=lw + 2 * stroke_width)

    def _arc(box, a0, a1):
        if stroke_width:
            draw.arc(box, a0, a1, fill=stroke_fill, width=lw + 2 * stroke_width)
        draw.arc(box, a0, a1, fill=fill, width=lw)
        mdraw.arc(box, a0, a1, fill=255, width=lw + 2 * stroke_width)

    n_strokes = rng.randint(2, 5)
    for _ in range(n_strokes):
        kind = rng.random()
        if kind < 0.45:  # axis-biased line (kana strokes favor h/v/diagonal)
            ax = rng.random()
            if ax < 0.4:  # horizontal-ish
                y0 = rng.randint(y + m, y + s - m)
                _line(x + m, y0, x + s - m, y0 + rng.randint(-m, m))
            elif ax < 0.8:  # vertical-ish
                x0 = rng.randint(x + m, x + s - m)
                _line(x0, y + m, x0 + rng.randint(-m, m), y + s - m)
            else:  # diagonal sweep
                _line(x + m, y + m + rng.randint(0, m), x + s - m, y + s - m - rng.randint(0, m))
        elif kind < 0.8:  # shallow arc (curved kana stroke)
            bx0 = x + rng.randint(0, s // 3)
            by0 = y + rng.randint(0, s // 3)
            bx1 = min(x + s, bx0 + rng.randint(s // 2, s))
            by1 = min(y + s, by0 + rng.randint(s // 2, s))
            a0 = rng.randint(0, 360)
            _arc([bx0, by0, bx1, by1], a0, a0 + rng.randint(70, 290))
        else:  # dot / short tick (handakuten-like)
            cx = rng.randint(x + m, x + s - m)
            cy = rng.randint(y + m, y + s - m)
            r = max(1, lw)
            draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=fill)
            mdraw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=255)


def draw_kana_block(
    char_counts: List[int],
    char_size: int,
    rng: random.Random,
    fill=(0, 0, 0, 255),
    stroke_width: int = 0,
    stroke_fill=(255, 255, 255, 255),
    rotation: float = 0,
    orientation: int = ORIENTATION_VER,
):
    """Kana-like text block: each line is ``char_counts[i]`` synthetic
    glyphs.  Layout mirrors :func:`draw_text_block` (vertical = columns
    right-to-left with chars top-down; horizontal = rows).  Returns the same
    (RGBA image, uint8 mask, (N, 8) line polys) contract."""
    Image, ImageDraw, _ = _pil()
    s = max(8, int(char_size))
    gap = max(2, s // 6)
    n_lines = max(1, len(char_counts))
    max_chars = max(1, max(char_counts, default=1))
    if orientation == ORIENTATION_VER:
        blk_w = n_lines * (s + gap) + 4
        blk_h = max_chars * (s + gap) + 4
    else:
        blk_w = max_chars * (s + gap) + 4
        blk_h = n_lines * (s + gap) + 4

    img = Image.new("RGBA", (int(blk_w), int(blk_h)), (0, 0, 0, 0))
    mask = Image.new("L", img.size, 0)
    draw = ImageDraw.Draw(img)
    mdraw = ImageDraw.Draw(mask)
    polys: List[List[int]] = []

    for li, n_chars in enumerate(char_counts):
        probe = Image.new("L", img.size, 0)
        pd = ImageDraw.Draw(probe)
        pm = ImageDraw.Draw(probe)  # same target for glyph + mask probes
        for ci in range(max(1, n_chars)):
            if orientation == ORIENTATION_VER:
                cx = int(blk_w - (li + 1) * (s + gap))
                cy = 2 + ci * (s + gap)
            else:
                cx = 2 + ci * (s + gap)
                cy = 2 + li * (s + gap)
            # one RNG stream drives both the probe and the real draw:
            # re-seed per char so the two passes draw identical strokes
            st = rng.getstate()
            _draw_kana_char(pd, pm, cx, cy, s, rng, 255, stroke_width, 255)
            rng.setstate(st)
            _draw_kana_char(draw, mdraw, cx, cy, s, rng, fill, stroke_width, stroke_fill)
        bbox = probe.getbbox()
        if bbox is None:
            continue
        x0, y0, x1, y1 = bbox
        polys.append([x0, y0, x1, y0, x1, y1, x0, y1])

    return _finalize_block(img, mask, polys, rotation)


def max_contrast_color(bg_region: np.ndarray, rng: random.Random) -> Tuple[int, int, int]:
    """Pick the candidate color farthest (L1 in RGB) from the background
    region's mean — the reference's adaptive color rule (:306)."""
    mean = bg_region.reshape(-1, bg_region.shape[-1]).mean(0)[:3]
    candidates = [(0, 0, 0), (255, 255, 255)] + [
        tuple(rng.randint(0, 255) for _ in range(3)) for _ in range(4)
    ]
    return max(candidates, key=lambda c: float(np.abs(np.array(c) - mean[::-1]).sum()))


@dataclass
class TextBlockSampler:
    """Sample a rendered block + collision-free placement on a page."""

    fonts: FontSampler
    texts: TextLinesSampler
    vertical_prob: float = 0.3
    rotate_prob: float = 0.15
    rotate_range: Tuple[float, float] = (-30, 30)
    max_attempts: int = 25
    # language mix: 'ja' blocks render synthetic kana-like glyphs (mostly
    # vertical, like real manga), 'eng' blocks render latin fonts (mostly
    # horizontal).  ja_prob = 0 renders latin blocks only.
    ja_prob: float = 0.35
    ja_vertical_prob: float = 0.75
    eng_vertical_prob: float = 0.1
    rng: random.Random = field(default_factory=lambda: random.Random(0))

    def sample_block(self, page_bgr: np.ndarray, text_rgb: Optional[Tuple[int, int, int]] = None):
        """Returns (RGBA block, uint8 mask, (N, 8) line polys, lang_cls) with
        lang_cls in constants.LANGCLS2IDX order (eng=0, ja=1)."""
        # font size relative to the page so blocks fit arbitrary page sizes
        ph = page_bgr.shape[0]
        size = max(8, int(ph * self.rng.uniform(0.015, 0.05)))
        font, stroke = self.fonts.sample(size=size)
        lines = self.texts.sample()
        is_ja = self.rng.random() < self.ja_prob
        v_prob = self.ja_vertical_prob if is_ja else self.eng_vertical_prob
        orientation = ORIENTATION_VER if self.rng.random() < v_prob else ORIENTATION_HOR
        rotation = (
            self.rng.uniform(*self.rotate_range) if self.rng.random() < self.rotate_prob else 0
        )
        if text_rgb is None:
            # probe a random region for adaptive color
            h, w = page_bgr.shape[:2]
            rx, ry = self.rng.randint(0, max(w - 64, 1)), self.rng.randint(0, max(h - 64, 1))
            color = max_contrast_color(page_bgr[ry : ry + 64, rx : rx + 64], self.rng)
        else:
            color = text_rgb
        stroke_color = (255 - color[0], 255 - color[1], 255 - color[2])
        if is_ja:
            char_counts = [max(1, len(ln.replace(" ", ""))) for ln in lines]
            img, mask, polys = draw_kana_block(
                char_counts,
                size,
                self.rng,
                fill=(*color, 255),
                stroke_width=stroke,
                stroke_fill=(*stroke_color, 255),
                orientation=orientation,
                rotation=rotation,
            )
        else:
            img, mask, polys = draw_text_block(
                lines,
                font,
                fill=(*color, 255),
                stroke_width=stroke,
                stroke_fill=(*stroke_color, 255),
                orientation=orientation,
                rotation=rotation,
            )
        return img, mask, polys, (1 if is_ja else 0)

    def place(self, placed: List[Tuple[int, int, int, int]], bw: int, bh: int, pw: int, ph: int):
        """Rejection-sample a non-overlapping top-left position, or None."""
        if bw >= pw or bh >= ph:
            return None
        for _ in range(self.max_attempts):
            x = self.rng.randint(0, pw - bw - 1)
            y = self.rng.randint(0, ph - bh - 1)
            box = (x, y, x + bw, y + bh)
            if all(
                box[2] <= p[0] or box[0] >= p[2] or box[3] <= p[1] or box[1] >= p[3] for p in placed
            ):
                return x, y
        return None


class ComicTextRenderer:
    """Page compositor: text-free page -> (page+text, mask, labels, polys)."""

    def __init__(
        self,
        font_dirs: Optional[Sequence[str]] = None,
        word_dict: Optional[str] = None,
        blocks_per_page: Tuple[int, int] = (2, 8),
        bubble_prob: float = 0.5,
        seed: int = 0,
    ):
        rng = random.Random(seed)
        self.rng = rng
        self.fonts = FontSampler(font_dirs=list(font_dirs or DEFAULT_FONT_DIRS), rng=rng)
        self.texts = TextLinesSampler(words=load_word_dict(word_dict), rng=rng)
        self.blocks = TextBlockSampler(self.fonts, self.texts, rng=rng)
        self.blocks_per_page = blocks_per_page
        self.bubble_prob = bubble_prob

    def render_page(self, page_bgr: np.ndarray):
        """Returns dict(img BGR, mask uint8, blk_xyxy (K,4), line_polys (N,8))."""
        Image, ImageDraw, _ = _pil()
        page = Image.fromarray(page_bgr[:, :, ::-1]).convert("RGBA")
        mask = np.zeros(page_bgr.shape[:2], np.uint8)
        ph, pw = page_bgr.shape[:2]
        placed: List[Tuple[int, int, int, int]] = []
        blk_xyxy: List[List[int]] = []
        blk_classes: List[int] = []
        all_polys: List[np.ndarray] = []
        n_blocks = self.rng.randint(*self.blocks_per_page)
        draw = ImageDraw.Draw(page)
        for _ in range(n_blocks):
            # speech bubbles: the dominant real-manga text carrier — a light
            # ellipse/rounded-rect with a dark outline behind the block, with
            # text color contrasted against the bubble fill
            use_bubble = self.rng.random() < self.bubble_prob
            text_rgb = None
            if use_bubble:
                tone = self.rng.randint(235, 255)
                bubble_fill = (tone, tone, tone, 255)
                text_rgb = max_contrast_color(
                    np.full((1, 1, 3), tone, np.uint8), self.rng
                )
            blk_img, blk_mask, polys, lang_cls = self.blocks.sample_block(
                page_bgr, text_rgb=text_rgb
            )
            if blk_img is None:
                continue
            if use_bubble:
                # ellipse containment pad: (w/2a)^2 + (h/2b)^2 <= 1 with
                # a = 0.75w, b = 0.75h
                pad_x = max(6, int(blk_img.width * 0.25))
                pad_y = max(6, int(blk_img.height * 0.25))
                bw, bh = blk_img.width + 2 * pad_x, blk_img.height + 2 * pad_y
            else:
                pad_x = pad_y = 0
                bw, bh = blk_img.width, blk_img.height
            pos = self.blocks.place(placed, bw, bh, pw, ph)
            if pos is None:
                continue
            bx, by = pos
            x, y = bx + pad_x, by + pad_y
            if use_bubble:
                outline_tone = self.rng.randint(0, 50)
                shape = [bx, by, bx + bw - 1, by + bh - 1]
                width = self.rng.randint(2, 4)
                if self.rng.random() < 0.6:
                    draw.ellipse(shape, fill=bubble_fill, outline=(outline_tone,) * 3 + (255,), width=width)
                else:
                    draw.rounded_rectangle(
                        shape, radius=max(4, min(bw, bh) // 6), fill=bubble_fill,
                        outline=(outline_tone,) * 3 + (255,), width=width,
                    )
            page.alpha_composite(blk_img, (x, y))
            bm = np.asarray(blk_mask)
            mask[y : y + blk_img.height, x : x + blk_img.width] = np.maximum(
                mask[y : y + blk_img.height, x : x + blk_img.width], bm
            )
            placed.append((bx, by, bx + bw, by + bh))  # reserve the bubble extent
            blk_xyxy.append([x, y, x + blk_img.width, y + blk_img.height])  # label = text box
            blk_classes.append(lang_cls)
            p = polys.copy()
            p[:, ::2] += x
            p[:, 1::2] += y
            all_polys.append(p)
        img_out = np.asarray(page.convert("RGB"))[:, :, ::-1].copy()
        polys_out = np.concatenate(all_polys) if all_polys else np.zeros((0, 8), np.int64)
        return {
            "img": img_out,
            "mask": mask,
            "blk_xyxy": np.asarray(blk_xyxy, np.int64).reshape(-1, 4),
            "blk_classes": np.asarray(blk_classes, np.int64),
            "line_polys": polys_out,
        }


def render_comictext(
    bg_dir: str,
    save_dir: str,
    n_pages: Optional[int] = None,
    renderer: Optional[ComicTextRenderer] = None,
    seed: int = 0,
) -> int:
    """Batch loop: render synthetic pages from text-free backgrounds and
    write the full dataset contract (image, mask-*.png, line-*.txt,
    <name>.txt YOLO labels) — the reference render_comictext (:405-463)."""
    os.makedirs(save_dir, exist_ok=True)
    renderer = renderer or ComicTextRenderer(seed=seed)
    bgs = find_all_imgs(bg_dir, abs_path=True)
    if n_pages is not None:
        bgs = bgs[:n_pages]
    count = 0
    for bg_path in bgs:
        bg = imread(bg_path)
        out = renderer.render_page(bg)
        name = osp.splitext(osp.basename(bg_path))[0]
        imwrite(osp.join(save_dir, name + ".png"), out["img"])
        imwrite(osp.join(save_dir, "mask-" + name + ".png"), out["mask"])
        if len(out["line_polys"]):
            np.savetxt(osp.join(save_dir, "line-" + name + ".txt"), out["line_polys"], fmt="%d")
        h, w = out["img"].shape[:2]
        yolo = xyxy2yolo(out["blk_xyxy"], w, h)
        with open(osp.join(save_dir, name + ".txt"), "w", encoding="utf8") as f:
            if yolo is not None:
                classes = out["blk_classes"]
                f.write(
                    "\n".join(
                        f"{int(classes[i])} " + " ".join(str(v) for v in row)
                        for i, row in enumerate(yolo)
                    )
                )
        count += 1
    return count
