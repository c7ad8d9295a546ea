"""IO utilities: image read/write with the reference's BGR contract
(cv2-based io_utils.py), directory walking, numpy-aware JSON encoding.

Own copy of the JAX package's ``utils/io.py``, whose reads and writes go
through Pillow.  Here PNG is read and written with the standard library's
``zlib`` and NumPy, so that the training datasets run where neither Pillow
nor cv2 is installed: 8-bit grey, grey + alpha, RGB and RGBA, not
interlaced, every row filter on read; the pixels equal Pillow's
(``convert("L")`` / ``convert("RGB")``).  Other formats, and other PNGs
(palette, 16-bit, interlaced), import Pillow inside the call and raise a
clear error where it is absent.
"""

from __future__ import annotations

import glob
import json
import os.path as osp
import struct
import zlib
from pathlib import Path
from typing import List, Optional

import numpy as np

IMG_EXT = [".bmp", ".jpg", ".png", ".jpeg", ".webp"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


class NumpyEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.integer):
            return int(obj)
        return json.JSONEncoder.default(self, obj)


def find_all_imgs(img_dir: str, abs_path: bool = False) -> List[str]:
    imglist = []
    for filep in sorted(glob.glob(osp.join(img_dir, "*"))):
        filename = osp.basename(filep)
        if Path(filename).suffix.lower() not in IMG_EXT:
            continue
        imglist.append(filep if abs_path else filename)
    return imglist


def _pillow(what: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{what} needs Pillow, which is not installed; the port reads and writes 8-bit "
                           "grey, RGB and RGBA PNGs without it") from e
    return Image


def _unfilter_sequential(ftype: int, line: bytes, prev: bytes, bpp: int) -> bytes:
    """PNG Average (3) and Paeth (4) row filters, byte by byte."""
    cur = bytearray(line)
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = prev[x]
        if ftype == 3:
            cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (cur[x] + pred) & 0xFF
    return bytes(cur)


def _png_decode(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> (H, W) or (H, W, C) uint8 samples in the file's order
    (grey, grey + alpha, RGB or RGBA); None for a PNG this reader does not
    take (palette, a depth other than 8, interlaced)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        return None
    ch = _PNG_CHANNELS[ctype]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum along the row, modulo 256, per sample
            cur = np.cumsum(line.reshape(-1, ch), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            cur = np.frombuffer(_unfilter_sequential(ftype, line.tobytes(), prev.tobytes(), ch), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter {ftype}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w) if ch == 1 else out.reshape(h, w, ch)


def _png_encode(samples: np.ndarray) -> bytes:
    """(H, W) grey or (H, W, C) grey + alpha / RGB / RGBA uint8 -> PNG
    bytes, every row with the Up filter, zlib level 6."""
    h, w = samples.shape[:2]
    ch = 1 if samples.ndim == 2 else samples.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = np.ascontiguousarray(samples, np.uint8).reshape(h, w * ch)
    filtered = np.empty((h, w * ch + 1), np.uint8)
    filtered[:, 0] = 2
    filtered[:, 1:] = rows
    filtered[1:, 1:] -= rows[:-1]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)) + chunk(b"IEND", b""))


def _grey_from_rgb(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def imread(imgpath: str, grayscale: bool = False) -> np.ndarray:
    """Read an image as BGR uint8 (H, W, 3), or (H, W) grey with
    ``grayscale`` — the pipeline's colour contract, the reference's
    cv2.imread."""
    with open(imgpath, "rb") as f:
        data = f.read()
    samples = _png_decode(data) if data[:8] == _PNG_SIGNATURE else None
    if samples is None:
        Image = _pillow(f"reading {imgpath}")
        img = Image.open(imgpath)
        if grayscale:
            return np.asarray(img.convert("L"))
        return np.asarray(img.convert("RGB"))[:, :, ::-1].copy()
    if samples.ndim == 2 or samples.shape[2] == 2:  # grey, grey + alpha
        grey = samples if samples.ndim == 2 else samples[..., 0].copy()
        return grey if grayscale else np.repeat(grey[..., None], 3, axis=2)
    rgb = samples[..., :3]
    if grayscale:
        return _grey_from_rgb(rgb)
    return rgb[:, :, ::-1].copy()


def imwrite(img_path: str, img: np.ndarray, ext: str = ".png") -> None:
    """Write a BGR (or single-channel) uint8 image; forces ``ext`` like the
    reference imwrite (io_utils.py:47-53).  Channels are written in
    reverse order, as the JAX package's ``Image.fromarray(img[:, :, ::-1])``
    writes them."""
    suffix = Path(img_path).suffix
    img_path = img_path.replace(suffix, ext) if suffix else img_path + ext
    samples = img[:, :, ::-1] if img.ndim == 3 else img
    if ext.lower() == ".png" and img.dtype == np.uint8 and (img.ndim == 2 or img.shape[2] in (3, 4)):
        with open(img_path, "wb") as f:
            f.write(_png_encode(samples))
        return
    Image = _pillow(f"writing {img_path}")
    Image.fromarray(np.ascontiguousarray(samples)).save(img_path)
