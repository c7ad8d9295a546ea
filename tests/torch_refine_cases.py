"""Cases that hold the device refine's card route (``csrc/refine.cu`` through
``ops/refine.py::_refine_pages_cuda``) byte for byte against its plain
route, run on CPU copies of the same inputs.

Imports no JAX, so that the card's machine runs it too
(``scripts/refine_card_check.py``); ``tests/test_torch_refine.py`` runs
the same cases where a card is present.  Pages are seeded NumPy: strokes
of dark "glyphs" on light bubbles, their predicted mask, and a field of
2x2 dots (4096 components in a 256 x 256 window) for the cap case.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from comic_text_detector_tpu_torch.ops import refine as R

PAGE_HW = (1100, 1300)
DOTS = (760, 1000)  # top-left of page 1's dot field, 300 x 300

# each BUCKETS entry with more windows than its old slot count, the
# resample fallback, both refine modes, two pages, the cap, none, the r4 caps,
# a call in several chains
CASES = ("bucket0", "bucket1", "bucket2", "bucket3", "bucket4", "bucket5", "resampled", "annotation", "cap",
         "empty", "r4_caps", "chained")
CHAIN_WINDOWS = {"chained": 3}  # windows a chain, where a case lowers it


def synthetic_pages(seed: int, n: int = 2, hw=PAGE_HW):
    """(n, H, W, 3) uint8 BGR pages and (n, H, W) uint8 predicted masks."""
    rng = np.random.default_rng(seed)
    h, w = hw
    imgs = rng.integers(200, 250, (n, h, w, 3)).astype(np.uint8)
    masks = rng.integers(0, 40, (n, h, w)).astype(np.uint8)
    for p in range(n):
        for _ in range(25):  # bubbles of another paper tone
            y, x = rng.integers(0, h - 200), rng.integers(0, w - 200)
            imgs[p, y:y + rng.integers(60, 200), x:x + rng.integers(60, 200)] = rng.integers(150, 256, 3)
        for _ in range(600):  # glyph strokes, dark or coloured, most of them in the mask
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 32)
            sh, sw = rng.integers(2, 7), rng.integers(3, 31)
            if rng.random() < 0.5:
                sh, sw = sw, sh
            imgs[p, y:y + sh, x:x + sw] = rng.integers(0, 120, 3)
            if rng.random() < 0.85:
                masks[p, y:y + sh, x:x + sw] = rng.integers(150, 256)
    y, x = DOTS
    field = imgs[1, y:y + 300, x:x + 300]
    field[...] = 235
    field[::4, ::4] = field[1::4, ::4] = field[::4, 1::4] = field[1::4, 1::4] = 20
    masks[1, y:y + 300, x:x + 300] = np.where(field[..., 0] < 100, 220, 10)
    return imgs, masks


def _boxes_in_bucket(rng, bi: int, k: int, hw=PAGE_HW) -> np.ndarray:
    """k boxes that _bucket_index sends to bucket bi (-1: beyond every
    bucket), the first one against the page's bottom-right corner."""
    h, w = hw
    out = []
    while len(out) < k:
        bw, bh = (int(rng.integers(1, 1000)), int(rng.integers(1, 1000))) if bi < 0 else (
            int(rng.integers(1, R.BUCKETS[bi][1] + 1)), int(rng.integers(1, R.BUCKETS[bi][0] + 1)))
        if bw > w or bh > h or R._bucket_index(bw, bh) != bi:
            continue
        x1 = w - bw if not out else int(rng.integers(0, w - bw + 1))
        y1 = h - bh if not out else int(rng.integers(0, h - bh + 1))
        out.append([x1, y1, x1 + bw, y1 + bh])
    return np.asarray(out, np.int32)


def case(name: str):
    """(imgs, masks, boxes, page ids, refine mode, caps or None) of a case."""
    imgs, masks = synthetic_pages(7)
    rng = np.random.default_rng(sum(map(ord, name)))
    mode, caps = 0, None
    if name.startswith("bucket"):
        bi = int(name[len("bucket"):])
        boxes = _boxes_in_bucket(rng, bi, R.BUCKETS[bi][2] + 2)
    elif name == "resampled":
        boxes = np.concatenate([_boxes_in_bucket(rng, -1, 3), _boxes_in_bucket(rng, 0, 2)])
    elif name in ("annotation", "r4_caps", "chained"):
        boxes = np.concatenate([_boxes_in_bucket(rng, bi, 2) for bi in (-1, *range(len(R.BUCKETS)))])
        mode = 1 if name == "annotation" else 0
        caps = (2048, 8192, 8192, 8192, 8192, 8192) if name == "r4_caps" else None
    elif name == "cap":
        y, x = DOTS
        boxes = np.asarray([[x + 20, y + 20, x + 276, y + 276], [x, y, x + 300, y + 250], [100, 100, 300, 300]],
                           np.int32)
        return imgs, masks, boxes, np.asarray([1, 1, 0]), mode, caps
    elif name == "empty":
        boxes = np.zeros((0, 4), np.int32)
    else:
        raise KeyError(name)
    pids = rng.integers(0, 2, len(boxes))
    return imgs, masks, boxes, pids, mode, caps


@contextlib.contextmanager
def patched(caps, chain=None):
    """BUCKETS with other caps and a chain of ``chain`` windows at most, and a
    count of the plain dispatches (``_refine_windows`` calls) made
    meanwhile."""
    buckets, plain, windows = R.BUCKETS, R._refine_windows, R._CHAIN_WINDOWS
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    if caps is not None:
        R.BUCKETS = tuple((h, w, s, c) for (h, w, s, _), c in zip(buckets, caps))
    R._refine_windows = counted
    R._CHAIN_WINDOWS = chain or windows
    try:
        yield calls
    finally:
        R.BUCKETS, R._refine_windows, R._CHAIN_WINDOWS = buckets, plain, windows


def check(name: str, device) -> dict:
    """Refine a case on the CPU (plain route) and on ``device`` (the card
    route); the number of canvas bytes that differ, how many plain
    dispatches each route made and how many chains the card's made."""
    imgs, masks, boxes, pids, mode, caps = case(name)
    with patched(caps, CHAIN_WINDOWS.get(name)) as calls:
        ref = R.refine_pages(torch.from_numpy(imgs), torch.from_numpy(masks), boxes, pids, mode)
        plain_cpu, calls[0] = calls[0], 0
        launches = R.launch_candidates.launches
        got = R.refine_pages(torch.from_numpy(imgs).to(device), torch.from_numpy(masks).to(device), boxes, pids, mode)
        got_host = got.cpu()
        R.check_bounds(got)
        plain_card = calls[0]
    chain = CHAIN_WINDOWS.get(name, R._CHAIN_WINDOWS)
    return {"case": name, "windows": len(boxes), "chains_expected": -(-len(boxes) // chain),
            "set": int(ref.count_nonzero()),
            "diff": int((got_host != ref).sum()), "plain_dispatches_cpu": plain_cpu,
            "plain_dispatches_card": plain_card, "chains": R.launch_candidates.launches - launches}
