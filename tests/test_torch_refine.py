"""The port's device refine (``ops/refine.py``, ``ops/bits.py``) vs the JAX
package's, on the CPU.

Inputs are rendered pages (``data/render.py::ComicTextRenderer``) and
seeded NumPy arrays.  Every comparison is bit-equal: the refine's outputs
are uint8, bool and int32, and its float32 steps (grey conversion, bilinear
blends, sampling grids, Otsu, the histogram rebinning) are written in the
order of operations of XLA's CPU backend, fused multiply-adds included, so
they round alike.  The JAX functions run as the JAX package's own tests run
them on the CPU: connected components through the grid-stacked XLA sweeps,
component sums through the scatter-add.  Those with float32 steps are
jitted, as they run inside the JAX refine's jitted dispatch: XLA fuses
``a * b + c`` into one rounding only when it compiles the expression whole.

The card's route (``csrc/refine.cu``) is held here in two parts: its table
of windows, pure NumPy, against the plain route's geometry on the CPU; its
stages, in the tests marked ``cuda``, byte for byte against the plain route
on CPU copies of the same inputs (``tests/torch_refine_cases.py``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comic_text_detector_tpu.ops import refine as JR
from comic_text_detector_tpu_torch.ops import refine as TR
from comic_text_detector_tpu_torch.ops.bits import packbits_rows
from tests import torch_refine_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE_HW = (660, 700)

# one window per bucket, and one too large for every bucket (resampled),
# alternating between the two pages: (xyxy, page)
BUCKET_WINDOWS = [
    ([10, 10, 210, 190], 0),  # 256x256
    ([50, 300, 450, 500], 1),  # 256x512
    ([400, 30, 600, 430], 0),  # 512x256
    ([20, 420, 620, 640], 1),  # 256x640
    ([470, 20, 690, 620], 0),  # 640x256
    ([100, 100, 550, 550], 1),  # 512x512
    ([5, 200, 690, 500], 0),  # resample fallback
]


def _render(seed: int, hw=PAGE_HW):
    """A rendered page and its predicted mask (the text mask at the grey
    level the net's mask typically has)."""
    from comic_text_detector_tpu.data.render import ComicTextRenderer

    rng = np.random.default_rng(seed)
    bg = rng.integers(215, 245, (*hw, 3)).astype(np.uint8)
    out = ComicTextRenderer(seed=seed, blocks_per_page=(6, 10)).render_page(bg)
    mask = np.where(out["mask"] > 127, rng.integers(150, 255, hw), rng.integers(0, 40, hw))
    return np.ascontiguousarray(out["img"]), mask.astype(np.uint8)


@pytest.fixture(scope="module")
def pages():
    imgs, masks = zip(*(_render(s) for s in (1, 2)))
    return np.stack(imgs), np.stack(masks)


def _eq(got: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(ref))


def _windows(pages, box, page, win_hw):
    imgs, masks = pages
    b = np.asarray([box], np.int32)
    p = np.asarray([page], np.int32)
    return TR.extract_windows(torch.from_numpy(imgs), torch.from_numpy(masks), b, p, win_hw), (b, p)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 7, 8, 13, 700])
def test_packbits_rows_matches_numpy(width):
    bits = np.random.default_rng(width).random((3, 5, width)) < 0.5
    _eq(packbits_rows(torch.from_numpy(bits)), np.packbits(bits, axis=-1))


def test_bgr2gray_matches_jax():
    img = np.random.default_rng(0).integers(0, 256, (96, 128, 3)).astype(np.uint8)
    _eq(TR.bgr2gray_u8(torch.from_numpy(img)), jax.jit(JR.bgr2gray_u8)(jnp.asarray(img)))


@pytest.mark.parametrize("hw", [(256, 256), (256, 640), (512, 512)])
def test_hist_and_otsu_match_jax(hw):
    """Dense mid-grey windows: at 512x512 the float32 cumsums of
    count x level pass 2**24, where the summation order decides rounding."""
    rng = np.random.default_rng(hw[0] + hw[1])
    n = hw[0] * hw[1]
    planes = np.concatenate([
        rng.normal(128, 6, (4, n)), rng.normal(128, 30, (4, n)), rng.integers(90, 170, (4, n)),
    ]).clip(0, 255).astype(np.uint8)
    weights = (rng.random(planes.shape) < 0.9).astype(np.float32)
    weights[:2] = 1.0
    hist = TR._hist256(torch.from_numpy(planes), torch.from_numpy(weights))
    _eq(hist, JR._hist256(jnp.asarray(planes), jnp.asarray(weights)))
    _eq(TR._otsu_from_hist(hist), jax.jit(JR._otsu_from_hist)(hist.numpy()))


def test_topk_colors_matches_jax():
    """Random 255-bin counts with many ties, zero runs and bins under the
    tolerance, so every stop rule of the greedy walk is taken."""
    rng = np.random.default_rng(3)
    k = 256
    counts = np.stack([rng.integers(0, [2, 6, 40, 4000][i % 4], 255) for i in range(k)]).astype(np.float32)
    counts[::5, rng.integers(0, 255, 150)] = 0
    counts[1::7] = 0
    lo = rng.integers(0, 200, k).astype(np.float32)
    step = (rng.random(k) * 0.9 + 0.004).astype(np.float32)
    sel, n = TR._topk_colors(torch.from_numpy(counts), torch.from_numpy(lo), torch.from_numpy(step))
    jsel, jn = jax.jit(JR._topk_colors)(counts, lo, step)
    _eq(sel, jsel)
    _eq(n, jn)


@pytest.mark.parametrize("case", range(len(BUCKET_WINDOWS)))
def test_extract_windows_matches_jax(pages, case):
    box, page = BUCKET_WINDOWS[case]
    bi = TR._bucket_index(box[2] - box[0], box[3] - box[1])
    win_hw = TR.BUCKETS[bi][:2]
    imgs, masks = pages
    # the window, one past the page edge, and a degenerate one
    boxes = np.asarray([box, [600, 600, 700, 660], [30, 650, 60, 640]], np.int32)
    pids = np.asarray([page, 1, 0], np.int32)
    got = TR.extract_windows(torch.from_numpy(imgs), torch.from_numpy(masks), boxes, pids, win_hw)
    extract = jax.jit(JR.extract_windows, static_argnums=(4,))
    ref = extract(jnp.asarray(imgs), jnp.asarray(masks), jnp.asarray(boxes), jnp.asarray(pids), win_hw)
    for g, r in zip(got, ref):
        _eq(g, r)


def test_paste_windows_match_jax():
    rng = np.random.default_rng(5)
    h, w = 300, 340
    merged = ((rng.random((3, 256, 256)) < 0.3) * 255).astype(np.uint8)
    boxes = np.asarray([[10, 20, 200, 180], [40, 30, 330, 290], [0, 0, 1, 1]], np.int32)
    valid = np.asarray([True, True, False])
    pids = np.asarray([0, 1, 0])
    # the resampling paste: windows larger and smaller than the bucket
    canvas = torch.zeros((2, h, w), dtype=torch.uint8)
    TR.paste_windows(canvas, torch.from_numpy(merged), boxes, valid, pids, (h, w))
    paste = jax.jit(lambda m, b, v, p: JR.paste_windows(m, b, v, (h, w), page_ids=p, n_pages=2))
    ref = paste(jnp.asarray(merged), jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(pids))
    _eq(canvas, ref)
    # the 1:1 paste, edge boxes included (zero outside each true box)
    boxes_x = np.asarray([[10, 20, 200, 180], [200, 100, 340, 300], [0, 0, 1, 1]], np.int32)
    _, _, in_win = TR.extract_windows(torch.zeros((h, w, 3), dtype=torch.uint8),
                                      torch.zeros((h, w), dtype=torch.uint8), boxes_x, None, (256, 256))
    m = np.where(in_win.numpy(), merged, 0)
    canvas = torch.zeros((2, h + 256, w + 256), dtype=torch.uint8)
    TR.paste_windows_exact(canvas, torch.from_numpy(m), boxes_x, valid, pids)
    ref = JR.paste_windows_exact(jnp.asarray(m), jnp.asarray(boxes_x), jnp.asarray(valid), (h, w),
                                 jnp.asarray(pids), 2)
    _eq(canvas[:, :h, :w], ref)


def test_stencils_match_jax():
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, (3, 40, 56)).astype(np.uint8)
    fg = rng.random((3, 40, 56)) < 0.2
    xt, ft = torch.from_numpy(x), torch.from_numpy(fg)
    _eq(TR._erode_rect3(xt), JR._erode_rect3(jnp.asarray(x)))
    _eq(TR._dilate_rect3(xt), JR._dilate_rect3(jnp.asarray(x)))
    _eq(TR._erode_ellipse3(xt), JR._erode_ellipse3(jnp.asarray(x)))
    _eq(TR._drop_tiny_components(ft), JR._drop_tiny_components(jnp.asarray(fg)))


def test_component_sums_and_take_accept_match_jax():
    rng = np.random.default_rng(7)
    cap = 64
    ids = rng.integers(0, 100, (3, 32, 40)).astype(np.int32)  # some ids >= cap
    q = rng.integers(-1, 2, (2, 3, 32, 40)).astype(np.float32)
    sums = TR._component_sums(torch.from_numpy(ids), torch.from_numpy(q), cap=cap)
    _eq(sums, JR._component_sums(jnp.asarray(ids), jnp.asarray(q), matmul=False, cap=cap))
    accept = rng.random((3, cap)) < 0.5
    _eq(TR._take_accept(torch.from_numpy(ids), torch.from_numpy(accept)),
        JR._take_accept(jnp.asarray(ids), jnp.asarray(accept), matmul=False))


def test_cap_rule_never_accepts_ids_beyond_capacity():
    """Components whose id is >= cap are never merged, however well they
    match the prediction; those below it are."""
    fg = np.zeros((1, 16, 64), bool)
    fg[0, 4, ::3] = True  # 22 separate pixels: ids 1..22 in raster order
    fg[0, 5, ::3] = True  # each now a vertical pair
    pred = torch.ones((1, 16, 64), dtype=torch.bool)
    ids = TR._component_ids(torch.from_numpy(fg))
    assert int(ids.max()) == 22
    merged = TR._merge_labeled(torch.zeros_like(pred), torch.from_numpy(fg), ids, pred, cap=64)
    assert bool(merged.sum() == fg.sum())
    merged = TR._merge_labeled(torch.zeros_like(pred), torch.from_numpy(fg), ids, pred, cap=16)
    taken = ids[merged]
    assert taken.numel() > 0 and int(taken.max()) < 16
    assert not bool(merged[ids >= 16].any())


def test_candidates_merge_and_fill_holes_match_jax(pages):
    """Small windows (the functions take any window shape) keep the JAX
    grid CC quick; every bucket shape runs in the whole-dispatch tests."""
    (win_img, win_msk, in_win), _ = _windows(pages, [10, 10, 150, 120], 0, (128, 160))
    ji, jm, jw = (jnp.asarray(t.numpy()) for t in (win_img, win_msk, in_win))
    cands, xors = TR._candidates(win_img, win_msk, in_win)
    jc, jx = jax.jit(JR._candidates)(ji, jm, jw)
    _eq(cands, jc)
    _eq(xors, jx)

    pred = (TR._erode_ellipse3(torch.where(in_win, win_msk, 255)) > 60) & in_win
    jpred = jnp.asarray(pred.numpy())
    merged = torch.zeros_like(pred)
    jmerged = jnp.zeros(pred.shape, bool)
    for c in (3, 0):  # the Otsu candidate, then the first band
        merged = TR._merge_candidate(merged, cands[c] > 0, pred, cap=1024)
        jmerged = JR._merge_candidate(jmerged, jnp.asarray(cands[c].numpy() > 0), jpred, cap=1024)
        _eq(merged, jmerged)
    _eq(TR._fill_holes(merged, pred, in_win, cap=1024), JR._fill_holes(jmerged, jpred, jw, cap=1024))


# ---------------------------------------------------------------------------
# whole dispatches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(BUCKET_WINDOWS)))
def test_refine_pages_matches_jax_per_bucket(pages, case):
    imgs, masks = pages
    box, page = BUCKET_WINDOWS[case]
    boxes, pids = np.asarray([box], np.int32), np.asarray([page])
    got = TR.refine_pages(torch.from_numpy(imgs), torch.from_numpy(masks), boxes, pids, 0)
    ref = JR.refine_pages(jnp.asarray(imgs), jnp.asarray(masks), boxes, pids, 0)
    assert int(got.count_nonzero()) > 0
    _eq(got, ref)


def test_refine_pages_two_pages_annotation_mode(pages):
    """Windows of two pages in one dispatch, overlapping ones OR-ed, with
    the annotation refine mode (no dilation)."""
    imgs, masks = pages
    boxes = np.asarray([[10, 10, 210, 190], [120, 100, 330, 300], [300, 380, 520, 600]], np.int32)
    pids = np.asarray([0, 0, 1])
    got = TR.refine_pages(torch.from_numpy(imgs), torch.from_numpy(masks), boxes, pids, 1)
    ref = JR.refine_pages(jnp.asarray(imgs), jnp.asarray(masks), boxes, pids, 1)
    assert int(got[0].count_nonzero()) > 0 and int(got[1].count_nonzero()) > 0
    _eq(got, ref)


def test_refine_windows_resampling_matches_jax(pages):
    """The single-page wrapper resamples every window into 256x256; an
    invalid slot contributes nothing."""
    imgs, masks = pages
    boxes = np.asarray([[60, 40, 380, 260], [0, 0, 128, 128]], np.int32)
    valid = np.asarray([True, False])
    got = TR.refine_windows(torch.from_numpy(imgs[1]), torch.from_numpy(masks[1]), boxes, valid, 0)
    ref = JR.refine_windows(jnp.asarray(imgs[1]), jnp.asarray(masks[1]), jnp.asarray(boxes),
                            jnp.asarray(valid), 0)
    assert int(got.count_nonzero()) > 0
    _eq(got, ref)


def test_refine_page_without_windows_is_empty(pages):
    imgs, masks = pages
    got = TR.refine_page(torch.from_numpy(imgs[0]), torch.from_numpy(masks[0]), np.zeros((0, 4)))
    assert got.shape == masks.shape[1:] and int(got.count_nonzero()) == 0


def test_bucket_routing_matches_jax():
    for w, h in [(1, 1), (256, 256), (257, 256), (512, 256), (256, 512), (640, 256), (256, 640),
                 (512, 512), (513, 100), (641, 10), (300, 600)]:
        assert TR._bucket_index(w, h) == JR._bucket_index(w, h)
    assert TR.BUCKETS == JR.BUCKETS


def test_caps_parse_and_override():
    assert TR._parse_caps("audit", 6) == (1024, 2048, 2048, 8192, 8192, 4096)
    assert TR._parse_caps("64,128,192,256,320,384", 6) == (64, 128, 192, 256, 320, 384)
    for bad in ("", "nope", "64,64", "64,64,64,64,64,100", "0,64,64,64,64,64"):
        with pytest.raises(ValueError):
            TR._parse_caps(bad, 6)
    probe = "from comic_text_detector_tpu_torch.ops import refine as R; print([b[3] for b in R.BUCKETS])"
    env = dict(os.environ, CTD_REFINE_CAPS="r4")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True)
    assert out.stdout.strip() == "[2048, 8192, 8192, 8192, 8192, 8192]", out.stderr
    env["CTD_REFINE_CAPS"] = "1,2"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True)
    assert out.returncode != 0 and "CTD_REFINE_CAPS" in out.stderr


# ---------------------------------------------------------------------------
# the card route: its table of windows (NumPy, here) and its stages (card)
# ---------------------------------------------------------------------------


def _table_boxes(seed: int, hw=PAGE_HW):
    """Seeded windows of every bucket and beyond, some clamped at the page
    edges, some degenerate, on two pages."""
    rng = np.random.default_rng(seed)
    h, w = hw
    boxes = []
    for _ in range(24):
        bw, bh = int(rng.integers(1, 800)), int(rng.integers(1, 800))
        x1, y1 = int(rng.integers(-40, w)), int(rng.integers(-40, h))
        boxes.append([max(x1, 0), max(y1, 0), min(x1 + bw, w), min(y1 + bh, h)])
    boxes += [[0, 0, w, h], [w - 10, h - 10, w, h], [30, 650, 60, 640]]
    return np.asarray(boxes, np.int32), rng.integers(0, 2, len(boxes))


def _triples(i0, i1, frac):
    return np.stack([i0, i1, frac.astype(np.float32).view(np.int32)], axis=-1).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_table_matches_the_plain_geometry(seed):
    """Each row's box, page, bucket, in-window rectangle, sampling rows and
    columns and resampled paste equal what the plain route computes with
    _bucket_index, _in_window, _sample_coords and _paste_coords."""
    h, w = PAGE_HW
    boxes, pids = _table_boxes(seed)
    tab = TR.window_table(boxes, pids, PAGE_HW)
    c = TR._COL
    assert sorted(tab.index.tolist()) == list(range(len(boxes)))
    for row, j in zip(tab.rows, tab.index):
        box = boxes[j]
        assert row[c["x0"]:c["y1"] + 1].tolist() == box.tolist() and row[c["page"]] == pids[j]
        bi = TR._bucket_index(int(box[2] - box[0]), int(box[3] - box[1]))
        sh, sw, _, cap = TR.BUCKETS[bi]
        assert (row[c["sh"]], row[c["sw"]], row[c["cap"]], row[c["exact"]]) == (sh, sw, cap, int(bi >= 0))
        in_win = (np.arange(sh) < row[c["ny"]])[:, None] & (np.arange(sw) < row[c["nx"]])[None, :]
        np.testing.assert_array_equal(in_win, TR._in_window(box[None], (sh, sw))[0])
        x_hi, y_hi = TR._ext_hi(box[None], (sh, sw))
        for lo, hi, n_src, n, col in ((box[1:2], y_hi, h, sh, "rows"), (box[0:1], x_hi, w, sw, "cols")):
            got = tab.coords[row[c[col]]: row[c[col]] + 3 * n].reshape(n, 3)
            np.testing.assert_array_equal(got, _triples(*(a[0] for a in TR._sample_coords(lo, hi, n_src, n))))
        at = TR._paste_coords(box, x_hi[0], y_hi[0], (sh, sw), PAGE_HW)
        if bi >= 0 or at is None:
            assert row[c["ry1"]] - row[c["ry0"]] <= 0 or bi >= 0
            continue
        region, ys, xs = at
        assert tuple(row[[c["ry0"], c["ry1"], c["rx0"], c["rx1"]]]) == region
        for tri, col in ((ys, "paste_rows"), (xs, "paste_cols")):
            n = len(tri[0])
            np.testing.assert_array_equal(tab.coords[row[c[col]]: row[c[col]] + 3 * n].reshape(n, 3), _triples(*tri))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_table_lays_out_planes_groups_and_tiles(seed):
    """Windows sit at the top-left of their K1 group's plane (at most
    512 x 512 elements), planes and candidate planes tile their buffers
    without overlap, and tiles and accumulators follow in order."""
    boxes, pids = _table_boxes(seed)
    tab = TR.window_table(boxes, pids, PAGE_HW)
    c = TR._COL
    rows = tab.rows.astype(np.int64)
    plane = rows[:, c["plane_h"]] * rows[:, c["stride"]]
    assert (plane <= 512 * 512).all()
    assert (rows[:, c["plane_h"]] >= rows[:, c["sh"]]).all() and (rows[:, c["stride"]] >= rows[:, c["sw"]]).all()
    np.testing.assert_array_equal(rows[:, c["px"]], np.cumsum(plane) - plane)
    assert tab.n_px == plane.sum()
    seen = 0
    for ph, pw, k, first in tab.groups:
        members = np.flatnonzero(rows[:, c["px"]] >= first)[:k]
        assert (rows[members, c["plane_h"]] == ph).all() and (rows[members, c["stride"]] == pw).all()
        np.testing.assert_array_equal(rows[members, c["cand"]], 4 * first + np.arange(k) * ph * pw)
        assert (rows[members, c["cand_step"]] == k * ph * pw).all()
        seen += k
    assert seen == len(boxes)
    tiles = -(-rows[:, c["plane_h"]] // TR._TILE) * -(-rows[:, c["stride"]] // TR._TILE)
    np.testing.assert_array_equal(tab.tile_start, np.concatenate([[0], np.cumsum(tiles)]))
    words = TR._ACC_HEADER + 6 * rows[:, c["cap"]]
    np.testing.assert_array_equal(rows[:, c["acc"]], TR._ACC_BASE + np.cumsum(words) - words)
    assert tab.acc_words == TR._ACC_BASE + words.sum()
    np.testing.assert_array_equal(tab.resampled, np.flatnonzero(rows[:, c["exact"]] == 0))


def test_window_table_reads_the_caps_and_buckets_at_call_time(monkeypatch):
    """CTD_REFINE_CAPS is read at import; a BUCKETS patched afterwards (the
    r4 caps) reaches the table, and an empty window list gives no row."""
    r4 = (2048, 8192, 8192, 8192, 8192, 8192)
    monkeypatch.setattr(TR, "BUCKETS", tuple((h, w, s, c) for (h, w, s, _), c in zip(TR.BUCKETS, r4)))
    boxes, pids = _table_boxes(3)
    tab = TR.window_table(boxes, pids, PAGE_HW)
    for row, j in zip(tab.rows, tab.index):
        bi = TR._bucket_index(int(boxes[j, 2] - boxes[j, 0]), int(boxes[j, 3] - boxes[j, 1]))
        assert row[TR._COL["cap"]] == r4[bi]
    empty = TR.window_table(np.zeros((0, 4), np.int32), np.zeros((0,), np.int64), PAGE_HW)
    assert len(empty.index) == 0 and empty.groups == () and empty.tile_start.tolist() == [0]


def test_cpu_route_never_takes_the_card_route(pages, monkeypatch):
    """A CPU tensor runs only the plain dispatches."""
    def refuse(*args, **kw):
        raise AssertionError("the card route ran on a CPU tensor")

    monkeypatch.setattr(TR, "_refine_pages_cuda", refuse)
    imgs, masks = pages
    got = TR.refine_page(torch.from_numpy(imgs[0]), torch.from_numpy(masks[0]), np.asarray([[10, 10, 210, 190]]))
    assert int(got.count_nonzero()) > 0


def test_check_bounds_reads_the_flag_a_canvas_carries(monkeypatch):
    canvas = torch.zeros((2, 4, 4), dtype=torch.uint8)
    TR.check_bounds(canvas)  # a CPU canvas carries none
    canvas._bound_flag = torch.tensor([0], dtype=torch.int32)
    TR.check_bounds(canvas)
    canvas._bound_flag = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="bound"):
        TR.check_bounds(canvas)
    # refine_page hands its page's canvas the stack's flag
    monkeypatch.setattr(TR, "refine_pages", lambda *a, **k: canvas)
    with pytest.raises(RuntimeError, match="bound"):
        TR.check_bounds(TR.refine_page(canvas[0], canvas[0, :, :], np.zeros((0, 4))))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the refine's stages have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", torch_refine_cases.CASES)
def test_card_route_matches_plain_route(cuda_device, name):
    """Each bucket with more windows than its old slot count, the resample
    fallback, both refine modes, two pages, a window past its cap, no
    window, the r4 caps and a call in several chains: byte-equal to the
    plain route on the CPU, with no plain dispatch on the card."""
    got = torch_refine_cases.check(name, cuda_device)
    assert got["diff"] == 0, got
    assert got["plain_dispatches_card"] == 0 and got["chains"] == got["chains_expected"], got
    assert got["set"] > 0 or got["windows"] == 0, got
