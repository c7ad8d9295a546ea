"""Port's K4 sweeps and ``connected_components`` vs the JAX package, bit for
bit.

The plain row and column sweeps are held against JAX's ``cc_row_sweep`` and
``cc_col_sweep`` (Pallas, interpret mode on the CPU as
``tests/test_cc_pallas.py`` runs them), with random labels under the mask's
zeros.  ``connected_components`` on every route is held against JAX's
``connected_components(..., "xla")`` and against ``scipy.ndimage.label`` up
to renumbering.  Labels are integers with one right answer, so nothing is
tolerated.  NumPy models of the CUDA kernels' decompositions are held bit
for bit against both: the column kernel's (row chunks, their summaries,
the carries across chunk borders) at several chunk counts, and the row
kernel's (one warp a row: lane chunks, per-lane summaries, the two
warp-shuffle carry scans, the resolve) at several chunk widths and lane
counts.

On the CPU the wrappers run their plain PyTorch versions; the tests marked
``cuda`` hold the CUDA kernels against those plain versions and run only
where a card is present.
"""

import functools

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from comic_text_detector_tpu.ops import cc as jcc
from comic_text_detector_tpu.ops.pallas_kernels import cc_col_sweep as jax_col_sweep
from comic_text_detector_tpu.ops.pallas_kernels import cc_row_sweep as jax_row_sweep
from comic_text_detector_tpu_torch.ops import cc as tcc
from comic_text_detector_tpu_torch.ops import scan_kernels as S


def _serpentine(h: int, w: int) -> np.ndarray:
    m = np.zeros((h, w), np.uint8)
    m[::2, :] = 1
    for r in range(0, h - 2, 2):
        m[r + 1, 0 if (r // 2) % 2 == 0 else w - 1] = 1
    return m


def _blobs(h: int, w: int, seed: int) -> np.ndarray:
    """Text-like blobs: random small rectangles and salt noise."""
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.uint8)
    for _ in range(h * w // 500):
        y, x = rng.integers(0, max(h - 2, 1)), rng.integers(0, max(w - 2, 1))
        m[y : y + rng.integers(2, 8), x : x + rng.integers(2, 12)] = 1
    m[rng.random((h, w)) > 0.97] = 1
    return m


def _masks(h: int, w: int) -> dict:
    rng = np.random.default_rng(h * 1000 + w)
    return {
        "blobs": _blobs(h, w, seed=h + w),
        "noise 45%": (rng.random((h, w)) < 0.45).astype(np.uint8),
        "serpentine": _serpentine(h, w),
        "all-zero": np.zeros((h, w), np.uint8),
        "all-one": np.ones((h, w), np.uint8),
    }


def _random_labels(shape, seed: int) -> np.ndarray:
    """Labels of the whole int32 range, not 2**30, under set and unset pixels."""
    return np.random.default_rng(seed).integers(-(2**31), 2**31 - 1, shape, dtype=np.int64).astype(np.int32)


def _canon(labels: np.ndarray) -> np.ndarray:
    """Renumber by first appearance in raster order."""
    flat = labels.reshape(-1)
    vals, first = np.unique(flat[flat != 0], return_index=True)
    rank = np.zeros(len(vals), np.int64)
    rank[np.argsort(first)] = np.arange(1, len(vals) + 1)
    out = np.zeros(flat.shape, np.int64)
    out[flat != 0] = rank[np.searchsorted(vals, flat[flat != 0])]
    return out.reshape(labels.shape)


@pytest.mark.parametrize("shape", [(64, 128), (128, 256), (8, 128)])
@pytest.mark.parametrize("kind", ["blobs", "noise 45%", "serpentine", "all-zero", "all-one"])
def test_sweeps_plain_match_jax_kernels(shape, kind):
    m = _masks(*shape)[kind]
    lab = _random_labels(shape, seed=shape[0] + len(kind))
    lj, mj = jnp.asarray(lab), jnp.asarray(m)
    lt, mt = torch.from_numpy(lab), torch.from_numpy(m)
    np.testing.assert_array_equal(S.cc_row_sweep(lt, mt).numpy(), np.asarray(jax_row_sweep(lj, mj)))
    np.testing.assert_array_equal(S.cc_col_sweep(lt, mt).numpy(), np.asarray(jax_col_sweep(lj, mj)))


def test_sweeps_take_a_stack_page_by_page():
    """An (N, H, W) stack sweeps as its pages do one by one, at odd H and W."""
    rng = np.random.default_rng(2)
    m = (rng.random((3, 37, 53)) < 0.6).astype(np.uint8)
    lab = _random_labels(m.shape, seed=3)
    lt, mt = torch.from_numpy(lab), torch.from_numpy(m)
    for sweep in (S.cc_row_sweep, S.cc_col_sweep):
        got = sweep(lt, mt)
        for i in range(3):
            assert torch.equal(got[i], sweep(lt[i], mt[i]))
    # a set pixel takes its run's minimum; an unset one keeps its label
    row = S.cc_row_sweep(torch.tensor([[5, 3, 9, 7, 1, 8]], dtype=torch.int32),
                         torch.tensor([[1, 1, 0, 1, 1, 1]], dtype=torch.uint8))
    assert row.tolist() == [[3, 3, 9, 1, 1, 1]]


def _chunked_col_sweep_model(lab: np.ndarray, m: np.ndarray, chunks: int) -> np.ndarray:
    """NumPy model of the column kernel of ``csrc/scan.cu`` on an (N, H, W)
    stack, with ``chunks`` row chunks a column (the kernel has 32), all
    columns of a page at once.

    Pass 1 walks each chunk's mask for its summary: first / last pixel set,
    set throughout, and the minima of the runs at its top and bottom, whose
    labels are the only ones it reads.  Two segmented scans over the
    summaries carry (gate, value) pairs down and up.  Pass 2 walks each
    chunk forward from the carry above, writing every pixel, then back from
    the carry below, reading each run's last pixel and writing the rest of
    the run."""
    n, h, w = lab.shape
    c = -(-h // chunks)
    out = np.zeros_like(lab)
    for p in range(n):
        lp, mp, op = lab[p], m[p] != 0, out[p]
        span = [(min(k * c, h), min(min(k * c, h) + c, h)) for k in range(chunks)]
        first, last, full = (np.zeros((chunks, w), bool) for _ in range(3))
        top, bot = (np.zeros((chunks, w), np.int32) for _ in range(2))
        for k, (r0, r1) in enumerate(span):  # pass 1
            if r1 == r0:
                continue
            ms = mp[r0:r1]
            top_len = np.where(ms.all(0), r1 - r0, np.argmin(ms, 0))  # leading set rows
            bot_start = np.where(ms.all(0), 0, r1 - r0 - np.argmin(ms[::-1], 0))  # first row of the trailing run
            first[k], last[k], full[k] = top_len > 0, bot_start < r1 - r0, top_len == r1 - r0
            rows = np.arange(r1 - r0)[:, None]
            top[k] = np.where(rows < top_len, lp[r0:r1], np.iinfo(np.int32).max).min(0)
            bot[k] = np.where(rows >= bot_start, lp[r0:r1], np.iinfo(np.int32).max).min(0)
        down_g, up_g = np.zeros((chunks, w), bool), np.zeros((chunks, w), bool)
        down, up = np.zeros((chunks, w), np.int32), np.zeros((chunks, w), np.int32)
        g, v = np.zeros(w, bool), np.zeros(w, np.int32)
        for k in range(chunks):  # carry down: a run passes a border where both sides are set
            down_g[k], down[k] = g, v
            v = np.where(last[k], np.where(full[k] & g, np.minimum(bot[k], v), bot[k]), v)
            g = last[k].copy()
        g, v = np.zeros(w, bool), np.zeros(w, np.int32)
        for k in reversed(range(chunks)):  # carry up
            up_g[k], up[k] = g, v
            v = np.where(first[k], np.where(full[k] & g, np.minimum(top[k], v), top[k]), v)
            g = first[k].copy()
        for k, (r0, r1) in enumerate(span):  # pass 2
            if r1 == r0:
                continue
            prev, carry = first[k] & down_g[k], down[k]
            for r in range(r0, r1):
                s = mp[r]
                op[r] = np.where(s & prev, np.minimum(carry, lp[r]), lp[r])
                carry, prev = op[r].copy(), s
            # back: the bottom pixel takes the carry from below where it enters
            enter = last[k] & up_g[k]
            op[r1 - 1] = np.where(enter, np.minimum(op[r1 - 1], up[k]), op[r1 - 1])
            prev = np.zeros(w, bool)
            for r in range(r1 - 1, r0 - 1, -1):
                s = mp[r]
                carry = np.where(s & ~prev, op[r], carry)  # a run's last pixel: its minimum
                op[r] = np.where(s & prev, carry, op[r])
                prev = s
    return out


def _column_masks(shape, kind: str, chunks: int) -> np.ndarray:
    """(N, H, W) masks for the chunked column sweep.  ``"chunk borders"``
    puts, column by column, runs that fill whole chunks, runs that cross a
    border by one pixel on each side, and one-pixel runs just below and just
    above each border of ``chunks`` chunks."""
    n, h, w = shape
    rng = np.random.default_rng(h * 100 + w)
    if kind == "noise 60%":
        m = (rng.random(shape) < 0.6).astype(np.uint8)
        m[:-1, -3:, ::2] = 1  # runs across the page seams, set on both sides
        m[1:, :3, ::2] = 1
        return m
    if kind == "all-one":
        return np.ones(shape, np.uint8)
    if kind == "all-zero":
        return np.zeros(shape, np.uint8)
    if kind == "serpentine columns":
        return np.broadcast_to(_serpentine(w, h).T, shape).copy()
    c = -(-h // chunks)
    m = np.zeros(shape, np.uint8)
    borders = np.arange(c, h, c)
    for j in range(w):
        if j % 4 == 0:
            for k in range(0, -(-h // c), 2):
                m[:, k * c : (k + 1) * c, j] = 1
        for b in borders:
            if j % 4 == 1:
                m[:, b - 1 : b + 1, j] = 1
            elif j % 4 == 2:
                m[:, b, j] = 1
            elif j % 4 == 3:
                m[:, b - 1, j] = 1
    return m


_CHUNK_COUNTS = ["1", "3", "16", "32", "H", "H+5"]


@pytest.mark.parametrize("chunks", _CHUNK_COUNTS)
@pytest.mark.parametrize("kind", ["noise 60%", "all-one", "all-zero", "serpentine columns", "chunk borders"])
@pytest.mark.parametrize("shape", [(1, 1, 7), (2, 37, 53), (1, 97, 33)])
def test_chunked_column_model_matches_plain_and_jax(shape, kind, chunks):
    """The column kernel's decomposition (chunk summaries, the carries down
    and up, pass 2), modelled in NumPy at several chunk counts, is bit-equal
    to the plain column sweep and to JAX's ``cc_col_sweep`` page by page."""
    k = {"H": shape[1], "H+5": shape[1] + 5}.get(chunks) or int(chunks)
    m = _column_masks(shape, kind, k)
    lab = _random_labels(shape, seed=shape[1] + k)
    got = _chunked_col_sweep_model(lab, m, k)
    np.testing.assert_array_equal(got, S.cc_col_sweep_plain(torch.from_numpy(lab), torch.from_numpy(m)).numpy())
    for p in range(shape[0]):
        np.testing.assert_array_equal(got[p], np.asarray(jax_col_sweep(jnp.asarray(lab[p]), jnp.asarray(m[p]))))
    if kind == "all-zero":
        np.testing.assert_array_equal(got, lab)


def _shfl_up(x: np.ndarray, d: int) -> np.ndarray:
    """``__shfl_up_sync`` over the last axis (the lanes): lane i gets lane
    i - d's value, lanes below d keep their own."""
    y = x.copy()
    y[..., d:] = x[..., :-d]
    return y


def _shfl_down(x: np.ndarray, d: int) -> np.ndarray:
    y = x.copy()
    y[..., :-d] = x[..., d:]
    return y


# the row kernel's chunk widths (``launch_rows<C>`` in ``csrc/scan.cu``)
_ROW_CHUNKS = (16, 32, 48, 64, 96, 128)


def _kernel_row_chunk(w: int) -> int:
    return next(c for c in _ROW_CHUNKS if 32 * c >= w)


def _warp_row_sweep_model(lab: np.ndarray, m: np.ndarray, lanes: int, c: int) -> np.ndarray:
    """NumPy model of the row kernel of ``csrc/scan.cu`` on an (N, H, W)
    stack: one warp of ``lanes`` lanes a row (the kernel has 32), lane i
    holding the ``c`` pixels [i*c, i*c + c) in registers, all rows at once.

    A forward walk leaves each set pixel the minimum of its run inside the
    chunk up to it, and the chunk's summary: the leading run's length and
    minimum (top), the trailing run's start and minimum (bot).  Two
    Hillis-Steele scans over the lanes, written with the warp's shuffles,
    carry (gate, value) pairs rightward and leftward: a run crosses a
    border where both pixels at it are set and passes through a lane set
    throughout.  A backward walk reads each run's minimum at its last
    pixel, adds the carries to the runs at the chunk's ends, and writes it
    over the run."""
    n_pages, h, w = lab.shape
    assert w <= lanes * c
    rows = n_pages * h
    v = np.zeros((rows, lanes * c), np.int32)
    s = np.zeros((rows, lanes * c), bool)
    v[:, :w], s[:, :w] = lab.reshape(rows, w), m.reshape(rows, w) != 0
    v, s = v.reshape(rows, lanes, c), s.reshape(rows, lanes, c)
    lane = np.arange(lanes)
    n = np.clip(w - lane * c, 0, c)  # each lane's pixels
    top, bot = np.zeros((rows, lanes), np.int32), np.zeros((rows, lanes), np.int32)
    top_len, bot_start = np.zeros((rows, lanes), np.int64), np.zeros((rows, lanes), np.int64)
    lead = np.ones((rows, lanes), bool)
    for k in range(c):  # forward walk
        if k > 0:
            v[:, :, k] = np.where(s[:, :, k] & s[:, :, k - 1], np.minimum(v[:, :, k], v[:, :, k - 1]), v[:, :, k])
        on = s[:, :, k] & lead
        top, top_len = np.where(on, v[:, :, k], top), np.where(on, k + 1, top_len)
        off = ~s[:, :, k] & (k < n)
        lead, bot_start = lead & ~off, np.where(off, k + 1, bot_start)
        bot = np.where(k == n - 1, v[:, :, k], bot)
    first, last, full = top_len > 0, bot_start < n, (n > 0) & (top_len == n)
    prev_last = _shfl_up(last, 1) & (lane > 0)
    next_first = _shfl_down(first, 1) & (lane < lanes - 1)
    rg, rv = full & prev_last, bot.copy()
    lg, lv = full & next_first, top.copy()
    d = 1
    while d < lanes:  # the two carry scans
        pg, pv, qg, qv = _shfl_up(rg, d), _shfl_up(rv, d), _shfl_down(lg, d), _shfl_down(lv, d)
        up, down = lane >= d, lane + d < lanes
        rv, rg = np.where(up & rg, np.minimum(rv, pv), rv), np.where(up, rg & pg, rg)
        lv, lg = np.where(down & lg, np.minimum(lv, qv), lv), np.where(down, lg & qg, lg)
        d *= 2
    from_left, from_right = _shfl_up(rv, 1), _shfl_down(lv, 1)
    take_left, take_right = prev_last & first, next_first & last
    after, r = np.zeros((rows, lanes), bool), np.zeros((rows, lanes), np.int32)
    for k in reversed(range(c)):  # backward walk: the resolve
        sk = s[:, :, k]
        end = sk & ~after
        r = np.where(end, v[:, :, k], r)
        r = np.where(end & take_right & (k == n - 1), np.minimum(r, from_right), r)
        r = np.where(end & take_left & (k < top_len), np.minimum(r, from_left), r)
        v[:, :, k] = np.where(sk, r, v[:, :, k])
        after = sk
    return v.reshape(rows, lanes * c)[:, :w].reshape(lab.shape)


def _lane_border_masks(shape, c: int, seed: int) -> np.ndarray:
    """(N, H, W) masks aimed at the lane borders of chunks of ``c`` pixels,
    one kind a row, cycling over the rows of the stack: runs ending at each
    border, runs starting at it, runs crossing it by one pixel a side,
    single-pixel runs just before and just after it, all-one rows, every
    other chunk set throughout, 45% noise with both pixels at each border
    set, and with the pixel before each border set and the one after it
    unset, and rows set but for their two end pixels.  The last row of each
    page and the first of the next are both set throughout."""
    n, h, w = shape
    rng = np.random.default_rng(seed)
    borders = np.arange(c, w, c)
    m = np.zeros((n * h, w), np.uint8)
    for i in range(n * h):
        kind, r = i % 10, m[i]
        if kind == 0:
            for b in borders:
                r[max(b - 5, 0) : b] = 1
        elif kind == 1:
            for b in borders:
                r[b : b + 5] = 1
        elif kind == 2:
            for b in borders:
                r[b - 1 : b + 1] = 1
        elif kind == 3:
            r[borders - 1] = 1
        elif kind == 4:
            r[borders] = 1
        elif kind == 5:
            r[:] = 1
        elif kind == 6:
            for k in range(0, -(-w // c), 2):
                r[k * c : (k + 1) * c] = 1
        elif kind in (7, 8):
            r[:] = rng.random(w) < 0.45
            r[borders - 1] = 1
            r[borders] = kind == 7
        else:
            r[1 : w - 1] = 1
    m = m.reshape(shape)
    m[:, 0] = m[:, -1] = 1
    return m


@functools.cache
def _jax_row_sweep_pages(shape, kind: str, c: int):
    m = _row_masks(shape, kind, c)
    lab = _random_labels(shape, seed=shape[2] + c)
    return np.stack([np.asarray(jax_row_sweep(jnp.asarray(lab[p]), jnp.asarray(m[p]))) for p in range(shape[0])])


def _row_masks(shape, kind: str, c: int) -> np.ndarray:
    if kind == "lane borders":
        return _lane_border_masks(shape, c, seed=c)
    rng = np.random.default_rng(shape[1] * 100 + shape[2])
    if kind == "noise 60%":
        m = (rng.random(shape) < 0.6).astype(np.uint8)
        m[:, 0] = m[:, -1] = 1  # pages whose last and first rows are set throughout
        return m
    return np.full(shape, kind == "all-one", np.uint8)


_ROW_LAYOUTS = ["kernel", "32 lanes, exact", "4 lanes", "8 lanes, wide", "one pixel a lane", "one lane"]


@pytest.mark.parametrize("layout", _ROW_LAYOUTS)
@pytest.mark.parametrize("kind", ["noise 60%", "all-one", "all-zero", "lane borders"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 5, 33), (3, 4, 53), (1, 10, 129), (1, 10, 256)])
def test_warp_row_model_matches_plain_and_jax(shape, kind, layout):
    """The row kernel's decomposition (lane chunks, per-lane summaries, the
    rightward and leftward shuffle scans, the resolve), modelled in NumPy at
    several lane counts and chunk widths (the kernel's own among them), is
    bit-equal to the plain row sweep and to JAX's ``cc_row_sweep`` page by
    page, on masks aimed at the lane borders and the page seams."""
    w = shape[2]
    lanes, c = {
        "kernel": (32, _kernel_row_chunk(w)),
        "32 lanes, exact": (32, -(-w // 32)),
        "4 lanes": (4, -(-w // 4)),
        "8 lanes, wide": (8, -(-w // 8) + 3),
        "one pixel a lane": (w, 1),
        "one lane": (1, w),
    }[layout]
    m = _row_masks(shape, kind, c)
    lab = _random_labels(shape, seed=w + c)
    got = _warp_row_sweep_model(lab, m, lanes, c)
    np.testing.assert_array_equal(got, S.cc_row_sweep_plain(torch.from_numpy(lab), torch.from_numpy(m)).numpy())
    np.testing.assert_array_equal(got, _jax_row_sweep_pages(shape, kind, c))
    if kind == "all-zero":
        np.testing.assert_array_equal(got, lab)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("kind", ["blobs", "noise 45%", "serpentine", "all-zero", "all-one"])
def test_connected_components_routes_match_jax(connectivity, kind):
    m = _masks(48, 128)[kind] > 0
    ref = np.asarray(jcc.connected_components(jnp.asarray(m), connectivity, "xla"))
    structure = np.ones((3, 3)) if connectivity == 8 else None
    sp, _ = ndimage.label(m, structure=structure)
    mt = torch.from_numpy(m)
    for backend in ("xla", "pallas", "vmem", "auto"):
        if backend == "vmem" and connectivity == 4:
            with pytest.raises(ValueError):
                tcc.connected_components(mt, connectivity, backend)
            continue
        got = tcc.connected_components(mt, connectivity, backend).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref, err_msg=backend)
        np.testing.assert_array_equal(_canon(got), _canon(sp), err_msg=backend)


@pytest.mark.parametrize("device, connectivity, h, w, route", [
    ("cuda", 8, 1536, 1536, "vmem"),
    ("cuda", 8, 1024, 1024, "vmem"),
    ("cuda", 8, 2048, 2048, "vmem"),
    ("cuda", 8, 64, 5000, "vmem"),
    ("cuda", 4, 1536, 1536, "pallas"),
    ("cuda", 4, 64, S.MAX_ROW, "pallas"),
    ("cuda", 4, 64, 5000, "xla"),
    ("cpu", 8, 1536, 1536, "xla"),
    ("cpu", 4, 1536, 1536, "xla"),
    ("cpu", 4, 64, 5000, "xla"),
])
def test_auto_backend_routes(device, connectivity, h, w, route):
    """``backend="auto"``: on the card every 8-connected map takes K2, a
    4-connected one K4 where its row kernel takes the width and the plain
    route where it is wider; on the CPU the plain route."""
    assert tcc.auto_backend(device, connectivity, h, w) == route


def test_connected_components_4_connected_wide_rows_match_jax():
    """A 4-connected map wider than K4's rows (which ``auto`` sends to the
    plain route on the card) gets the JAX function's labels."""
    rng = np.random.default_rng(21)
    m = rng.random((3, 5000)) < 0.55
    m[1, ::7] = True
    ref = np.asarray(jcc.connected_components(jnp.asarray(m), 4, "xla"))
    for backend in ("auto", "xla"):
        got = tcc.connected_components(torch.from_numpy(m), 4, backend).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=backend)


def test_connected_components_stack_and_rounds():
    """A (N, H, W) stack labels each page on its own; the sweep route counts
    its rounds, two per changed test."""
    masks = np.stack([_masks(40, 72)[k] for k in ("blobs", "serpentine", "noise 45%")])
    mt = torch.from_numpy(masks)
    got = tcc.connected_components(mt, 8, "pallas")
    for i in range(3):
        ref = np.asarray(jcc.connected_components(jnp.asarray(masks[i] > 0), 8, "xla"))
        np.testing.assert_array_equal(got[i].numpy(), ref)
        np.testing.assert_array_equal(tcc.connected_components(mt[i], 8, "xla").numpy(), ref)
    rounds = tcc.connected_components.rounds
    assert rounds % 2 == 0 and rounds >= 20  # the serpentine turns 19 times


def test_connected_components_validates():
    with pytest.raises(ValueError):
        tcc.connected_components(torch.zeros((4, 4), dtype=torch.bool), 6)
    with pytest.raises(ValueError):
        tcc.connected_components(torch.zeros((4, 4), dtype=torch.bool), 8, "grid")
    with pytest.raises(ValueError):
        tcc.connected_components(torch.zeros((4, 4), dtype=torch.float32), 8)
    with pytest.raises(ValueError):
        S.cc_row_sweep(torch.zeros((4, 4), dtype=torch.int32), torch.zeros((4, 5), dtype=torch.uint8))
    with pytest.raises(ValueError):
        S.cc_col_sweep(torch.zeros((4, 4), dtype=torch.int64), torch.zeros((4, 4), dtype=torch.uint8))


def test_cpu_route_does_not_count_launches():
    before = (S.cc_row_sweep.launches, S.cc_col_sweep.launches)
    tcc.connected_components(torch.ones((16, 16), dtype=torch.bool), 8, "pallas")
    assert (S.cc_row_sweep.launches, S.cc_col_sweep.launches) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 53), (1037, 1531), (1536, 1536), (4, 1536, 1536), (1, 4097)])
def test_k4_matches_plain_version_on_card(cuda_device, shape):
    rng = np.random.default_rng(9)
    hw = shape[-2:]
    kinds = list(_masks(*hw).values())
    m = np.stack([kinds[i % len(kinds)] for i in range(int(np.prod(shape[:-2], dtype=np.int64)))]).reshape(shape)
    m[..., :1, :] = rng.random(m[..., :1, :].shape) < 0.5
    lab = torch.from_numpy(_random_labels(shape, seed=10)).to(cuda_device)
    mt = torch.from_numpy(m).to(cuda_device)
    sweeps = [(S.cc_col_sweep, S.cc_col_sweep_plain)]
    if hw[1] <= S.MAX_ROW:
        sweeps.append((S.cc_row_sweep, S.cc_row_sweep_plain))
    for kernel, plain in sweeps:
        before = kernel.launches
        got = kernel(lab, mt)
        assert kernel.launches == before + 1
        assert torch.equal(got, plain(lab, mt))


@pytest.mark.cuda
def test_k4_route_matches_k2_and_plain_on_card(cuda_device):
    masks = torch.from_numpy(np.stack([_blobs(1100, 1024, 4), _serpentine(1100, 1024)])).to(cuda_device)
    ref = tcc.connected_components(masks, 8, "xla")
    assert torch.equal(tcc.connected_components(masks, 8, "pallas"), ref)
    assert torch.equal(tcc.connected_components(masks, 8, "vmem"), ref)
    assert torch.equal(tcc.connected_components(masks, 8, "auto"), ref)
