"""Port's connected-components kernels (K1, K2, K3) and ids route vs the JAX
package, bit for bit: against the Pallas kernels run in interpret mode, and
for K1 at the refine's bucket shapes against the refine's own CPU route,
``refine._component_ids(fg, backend="grid")`` (interpret mode is too slow
there).  Ids are integers with one right answer, so nothing is tolerated.

A NumPy model of the CUDA K2's decomposition (its tiles, the border links
between them, the in-place resolve and gather) is held bit for bit against
K2's plain version where tiles sit side by side.

On the CPU the port's wrappers run their plain PyTorch versions; the tests
marked ``cuda`` hold the CUDA kernels against those plain versions and run
only where a card is present.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from comic_text_detector_tpu.ops import refine as JR
from comic_text_detector_tpu.ops.pallas_kernels import (
    _CC_BIG,
    cc_ids_windows_local as jax_cc_ids,
    cc_windows_local as jax_cc_windows,
    min_prop_windows_local as jax_min_prop,
)
from comic_text_detector_tpu_torch.ops import cc_kernels as K


def _serpentine(s: int) -> np.ndarray:
    m = np.zeros((s, s), np.uint8)
    m[::2, :] = 1
    for r in range(0, s - 2, 2):
        m[r + 1, 0 if (r // 2) % 2 == 0 else s - 1] = 1
    return m


def _glyphs(h: int, w: int, seed: int) -> np.ndarray:
    """Text mask of a rendered page, cropped to (h, w)."""
    from comic_text_detector_tpu.data.render import ComicTextRenderer

    bg = np.full((max(h, 256) + 64, max(w, 256) + 64, 3), 235, np.uint8)
    mask = ComicTextRenderer(seed=seed).render_page(bg)["mask"]
    return (mask[:h, :w] > 127).astype(np.uint8)


def _border_windows(h: int, w: int) -> np.ndarray:
    """Masks aimed at the tile borders of the CUDA K1 and K3: vertical combs
    with their spine at the bottom and at the top, a serpentine turned on
    its side, chains linked only through NW or only through NE, and zigzags
    linked only diagonally."""
    y, x = np.mgrid[0:h, 0:w]
    comb = (x % 2 == 0).astype(np.uint8)
    comb_top = comb.copy()
    comb[-1] = 1
    comb_top[0] = 1
    serp = np.zeros((h, w), np.uint8)
    s = min(h, w)
    serp[:s, :s] = _serpentine(s).T
    return np.stack([comb, comb_top, serp, ((x - y) % 3 == 0).astype(np.uint8),
                     ((x + y) % 3 == 0).astype(np.uint8), (x % 4 == y % 2).astype(np.uint8)])


def _windows(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    serp = np.zeros((h, w), np.uint8)
    s = min(h, w)
    serp[:s, :s] = _serpentine(s)
    return np.stack([
        (rng.random((h, w)) < 0.45).astype(np.uint8),
        serp,
        _glyphs(h, w, seed),
    ])


# the device refine's window buckets, and windows per dispatch (4 x slots)
BUCKETS = [((256, 256), 32), ((256, 512), 24), ((512, 256), 24), ((256, 640), 16), ((640, 256), 16),
           ((512, 512), 12)]


def _k1_windows(h: int, w: int, seed: int) -> np.ndarray:
    """Glyph, serpentine, 45% noise, all-zero and all-one windows."""
    return np.concatenate([_windows(h, w, seed)[[2, 1, 0]], np.zeros((1, h, w), np.uint8),
                           np.ones((1, h, w), np.uint8)])


# windows of the direct JAX-kernel tests; the border shapes (rows that are
# not whole 32-pixel words, nor a power of two) also carry _border_windows
BORDER_SHAPES = [(40, 72), (37, 129)]
SMALL_SHAPES = [(64, 128), (256, 256)] + BORDER_SHAPES


def _small_windows(shape, seed: int) -> np.ndarray:
    masks = _windows(*shape, seed=seed)
    return np.concatenate([masks, _border_windows(*shape)]) if shape in BORDER_SHAPES else masks


def _seeds(masks: np.ndarray, seed: int) -> np.ndarray:
    """Seeds from -2**31 to 2**30 on 70% of foreground, with -1, 0 and 2**30
    mixed in; 2**30 elsewhere and on the rest of the foreground.  2**30 is
    the JAX kernel's "no seed": it reads the seeds under the background too
    (K3 does not) and takes no seed above 2**30, so larger seeds are held
    against the plain version on the card only (chip_smoke.py)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-(2**31), _CC_BIG + 1, masks.shape)
    special = np.array([-1, 0, _CC_BIG])[rng.integers(0, 3, masks.shape)]
    vals = np.where(rng.random(masks.shape) < 0.2, special, vals)
    keep = (masks > 0) & (rng.random(masks.shape) < 0.7)
    return np.where(keep, vals, _CC_BIG).astype(np.int32)


@pytest.mark.parametrize("shape", SMALL_SHAPES)
def test_cc_windows_plain_matches_jax_kernel(shape):
    masks = _small_windows(shape, seed=1)
    ref = np.asarray(jax_cc_windows(jnp.asarray(masks), True))
    got = K.cc_windows_local(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", SMALL_SHAPES)
def test_min_prop_plain_matches_jax_kernel(shape):
    masks = _small_windows(shape, seed=2)
    seeds = _seeds(masks, 3)
    ref = np.asarray(jax_min_prop(jnp.asarray(masks), jnp.asarray(seeds), True))
    got = K.min_prop_windows_local(torch.from_numpy(masks), torch.from_numpy(seeds)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_split_ids_matches_jax_at_512x640():
    """The tests/test_cc_pallas.py split-route case: dense noise and a large
    blob with holes at 512x640 (above the JAX fused kernel's 512x512)."""
    h, w = 512, 640
    rng = np.random.default_rng(11)
    masks = np.zeros((2, h, w), np.uint8)
    masks[0] = rng.random((h, w)) < 0.35
    masks[1, 40:480, 60:600] = 1
    masks[1][rng.random((h, w)) < 0.08] = 0
    ref = np.asarray(jax_cc_ids(jnp.asarray(masks), True))
    got = K.cc_ids_windows_local(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(64, 128), (128, 128)] + BORDER_SHAPES)
def test_k1_plain_matches_jax_fused_kernel(shape):
    masks = _k1_windows(*shape, seed=6)
    if shape in BORDER_SHAPES:
        masks = np.concatenate([masks, _border_windows(*shape)])
    ref = np.asarray(jax_cc_ids(jnp.asarray(masks), True))
    got = K.cc_ids_fused(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [b[0] for b in BUCKETS])
def test_k1_plain_matches_jax_component_ids_at_buckets(shape):
    masks = _k1_windows(*shape, seed=7)
    ref = np.asarray(JR._component_ids(jnp.asarray(masks > 0), backend="grid"))
    got = K.cc_ids_windows_local(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_ids_route_by_window_size(monkeypatch):
    """Up to 512x512 the ids come from K1, above from the split route, and
    above 1024x1024 the call raises, as in the JAX package."""
    calls = []
    monkeypatch.setattr(K, "cc_ids_fused", lambda m: calls.append("K1") or m.int())
    monkeypatch.setattr(K, "_split_ids", lambda m, *fns: calls.append("split") or m.int())
    for shape in [(1, 8, 8), (1, 512, 512), (1, 640, 256), (1, 513, 512), (1, 1024, 1024)]:
        K.cc_ids_windows_local(torch.zeros(shape, dtype=torch.uint8))
    assert calls == ["K1", "K1", "K1", "split", "split"]
    with pytest.raises(ValueError):
        K.cc_ids_windows_local(torch.zeros((1, 1025, 1024), dtype=torch.uint8))


def test_ids_chunk_count_sizes_k1_scratch():
    """K1's per-window chunk counts: ceil(H*W / IDS_CHUNK), at most 32 for
    any window K1 takes (one warp scans them), with IDS_CHUNK the chunk of
    csrc/cc.cu."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(K.__file__), "..", "csrc", "cc.cu")).read()
    assert int(re.search(r"constexpr int kChunk = (\d+);", src).group(1)) == K.IDS_CHUNK
    assert int(re.search(r"constexpr int kMaxChunks = (\d+);", src).group(1)) == 32
    assert [K.ids_chunk_count(h, w) for h, w in [(1, 1), (64, 128), (1, 8192), (1, 8193), (257, 255), (257, 256), (512, 512)]] == [
        1, 1, 1, 2, 8, 9, 32]
    assert max(K.ids_chunk_count(h, K.FUSED_IDS_MAX_ELEMS // h) for h in (1, 3, 255, 512, 4096)) <= 32


def test_k1_refuses_windows_above_512x512():
    with pytest.raises(ValueError):
        K.cc_ids_fused(torch.zeros((1, 513, 512), dtype=torch.uint8))


def test_wrappers_validate_inputs():
    with pytest.raises(ValueError):
        K.cc_windows_local(torch.zeros((4, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.cc_windows_local(torch.zeros((1, 4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.min_prop_windows_local(torch.zeros((1, 4, 4), dtype=torch.uint8),
                                 torch.zeros((1, 4, 5), dtype=torch.int32))


def test_cpu_route_does_not_count_launches():
    def counts():
        return K.cc_windows_local.launches, K.min_prop_windows_local.launches, K.cc_ids_fused.launches

    before = counts()
    K.cc_ids_windows_local(torch.ones((1, 8, 8), dtype=torch.uint8))
    K.cc_ids_windows_local(torch.ones((1, 600, 600), dtype=torch.uint8))
    assert counts() == before


# ---------------------------------------------------------------------------
# A NumPy model of the CUDA K2's decomposition (csrc/cc.cu): union-find in
# tiles of at most 8192 pixels and 1024 columns, a border phase that unites
# tile roots across tile edges, then a resolve and a gather that write each
# pixel's root in place over the parent array.
# ---------------------------------------------------------------------------

_TILE_PX, _TILE_MAX_W = 8192, 1024  # kTilePx, kTileMaxW
_BACKGROUND = -(2**31)  # kBackground: INT_MIN


def _tiling(h: int, w: int):
    """``tiling``: tile width and rows, tiles across a window, tiles a window."""
    tw = min(w, _TILE_MAX_W)
    rows = _TILE_PX // tw
    across = -(-w // tw)
    return tw, rows, across, across * -(-h // rows)


def _tile_of(k: int, t, h: int, w: int):
    """``tile_of`` for tile k of a window: first row and column, rows, width."""
    tw, rows, across, _ = t
    ty, tx = divmod(k, across)
    y0, x0 = ty * rows, tx * tw
    return y0, x0, min(rows, h - y0), min(tw, w - x0)


def _model_local(m: np.ndarray, t) -> np.ndarray:
    """The local phase on one (H, W) window: union-find over the links each
    pixel takes inside its tile (W; N unless W and NW are set; NW unless N
    or W is; NE unless N is; pixels outside the tile read as background),
    then the parent encoding: a tile root (the minimum pixel of its piece of
    a component) its own window index, any other foreground pixel ~(its tile
    root), the background INT_MIN."""
    h, w = m.shape
    tw, rows = t[0], t[1]
    y, x = np.mgrid[0:h, 0:w]
    ly, lx = y % rows, x % tw
    right_end = np.minimum((x // tw + 1) * tw, w)  # one past the tile's last column
    p = np.pad(m, 1)
    north = p[:-2, 1:-1] & (ly > 0)
    west = p[1:-1, :-2] & (lx > 0)
    nw = p[:-2, :-2] & (ly > 0) & (lx > 0)
    ne = p[:-2, 2:] & (ly > 0) & (x + 1 < right_end)
    idx = np.arange(h * w).reshape(h, w)
    src, dst = [], []
    for take, back in ((m & west, 1), (m & north & ~(west & nw), w), (m & nw & ~north & ~west, w + 1),
                       (m & ne & ~north, w - 1)):
        src.append(idx[take])
        dst.append(idx[take] - back)
    src, dst = np.concatenate(src), np.concatenate(dst)
    parent = np.arange(h * w)
    while True:  # hook-to-min rounds, each followed by full pointer jumping
        rp, rq = parent[src], parent[dst]
        hi, lo = np.maximum(rp, rq), np.minimum(rp, rq)
        if not (hi != lo).any():
            break
        np.minimum.at(parent, hi, lo)
        while not np.array_equal(parent[parent], parent):
            parent = parent[parent]
    fg = m.reshape(-1)
    return np.where(~fg, _BACKGROUND, np.where(parent == np.arange(h * w), parent, ~parent))


def _model_border(m: np.ndarray, par: list, t) -> None:
    """The border phase on one window, in place on ``par`` (a list): each
    tile's slots (its top row below the first tile row, its left column
    beside a tile to the left, its right column beside one to the right)
    take ``border_links`` under the local phase's rule with the whole mask
    in view, uniting tile roots."""
    h, w = m.shape
    mf = m.reshape(-1).tolist()

    def find(x):
        while par[x] != x:
            x = par[x]
        return x

    def tile_root(x):
        return ~par[x] if par[x] < 0 else x

    def unite(a, b):
        a, b = find(tile_root(a)), find(tile_root(b))
        if a != b:
            par[max(a, b)] = min(a, b)

    for k in range(t[3]):
        y0, x0, rows, tw = _tile_of(k, t, h, w)
        first = 1 if y0 > 0 else 0
        slots = [(y0, x0 + i) for i in range(tw if y0 > 0 else 0)]
        slots += [(y0 + first + i, x0) for i in range(rows - first if x0 > 0 else 0)]
        slots += [(y0 + 1 + i, x0 + tw - 1) for i in range(rows - 1 if x0 + tw < w else 0)]
        for yy, xx in slots:
            q = yy * w + xx
            if not mf[q]:
                continue
            west = xx > 0 and mf[q - 1]
            if west and xx == x0:
                unite(q, q - 1)
            if yy == 0:
                continue
            n_ = q - w
            above = yy == y0
            nw = xx > 0 and mf[n_ - 1]
            if mf[n_]:
                if above and not (west and nw):
                    unite(q, n_)
                continue
            if nw and not west and (above or xx == x0):
                unite(q, n_ - 1)
            if xx + 1 < w and mf[n_ + 1] and (above or xx + 1 == x0 + tw):
                unite(q, n_ + 1)


def _quad_groups(total: int, rng):
    """The pixels of four-pixel threads, the threads in groups run one after
    another in a random order: each group reads the array as the groups
    before it left it."""
    quads = rng.permutation(-(-total // 4))
    for group in np.array_split(quads, 7):
        i = (group[:, None] * 4 + np.arange(4)).reshape(-1)
        yield i[i < total]


def _model_resolve_gather(out: np.ndarray, hw: int, rng) -> None:
    """The resolve and the gather, in place on the flat (N*H*W,) parent
    array: each tile root that is not its component's root points itself at
    the root; then each foreground pixel takes its tile root's slot, the
    background 2**30."""
    for i in _quad_groups(out.size, rng):
        i = i[out[i] >= 0]  # tile roots
        base = i - i % hw
        cur = i - base
        while True:
            nxt = out[base + cur]
            if np.array_equal(nxt, cur):
                break
            cur = nxt
        out[i] = cur
    for i in _quad_groups(out.size, rng):
        v = out[i]
        linked = (v < 0) & (v != _BACKGROUND)
        tile_root_slot = out[i - i % hw + np.where(linked, ~v, 0)]
        out[i] = np.where(v == _BACKGROUND, K.CC_BIG, np.where(linked, tile_root_slot, v))


def _model_k2(masks: np.ndarray, seed: int = 0) -> np.ndarray:
    n, h, w = masks.shape
    t = _tiling(h, w)
    out = np.empty(n * h * w, np.int64)
    for i in range(n):
        m = masks[i] > 0
        par = _model_local(m, t).tolist()
        _model_border(m, par, t)
        out[i * h * w:(i + 1) * h * w] = par
    _model_resolve_gather(out, h * w, np.random.default_rng(seed))
    return out.reshape(n, h, w).astype(np.int32)


def test_model_tiling_matches_the_kernel_geometry():
    """Tiles of 8192 pixels, at most 1024 columns, side by side beyond."""
    assert _tiling(1024, 1024) == (1024, 8, 1, 128)
    assert _tiling(1536, 1536) == (1024, 8, 2, 384)
    assert _tiling(9, 2049) == (1024, 8, 3, 6)
    assert _tiling(17, 1025) == (1024, 8, 2, 6)
    assert _tiling(40, 72) == (72, 113, 1, 1)
    t = _tiling(20, 1100)
    assert [_tile_of(k, t, 20, 1100) for k in range(t[3])] == [
        (0, 0, 8, 1024), (0, 1024, 8, 76), (8, 0, 8, 1024), (8, 1024, 8, 76), (16, 0, 4, 1024), (16, 1024, 4, 76)]


K2_MODEL_SHAPES = [(2, 20, 1100), (1, 9, 2049), (3, 17, 1025), (2, 11, 1536)]


@pytest.mark.parametrize("kind", range(7))
@pytest.mark.parametrize("shape", K2_MODEL_SHAPES)
def test_k2_model_matches_plain(shape, kind):
    """The model of K2's tiles, border, resolve and gather gives
    ``cc_windows_local_plain``'s labels bit for bit, where tiles sit side by
    side (the seam at x = 1024 crossed by chains linked only through NE or
    NW) and tile rows end inside the window.  Each stack's pages differ."""
    n, h, w = shape
    kinds = list(_border_windows(h, w)) + [(np.random.default_rng(h * w).random((h, w)) < 0.45).astype(np.uint8)]
    masks = np.stack([kinds[(kind + i) % len(kinds)] for i in range(n)])
    got = _model_k2(masks, seed=kind)
    np.testing.assert_array_equal(got, K.cc_windows_local_plain(torch.from_numpy(masks)).numpy())


def test_k2_launcher_refuses_unaligned_out():
    masks = torch.zeros((1, 4, 4), dtype=torch.uint8)
    out = torch.empty(17, dtype=torch.int32)[1:].view(1, 4, 4)
    with pytest.raises(ValueError):
        K.launch_cc_window(masks, out, torch.zeros(1, dtype=torch.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128), (256, 256), (1024, 1024)])
def test_kernels_match_plain_versions_on_card(cuda_device, shape):
    masks = torch.from_numpy(_windows(*shape, seed=4)).to(cuda_device)
    seeds = torch.from_numpy(_seeds(masks.cpu().numpy(), 5)).to(cuda_device)
    assert torch.equal(K.cc_windows_local(masks), K.cc_windows_local_plain(masks))
    assert torch.equal(
        K.min_prop_windows_local(masks, seeds), K.min_prop_windows_local_plain(masks, seeds)
    )
    assert torch.equal(K.cc_ids_windows_local(masks), K.cc_ids_windows_local_plain(masks))


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", BUCKETS)
def test_k1_matches_plain_version_on_card(cuda_device, bucket):
    (h, w), n = bucket
    masks = torch.from_numpy(np.resize(_k1_windows(h, w, seed=8), (n, h, w))).to(cuda_device)
    before = K.cc_ids_fused.launches
    got = K.cc_ids_windows_local(masks)
    assert K.cc_ids_fused.launches == before + 1
    assert torch.equal(got, K.cc_ids_windows_local_plain(masks))


@pytest.mark.cuda
def test_k2_matches_plain_version_on_card_at_1536(cuda_device):
    """K2 on the 1536 batch's shape: tiles of 1024 and 512 columns side by
    side, pages that differ, each launch counted."""
    h = w = 1536
    kinds = list(_border_windows(h, w)) + [(np.random.default_rng(12).random((h, w)) < 0.45).astype(np.uint8)]
    masks = torch.from_numpy(np.stack([kinds[i] for i in (0, 3, 4, 6)])).to(cuda_device)  # comb, NW, NE, noise
    before = K.cc_windows_local.launches
    got = K.cc_windows_local(masks)
    assert K.cc_windows_local.launches == before + 1
    assert torch.equal(got, K.cc_windows_local_plain(masks))
