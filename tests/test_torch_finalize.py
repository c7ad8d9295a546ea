"""Port's K6 (mask finalize and binarize) vs the JAX package's Pallas
kernels, run in interpret mode as ``tests/test_pallas_kernels.py`` runs
them.  Both outputs are uint8 with one right answer, so nothing is
tolerated: bit-equal on edge values (0, 1, every k/255 and its float32
neighbours; the threshold and its neighbours) and on seeded random maps.

The wrappers read page-strided stacks in place (``x[:, 0]`` of a (B, 2,
H, W) stack, as the batch stream's DB decode passes the DB head's shrink
maps): those views are held against the JAX kernels too, the batch stream
is shown to hand K6 the net's own memory, and a NumPy model of the CUDA
kernel's decomposition (16 elements a thread in four warp-coalesced
float4s, the page from the grid, head and tail in the same launch) is held
bit-equal to the plain version on odd plane sizes, page strides and
offsets.

On the CPU the wrappers run their plain PyTorch versions; the test marked
``cuda`` holds the CUDA kernels against those plain versions and runs only
where a card is present.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from comic_text_detector_tpu.ops import pallas_kernels as pk
from comic_text_detector_tpu_torch.ops import db_decode
from comic_text_detector_tpu_torch.ops import finalize as K6

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")


def _edges() -> np.ndarray:
    k = np.arange(256, dtype=np.float32) / np.float32(255)
    vals = np.concatenate([k, np.nextafter(k, np.float32(2)), np.nextafter(k, np.float32(-1)),
                           np.float32([0.0, 1.0])])
    return np.clip(vals, 0, 1).astype(np.float32)


def _around(t: float) -> np.ndarray:
    t = np.float32(t)
    return np.float32([t, np.nextafter(t, np.float32(1)), np.nextafter(t, np.float32(0)), 0.0, 1.0])


def _maps(seed: int):
    rng = np.random.default_rng(seed)
    return [_edges().reshape(1, -1), rng.random((2, 37, 101), dtype=np.float32),
            rng.random((1, 64, 128), dtype=np.float32)]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_mask_to_u8_plain_matches_jax_kernel(case):
    x = _maps(0)[case]
    ref = np.asarray(pk.mask_to_u8(jnp.asarray(x)))
    got = K6.mask_to_u8(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_binarize_plain_matches_jax_kernel(thresh):
    x = np.concatenate([np.resize(_around(thresh), 1003), _maps(1)[1].reshape(-1)]).reshape(1, -1)
    ref = np.asarray(pk.binarize(jnp.asarray(x), thresh))
    got = K6.binarize(torch.from_numpy(x), thresh).numpy()
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 1}
    np.testing.assert_array_equal(got, ref)


def test_wrappers_validate_and_do_not_count_on_cpu():
    before = (K6.mask_to_u8.launches, K6.binarize.launches)
    x = torch.rand(3, 5)
    K6.mask_to_u8(x)
    K6.binarize(x, 0.3)
    assert (K6.mask_to_u8.launches, K6.binarize.launches) == before
    with pytest.raises(ValueError, match="float32"):
        K6.mask_to_u8(x.double())
    with pytest.raises(ValueError, match="float32"):
        K6.binarize(x.to(torch.bfloat16), 0.3)


def _lines(b: int, h: int, w: int, seed: int) -> torch.Tensor:
    """A seeded (B, 2, H, W) float32 stack, the DB head's output layout,
    with edge values and the threshold's neighbours in its first channel."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, 2, h, w), dtype=np.float32)
    edge = np.concatenate([_edges(), np.resize(_around(0.3), 64)])
    flat = x[:, 0].reshape(b, -1)
    n = min(edge.size, flat.shape[1])
    flat[:, :n] = edge[:n]
    x[:, 0] = flat.reshape(b, h, w)
    return torch.from_numpy(x)


@pytest.mark.parametrize("shape", [(1, 37, 101), (5, 17, 61), (2, 64, 64)])
def test_page_strided_views_match_jax_kernels(shape):
    lines = _lines(*shape, seed=sum(shape))
    view = lines[:, 0]
    assert shape[0] == 1 or not view.is_contiguous()
    ref_u8 = np.asarray(pk.mask_to_u8(jnp.asarray(view.numpy())))
    ref_bin = np.asarray(pk.binarize(jnp.asarray(view.numpy()), 0.3))
    got_u8, got_bin = K6.mask_to_u8(view), K6.binarize(view, 0.3)
    assert got_u8.shape == view.shape and got_bin.shape == view.shape
    np.testing.assert_array_equal(got_u8.numpy(), ref_u8)
    np.testing.assert_array_equal(got_bin.numpy(), ref_bin)


def test_plane_layout_reads_lines_view_in_place():
    lines = _lines(4, 24, 40, seed=5)
    view, pages, plane, page_stride = K6.plane_layout(lines[:, 0])
    assert (pages, plane, page_stride) == (4, 24 * 40, 2 * 24 * 40)
    assert view.data_ptr() == lines.data_ptr()
    assert view.untyped_storage().data_ptr() == lines.untyped_storage().data_ptr()
    # the second channel: the same storage, one plane on
    view1, *layout1 = K6.plane_layout(lines[:, 1])
    assert view1.data_ptr() == lines.data_ptr() + 24 * 40 * 4 and layout1 == [4, 24 * 40, 2 * 24 * 40]
    # contiguous stacks, a plane, a vector and a scalar are read as they are
    for t, layout in ((lines, (8, 960, 960)), (lines[2, 1], (1, 960, 960)), (lines[0, 0, 3], (1, 40, 40)),
                      (lines[0, 0, 0, 0], (1, 1, 1))):
        got, *rest = K6.plane_layout(t)
        assert got.data_ptr() == t.data_ptr() and tuple(rest) == layout
    # whole rows of each plane are a plane too
    got, *rest = K6.plane_layout(lines[:, 0, 1:-1])
    assert got.data_ptr() == lines.data_ptr() + 40 * 4 and rest == [4, 22 * 40, 2 * 24 * 40]
    # planes that are not contiguous are copied: a column slice, a column
    # step, a transposed plane, pages that do not step at one stride
    for t in (lines[:, 0, :, 1:-1], lines[:, 0, :, ::2], lines[:, 0].transpose(1, 2),
              lines.expand(2, 4, 2, 24, 40)[:, :, 0]):
        got, pages, plane, page_stride = K6.plane_layout(t)
        assert got.is_contiguous() and got.data_ptr() != t.data_ptr() and page_stride == plane
        assert pages * plane == t.numel() and torch.equal(got, t)


def test_db_decode_batch_binarizes_the_nets_memory(monkeypatch):
    """The batch stream's DB decode hands K6 and the component sums views of
    the DB head's own output: no copy of the shrink maps anywhere."""
    from comic_text_detector_tpu_torch.pipeline import BatchTextDetector
    from comic_text_detector_tpu_torch.weights import load_npz

    seen = {"binarize": [], "sums": []}
    real_binarize, real_sums = db_decode.binarize, db_decode.component_sums

    def spy_binarize(x, thresh):
        seen["binarize"].append((x, K6.plane_layout(x)[0].data_ptr()))
        return real_binarize(x, thresh)

    def spy_sums(values, labels, capacity):
        seen["sums"].append(values.data_ptr())
        return real_sums(values, labels, capacity)

    monkeypatch.setattr(db_decode, "binarize", spy_binarize)
    monkeypatch.setattr(db_decode, "component_sums", spy_sums)
    det = BatchTextDetector(load_npz(WEIGHTS), batch_size=2, input_size=128, half=False, device="cpu")
    rng = np.random.default_rng(9)
    pages = [rng.integers(0, 256, (150, 110, 3), dtype=np.uint8) for _ in range(2)]
    det.collect(det.submit(pages))
    (x, read_ptr), = seen["binarize"]
    s = 128 * 128
    assert tuple(x.shape) == (2, 128, 128) and x.stride() == (2 * s, 128, 1)
    # a view of the (2, 2, 128, 128) DB head output, read where it lies
    assert x.untyped_storage().nbytes() == 2 * x.numel() * 4 and read_ptr == x.data_ptr()
    assert seen["sums"] == [x.data_ptr(), x.data_ptr() + 2 * s * 4]


def _k6_model(buf: np.ndarray, base: int, pages: int, plane: int, page_stride: int, op, out_off: int = 0):
    """NumPy model of ``csrc/finalize.cu``: ``buf`` is device memory whose
    element 0 sits at a 16-byte aligned address, the input starts at
    element ``base`` and the output at byte ``out_off`` of an aligned
    buffer.  A plane's 16-element chunks start at its first 16-byte aligned
    output byte; warp w of the plane takes chunks 32 w .. 32 w + 31, and
    lane i's k-th float4 is the i-th of their k-th 512 bytes, skipped past
    the last whole chunk; the plane's first block also does the head and
    the tail, one element a thread.  Asserts that every vector load is
    16-byte aligned, every 4-byte store 4-byte aligned and every output byte
    written once; returns the output."""
    if pages == 1 or page_stride == plane:
        plane, pages, page_stride = plane * pages, 1, plane * pages
    threads, per = 256, 16
    blocks = max(1, -(-(plane // per) // threads))
    out = np.zeros(out_off + pages * plane, np.uint8)
    writes = np.zeros(out.shape, np.int32)
    warp, lane, k = np.meshgrid(np.arange(blocks * threads // 32), np.arange(32), np.arange(4), indexing="ij")
    for page in range(pages):
        src, dst = base + page * page_stride, out_off + page * plane
        head = min((16 - dst % 16) % 16, plane)
        chunks = (plane - head) // per
        vector = (4 * (src + head)) % 16 == 0
        ok = 32 * warp + 8 * k + lane // 4 < chunks
        e = (head + 32 * per * warp + 4 * lane + 128 * k)[ok]
        if vector:
            assert np.all((4 * (src + e)) % 16 == 0)
        assert np.all((dst + e) % 4 == 0)
        idx = e[:, None] + np.arange(4)[None, :]
        out[dst + idx] = op(buf[src + idx])
        writes[dst + idx] += 1
        t = np.arange(per)
        h, tail = t[t < head], head + per * chunks + t
        tail = tail[tail < plane]
        for part in (h, tail):
            out[dst + part] = op(buf[src + part])
            writes[dst + part] += 1
    assert np.all(writes[out_off:] == 1) and np.all(writes[:out_off] == 0)
    return out[out_off:].reshape(pages, plane)


@pytest.mark.parametrize("plane", [1, 15, 16, 17, 35, 4095, 4096, 4097, 8191])
@pytest.mark.parametrize("pages,gap,base", [(1, 0, 0), (5, 0, 0), (5, 1, 0), (3, 3, 1), (4, 7, 2), (2, 13, 3)])
def test_k6_decomposition_model_matches_plain(plane, pages, gap, base):
    """Planes of odd sizes, page strides that keep or break 16-byte
    alignment (plane + gap), unaligned bases and out offsets: the model of
    the kernel gives the plain version's bits."""
    rng = np.random.default_rng(plane * 31 + pages * 7 + gap)
    page_stride = plane + gap
    buf = rng.random(base + pages * page_stride + 16, dtype=np.float32)
    buf[base:base + min(_edges().size, buf.size - base)] = _edges()[: buf.size - base]
    view = torch.from_numpy(buf).as_strided((pages, plane), (page_stride, 1), base)
    ops = {
        "mask_to_u8": (lambda v: (v * np.float32(255)).astype(np.uint8), K6.mask_to_u8_plain),
        "binarize": (lambda v: (v > np.float32(0.3)).astype(np.uint8), lambda x: K6.binarize_plain(x, 0.3)),
    }
    for name, (op, plain) in ops.items():
        ref = plain(view).numpy()
        for out_off in (0, 3):
            got = _k6_model(buf, base, pages, plane, page_stride, op, out_off)
            np.testing.assert_array_equal(got.reshape(ref.shape), ref, err_msg=f"{name}, out offset {out_off}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k6_matches_plain_versions_on_card(cuda_device):
    before = (K6.mask_to_u8.launches, K6.binarize.launches)
    for x_np in _maps(2) + [np.random.default_rng(3).random((4, 1024, 1024), dtype=np.float32)]:
        x = torch.from_numpy(np.ascontiguousarray(x_np)).to(cuda_device)
        for xin in (x, x.reshape(-1)[1:]):  # the second is not 16-byte aligned
            assert torch.equal(K6.mask_to_u8(xin), K6.mask_to_u8_plain(xin))
            assert torch.equal(K6.binarize(xin, 0.3), K6.binarize_plain(xin, 0.3))
    t = torch.from_numpy(np.resize(_around(0.3), 1001)).to(cuda_device)
    assert torch.equal(K6.binarize(t, 0.3), K6.binarize_plain(t, 0.3))
    # page-strided views read in place: strides that keep and break 16-byte
    # alignment, an unaligned base
    for b, h, w in ((4, 64, 64), (5, 17, 61), (1, 1, 4097)):
        lines = _lines(b, h, w, seed=b + h + w).to(cuda_device)
        unaligned = lines.reshape(-1)[1:1 + 2 * b * h * (w - 1)].view(b, 2, h, w - 1)[:, 0]
        for xin in (lines[:, 0], lines[:, 1], unaligned):
            assert torch.equal(K6.mask_to_u8(xin), K6.mask_to_u8_plain(xin))
            assert torch.equal(K6.binarize(xin, 0.3), K6.binarize_plain(xin, 0.3))
    assert K6.mask_to_u8.launches == before[0] + 17 and K6.binarize.launches == before[1] + 18
