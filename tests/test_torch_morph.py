"""Port's K5 (3x3 erode, dilate and cross erode, replicate border) vs the
JAX package's Pallas kernels, run in interpret mode as
``tests/test_pallas_kernels.py`` runs them, and vs ``scipy.ndimage`` with
``mode="nearest"``.  Minima and maxima have one right answer in uint8 and
in float32, so nothing is tolerated.

A NumPy model of the CUDA kernel's decomposition (strips of 4 pixels a
lane, bands of rows, the neighbours shuffled in from the adjacent lanes and
loaded at a warp's ends, the clamped border) is held against the plain
version and the JAX kernel at several strip widths, lane counts and band
heights, with NaN and infinities planted at strip and band borders in
float32.  NaN is compared as NaN: the plain version's ``torch.minimum``
on the CPU writes its own NaN bits (0xffffffff), the kernel returns the
input's.

On the CPU the wrappers run their plain PyTorch versions; the test marked
``cuda`` holds the CUDA kernel against those plain versions and runs only
where a card is present.
"""

import functools

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from comic_text_detector_tpu.ops import pallas_kernels as pk
from comic_text_detector_tpu_torch.ops import morph as K5

_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)
SHAPES = [(64, 128), (1, 37), (29, 1), (37, 53), (1, 1)]
DTYPES = [np.uint8, np.float32]


def _image(shape, dtype, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return (rng.standard_normal(shape) * 100).astype(np.float32)


def _scipy(name: str, x: np.ndarray) -> np.ndarray:
    if name == "erode3x3":
        return ndimage.minimum_filter(x, size=3, mode="nearest")
    if name == "dilate3x3":
        return ndimage.maximum_filter(x, size=3, mode="nearest")
    return ndimage.minimum_filter(x, footprint=_CROSS, mode="nearest")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["erode3x3", "dilate3x3", "erode3x3_ellipse"])
def test_morph_plain_matches_jax_kernel_and_scipy(name, shape, dtype):
    x = _image(shape, dtype, seed=shape[0] * 7 + shape[1])
    got = getattr(K5, name)(torch.from_numpy(x)).numpy()
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(got, np.asarray(getattr(pk, name)(jnp.asarray(x))))
    np.testing.assert_array_equal(got, _scipy(name, x))


def _strip_model(x: np.ndarray, name: str, lanes: int, strip: int, rows: int) -> np.ndarray:
    """NumPy model of the kernel in ``csrc/morph.cu``: a warp of ``lanes``
    lanes owns a segment of ``lanes * strip`` columns, each lane a strip of
    ``strip`` adjacent pixels (the kernel has 32 lanes of 4), over a band of
    ``rows`` output rows (8), all segments and bands alike.  Each lane
    loads its strip of the band's rows and the rows above and below, row
    and column indices clamped to the image (the replicate border); the
    pixels left and right of a strip come from the neighbouring lanes, at
    the warp's ends from one extra pixel each; the horizontal 3-tap of
    every row, then the vertical 3-tap of three rows' horizontal results
    (the cross: the centre row's with the centre pixels above and below)."""
    h, w = x.shape
    seg = lanes * strip
    segs = -(-w // seg)
    pick = np.maximum if name == "dilate3x3" else np.minimum
    cols = np.minimum(np.arange(segs * seg), w - 1).reshape(segs, lanes, strip)
    x0 = np.arange(segs) * seg
    left_end, right_end = np.maximum(x0 - 1, 0), np.minimum(x0 + seg, w - 1)
    out = np.empty_like(x)
    for y0 in range(0, h, rows):
        band = x[np.clip(np.arange(y0 - 1, y0 + rows + 1), 0, h - 1)]
        c = band[:, cols]  # (rows + 2, segs, lanes, strip)
        left = np.concatenate([band[:, left_end][:, :, None], c[:, :, :-1, -1]], axis=2)  # shuffled up
        right = np.concatenate([c[:, :, 1:, 0], band[:, right_end][:, :, None]], axis=2)  # shuffled down
        hz = pick(pick(np.concatenate([left[..., None], c[..., :-1]], -1), c),
                  np.concatenate([c[..., 1:], right[..., None]], -1))
        if name == "erode3x3_ellipse":
            v = pick(pick(hz[1:-1], c[:-2]), c[2:])
        else:
            v = pick(pick(hz[:-2], hz[1:-1]), hz[2:])
        n = min(rows, h - y0)
        out[y0 : y0 + n] = v.reshape(rows, -1)[:n, :w]
    return out


def _seam_image(shape, dtype, seed: int) -> np.ndarray:
    """An image with, in float32, NaN, +inf and -inf planted at the strip
    borders (columns 3, 4 mod 4), the segment borders (127, 128 mod 128)
    and the band borders (rows 7, 8 mod 8)."""
    x = _image(shape, dtype, seed)
    if dtype == np.float32:
        rng = np.random.default_rng(seed + 1)
        h, w = shape
        for special in (np.nan, np.inf, -np.inf):
            for rows, cols in ((np.arange(7, h, 8), slice(None)), (slice(None), np.arange(3, w, 4)),
                               (slice(None), np.arange(127, w, 128)), (np.arange(8, h, 8), slice(None))):
                pick = rng.random(x[rows, cols].shape) < 0.05
                x[rows, cols] = np.where(pick, special, x[rows, cols])
    return x


@functools.cache
def _jax_morph(shape, dtype_name: str, name: str) -> np.ndarray:
    x = _seam_image(shape, np.dtype(dtype_name).type, seed=shape[0] * 31 + shape[1])
    return np.asarray(getattr(pk, name)(jnp.asarray(x)))


_STRIP_LAYOUTS = {"kernel": (32, 4, 8), "one row a band": (32, 4, 1), "3 lanes, 5 rows": (3, 4, 5),
                  "strips of 1, 8 lanes, 32 rows": (8, 1, 32)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", list(_STRIP_LAYOUTS))
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (3, 2), (3, 127), (5, 129), (37, 53), (33, 255), (17, 256)])
def test_strip_model_matches_plain_and_jax(shape, layout, dtype):
    """The kernel's decomposition (strips, bands, shuffled neighbours, the
    clamped border), modelled in NumPy, gives the plain version's and the
    JAX kernel's result for all three ops."""
    x = _seam_image(shape, dtype, seed=shape[0] * 31 + shape[1])
    for name in ("erode3x3", "dilate3x3", "erode3x3_ellipse"):
        got = _strip_model(x, name, *_STRIP_LAYOUTS[layout])
        np.testing.assert_array_equal(got, getattr(K5, name + "_plain")(torch.from_numpy(x)).numpy(), err_msg=name)
        np.testing.assert_array_equal(got, _jax_morph(shape, np.dtype(dtype).name, name), err_msg=name)


def test_morph_refuses_other_dtypes_and_ranks():
    for bad in (torch.zeros((4, 4), dtype=torch.int32), torch.zeros((4, 4), dtype=torch.float64),
                torch.zeros((2, 4, 4), dtype=torch.uint8)):
        for fn in (K5.erode3x3, K5.dilate3x3, K5.erode3x3_ellipse):
            with pytest.raises(ValueError):
                fn(bad)


def test_cpu_route_does_not_count_launches():
    before = (K5.erode3x3.launches, K5.dilate3x3.launches, K5.erode3x3_ellipse.launches)
    x = torch.zeros((8, 8), dtype=torch.uint8)
    K5.erode3x3(x), K5.dilate3x3(x), K5.erode3x3_ellipse(x)
    assert (K5.erode3x3.launches, K5.dilate3x3.launches, K5.erode3x3_ellipse.launches) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1536, 1536), (1, 4097), (4097, 1), (1037, 1531), (37, 53)])
def test_k5_matches_plain_version_on_card(cuda_device, shape, dtype):
    x = torch.from_numpy(_image(shape, dtype, seed=1)).to(cuda_device)
    for name in ("erode3x3", "dilate3x3", "erode3x3_ellipse"):
        kernel, plain = getattr(K5, name), getattr(K5, name + "_plain")
        before = kernel.launches
        got = kernel(x)
        assert kernel.launches == before + 1
        assert torch.equal(got, plain(x)), name
