"""Port's K5 (3x3 erode, dilate and cross erode, replicate border) vs the
JAX package's Pallas kernels, run in interpret mode as
``tests/test_pallas_kernels.py`` runs them, and vs ``scipy.ndimage`` with
``mode="nearest"``.  Minima and maxima have one right answer in uint8 and
in float32, so nothing is tolerated.

On the CPU the wrappers run their plain PyTorch versions; the test marked
``cuda`` holds the CUDA kernel against those plain versions and runs only
where a card is present.
"""

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
