"""Port's K6 (mask finalize and binarize) vs the JAX package's Pallas
kernels, run in interpret mode as ``tests/test_pallas_kernels.py`` runs
them.  Both outputs are uint8 with one right answer, so nothing is
tolerated: bit-equal on edge values (0, 1, every k/255 and its float32
neighbours; the threshold and its neighbours) and on seeded random maps.

On the CPU the wrappers run their plain PyTorch versions; the test marked
``cuda`` holds the CUDA kernels against those plain versions and runs only
where a card is present.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from comic_text_detector_tpu.ops import pallas_kernels as pk
from comic_text_detector_tpu_torch.ops import finalize as K6


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
    assert K6.mask_to_u8.launches == before[0] + 8 and K6.binarize.launches == before[1] + 9
