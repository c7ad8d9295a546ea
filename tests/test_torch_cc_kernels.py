"""Port's connected-components route (K2, K3, split ids) vs the JAX Pallas
kernels run in interpret mode, bit for bit.

On the CPU the port's wrappers run their plain PyTorch versions; the tests
marked ``cuda`` hold the CUDA kernels against those plain versions and run
only where a card is present.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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


def _seeds(masks: np.ndarray, seed: int) -> np.ndarray:
    """Random seeds on foreground, 2**30 elsewhere and on 30% of foreground
    (the split route seeds only foreground pixels)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 20, masks.shape)
    keep = (masks > 0) & (rng.random(masks.shape) < 0.7)
    return np.where(keep, vals, _CC_BIG).astype(np.int32)


@pytest.mark.parametrize("shape", [(64, 128), (256, 256)])
def test_cc_windows_plain_matches_jax_kernel(shape):
    masks = _windows(*shape, seed=1)
    ref = np.asarray(jax_cc_windows(jnp.asarray(masks), True))
    got = K.cc_windows_local(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(64, 128), (256, 256)])
def test_min_prop_plain_matches_jax_kernel(shape):
    masks = _windows(*shape, seed=2)
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


def test_wrappers_validate_inputs():
    with pytest.raises(ValueError):
        K.cc_windows_local(torch.zeros((4, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.cc_windows_local(torch.zeros((1, 4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.min_prop_windows_local(torch.zeros((1, 4, 4), dtype=torch.uint8),
                                 torch.zeros((1, 4, 5), dtype=torch.int32))


def test_cpu_route_does_not_count_launches():
    before = (K.cc_windows_local.launches, K.min_prop_windows_local.launches)
    K.cc_ids_windows_local(torch.ones((1, 8, 8), dtype=torch.uint8))
    assert (K.cc_windows_local.launches, K.min_prop_windows_local.launches) == before


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
