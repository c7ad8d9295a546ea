"""Both pipelines at input sizes above 1024, where the DB decode labels its
map through ``connected_components`` (the label route) instead of the
rank-ids kernels, whose windows stop at 1024x1024.

* ``TextDetector(input_size=1088)`` (1.18M-element maps, the smallest such
  size the net takes) with the host refine, against the JAX package's:
  blocks, line quads and the refined mask bit-equal, the grey mask within
  1 level on fewer than 100 pixels (the nets' float32 maps differ by up to
  1e-4, ``tests/test_torch_net.py``).
* The letterbox to 1536 and the packed upsample of a 1536 mask back to a
  2150x1500 scan, against the JAX package's, bit-equal.
* The device refine with packed masks at 1088, single page and batch
  stream: the batch of pages gives each page's single-page outputs bit for
  bit (float32, on the CPU).

The JAX TextDetector at 1088 takes about 14 s on one CPU worker (compile
included), the port's pipelines about 2-6 s each.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from comic_text_detector_tpu.ops import resize as jrs
from comic_text_detector_tpu.pipeline import TextDetector as JaxTextDetector
from comic_text_detector_tpu.pipeline.detector import _upsample_mask_packed
from comic_text_detector_tpu.training.checkpoint import load_compact
from comic_text_detector_tpu_torch.ops import resize as trs
from comic_text_detector_tpu_torch.ops.bits import packbits_rows
from comic_text_detector_tpu_torch.pipeline import BatchTextDetector, TextDetector
from comic_text_detector_tpu_torch.weights import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
SIZE = 1088


def _page(h: int, w: int, seed: int) -> np.ndarray:
    from comic_text_detector_tpu.data.render import ComicTextRenderer

    rng = np.random.default_rng(seed)
    bg = rng.integers(215, 250, (h, w, 3)).astype(np.uint8)
    return np.ascontiguousarray(ComicTextRenderer(seed=seed, blocks_per_page=(3, 6)).render_page(bg)["img"])


@pytest.fixture(scope="module")
def pages():
    return [_page(1400, 1000, 1), _page(1000, 1400, 2)]


def _same_results(a, b) -> None:
    (m1, r1, b1), (m2, r2, b2) = a, b
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(r1, r2)
    assert len(b1) == len(b2) > 0
    for x, y in zip(b1, b2):
        assert list(x.xyxy) == list(y.xyxy) and x.language == y.language
        np.testing.assert_array_equal(np.asarray(x.lines), np.asarray(y.lines))


def test_text_detector_above_1024_matches_jax(pages):
    jax_det = JaxTextDetector(variables=load_compact(WEIGHTS), input_size=SIZE)
    port = TextDetector(WEIGHTS, input_size=SIZE, device="cpu")
    jmask, jrefined, jblks = jax_det(pages[0].copy())
    mask, refined, blks = port(pages[0].copy())
    assert sum(len(b.lines) for b in blks) > 0
    # the two nets' float32 maps differ by up to 1e-4, which moves a few
    # grey-mask pixels across a truncation step
    diff = np.abs(mask.astype(np.int16) - jmask)
    assert diff.max() <= 1 and np.count_nonzero(diff) < 100
    np.testing.assert_array_equal(refined, jrefined)
    assert len(blks) == len(jblks) > 0
    for a, b in zip(blks, jblks):
        assert list(a.xyxy) == list(b.xyxy) and a.language == b.language
        np.testing.assert_array_equal(np.asarray(a.lines), np.asarray(b.lines))


@pytest.mark.parametrize("hw", [(2150, 1500), (1500, 2150)])
def test_letterbox_and_packed_upsample_at_1536_match_jax(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    assert trs.letterbox_shape(*hw, 1536) == jrs.letterbox_shape(*hw, 1536)
    np.testing.assert_array_equal(trs.letterbox_device_u8(torch.from_numpy(img), 1536).numpy(),
                                  np.asarray(jrs.letterbox_device_u8(jnp.asarray(img), 1536)))
    _, _, dw, dh, _ = trs.letterbox_shape(*hw, 1536)
    mask = np.random.default_rng(1).integers(0, 256, (1536, 1536), dtype=np.uint8)
    jup, jbits = _upsample_mask_packed(jnp.asarray(mask), 1536 - dh, 1536 - dw, hw)
    up = trs.resize_cv2exact_u8(torch.from_numpy(mask)[: 1536 - dh, : 1536 - dw], hw)
    np.testing.assert_array_equal(up.numpy(), np.asarray(jup))
    np.testing.assert_array_equal(packbits_rows(up > 30).numpy(), np.asarray(jbits))


def test_device_refine_batch_above_1024_matches_single_page(pages):
    kw = dict(input_size=SIZE, refine_backend="device", mask_transfer="packed")
    single = TextDetector(WEIGHTS, device="cpu", **kw)
    batch = BatchTextDetector(load_npz(WEIGHTS), batch_size=2, half=False, device="cpu", **kw)
    streamed = list(batch.stream(iter(pages)))
    assert len(streamed) == 2
    for page, out in zip(pages, streamed):
        assert out[0].shape == out[1].shape == page.shape[:2]
        _same_results(out, single(page))
