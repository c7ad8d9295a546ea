"""The port's whole slice vs the JAX TextDetector on rendered pages.

Both run the default configuration (host refine, grey mask, float32) with
the flagship_r2 weights at input size 256.  Tolerances:

* ``blk_list``: the same count; each block's xyxy within 1 px, the same
  language, orientation and line quads;
* ``mask``: bit-equal to the JAX package's device un-letterbox
  (``_upsample_mask``, cv2-exact) and within 1 grey level of the JAX
  TextDetector's own grey mask, which it resizes on the host with PIL;
* ``mask_refined``: IoU >= 0.99 with the JAX result.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comic_text_detector_tpu.pipeline.detector import TextDetector as JaxTextDetector
from comic_text_detector_tpu.pipeline.detector import _upsample_mask
from comic_text_detector_tpu.training.checkpoint import load_compact
from comic_text_detector_tpu_torch.ops.resize import letterbox_shape
from comic_text_detector_tpu_torch.pipeline import TextDetector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
SIZE = 256


def _pages():
    """Three rendered pages of one shape (one compile of the JAX graph):
    grey, colour, and a text-dense colour page."""
    from comic_text_detector_tpu.data.render import ComicTextRenderer

    out = []
    for seed, grey, blocks in ((1, True, (3, 6)), (2, False, (3, 6)), (3, False, (6, 9))):
        rng = np.random.default_rng(seed)
        bg = rng.integers(215, 250, (384, 320, 3)).astype(np.uint8)
        img = ComicTextRenderer(seed=seed, blocks_per_page=blocks).render_page(bg)["img"]
        if grey:
            img = np.repeat(img[..., :1], 3, axis=2)
        out.append(np.ascontiguousarray(img))
    return out


@pytest.fixture(scope="module")
def detectors():
    variables = load_compact(WEIGHTS)
    jax_det = JaxTextDetector(variables=variables, input_size=SIZE)
    port = TextDetector(WEIGHTS, input_size=SIZE, device="cpu")
    return jax_det, port


@pytest.mark.parametrize("page", [0, 1, 2])
def test_slice_matches_jax_text_detector(detectors, page):
    jax_det, port = detectors
    img = _pages()[page]
    jmask, jrefined, jblks = jax_det(img.copy())
    mask, refined, blks = port(img.copy())

    assert len(blks) == len(jblks) > 0
    for a, b in zip(blks, jblks):
        assert np.abs(np.asarray(a.xyxy) - np.asarray(b.xyxy)).max() <= 1
        assert (a.language, bool(a.vertical)) == (b.language, bool(b.vertical))
        np.testing.assert_array_equal(np.asarray(a.lines), np.asarray(b.lines))

    # the JAX device un-letterbox of the JAX net's own grey mask
    h, w = img.shape[:2]
    _, _, dw, dh, _ = letterbox_shape(h, w, SIZE)
    lb = jax_det._lb(h, w)(jnp.asarray(img))
    mask_full = jax_det._infer(h, w)(jax_det.variables, lb)[6]
    up = np.asarray(jax.device_get(_upsample_mask(mask_full, SIZE - dh, SIZE - dw, (h, w))))
    np.testing.assert_array_equal(mask, up)
    assert np.abs(mask.astype(np.int16) - jmask).max() <= 1

    a, b = refined > 0, jrefined > 0
    iou = np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)
    assert iou >= 0.99, f"mask_refined IoU {iou:.4f}"


def test_keep_undetected_mask_runs(detectors):
    _, port = detectors
    img = _pages()[1]
    mask, refined, _ = port(img, keep_undetected_mask=True)
    assert refined.shape == mask.shape == img.shape[:2] and refined.dtype == np.uint8


@pytest.mark.parametrize(
    "kwargs",
    [dict(half=True), dict(refine_backend="device"), dict(mask_transfer="packed"),
     dict(model_path="model.onnx", variables=None), dict(model_path="model.stablehlo", variables=None)],
)
def test_later_slices_raise_not_implemented(kwargs):
    args = dict(model_path=None, variables={}, device="cpu")
    args.update(kwargs)
    with pytest.raises(NotImplementedError):
        TextDetector(**args)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TextDetector(WEIGHTS, input_size=SIZE)
