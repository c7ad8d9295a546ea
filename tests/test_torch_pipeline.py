"""The port's whole slice vs the JAX TextDetector on rendered pages.

Both run with the flagship_r2 weights in float32 at input size 256, in the
default configuration (host refine, grey mask) and in the device-refine
ones (``refine_backend="device"`` with ``mask_transfer="packed"`` or
``"grey"``).  Tolerances:

* ``blk_list``: the same count; each block's xyxy within 1 px, the same
  language, orientation and line quads;
* ``mask``, grey: bit-equal to the JAX TextDetector's grey mask.  Both
  resize the letterbox-resolution mask to the page on the host with the
  same routing: Pillow's bilinear where both axes scale up (the port
  reproduces it in NumPy), cv2-exact otherwise;
* ``mask``, packed: bit-equal (both binarise the same cv2-exact upsample);
* ``mask_refined``, host refine: bit-equal, with and without
  ``keep_undetected_mask`` (the same grey mask goes into the same refine);
* ``mask_refined``, device refine: bit-equal.  Both refine the same page
  and the same cv2-exact grey mask, and the port's refine is bit-equal to
  the JAX package's (``tests/test_torch_refine.py``).
"""

import os

import numpy as np
import pytest
import torch

from comic_text_detector_tpu.pipeline.detector import TextDetector as JaxTextDetector
from comic_text_detector_tpu.training.checkpoint import load_compact
from comic_text_detector_tpu_torch.parallel.mesh import Mesh
from comic_text_detector_tpu_torch.pipeline import BatchTextDetector, TextDetector

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
def variables():
    return load_compact(WEIGHTS)


@pytest.fixture(scope="module")
def detectors(variables):
    jax_det = JaxTextDetector(variables=variables, input_size=SIZE)
    port = TextDetector(WEIGHTS, input_size=SIZE, device="cpu")
    return jax_det, port


@pytest.fixture(scope="module")
def device_detectors(variables):
    """(JAX, port) pairs with the device refine, by mask transfer."""
    kw = dict(input_size=SIZE, refine_backend="device")
    return {
        transfer: (
            JaxTextDetector(variables=variables, mask_transfer=transfer, **kw),
            TextDetector(WEIGHTS, device="cpu", mask_transfer=transfer, **kw),
        )
        for transfer in ("packed", "grey")
    }


def _same_blocks(blks, jblks):
    assert len(blks) == len(jblks) > 0
    for a, b in zip(blks, jblks):
        assert np.abs(np.asarray(a.xyxy) - np.asarray(b.xyxy)).max() <= 1
        assert (a.language, bool(a.vertical)) == (b.language, bool(b.vertical))
        np.testing.assert_array_equal(np.asarray(a.lines), np.asarray(b.lines))


@pytest.mark.parametrize("page", [0, 1, 2])
def test_slice_matches_jax_text_detector(detectors, page):
    jax_det, port = detectors
    img = _pages()[page]
    jmask, jrefined, jblks = jax_det(img.copy())
    mask, refined, blks = port(img.copy())
    _same_blocks(blks, jblks)
    assert mask.shape == refined.shape == img.shape[:2] and mask.dtype == refined.dtype == np.uint8
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(refined, jrefined)


def test_keep_undetected_mask_runs(detectors):
    """Host refine with ``keep_undetected_mask=True`` against the JAX
    TextDetector's, bit for bit."""
    jax_det, port = detectors
    img = _pages()[1]
    jmask, jrefined, _ = jax_det(img.copy(), keep_undetected_mask=True)
    mask, refined, _ = port(img.copy(), keep_undetected_mask=True)
    assert refined.shape == mask.shape == img.shape[:2] and refined.dtype == np.uint8
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(refined, jrefined)


@pytest.mark.parametrize("transfer", ["packed", "grey"])
@pytest.mark.parametrize("page", [0, 1, 2])
def test_device_refine_matches_jax_text_detector(device_detectors, transfer, page):
    jax_det, port = device_detectors[transfer]
    img = _pages()[page]
    jmask, jrefined, jblks = jax_det(img.copy())
    mask, refined, blks = port(img.copy())
    _same_blocks(blks, jblks)
    assert mask.shape == refined.shape == img.shape[:2] and mask.dtype == refined.dtype == np.uint8
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(refined, jrefined)


def test_device_refine_keep_undetected_matches_jax(device_detectors):
    jax_det, port = device_detectors["packed"]
    img = _pages()[2]
    jmask, jrefined, _ = jax_det(img.copy(), keep_undetected_mask=True)
    mask, refined, _ = port(img.copy(), keep_undetected_mask=True)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(refined, jrefined)


def test_packed_without_device_refine_raises():
    with pytest.raises(ValueError, match="packed"):
        TextDetector(model_path=None, variables={}, device="cpu", mask_transfer="packed")


@pytest.mark.parametrize(
    "kwargs,error",
    [(dict(mesh=Mesh([torch.device("cpu")], group=object())), NotImplementedError),
     (dict(model_path="model.stablehlo", variables=None), ValueError)],
)
def test_later_slices_raise_not_implemented(kwargs, error):
    """What the port does not run raises: a mesh with a process group for
    the batch stream (serving is one process), and the JAX package's
    .stablehlo artifact (the port's deploy artifact is a .pt2 program)."""
    args = dict(variables={}, device="cpu")
    args.update(kwargs)
    cls = BatchTextDetector if "mesh" in args else TextDetector
    with pytest.raises(error, match=None if error is NotImplementedError else r"JAX package.*\.pt2"):
        cls(**args)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TextDetector(WEIGHTS, input_size=SIZE)
