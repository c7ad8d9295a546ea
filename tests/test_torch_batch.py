"""The port's batch stream vs the JAX package's BatchTextDetector.

Both run with the flagship_r2 weights in float32 (``half=False``), batch 2,
input 256, on three rendered pages of two shapes (so one batch mixes the
shapes and the device refine groups them), through ``stream``.  The
configurations are the default (host refine, grey mask) and the main
path's (device refine, packed masks), the latter also with
``keep_undetected_mask=True``.  Tolerances are the single-page ones of
``tests/test_torch_pipeline.py``:

* ``blk_list``: the same count; each block's xyxy within 1 px, the same
  language, orientation and line quads;
* ``mask`` and ``mask_refined``: bit-equal.  The grey mask is resized on
  the host with the same routing (Pillow's bilinear upscale, reproduced in
  NumPy); the packed mask binarises the same cv2-exact upsample; both
  refines are bit-equal to the JAX package's.

Also: an error raised by the stream's source reaches the consumer after
the pages read before it, and the constructor's contract (no mesh with a
process group, packed needs the device refine, CUDA by default).
"""

import os

import numpy as np
import pytest
import torch

from comic_text_detector_tpu.pipeline.batch import BatchTextDetector as JaxBatchTextDetector
from comic_text_detector_tpu.training.checkpoint import load_compact
from comic_text_detector_tpu_torch.parallel.mesh import Mesh
from comic_text_detector_tpu_torch.pipeline import BatchTextDetector
from comic_text_detector_tpu_torch.weights import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
SIZE = 256
DEVICE_KW = dict(refine_backend="device", mask_transfer="packed")


def _pages():
    """Three rendered pages in two shapes: grey 384x320, colour 288x352,
    text-dense colour 384x320."""
    from comic_text_detector_tpu.data.render import ComicTextRenderer

    out = []
    for seed, (h, w), grey, blocks in ((1, (384, 320), True, (4, 7)), (2, (288, 352), False, (4, 7)),
                                       (3, (384, 320), False, (6, 9))):
        rng = np.random.default_rng(seed)
        bg = rng.integers(215, 250, (h, w, 3)).astype(np.uint8)
        img = ComicTextRenderer(seed=seed, blocks_per_page=blocks).render_page(bg)["img"]
        if grey:
            img = np.repeat(img[..., :1], 3, axis=2)
        out.append(np.ascontiguousarray(img))
    return out


@pytest.fixture(scope="module")
def pages():
    return _pages()


@pytest.fixture(scope="module")
def results(pages):
    """{case: (JAX outputs, port outputs)} for every configuration."""
    variables, port_vars = load_compact(WEIGHTS), load_npz(WEIGHTS)
    dets = {
        refine: (JaxBatchTextDetector(variables, batch_size=2, input_size=SIZE, half=False, **kw),
                 BatchTextDetector(port_vars, batch_size=2, input_size=SIZE, half=False, device="cpu", **kw))
        for refine, kw in (("host", {}), ("device", DEVICE_KW))
    }
    out = {}
    for case, refine, keep in (("host", "host", False), ("device", "device", False),
                               ("device_keep", "device", True)):
        jdet, port = dets[refine]
        out[case] = (list(jdet.stream(iter(pages), keep_undetected_mask=keep)),
                     list(port.stream(iter(pages), keep_undetected_mask=keep)))
    return out


def _same_blocks(blks, jblks):
    assert len(blks) == len(jblks) > 0
    for a, b in zip(blks, jblks):
        assert np.abs(np.asarray(a.xyxy) - np.asarray(b.xyxy)).max() <= 1
        assert (a.language, bool(a.vertical)) == (b.language, bool(b.vertical))
        np.testing.assert_array_equal(np.asarray(a.lines), np.asarray(b.lines))


@pytest.mark.parametrize("case", ["host", "device", "device_keep"])
@pytest.mark.parametrize("page", [0, 1, 2])
def test_batch_stream_matches_jax(results, pages, case, page):
    jout, pout = results[case]
    assert len(pout) == len(jout) == len(pages)
    jmask, jrefined, jblks = jout[page]
    mask, refined, blks = pout[page]
    _same_blocks(blks, jblks)
    assert mask.shape == refined.shape == pages[page].shape[:2]
    assert mask.dtype == refined.dtype == np.uint8
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(refined, jrefined)


def test_process_batch_matches_stream(results, pages):
    """One batch through ``process_batch`` gives the stream's results."""
    port = BatchTextDetector(load_npz(WEIGHTS), batch_size=2, input_size=SIZE, half=False, device="cpu")
    _, pout = results["host"]
    for got, want in zip(port.process_batch(pages[:2]), pout[:2]):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert [b.xyxy for b in got[2]] == [b.xyxy for b in want[2]]


def test_stream_propagates_source_errors(pages):
    port = BatchTextDetector(load_npz(WEIGHTS), batch_size=2, input_size=SIZE, half=False, device="cpu")

    def bad_source():
        yield pages[0]
        yield pages[1]
        raise RuntimeError("decode failed")

    got = []
    with pytest.raises(RuntimeError, match="decode failed"):
        for item in port.stream(bad_source()):
            got.append(item)
    assert len(got) == 2  # the full batch read before the error still comes out


def test_constructor_contract():
    with pytest.raises(NotImplementedError, match="mesh"):
        BatchTextDetector({}, mesh=Mesh([torch.device("cpu")], group=object()), device="cpu")
    with pytest.raises(ValueError, match="packed"):
        BatchTextDetector({}, mask_transfer="packed", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchTextDetector(load_npz(WEIGHTS), input_size=SIZE)
    det = BatchTextDetector(load_npz(WEIGHTS), input_size=SIZE, device="cpu")
    assert det.batch_size == 4 and det.model.dtype == torch.bfloat16  # half=True by default
