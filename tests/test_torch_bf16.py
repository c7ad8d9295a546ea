"""The port in bf16 (``half=True``) vs the JAX package in bf16.

The two frameworks round bf16 at different places (cuDNN/oneDNN
convolutions accumulate in float32 and round once; XLA's CPU convolutions
and activations round elsewhere), so bf16 outputs are not held bit for bit.
The yardstick is the JAX package's own bf16 error, measured in the test on
the same inputs: the gap between JAX bf16 and JAX float32.  Tolerances:

* raw head outputs on the letterboxed page (the blocks' boxes, the blocks'
  objectness and class confidences, the seg mask, the DB shrink map): the
  port's max abs gap to JAX bf16 is at most twice JAX's bf16-vs-f32 gap,
  each quantity on its own (both gaps are printed);
* the whole ``TextDetector(half=True)`` against JAX ``TextDetector(
  half=True)``: refined masks with IoU >= 0.98, the JAX package's own bf16
  budget (``tests/test_bf16_parity.py``).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comic_text_detector_tpu.models.detector import build_inference_model as jax_build
from comic_text_detector_tpu.pipeline.detector import TextDetector as JaxTextDetector
from comic_text_detector_tpu.training.checkpoint import load_compact
from comic_text_detector_tpu_torch.ops.resize import letterbox_device_u8
from comic_text_detector_tpu_torch.pipeline import TextDetector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
SIZE = 256


def _pages():
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
def variables():
    return load_compact(WEIGHTS)


@pytest.fixture(scope="module")
def port_half():
    return TextDetector(WEIGHTS, input_size=SIZE, half=True, device="cpu")


@pytest.fixture(scope="module")
def jax_half(variables):
    return JaxTextDetector(variables=variables, input_size=SIZE, half=True)


@pytest.fixture(scope="module")
def jax_nets(variables):
    return (jax.jit(jax_build(act="leaky", dtype=jnp.bfloat16).apply), jax.jit(jax_build(act="leaky").apply))


def _heads(blks, mask, lines) -> dict:
    """NHWC float32 head outputs -> the quantities the tolerance names."""
    blks, mask, lines = (np.asarray(a, np.float32) for a in (blks, mask, lines))
    return {"box": blks[..., 0:4], "conf": blks[..., 4:], "mask": mask[..., 0], "shrink": lines[..., 0]}


@pytest.mark.parametrize("page", [0, 1, 2])
def test_net_bf16_within_twice_jax_bf16_gap(variables, port_half, jax_nets, page):
    img = _pages()[page]
    lb = letterbox_device_u8(torch.from_numpy(img), SIZE)
    x = (lb.numpy().astype(np.float32) / np.float32(255.0))[None]
    f16, f32 = jax_nets
    j16 = _heads(*jax.device_get(f16(variables, jnp.asarray(x))))
    j32 = _heads(*jax.device_get(f32(variables, jnp.asarray(x))))
    with torch.no_grad():
        blks, mask, lines = port_half.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert blks.dtype == mask.dtype == lines.dtype == torch.float32
    got = _heads(blks.numpy(), mask.permute(0, 2, 3, 1).numpy(), lines.permute(0, 2, 3, 1).numpy())
    for name in ("box", "conf", "mask", "shrink"):
        gap = float(np.abs(got[name] - j16[name]).max())
        budget = float(np.abs(j16[name] - j32[name]).max())
        print(f"page {page} {name}: port-vs-JAX bf16 {gap:.4g}, JAX bf16-vs-f32 {budget:.4g}")
        assert budget > 0 and gap <= 2 * budget, f"{name}: {gap:.4g} > 2 x {budget:.4g}"


@pytest.mark.parametrize("page", [0, 1, 2])
def test_text_detector_half_matches_jax_half(jax_half, port_half, page):
    img = _pages()[page]
    jmask, jrefined, jblks = jax_half(img.copy())
    mask, refined, blks = port_half(img.copy())
    assert mask.shape == refined.shape == img.shape[:2] and refined.dtype == np.uint8
    a, b = refined > 30, jrefined > 30
    iou = np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)
    print(f"page {page}: {len(blks)} blocks (JAX {len(jblks)}), refined IoU {iou:.4f}")
    assert iou >= 0.98, f"refined mask IoU {iou:.4f}"
