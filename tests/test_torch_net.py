"""Port's weights and three-head net vs the JAX package, flagship_r2 weights.

Tolerances: the float32 net outputs agree within 1e-4 absolute on the mask
and DB maps (probabilities in [0, 1]); Detect rows (pixel xywh up to the
input size, then obj/cls probabilities) within 1e-4 + 1e-5 relative.  The
two frameworks sum convolutions in different orders; the measured gap at
256 is about 1e-5 on the maps and 5e-4 px on the boxes.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comic_text_detector_tpu.models.convert import export_torch_checkpoint
from comic_text_detector_tpu.models.detector import build_inference_model as jax_build
from comic_text_detector_tpu.training.checkpoint import load_compact
from comic_text_detector_tpu_torch.models.detector import build_inference_model
from comic_text_detector_tpu_torch.weights import load_npz, load_reference_pt, state_dict_from_jax

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "flagship_r2.npz")


@pytest.fixture(scope="module")
def variables():
    return load_compact(WEIGHTS)


@pytest.fixture(scope="module")
def torch_model(variables):
    model = build_inference_model()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def test_load_npz_matches_jax_reader(variables):
    ours = load_npz(WEIGHTS)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
        assert flat_b[path].dtype == np.float32


def test_reference_pt_loads_to_the_same_state_dict(variables, tmp_path):
    """A reference-format combined .pt (written by the JAX package's
    exporter) reads back into exactly the state dict of the npz route."""
    path = tmp_path / "ckpt.pt"
    torch.save(export_torch_checkpoint(variables), path)
    sd_pt, cfg = load_reference_pt(str(path))
    sd_np = state_dict_from_jax(variables)
    assert cfg is not None and set(sd_pt) == set(sd_np)
    for k, v in sd_np.items():
        assert torch.equal(sd_pt[k], v), k
    build_inference_model(cfg).load_state_dict(sd_pt, strict=True)


def test_fused_bn_checkpoint_gets_identity_bn(variables, tmp_path):
    """A conv with its BN folded away (``X.conv.bias``, no ``X.bn``) loads
    as conv + identity BN carrying the bias."""
    ckpt = export_torch_checkpoint(variables)
    sd = ckpt["blk_det"]["weights"]
    for leaf in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
        del sd[f"model.0.bn.{leaf}"]
    sd["model.0.conv.bias"] = torch.arange(32, dtype=torch.float32)
    path = tmp_path / "fused.pt"
    torch.save(ckpt, path)
    sd_pt, _ = load_reference_pt(str(path))
    assert torch.equal(sd_pt["blk_det.model.0.bn.bias"], torch.arange(32, dtype=torch.float32))
    assert torch.equal(sd_pt["blk_det.model.0.bn.weight"], torch.ones(32))
    build_inference_model().load_state_dict(sd_pt, strict=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_net_matches_jax_apply(variables, torch_model, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((1, 256, 256, 3)).astype(np.float32)
    jblks, jmask, jlines = jax.device_get(jax.jit(jax_build(act="leaky").apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        blks, mask, lines = torch_model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert blks.shape == jblks.shape
    np.testing.assert_allclose(blks.numpy(), jblks, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mask.permute(0, 2, 3, 1).numpy(), jmask, rtol=0, atol=1e-4)
    np.testing.assert_allclose(lines.permute(0, 2, 3, 1).numpy(), jlines, rtol=0, atol=1e-4)
