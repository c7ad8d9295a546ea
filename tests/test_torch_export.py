"""The port's deploy artifact (``export/program.py``): a ``torch.export``
program of the three-head net at a fixed input, with the flagship_r2
weights, on the CPU at 128.

* ``parity_check`` of the loaded program against the live net: within 1e-4
  (the JAX ``parity_check``'s default); on the CPU the outputs are
  bit-equal;
* ``TextDetector`` from the ``.pt2`` against ``TextDetector`` from the
  ``.npz``: masks, refined masks and blocks bit-identical;
* ``concate_models`` of the three subnets' state dicts: the whole state
  dict.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from comic_text_detector_tpu_torch.export import concate_models, export_program, load_exported, parity_check
from comic_text_detector_tpu_torch.models.detector import build_inference_model
from comic_text_detector_tpu_torch.pipeline import TextDetector
from comic_text_detector_tpu_torch.weights import SUBNETS, load_npz, state_dict_from_jax

from tests.test_torch_pipeline import _pages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
SIZE = 128


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variables():
    return load_npz(WEIGHTS)


@pytest.fixture(scope="module")
def programs(tmp_path_factory, variables):
    """{dtype name: path} of the float32 program (from the port's state
    dict) and the bf16 one (from the JAX-layout variables)."""
    d = tmp_path_factory.mktemp("pt2")
    out = {}
    for dtype, weights in ((torch.float32, state_dict_from_jax(variables)), (torch.bfloat16, variables)):
        path = str(d / f"ctd_{str(dtype)[6:]}.pt2")
        export_program(weights, path, input_size=SIZE, dtype=dtype, device="cpu")
        out[str(dtype)[6:]] = path
    return out


def test_sidecar(programs):
    for name, path in programs.items():
        with open(path + ".json") as f:
            meta = json.load(f)
        assert meta == {"input": [1, 3, SIZE, SIZE], "outputs": ["blk", "seg", "det"], "act": "leaky",
                        "dtype": name, "device": "cpu", "format": "torch.export"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parity_check(variables, programs, dtype):
    ok, gap = parity_check(variables, programs[dtype], input_size=SIZE, device="cpu")
    assert ok and gap <= 1e-4, gap


def test_load_exported_refuses_another_device(programs, tmp_path):
    path = str(tmp_path / "card.pt2")
    shutil.copy(programs["float32"], path)
    with open(programs["float32"] + ".json") as f:
        meta = json.load(f)
    with open(path + ".json", "w") as f:
        json.dump(dict(meta, device="cuda"), f)
    with pytest.raises(ValueError, match="exported on 'cuda'"):
        load_exported(path, "cpu")


@pytest.fixture(scope="module")
def detectors(programs):
    """{half: (TextDetector from the .pt2, TextDetector from the .npz)},
    device refine and packed masks."""
    out = {}
    for half in (False, True):
        kw = dict(input_size=SIZE, device="cpu", half=half, refine_backend="device", mask_transfer="packed")
        out[half] = TextDetector(programs["bfloat16" if half else "float32"], **kw), TextDetector(WEIGHTS, **kw)
    return out


@pytest.mark.parametrize("half", [False, True])
def test_text_detector_from_pt2_bit_identical(detectors, half):
    det_pt2, det_npz = detectors[half]
    for page in _pages()[:2]:
        (m1, r1, b1), (m2, r2, b2) = det_pt2(page.copy()), det_npz(page.copy())
        np.testing.assert_array_equal(m1, m2)
        np.testing.assert_array_equal(r1, r2)
        assert len(b1) == len(b2)
        for a, b in zip(b1, b2):
            assert list(a.xyxy) == list(b.xyxy) and a.language == b.language
            np.testing.assert_array_equal(np.asarray(a.lines), np.asarray(b.lines))


def test_pt2_holds_no_variables(detectors, tmp_path):
    with pytest.raises(ValueError, match="no variables"):
        detectors[False][0].save_variables(str(tmp_path / "x.msgpack"))


@pytest.mark.parametrize("kw,match", [(dict(half=True), "computes with"), (dict(act="relu"), "computes with"),
                                      (dict(input_size=2 * SIZE), "exported at input size")])
def test_pt2_refuses_another_dtype_or_act(programs, kw, match):
    with pytest.raises(ValueError, match=match):
        TextDetector(programs["float32"], **{"input_size": SIZE, "device": "cpu", **kw})


def test_concate_models(variables):
    whole = state_dict_from_jax(variables)
    parts = [{k[len(s) + 1:]: v for k, v in whole.items() if k.startswith(s + ".")} for s in SUBNETS]
    merged = concate_models(*parts)
    assert set(merged) == set(whole) and all(merged[k] is whole[k] for k in whole)
    build_inference_model().load_state_dict(merged, strict=True)
