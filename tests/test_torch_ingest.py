"""The port's model files against the JAX package's: the native msgpack
format, ``.onnx`` ingestion and ``models/convert.py``, with the flagship_r2
weights.

Tolerances:

* the native file: **byte-equal** to ``flax.serialization.to_bytes`` of the
  same variables, and to the JAX ``TextDetector``'s ``save_variables``; each
  package's ``from_native`` reads the other's file; pages from it equal the
  JAX ``TextDetector``'s as ``tests/test_torch_pipeline.py`` holds them
  (masks bit-equal, blocks within 1 px with equal lines);
* ``load_from_parts`` and ``export_torch_checkpoint``: bit-equal, leaf by
  leaf;
* ``onnx_to_state_dicts``, ``convert_onnx_checkpoint`` and
  ``fold_batchnorm``: bit-equal except where the JAX package takes the
  wrong eps.  Every yolov5 ``Conv`` BatchNorm has eps 1e-3 in both
  packages' nets (``models/blocks.py::Conv``), those in the heads' C3
  blocks too, but the JAX ingestion and fold use 1e-5 for every BN of the
  heads, so their "identity" BNs there scale by 1/sqrt(1 - 1e-5 + 1e-3).
  The port takes each BN's own eps: its re-expanded ``running_var`` is
  1 - 1e-3 there, and its fold equals JAX's fold with eps 1e-3 on those
  pairs;
* the net from the ``.onnx`` (Conv+BN folded by the exporter): the
  unexported net's outputs within the JAX test's tolerances (maps 1e-4,
  boxes 1e-3 relative + 5e-3), the JAX net on the same file (its eps
  corrected as above) within ``tests/test_torch_net.py``'s.
"""

import os
import re

import numpy as np
import pytest
import torch
from torch import nn

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import msgpack

from comic_text_detector_tpu.models import convert as jconvert
from comic_text_detector_tpu.models import onnx_ingest as jonnx
from comic_text_detector_tpu.models.detector import build_inference_model as jax_build
from comic_text_detector_tpu.pipeline.detector import TextDetector as JaxTextDetector
from comic_text_detector_tpu.training.checkpoint import load_compact
from comic_text_detector_tpu_torch.config import YOLOV5S_CFG
from comic_text_detector_tpu_torch.export import export_onnx
from comic_text_detector_tpu_torch.models import convert
from comic_text_detector_tpu_torch.models import onnx_ingest
from comic_text_detector_tpu_torch.models.detector import build_inference_model
from comic_text_detector_tpu_torch.pipeline import TextDetector
from comic_text_detector_tpu_torch.utils.serialization import msgpack_restore, to_bytes
from comic_text_detector_tpu_torch.weights import SUBNETS, load_reference_pt, state_dict_from_jax

from tests.test_torch_pipeline import _pages, _same_blocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
SIZE = 256  # pipeline comparisons (the flagship finds blocks on the rendered pages)
NET = 128  # net comparisons and the ONNX trace


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Full-width nets on the CPU: torch's thread pool spins against the
    other workers' (ROADMAP, Facts)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def variables():
    return load_compact(WEIGHTS)


@pytest.fixture(scope="module")
def page():
    return _pages()[2]


@pytest.fixture(scope="module")
def jax_detector(variables):
    return JaxTextDetector(variables=variables, input_size=SIZE)


@pytest.fixture(scope="module")
def jax_page(jax_detector, page):
    return jax_detector(page.copy())


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), (sorted(set(g) ^ set(w)))[:5]
    for k, v in w.items():
        assert np.asarray(g[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(v), err_msg=k)


def _same_page(got, want):
    mask, refined, blks = got
    jmask, jrefined, jblks = want
    _same_blocks(blks, jblks)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(refined, jrefined)


# --- the native format -----------------------------------------------------------


def test_to_bytes_equals_flax(variables):
    buf = to_bytes(variables)
    assert buf == flax_ser.to_bytes(jax.device_get(variables))
    _assert_trees_equal(msgpack_restore(buf), flax_ser.msgpack_restore(buf))


def _tree(case: str):
    rng = np.random.default_rng(0)
    if case == "map16, str8 keys, fixext sizes":
        return {"k" * 40: {f"{i:02d}": rng.random((i,)).astype(np.float32) for i in range(20)},
                "e1": np.zeros(1, np.uint8), "e2": np.zeros(1, np.float16), "e4": np.zeros(1, np.int32),
                "e8": np.zeros(1, np.float64), "e16": np.zeros(2, np.float64)}
    if case == "str16 key, bin16, uint16 dims":
        return {"x" * 300: rng.integers(0, 255, (2, 70000), dtype=np.uint8)}
    if case == "bin32, uint32 dims, ext32":
        return {"a": np.arange(70000 * 1000, dtype=np.uint8).reshape(70000, 1000)[:, :1]
                .repeat(1000, 1)}
    if case == "scalar, empty, int64, bool, views":
        return {"s": np.asarray(3.0, np.float64), "z": np.zeros((0, 3), np.int64),
                "b": rng.random((3, 5)) < 0.5, "t": rng.random((4, 6)).astype(np.float32).T}
    raise KeyError(case)


@pytest.mark.parametrize("case", ["map16, str8 keys, fixext sizes", "str16 key, bin16, uint16 dims",
                                  "bin32, uint32 dims, ext32", "scalar, empty, int64, bool, views"])
def test_to_bytes_encodings_equal_flax(case):
    tree = {"root": _tree(case)}
    buf = to_bytes(tree)
    assert buf == flax_ser.to_bytes(jax.device_get(tree))
    _assert_trees_equal(msgpack_restore(buf), flax_ser.msgpack_restore(buf))


def test_restore_reads_npscalar():
    buf = msgpack.packb({"a": np.float32(2.5)}, default=flax_ser._msgpack_ext_pack, strict_types=True)
    out = msgpack_restore(buf)
    assert out["a"] == np.float32(2.5) and out["a"].dtype == np.float32


@pytest.mark.parametrize("name,buf", [
    ("nil", msgpack.packb({"a": None})),
    ("negative int", msgpack.packb({"a": -1})),
    ("float", msgpack.packb({"a": 1.5})),
    ("ext type 2", msgpack.packb({"a": msgpack.ExtType(2, b"xx")})),
    ("chunked leaf", msgpack.packb({"a": {"__msgpack_chunked_array__": True, "shape": {"0": 1}}})),
    ("object dtype", msgpack.packb({"a": msgpack.ExtType(1, msgpack.packb(((1,), "object", b"x" * 8)))})),
    ("trailing bytes", msgpack.packb({"a": 1}) + b"\x00"),
])
def test_restore_raises_on_what_it_does_not_cover(name, buf):
    with pytest.raises(ValueError):
        msgpack_restore(buf)


def test_restore_raises_on_bfloat16():
    buf = flax_ser.to_bytes({"a": np.zeros(2, jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        msgpack_restore(buf)


def test_to_bytes_raises_on_other_leaves():
    with pytest.raises(ValueError):
        to_bytes({"a": [np.zeros(2)]})
    with pytest.raises(ValueError):
        to_bytes({"a": np.array([object()])})


@pytest.fixture(scope="module")
def native_files(tmp_path_factory, jax_detector):
    """(the port's save_variables file, the JAX package's)."""
    d = tmp_path_factory.mktemp("native")
    port_path, jax_path = str(d / "port.msgpack"), str(d / "jax.msgpack")
    TextDetector(WEIGHTS, input_size=SIZE, device="cpu").save_variables(port_path)
    jax_detector.save_variables(jax_path)
    return port_path, jax_path


def test_save_variables_byte_equal_to_jax(native_files):
    port_path, jax_path = native_files
    with open(port_path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()


def test_from_native_reads_jax_file(native_files, page, jax_page):
    det = TextDetector.from_native(native_files[1], input_size=SIZE, device="cpu")
    _same_page(det(page.copy()), jax_page)


def test_flax_reads_port_file(native_files, variables):
    """What the JAX ``from_native`` does after building its template (an
    init of the net at 256, about 40 s on the CPU): ``from_bytes``."""
    with open(native_files[0], "rb") as f:
        _assert_trees_equal(flax_ser.from_bytes(variables, f.read()), variables)


# --- .onnx ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_model(variables):
    model = build_inference_model()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def onnx_path(tmp_path_factory, port_model):
    path = str(tmp_path_factory.mktemp("onnx") / "comictextdetector.pt.onnx")
    export_onnx(port_model, path, input_size=NET)
    return path


def _head_convbnact_vars(keys):
    """The ``running_var`` keys of the yolov5 Conv BNs inside the heads
    (their C3 blocks): the only BNs of the heads named ``*.bn``."""
    return {k for k in keys if k.split(".")[0] in ("text_seg", "text_det") and k.endswith(".bn.running_var")}


def test_onnx_state_dicts_match_jax(onnx_path):
    init, nodes = onnx_ingest.read_onnx_graph(onnx_path)
    jinit, jnodes = jonnx.read_onnx_graph(onnx_path)
    assert set(init) == set(jinit) and nodes == jnodes
    got = onnx_ingest.onnx_to_state_dicts(init, nodes)
    want = jonnx.onnx_to_state_dicts(jinit, jnodes)
    assert set(got) == set(want) == set(SUBNETS)
    flat_got = {f"{s}.{k}": v for s, sd in got.items() for k, v in sd.items()}
    flat_want = {f"{s}.{k}": v for s, sd in want.items() for k, v in sd.items()}
    assert set(flat_got) == set(flat_want)
    eps_keys = _head_convbnact_vars(flat_got)
    assert len(eps_keys) == 40  # 8 C3 blocks of 5 Convs: down_conv1 and five upconvs, two in the DB head
    for k, v in flat_want.items():
        assert flat_got[k].dtype == v.dtype and flat_got[k].shape == v.shape, k
        if k in eps_keys:  # the port's identity BN under eps 1e-3, JAX's under 1e-5
            np.testing.assert_array_equal(v, np.full(v.shape, 1.0 - 1e-5, np.float32), err_msg=k)
            np.testing.assert_array_equal(flat_got[k], np.full(v.shape, 1.0 - 1e-3, np.float32), err_msg=k)
        else:
            np.testing.assert_array_equal(flat_got[k], v, err_msg=k)


def _jax_onnx_tree(onnx_path):
    """The JAX ingestion's tree with the eps of the heads' C3 BNs corrected
    (identity under their eps 1e-3)."""
    tree, _ = jonnx.convert_onnx_checkpoint(onnx_path)

    def fix(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                fix(v, path + (k,))
            elif k == "var" and path[0] in ("text_seg", "text_det") and path[-1] == "bn" \
                    and not path[-2].startswith("upconv"):  # an upconv's own BN has eps 1e-5
                node[k] = np.full(v.shape, 1.0 - 1e-3, np.float32)

    fix(tree["batch_stats"], ())
    return tree


def test_convert_onnx_checkpoint_matches_jax(onnx_path):
    sd, cfg = onnx_ingest.convert_onnx_checkpoint(onnx_path)
    assert cfg is None
    want = state_dict_from_jax(jonnx.convert_onnx_checkpoint(onnx_path)[0])
    fixed = state_dict_from_jax(_jax_onnx_tree(onnx_path))
    assert set(sd) == set(want)
    eps_keys = _head_convbnact_vars(sd)
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and sd[k].shape == v.shape, k
        assert torch.equal(sd[k], fixed[k]), k
        assert torch.equal(sd[k], v) == (k not in eps_keys), k
    build_inference_model().load_state_dict(sd, strict=True)


@pytest.fixture(scope="module")
def onnx_model(onnx_path):
    model = build_inference_model()
    model.load_state_dict(onnx_ingest.convert_onnx_checkpoint(onnx_path)[0], strict=True)
    return model


@pytest.mark.parametrize("seed", [0, 1])
def test_onnx_net_matches_unfused_net(port_model, onnx_model, seed):
    x = torch.from_numpy(np.random.default_rng(seed).random((1, 3, NET, NET), np.float32))
    with torch.no_grad():
        want, got = port_model(x), onnx_model(x)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-3, atol=5e-3)


def test_jax_net_on_onnx_matches_port(onnx_path, onnx_model):
    x = np.random.default_rng(2).random((1, NET, NET, 3)).astype(np.float32)
    jblks, jmask, jlines = jax.device_get(jax.jit(jax_build(act="leaky").apply)(_jax_onnx_tree(onnx_path),
                                                                                  jnp.asarray(x)))
    with torch.no_grad():
        blks, mask, lines = onnx_model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(blks.numpy(), jblks, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mask.permute(0, 2, 3, 1).numpy(), jmask, rtol=0, atol=1e-4)
    np.testing.assert_allclose(lines.permute(0, 2, 3, 1).numpy(), jlines, rtol=0, atol=1e-4)


def test_text_detector_from_onnx_matches_jax(onnx_path, page):
    port = TextDetector(onnx_path, input_size=SIZE, device="cpu")
    jdet = JaxTextDetector(variables=_jax_onnx_tree(onnx_path), input_size=SIZE)
    _same_page(port(page.copy()), jdet(page.copy()))


class _OneConv(nn.Module):
    """A graph of three outputs and one conv: not TextDetBase."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3)

    def forward(self, x):
        y = self.conv(x)
        return y, y + 1, y * 2


def test_onnx_reader_rejects_foreign_model(tmp_path):
    path = str(tmp_path / "other.onnx")
    export_onnx(_OneConv(), path, input_size=16)
    with pytest.raises(ValueError, match="conv nodes, expected"):
        onnx_ingest.convert_onnx_checkpoint(path)


# --- models/convert.py --------------------------------------------------------------


def _split_training_files(variables, d):
    """The port's state dict as the reference's three training files:
    ``{cfg, weights}`` and ``{weights, epoch}`` x 2."""
    sd = state_dict_from_jax(variables)
    parts = {s: {k[len(s) + 1:]: v for k, v in sd.items() if k.startswith(s + ".")} for s in SUBNETS}
    files = []
    for subnet, ckpt in (("blk_det", {"cfg": YOLOV5S_CFG, "weights": parts["blk_det"]}),
                         ("text_seg", {"weights": parts["text_seg"], "epoch": 7}),
                         ("text_det", {"weights": parts["text_det"], "epoch": 9})):
        path = str(d / f"{subnet}.ckpt")
        torch.save(ckpt, path)
        files.append(path)
    return files, parts


def test_load_from_parts_matches_jax(variables, tmp_path):
    files, _ = _split_training_files(variables, tmp_path)
    got, cfg = convert.load_from_parts(*files)
    want, jcfg = jconvert.load_from_parts(*files)
    assert cfg == jcfg == YOLOV5S_CFG
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, variables)
    TextDetector(variables=got, cfg=cfg, input_size=NET, device="cpu")


def _jitter(tree):
    rng = np.random.default_rng(5)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _jitter(v)
        elif k == "mean":
            out[k] = (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
        elif k == "var":
            out[k] = (v * rng.uniform(0.7, 1.4, v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def jittered(variables):
    return {"params": variables["params"], "batch_stats": _jitter(variables["batch_stats"])}


def test_fold_batchnorm_matches_jax(jittered):
    got = _leaves(convert.fold_batchnorm(jittered))
    want = _leaves(jconvert.fold_batchnorm(jittered))
    want_e3 = _leaves(jconvert.fold_batchnorm(jittered, yolo_roots=SUBNETS))
    assert set(got) == set(want)
    moved = 0
    for k, v in want.items():
        # leaves of a yolov5 Conv (conv/bn) in the heads: JAX folds them with
        # eps 1e-5, the port with their eps 1e-3, as JAX does under yolo_roots
        conv_bn = k.startswith(("['params']['text", "['batch_stats']['text")) and (
            "['conv']['kernel']" in k or ("['bn']" in k and not re.search(r"\['upconv\d+'\]\['bn'\]", k)))
        ref = want_e3[k] if conv_bn else v
        np.testing.assert_array_equal(got[k], ref, err_msg=k)
        moved += conv_bn and not np.array_equal(v, ref)
    assert moved > 100


def test_fold_batchnorm_preserves_outputs(jittered):
    x = torch.from_numpy(np.random.default_rng(4).random((1, 3, NET, NET), np.float32))
    outs = []
    for tree in (jittered, convert.fold_batchnorm(jittered)):
        model = build_inference_model()
        model.load_state_dict(state_dict_from_jax(tree), strict=True)
        with torch.no_grad():
            outs.append(model(x))
    (b0, m0, l0), (b1, m1, l1) = outs
    np.testing.assert_allclose(m1.numpy(), m0.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(b1.numpy(), b0.numpy(), rtol=1e-4, atol=1e-3)


def test_export_torch_checkpoint_matches_jax(variables, tmp_path):
    got = convert.export_torch_checkpoint(variables)
    want = jconvert.export_torch_checkpoint(variables)
    assert got["blk_det"]["cfg"] == want["blk_det"]["cfg"] == YOLOV5S_CFG
    for subnet in SUBNETS:
        g = got[subnet]["weights"] if subnet == "blk_det" else got[subnet]
        w = want[subnet]["weights"] if subnet == "blk_det" else want[subnet]
        assert set(g) == set(w), subnet
        for k, v in w.items():
            assert g[k].dtype == v.dtype and g[k].shape == v.shape and torch.equal(g[k], v), k
    blk = got["blk_det"]["weights"]
    assert not any("anchor_grid" in k for k in blk)
    assert torch.equal(blk["model.24.anchors"], torch.tensor(YOLOV5S_CFG["anchors"], dtype=torch.float32)
                       .view(3, 3, 2) / torch.tensor([8.0, 16.0, 32.0]).view(3, 1, 1))
    path = str(tmp_path / "combined.pt")
    torch.save(got, path)
    sd, cfg = load_reference_pt(path)
    assert cfg == YOLOV5S_CFG
    build_inference_model(cfg).load_state_dict(sd, strict=True)
    want_sd = state_dict_from_jax(variables)
    assert set(sd) == set(want_sd) and all(torch.equal(sd[k], v) for k, v in want_sd.items())
