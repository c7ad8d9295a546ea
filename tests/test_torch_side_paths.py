"""The side paths of inference in the port against the JAX package, on the
CPU, with the flagship_r2 weights at input size 256 and pages rendered
into ``tmp_path``:

* ``model2annotations``: the label ``.txt``, ``line-*.txt`` and ``.json``
  files byte-equal to the JAX function's; ``mask-*.png`` and the copied
  pages equal pixel for pixel (the two packages' PNG encoders differ:
  Pillow's in JAX, the port's zlib one, so the PNG bytes are not compared);
* ``traverse_by_dict`` on that output: ``viz-*`` and ``refined-*`` equal
  pixel for pixel;
* ``xyxy2yolo``, ``yolo_xywh2xyxy``, ``get_yololabel_strings`` and the
  ``utils/viz.py`` helpers equal;
* ``render_comictext`` with one seed: label and line files byte-equal, the
  pages and masks pixel-equal;
* ``SEG_DEFAULTS``, ``DB_DEFAULTS``, ``load_hyp``, ``deep_merge`` equal,
  ``dump_effective`` byte-equal;
* ``letterbox_device`` within 1e-6; ``preprocess_img`` and
  ``postprocess_mask`` equal;
* ``random_init`` (both detectors): shapes and dtypes of one run, the same
  weights for the same seed, others for another;
* the span recorder (``utils/profiling.py``) on the CPU;
* the CLI: ``detect``, ``annotate`` and ``export`` through
  ``main([..., "--device", "cpu"])`` equal to direct calls, and its
  commands and options those of the JAX ``cli.main`` plus ``--device``
  (and ``--trace`` on ``detect`` and ``annotate``).
"""

import argparse
import contextlib
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from comic_text_detector_tpu.pipeline import model2annotations as jax_model2annotations
from comic_text_detector_tpu.pipeline import traverse_by_dict as jax_traverse_by_dict
from comic_text_detector_tpu.pipeline.detector import TextDetector as JaxTextDetector
from comic_text_detector_tpu.training.checkpoint import load_compact
from comic_text_detector_tpu_torch import cli
from comic_text_detector_tpu_torch.pipeline import BatchTextDetector, TextDetector
from comic_text_detector_tpu_torch.pipeline import model2annotations, traverse_by_dict
from comic_text_detector_tpu_torch.utils.io import imread, imwrite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
SIZE = 256


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pages():
    from comic_text_detector_tpu.data.render import ComicTextRenderer

    out = []
    for seed, grey in ((1, True), (2, False), (3, False)):
        rng = np.random.default_rng(seed)
        bg = rng.integers(215, 250, (384, 320, 3)).astype(np.uint8)
        img = ComicTextRenderer(seed=seed, blocks_per_page=(3, 6)).render_page(bg)["img"]
        out.append(np.ascontiguousarray(np.repeat(img[..., :1], 3, axis=2) if grey else img))
    return out


@pytest.fixture(scope="module")
def page_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pages")
    for i, img in enumerate(_pages()):
        imwrite(str(d / f"page{i}.png"), img)
    return str(d)


@pytest.fixture(scope="module")
def port_det():
    return TextDetector(WEIGHTS, input_size=SIZE, device="cpu")


def _same_files(a: str, b: str, names) -> None:
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".png"):
            np.testing.assert_array_equal(imread(pa), imread(pb), err_msg=name)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), name


@pytest.fixture(scope="module")
def annotations(tmp_path_factory, page_dir, port_det):
    """(port dir, JAX dir) of ``model2annotations`` with ``save_json``."""
    ours, theirs = tmp_path_factory.mktemp("ann_port"), tmp_path_factory.mktemp("ann_jax")
    model2annotations(port_det, page_dir, str(ours), save_json=True, progress=False)
    jax_det = JaxTextDetector(variables=load_compact(WEIGHTS), input_size=SIZE)
    jax_model2annotations(jax_det, page_dir, str(theirs), save_json=True, progress=False)
    return str(ours), str(theirs)


def test_model2annotations_matches_jax(annotations):
    ours, theirs = annotations
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names
    assert {n for n in names if n.startswith("line-")} and {n for n in names if n.endswith(".json")}
    for i in range(3):
        assert f"mask-page{i}.png" in names and f"page{i}.txt" in names
        assert open(os.path.join(ours, f"page{i}.txt")).read().strip()  # blocks were found
    _same_files(ours, theirs, names)


def test_traverse_by_dict_matches_jax(annotations, page_dir, tmp_path):
    ours, theirs = annotations
    traverse_by_dict(page_dir, ours, str(tmp_path / "port"))
    jax_traverse_by_dict(page_dir, theirs, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 6
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"), names)


def test_imgproc_label_helpers_match_jax():
    from comic_text_detector_tpu.utils import imgproc as J
    from comic_text_detector_tpu_torch.utils import imgproc as P

    rng = np.random.default_rng(4)
    xy = rng.integers(0, 300, (7, 2))
    xyxy = np.concatenate([xy, xy + rng.integers(1, 80, (7, 2))], axis=1)
    for boxes in (xyxy, xyxy[0], xyxy.tolist(), [], None):
        a, b = P.xyxy2yolo(boxes, 320, 384), J.xyxy2yolo(boxes, 320, 384)
        assert (a is None and b is None) or np.array_equal(a, b)
    yolo = J.xyxy2yolo(xyxy, 320, 384)
    for to_int in (True, False):
        a, b = P.yolo_xywh2xyxy(yolo, 320, 384, to_int), J.yolo_xywh2xyxy(yolo, 320, 384, to_int)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert P.yolo_xywh2xyxy(None, 1, 1) is None and P.yolo_xywh2xyxy([], 1, 1) is None
    classes = rng.integers(0, 2, 7)
    assert P.get_yololabel_strings(classes, yolo) == J.get_yololabel_strings(classes, yolo)


def test_viz_helpers_match_jax():
    from comic_text_detector_tpu.postproc.textblock import TextBlock as JaxTextBlock
    from comic_text_detector_tpu.postproc.textblock import visualize_textblocks as jax_visualize
    from comic_text_detector_tpu.utils import viz as J
    from comic_text_detector_tpu_torch.postproc.textblock import TextBlock, visualize_textblocks
    from comic_text_detector_tpu_torch.utils import viz as P

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    pred = np.array([[4, 6, 60, 40, 0.9, 0], [30, 20, 120, 90, 0.8, 1]])
    np.testing.assert_array_equal(P.draw_bbox(pred, img), J.draw_bbox(pred, img))
    assert [P.Colors()(i, bgr) for i in range(25) for bgr in (False, True)] == \
        [J.Colors()(i, bgr) for i in range(25) for bgr in (False, True)]
    hexes = rng.integers(0, 2 ** 24, 9)
    np.testing.assert_array_equal(P.hex2bgr(hexes), J.hex2bgr(hexes))
    labels = rng.integers(0, 5, (40, 50))
    np.testing.assert_array_equal(P.draw_connected_labels(5, labels, None, None, seed=3),
                                  J.draw_connected_labels(5, labels, None, None, seed=3))
    kw = dict(xyxy=[10, 12, 90, 70], lines=[[[12, 14], [80, 14], [80, 30], [12, 30]]], angle=3)
    a, b = img.copy(), img.copy()
    visualize_textblocks(a, [TextBlock(**kw)])
    jax_visualize(b, [JaxTextBlock(**kw)])
    np.testing.assert_array_equal(a, b)


def test_render_comictext_matches_jax(tmp_path):
    from comic_text_detector_tpu.data.render import render_comictext as jax_render
    from comic_text_detector_tpu_torch.data.render import render_comictext

    bg_dir = tmp_path / "bg"
    bg_dir.mkdir()
    rng = np.random.default_rng(6)
    for i in range(2):
        imwrite(str(bg_dir / f"bg{i}.png"), rng.integers(200, 256, (256, 224, 3), dtype=np.uint8))
    assert render_comictext(str(bg_dir), str(tmp_path / "port"), seed=9) == 2
    assert jax_render(str(bg_dir), str(tmp_path / "jax"), seed=9) == 2
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and {n for n in names if n.startswith("line-")}
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"), names)


def test_hyp_config_matches_jax(tmp_path):
    from comic_text_detector_tpu.utils import config as J
    from comic_text_detector_tpu_torch.utils import config as P

    assert P.SEG_DEFAULTS == J.SEG_DEFAULTS and P.DB_DEFAULTS == J.DB_DEFAULTS
    override = {"train": {"lr0": 0.004, "new": [1, 2]}, "data": {"aug_param": {"hsv": 0.1}}, "extra": 3}
    assert P.deep_merge(P.SEG_DEFAULTS, override) == J.deep_merge(J.SEG_DEFAULTS, override)
    hyp_file = tmp_path / "hyp.yaml"
    hyp_file.write_text("train:\n  epochs: 2\n  batch_size: 8\ndata:\n  imgsz: 512\n")
    for kind in ("seg", "db"):
        for path in (str(hyp_file), None, str(tmp_path / "absent.yaml")):
            assert P.load_hyp(path, kind, {"train": {"lr0": 0.1}}) == J.load_hyp(path, kind, {"train": {"lr0": 0.1}})
    hyp = P.load_hyp(str(hyp_file), "db")
    P.dump_effective(hyp, str(tmp_path / "port" / "eff.yaml"))
    J.dump_effective(hyp, str(tmp_path / "jax" / "eff.yaml"))
    assert filecmp.cmp(tmp_path / "port" / "eff.yaml", tmp_path / "jax" / "eff.yaml", shallow=False)


def test_letterbox_and_host_pre_post_match_jax():
    import jax.numpy as jnp

    from comic_text_detector_tpu.ops.resize import letterbox_device as jax_letterbox_device
    from comic_text_detector_tpu.pipeline.detector import postprocess_mask as jax_postprocess_mask
    from comic_text_detector_tpu.pipeline.detector import preprocess_img as jax_preprocess_img
    from comic_text_detector_tpu_torch.ops.resize import letterbox_device
    from comic_text_detector_tpu_torch.pipeline.detector import postprocess_mask, preprocess_img

    for img in _pages()[:2] + [np.random.default_rng(7).integers(0, 256, (200, 333, 3), dtype=np.uint8)]:
        got = letterbox_device(torch.from_numpy(img), SIZE)
        want = np.asarray(jax_letterbox_device(jnp.asarray(img), SIZE))
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= 1e-6
        for size, to_tensor in ((SIZE, True), ((192, 192), False)):
            a, b = preprocess_img(img, size, to_tensor), jax_preprocess_img(img, size, to_tensor)
            assert a[1:] == b[1:] and a[0].dtype == b[0].dtype and np.array_equal(a[0], b[0])
    mask = np.random.default_rng(8).random((1, 1, 64, 48)).astype(np.float32)
    for thresh in (None, 0.3):
        np.testing.assert_array_equal(postprocess_mask(mask, thresh), jax_postprocess_mask(mask, thresh))
        np.testing.assert_array_equal(postprocess_mask(torch.from_numpy(mask), thresh),
                                      jax_postprocess_mask(mask, thresh))


def _leaves(variables):
    import jax

    return jax.tree_util.tree_flatten_with_path(variables)[0]


def test_random_init_contract():
    from comic_text_detector_tpu_torch.models.init import random_variables

    # the JAX deploy tree's paths, shapes and dtypes (float32 once loaded)
    ours, theirs = random_variables(0), load_compact(WEIGHTS)
    assert [(p, a.shape, a.dtype) for p, a in _leaves(ours)] == \
        [(p, tuple(a.shape), np.dtype(np.float32)) for p, a in _leaves(theirs)]
    again, other = random_variables(0), random_variables(1)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(_leaves(ours), _leaves(again)))
    assert not all(np.array_equal(a, b) for (_, a), (_, b) in zip(_leaves(ours), _leaves(other)))
    img = _pages()[1]
    det = TextDetector.random_init(input_size=128, device="cpu", seed=0)
    mask, refined, blks = det(img)
    assert det.device.type == "cpu" and det.compute_dtype == torch.float32
    assert mask.shape == refined.shape == img.shape[:2] and mask.dtype == refined.dtype == np.uint8
    assert isinstance(blks, list)
    assert all(torch.equal(a, b) for a, b in zip(det.model.state_dict().values(),
                                                   TextDetector.random_init(input_size=128, device="cpu")
                                                   .model.state_dict().values()))
    bdet = BatchTextDetector.random_init(batch_size=2, input_size=128, device="cpu", half=False)
    out = list(bdet.stream([img, img]))
    assert len(out) == 2 and out[0][0].shape == img.shape[:2]
    assert np.array_equal(out[0][0], mask)  # the same weights and page as the single-page detector
    with pytest.raises(RuntimeError) if not torch.cuda.is_available() else contextlib.nullcontext():
        TextDetector.random_init(input_size=128)  # the card unless the CPU is asked for


def test_compute_dtype_matches_half(port_det):
    img = _pages()[0]
    half = TextDetector(WEIGHTS, input_size=SIZE, device="cpu", half=True)
    by_dtype = TextDetector(WEIGHTS, input_size=SIZE, device="cpu", compute_dtype=torch.bfloat16)
    assert by_dtype.compute_dtype == torch.bfloat16 and port_det.compute_dtype == torch.float32
    a, b = half(img.copy()), by_dtype(img.copy())
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and len(a[2]) == len(b[2])


def test_stage_timer_on_cpu():
    """The span recorder that replaced ``StageTimer``: named stages, their
    nesting, host time and counters, on the CPU."""
    from comic_text_detector_tpu_torch.utils import profiling

    profiling.enable()
    try:
        for _ in range(3):
            with profiling.span("a", profiling.new_unit()):
                sum(range(10000))
                with profiling.span("b"):
                    profiling.count("n", 2)
    finally:
        got = profiling.disable()
    assert [s.name for s in got.spans] == ["a", "b"] * 3
    assert [s.unit for s in got.spans] == [0, 0, 1, 1, 2, 2]
    assert got.paths()[:2] == ["a", "a/b"]
    assert all(s.end_ns > s.start_ns for s in got.spans)
    assert [s.counts for s in got.spans[:2]] == [{}, {"n": 2}]


def test_cli_detect_matches_direct_call(port_det, page_dir, tmp_path):
    from comic_text_detector_tpu_torch.utils.io import NumpyEncoder

    image = os.path.join(page_dir, "page2.png")
    prefix = str(tmp_path / "p2")
    cli.main(["detect", "--model", WEIGHTS, "--image", image, "--out-prefix", prefix,
              "--input-size", str(SIZE), "--device", "cpu"])
    mask, refined, blks = port_det(imread(image), keep_undetected_mask=True)
    np.testing.assert_array_equal(imread(prefix + "-mask.png", grayscale=True), mask)
    np.testing.assert_array_equal(imread(prefix + "-mask-refined.png", grayscale=True), refined)
    with open(prefix + "-blocks.json") as f:
        assert json.load(f) == json.loads(json.dumps([b.to_dict() for b in blks], cls=NumpyEncoder))
    assert len(blks) > 0


def test_cli_annotate_matches_direct_call(annotations, page_dir, tmp_path):
    ours, _ = annotations
    cli.main(["annotate", "--model", WEIGHTS, "--img-dir", page_dir, "--save-dir", str(tmp_path),
              "--save-json", "--input-size", str(SIZE), "--device", "cpu"])
    names = sorted(os.listdir(ours))
    assert sorted(os.listdir(tmp_path)) == names
    _same_files(str(tmp_path), ours, names)


def test_cli_export_writes_a_checked_program(tmp_path, capsys):
    out = str(tmp_path / "ctd.pt2")
    cli.main(["export", "--model", WEIGHTS, "--out", out, "--input-size", "64", "--device", "cpu"])
    assert "parity ok=True" in capsys.readouterr().out
    with open(out + ".json") as f:
        meta = json.load(f)
    assert meta["input"] == [1, 3, 64, 64] and meta["device"] == "cpu"


def test_load_model_file_serves_build_model_and_cli_export(tmp_path):
    """One reader of model files for ``TextDetector`` and the CLI's
    ``export``: a file's weights with the cfg they serve, a given cfg
    kept; exported programs refused as weights."""
    from comic_text_detector_tpu_torch.config import YOLOV5S_CFG
    from comic_text_detector_tpu_torch.models.convert import export_torch_checkpoint
    from comic_text_detector_tpu_torch.weights import load_model_file, load_npz, state_dict_from_jax

    state, cfg = load_model_file(WEIGHTS)
    assert cfg is YOLOV5S_CFG
    want = state_dict_from_jax(load_npz(WEIGHTS), YOLOV5S_CFG)
    assert state.keys() == want.keys() and all(torch.equal(state[k], want[k]) for k in want)
    pt = str(tmp_path / "ctd.pt")
    torch.save(export_torch_checkpoint(load_npz(WEIGHTS), YOLOV5S_CFG), pt)
    state_pt, cfg_pt = load_model_file(pt)
    assert cfg_pt == YOLOV5S_CFG and all(torch.equal(state_pt[k], want[k]) for k in want)
    assert load_model_file(pt, cfg={"given": True})[1] == {"given": True}
    for name in ("model.pt2", "model.stablehlo"):
        with pytest.raises(ValueError):
            load_model_file(str(tmp_path / name))
    with pytest.raises(ValueError):
        cli.main(["export", "--model", str(tmp_path / "model.pt2"), "--out", str(tmp_path / "x.pt2"),
                  "--device", "cpu"])


def _jax_parser() -> argparse.ArgumentParser:
    """The JAX ``cli.main``'s parser, read without running a command."""
    from comic_text_detector_tpu import cli as jax_cli

    class Caught(Exception):
        pass

    seen = {}
    real = argparse.ArgumentParser.parse_args

    def catch(self, *a, **k):
        seen["parser"] = self
        raise Caught

    argparse.ArgumentParser.parse_args = catch
    try:
        jax_cli.main(["detect"])
    except Caught:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen["parser"]


def _tree(parser: argparse.ArgumentParser) -> dict:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {tuple(a.option_strings): (a.required, a.default, a.nargs, a.type)
                   for a in p._actions if a.option_strings and a.dest != "help"}
            for name, p in sub.choices.items()}


def test_cli_commands_and_options_match_jax():
    ours, theirs = _tree(cli.build_parser()), _tree(_jax_parser())
    assert sorted(ours) == sorted(theirs) == ["annotate", "detect", "export", "render", "train-db", "train-seg"]
    for name in theirs:
        extra = {k: v for k, v in ours[name].items() if k not in theirs[name]}
        assert {k: v for k, v in ours[name].items() if k in theirs[name]} == theirs[name], name
        want = {} if name == "render" else {("--device",): (False, "cuda", None, None)}
        if name in ("annotate", "detect"):
            want[("--trace",)] = (False, None, None, None)
        assert extra == want, name
