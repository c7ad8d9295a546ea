"""Port's component statistics, DB decode routes, host decoders and
``SegDetectorRepresenter`` vs the JAX package; thresholding and
``nms_batch`` too.

Tolerances:

* labels, ids, areas, bounding boxes, ``valid``, counts, quads and polygons
  are integers or booleans: equal;
* ``value_sum`` and scores: the port sums each component in raster order
  on the CPU, the order of JAX's scatter-add, so they are bit-equal;
* the DB decode's rotated boxes (float32): within 1e-3 px, except where two
  of the 90 angles give float32-tied areas and 1-ulp differences in cos/sin
  between the frameworks pick the other one (``tests/test_torch_ops.py``);
  such a flip must keep the box's area within 1e-4 relative;
* ``boxes_from_stats`` and the quad-mode representer on the port's host
  library against the JAX package's native C++ route: equal (the library
  is the extension's code behind a plain-C interface,
  ``tests/test_torch_native.py``); the NumPy routes are held against each
  other with both packages' ``get_native`` patched to return None.

The map over 1M elements (1088x1024) holds a repaired fault: the port's
decode used to raise there.  The JAX side of that test takes about 5 s on
one CPU worker, the port's 0.2 s.
"""

import os

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

import comic_text_detector_tpu.native as jnative
import comic_text_detector_tpu_torch.native as tnative
from comic_text_detector_tpu.models.detector import build_inference_model as jax_build
from comic_text_detector_tpu.ops import cc as jcc
from comic_text_detector_tpu.ops import db_decode as jdb
from comic_text_detector_tpu.ops import nms as jnms
from comic_text_detector_tpu.ops import thresholding as jth
from comic_text_detector_tpu.postproc.db_rep import SegDetectorRepresenter as JaxRep
from comic_text_detector_tpu.training.checkpoint import load_compact
from comic_text_detector_tpu_torch.models.detector import build_inference_model
from comic_text_detector_tpu_torch.ops import cc as tcc
from comic_text_detector_tpu_torch.ops import db_decode as tdb
from comic_text_detector_tpu_torch.ops import nms as tnms
from comic_text_detector_tpu_torch.ops import thresholding as tth
from comic_text_detector_tpu_torch.ops.resize import letterbox_device_u8
from comic_text_detector_tpu_torch.postproc.db_rep import SegDetectorRepresenter
from comic_text_detector_tpu_torch.weights import state_dict_from_jax
from tests.torch_native_oracle import jax_ext  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")


def _shrink_map(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth probability map: rotated bars of text-line size, speckle."""
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.float32)
    yy, xx = np.mgrid[-20:20, -20:20].astype(np.float32)
    for _ in range(h * w // 1500):
        cy, cx = rng.integers(20, h - 20), rng.integers(20, w - 20)
        ang = rng.uniform(0, np.pi)
        length, width = rng.uniform(4, 18), rng.uniform(1.5, 4)
        u = xx * np.cos(ang) + yy * np.sin(ang)
        v = -xx * np.sin(ang) + yy * np.cos(ang)
        bar = ((np.abs(u) < length) & (np.abs(v) < width)) * rng.uniform(0.5, 0.95)
        win = m[cy - 20 : cy + 20, cx - 20 : cx + 20]
        np.maximum(win, bar, out=win)
    m = ndimage.gaussian_filter(m, 1.0) + 0.25 * (rng.random((h, w)) < 0.02)
    return np.clip(m, 0, 1).astype(np.float32)


def _box_area(box: np.ndarray) -> float:
    return float(np.linalg.norm(box[1] - box[0]) * np.linalg.norm(box[2] - box[1]))


def _assert_decode_equal(got, ref) -> int:
    """(boxes, scores, valid) of the port against JAX's; returns the number
    of angle flips between tied areas."""
    (tb, ts, tv), (jb, js, jv) = ([np.asarray(a) for a in x] for x in (got, ref))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ts, js)
    far = np.abs(tb - jb).reshape(len(tb), -1).max(axis=1) > 1e-3
    for i in np.nonzero(far)[0]:
        np.testing.assert_allclose(_box_area(tb[i]), _box_area(jb[i]), rtol=1e-4)
    return int(far.sum())


@pytest.fixture(scope="module")
def maps():
    return [_shrink_map(256, 256, 0), _shrink_map(192, 256, 1), _shrink_map(256, 160, 2)]


# ---------------------------------------------------------------------------
# component statistics and the device half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [256, 24])
def test_component_stats_matches_jax(maps, capacity):
    for sm in maps:
        bitmap = sm > 0.3
        labels = np.array(jcc.connected_components(jnp.asarray(bitmap), 8, "xla"))
        ref = jcc.component_stats(jnp.asarray(labels), jnp.asarray(sm), capacity)
        got = tcc.component_stats(torch.from_numpy(labels), torch.from_numpy(sm), capacity)
        assert int(got.count) == int(ref.count) > 0
        for field in ("area", "xmin", "ymin", "xmax", "ymax", "value_sum", "compact_labels"):
            g, r = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
            assert g.dtype == r.dtype, field
            np.testing.assert_array_equal(g, r, err_msg=field)
        no_values = tcc.component_stats(torch.from_numpy(labels), None, capacity)
        assert not no_values.value_sum.any()
        np.testing.assert_array_equal(no_values.area.numpy(), np.asarray(ref.area))


def test_db_device_decode_matches_jax(maps):
    for sm in maps:
        ref = jdb.db_device_decode(jnp.asarray(sm), 0.3)
        got = tdb.db_device_decode(torch.from_numpy(sm), 0.3)
        for field in ref._fields:
            np.testing.assert_array_equal(np.asarray(getattr(got, field)), np.asarray(getattr(ref, field)),
                                          err_msg=field)


# ---------------------------------------------------------------------------
# the DB decode's label route (the repair)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,capacity,max_boundary", [(0, 256, 8192), (1, 16, 1200)])
def test_label_route_matches_jax(seed, capacity, max_boundary):
    sm = _shrink_map(256, 256, seed)
    ref = jdb.db_decode_full_device(jnp.asarray(sm), 0.3, capacity, 90, max_boundary, False)
    got = tdb.db_decode_full_device(torch.from_numpy(sm), 0.3, capacity, 90, max_boundary, rank_ids=False)
    assert np.asarray(ref[2]).sum() > 1
    _assert_decode_equal(got, ref)
    # both routes of the port give the same outputs
    ranked = tdb.db_decode_full_device(torch.from_numpy(sm), 0.3, capacity, 90, max_boundary, rank_ids=True)
    for a, b in zip(got, ranked):
        assert torch.equal(a, b)


def test_batch_label_route_matches_jax(maps):
    stack = np.stack([maps[0][:192, :160], maps[1][:192, :160], maps[2][:192, :160]])
    got = tdb.db_decode_batch(torch.from_numpy(stack), 0.3, rank_ids=False)
    for i in range(3):
        ref = jdb.db_decode_full_device(jnp.asarray(stack[i]), 0.3, rank_ids=False)
        _assert_decode_equal([t[i] for t in got], ref)


def test_decode_of_a_map_over_1m_elements_matches_jax():
    """1088x1024 (1.1M elements): the port's default route labels it through
    ``connected_components`` (the plain route here, K4 on the card); it used
    to raise in ``cc_ids_windows_local``."""
    sm = _shrink_map(1088, 1024, 3)
    ref = jdb.db_decode_full_device(jnp.asarray(sm), 0.3)
    got = tdb.db_decode_full_device(torch.from_numpy(sm), 0.3)
    assert np.asarray(ref[2]).sum() > 20
    _assert_decode_equal(got, ref)
    batch = tdb.db_decode_batch(torch.from_numpy(sm)[None], 0.3)
    for a, b in zip(batch, got):
        assert torch.equal(a[0], b)


# ---------------------------------------------------------------------------
# host decoders
# ---------------------------------------------------------------------------


def _stats_pair(sm: np.ndarray):
    return jdb.db_device_decode(jnp.asarray(sm), 0.3), tdb.db_device_decode(torch.from_numpy(sm), 0.3)


def test_boxes_from_stats_matches_jax_numpy_route(maps, monkeypatch):
    monkeypatch.setattr(jnative, "get_native", lambda: None)
    monkeypatch.setattr(tnative, "get_native", lambda: None)
    for sm in maps:
        jstats, tstats = _stats_pair(sm)
        for dest in ((256, 256), (512, 384)):
            jb, js = jdb.boxes_from_stats(jstats, *dest, sm.shape[1], sm.shape[0])
            tb, ts = tdb.boxes_from_stats(tstats, *dest, sm.shape[1], sm.shape[0])
            assert len(jb) > 3
            np.testing.assert_array_equal(tb, jb)
            np.testing.assert_array_equal(ts, js)
    few = tdb.boxes_from_stats(tstats, 256, 256, 256, 256, max_candidates=2)
    assert len(few[0]) <= 2


def test_boxes_from_stats_near_jax_native_route(maps, jax_ext, monkeypatch):
    monkeypatch.setattr(jnative, "get_native", lambda: jax_ext)
    for sm in maps:
        jstats, tstats = _stats_pair(sm)
        for dest in ((256, 256), (512, 384)):
            jb, js = jdb.boxes_from_stats(jstats, *dest, sm.shape[1], sm.shape[0])
            tb, ts = tdb.boxes_from_stats(tstats, *dest, sm.shape[1], sm.shape[0])
            assert len(jb) > 3
            np.testing.assert_array_equal(tb, jb)
            np.testing.assert_array_equal(ts, js)
        for kw in ({"max_candidates": 2}, {"min_sside": 6.0}, {"unclip_ratio": 2.0}):
            jb, js = jdb.boxes_from_stats(jstats, 256, 256, sm.shape[1], sm.shape[0], **kw)
            tb, ts = tdb.boxes_from_stats(tstats, 256, 256, sm.shape[1], sm.shape[0], **kw)
            np.testing.assert_array_equal(tb, jb)
            np.testing.assert_array_equal(ts, js)
    empty = tdb.db_device_decode(torch.zeros(64, 64), 0.3)
    assert tdb.boxes_from_stats(empty, 64, 64, 64, 64)[0].shape == (0, 4, 2)


def test_polygons_from_stats_matches_jax(maps):
    for sm in maps:
        jstats, tstats = _stats_pair(sm)
        for box_thresh in (0.7, 0.3):
            jp, js = jdb.polygons_from_stats(jstats, 512, 384, sm.shape[1], sm.shape[0], box_thresh=box_thresh)
            tp, ts = tdb.polygons_from_stats(tstats, 512, 384, sm.shape[1], sm.shape[0], box_thresh=box_thresh)
            assert len(tp) == len(jp)
            for a, b in zip(tp, jp):
                np.testing.assert_array_equal(a, b)
            assert ts == js
    assert len(jp) > 3


def test_trace_boundary_and_douglas_peucker_match_jax():
    rng = np.random.default_rng(4)
    for k in range(6):
        m = ndimage.binary_dilation(rng.random((24, 31)) < 0.08, iterations=k % 3 + 1)
        c_j, c_t = jdb.trace_boundary(m), tdb.trace_boundary(m)
        np.testing.assert_array_equal(c_t, c_j)
        for eps in (0.5, 2.0):
            np.testing.assert_array_equal(tdb.douglas_peucker_closed(c_t.astype(np.float64), eps),
                                          jdb.douglas_peucker_closed(c_j.astype(np.float64), eps))
    assert tdb.trace_boundary(np.zeros((3, 3), bool)).shape == (0, 2)
    assert len(tdb.trace_boundary(np.eye(1, dtype=bool))) == 1


# ---------------------------------------------------------------------------
# SegDetectorRepresenter on the flagship net's DB maps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def net_maps():
    """The flagship net's DB maps of one rendered page at 256: the port's
    (B, 2, H, W) and JAX's (B, H, W, 2)."""
    from comic_text_detector_tpu.data.render import ComicTextRenderer

    rng = np.random.default_rng(5)
    bg = rng.integers(215, 250, (320, 256, 3)).astype(np.uint8)
    page = ComicTextRenderer(seed=5, blocks_per_page=(4, 7)).render_page(bg)["img"]
    lb = letterbox_device_u8(torch.from_numpy(np.ascontiguousarray(page)), 256)
    x = lb[None].float() / 255.0
    variables = load_compact(WEIGHTS)
    model = build_inference_model()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        lines_t = model(x.permute(0, 3, 1, 2))[2]
    lines_j = jax.jit(jax_build(act="leaky").apply)(variables, jnp.asarray(x.numpy()))[2]
    return lines_t.numpy(), np.asarray(lines_j)


@pytest.mark.parametrize("polygon", [False, True])
def test_seg_detector_representer_matches_jax(net_maps, polygon, monkeypatch):
    monkeypatch.setattr(jnative, "get_native", lambda: None)
    monkeypatch.setattr(tnative, "get_native", lambda: None)
    lines_nchw, lines_nhwc = net_maps
    # the net's line scores on this page are 0.3-0.45: a box_thresh of 0.3
    # keeps polygons to compare
    rep = SegDetectorRepresenter(thresh=0.3, box_thresh=0.3, device="cpu")
    jrep = JaxRep(thresh=0.3, box_thresh=0.3)
    n = 0
    for nchw in (lines_nchw, lines_nhwc.transpose(0, 3, 1, 2)):  # the port's maps, then JAX's
        nhwc = np.ascontiguousarray(nchw.transpose(0, 2, 3, 1))
        jb, js = jrep(None, jnp.asarray(nhwc), is_output_polygon=polygon)
        for pred in (torch.from_numpy(nchw), nchw, torch.from_numpy(nhwc), nhwc):
            tb, ts = rep(None, pred, is_output_polygon=polygon)
            assert len(tb) == len(jb) == 1
            assert len(tb[0]) == len(jb[0])
            for a, b in zip(tb[0], jb[0]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ts[0], js[0])
        n = len(jb[0])
    assert n > 3
    with pytest.raises(ValueError):
        rep(None, lines_nchw[0])


def test_seg_detector_representer_native_route_matches_jax(net_maps, maps, jax_ext, monkeypatch):
    """Quad mode through the port's host library against the JAX
    representer through its native extension: equal."""
    monkeypatch.setattr(jnative, "get_native", lambda: jax_ext)
    lines_nchw, _ = net_maps
    synthetic = np.stack([np.stack([m[:192, :160]] * 2) for m in maps])  # (3, 2, 192, 160)
    n = 0
    for pred, box_thresh in ((lines_nchw, 0.3), (synthetic, 0.7), (synthetic, 0.3)):
        rep = SegDetectorRepresenter(thresh=0.3, box_thresh=box_thresh, device="cpu")
        jrep = JaxRep(thresh=0.3, box_thresh=box_thresh)
        jb, js = jrep(None, jnp.asarray(np.ascontiguousarray(pred.transpose(0, 2, 3, 1))))
        tb, ts = rep(None, torch.from_numpy(pred))
        assert len(tb) == len(jb) == len(pred)
        for a, b, sa, sb in zip(tb, jb, ts, js):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            np.testing.assert_array_equal(sa, sb)
            n += len(a)
    assert n > 10


# ---------------------------------------------------------------------------
# thresholding and nms_batch
# ---------------------------------------------------------------------------


def test_thresholding_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    img[20:60, 30:90] = rng.integers(0, 60, (40, 60, 3))
    grey_j = np.asarray(jth.bgr2gray(jnp.asarray(img)))
    grey_t = tth.bgr2gray(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(grey_t, grey_j)
    every = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(0, 256, 3)), -1).reshape(-1, 1, 3)
    every = every.astype(np.uint8)
    np.testing.assert_array_equal(tth.bgr2gray(torch.from_numpy(every)).numpy(),
                                  np.asarray(jth.bgr2gray(jnp.asarray(every))))
    mask = rng.random(grey_j.shape) < 0.7
    for m in (None, mask, (mask * 255).astype(np.uint8)):
        mj = None if m is None else jnp.asarray(m)
        mt = None if m is None else torch.from_numpy(m)
        np.testing.assert_array_equal(tth.histogram256(torch.from_numpy(grey_j), mt).numpy(),
                                      np.asarray(jth.histogram256(jnp.asarray(grey_j), mj)))
        tj, bj = jth.otsu_threshold(jnp.asarray(grey_j), mj)
        tt, bt = tth.otsu_threshold(torch.from_numpy(grey_j), mt)
        assert int(tt) == int(tj)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(tth.in_range(torch.from_numpy(grey_j), 40, 200).numpy(),
                                  np.asarray(jth.in_range(jnp.asarray(grey_j), 40, 200)))
    other = rng.integers(0, 256, grey_j.shape, dtype=np.uint8)
    assert int(tth.xor_sum(torch.from_numpy(grey_j), torch.from_numpy(other))) == int(
        jth.xor_sum(jnp.asarray(grey_j), jnp.asarray(other)))


def test_nms_batch_matches_jax():
    rng = np.random.default_rng(7)
    n = 300
    preds = []
    for _ in range(3):
        c = rng.uniform(20, 230, (12, 2))[rng.integers(0, 12, n)] + rng.normal(0, 4, (n, 2))
        wh = rng.uniform(8, 60, (n, 2))
        obj = rng.choice([0.3, 0.45, 0.6, 0.8, 0.95], n)
        cls = rng.choice([0.5, 0.9, 1.0], (n, 2))
        preds.append(np.concatenate([c, wh, obj[:, None], cls], axis=1))
    pred = np.stack(preds).astype(np.float32)
    rows_j, count_j = jnms.nms_batch(jnp.asarray(pred), 0.4, 0.35)
    rows_t, count_t = tnms.nms_batch(torch.from_numpy(pred), 0.4, 0.35)
    np.testing.assert_array_equal(count_t.numpy(), np.asarray(count_j))
    assert count_t.min() > 0
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
