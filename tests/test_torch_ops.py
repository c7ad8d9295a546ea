"""Port's resize/letterbox, NMS and DB decode vs the JAX package.

Tolerances: resize and letterbox are uint8 and bit-equal (the Pillow-exact
upscale against Pillow itself, imported inside its test); NMS rows and
count are equal; the DB decode's ids and ``valid`` are equal and boxes
within 1e-3 px.  Scores are means of the probability map over each
component: against the JAX scatter-add route (the same order of f32 sums
as the port on the CPU) they agree within 1e-6; the JAX rank-ids route sums
by a one-hot f32 matmul in another order, and the two agree within 5e-5
relative (the largest measured gap is 2.6e-5).  The decode picks each component's min-area
angle by argmin over 90 angles; where two angles give f32-tied areas, 1-ulp
differences in cos/sin between the frameworks may pick the other one.  Such
flips are counted and printed, and only flips between tied areas pass.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from comic_text_detector_tpu.ops import db_decode as jdb
from comic_text_detector_tpu.ops import nms as jnms
from comic_text_detector_tpu.ops import resize as jrs
from comic_text_detector_tpu_torch.ops import db_decode as tdb
from comic_text_detector_tpu_torch.ops import nms as tnms
from comic_text_detector_tpu_torch.ops import resize as trs


def _page(h: int, w: int, seed: int, grey: bool) -> np.ndarray:
    from comic_text_detector_tpu.data.render import ComicTextRenderer

    rng = np.random.default_rng(seed)
    bg = rng.integers(200, 250, (h, w, 3)).astype(np.uint8)
    if grey:
        bg[..., 1] = bg[..., 2] = bg[..., 0]
    img = ComicTextRenderer(seed=seed).render_page(bg)["img"]
    if grey:
        img = np.repeat(img[..., :1], 3, axis=2)
    return img


@pytest.mark.parametrize("out_hw", [(256, 171), (300, 420), (97, 64)])
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_cv2exact_u8_bit_equal(out_hw, channels):
    rng = np.random.default_rng(sum(out_hw) + channels)
    shape = (180, 140, channels) if channels else (180, 140)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    ref = np.asarray(jrs.resize_cv2exact_u8_gather(jnp.asarray(img), out_hw))
    got = trs.resize_cv2exact_u8(torch.from_numpy(img), out_hw).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(trs.resize_cv2exact_u8_np(img, out_hw), jrs.resize_cv2exact_u8_np(img, out_hw))


@pytest.mark.parametrize("hw", [(300, 200), (180, 333), (256, 256)])
def test_letterbox_device_u8_bit_equal(hw):
    img = _page(*hw, seed=hw[0], grey=False)
    assert trs.letterbox_shape(*hw, 256) == jrs.letterbox_shape(*hw, 256)
    ref = np.asarray(jrs.letterbox_device_u8(jnp.asarray(img), 256))
    got = trs.letterbox_device_u8(torch.from_numpy(img), 256).numpy()
    np.testing.assert_array_equal(got, ref)


def test_resize_bilinear_np_matches_jax():
    rng = np.random.default_rng(2)
    f = rng.random((50, 70, 3)).astype(np.float32)
    np.testing.assert_array_equal(trs.resize_bilinear_np(f, (64, 33)), jrs.resize_bilinear_np(f, (64, 33)))
    u = rng.integers(0, 256, (50, 70)).astype(np.uint8)
    np.testing.assert_array_equal(trs.resize_bilinear_np(u, (81, 90)), jrs.resize_bilinear_np(u, (81, 90)))


# upscales: both axes, one axis equal (a single pass), tiny sources, the
# grey mask's own letterbox-to-page shapes, and three channels
_PIL_UPSCALES = [((171, 213), (384, 320), 0), ((256, 183), (1400, 1000), 0), ((174, 256), (1100, 1600), 0),
                 ((50, 70), (50, 211), 0), ((50, 70), (163, 70), 0), ((1, 1), (4, 7), 0), ((3, 9), (4, 9), 0),
                 ((37, 41), (38, 123), 3), ((100, 100), (101, 333), 3), ((2, 2), (513, 257), 0)]


@pytest.mark.parametrize("in_hw,out_hw,channels", _PIL_UPSCALES)
def test_resize_pil_bilinear_matches_pillow(in_hw, out_hw, channels):
    from PIL import Image

    rng = np.random.default_rng(sum(in_hw) + sum(out_hw))
    img = rng.integers(0, 256, in_hw + ((channels,) if channels else ())).astype(np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((out_hw[1], out_hw[0]), Image.BILINEAR))
    got = trs.resize_pil_bilinear_u8_np(img, out_hw)
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("out_hw", [(120, 80), (240, 80), (120, 160), (180, 140)])
def test_resize_bilinear_fast_routes_as_jax(out_hw):
    """Downscale, mixed (one axis down) and identity take the cv2-exact
    route, a two-axis upscale the Pillow one; all bit-equal to the JAX
    function, and the non-Pillow routes to the cv2-exact resize.  The
    Pillow-exact resize itself takes a mixed resize too (the training
    loaders' letterbox downscales through it), bit-equal to Pillow."""
    from PIL import Image

    img = np.random.default_rng(5).integers(0, 256, (180, 140)).astype(np.uint8)
    got = trs.resize_bilinear_fast(img, out_hw)
    np.testing.assert_array_equal(got, jrs.resize_bilinear_fast(img, out_hw))
    if out_hw[0] < 180 or out_hw[1] < 140:
        np.testing.assert_array_equal(got, trs.resize_cv2exact_u8_np(img, out_hw))
    np.testing.assert_array_equal(trs.resize_pil_bilinear_u8_np(img, (179, 300)),
                                  np.asarray(Image.fromarray(img).resize((300, 179), Image.BILINEAR)))


def _tied_preds(seed: int, n: int = 700) -> np.ndarray:
    """Clustered boxes with quantized confidences: many exact score ties and
    more candidates than MAX_NMS_CANDIDATES."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, 230, (12, 2))
    c = centers[rng.integers(0, 12, n)] + rng.normal(0, 4, (n, 2))
    wh = rng.uniform(8, 60, (n, 2))
    obj = rng.choice([0.3, 0.45, 0.6, 0.8, 0.95], n)
    cls = rng.choice([0.5, 0.9, 1.0], (n, 2))
    return np.concatenate([c, wh, obj[:, None], cls], axis=1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_single_matches_jax(seed):
    pred = _tied_preds(seed)
    rows_j, count_j = jnms.nms_single(jnp.asarray(pred), 0.4, 0.35)
    rows_t, count_t = tnms.nms_single(torch.from_numpy(pred), 0.4, 0.35)
    assert int(count_t) == int(count_j) > 0
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))


def _shrink_map(seed: int, s: int = 256) -> np.ndarray:
    """Smooth probability map with rotated bars, blobs and speckle."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    m = np.zeros((s, s), np.float32)
    for _ in range(14):
        cy, cx = rng.uniform(10, s - 10, 2)
        ang = rng.uniform(0, np.pi)
        L, W = rng.uniform(8, 70), rng.uniform(2, 9)
        u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        v = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
        m = np.maximum(m, ((np.abs(u) < L) & (np.abs(v) < W)) * rng.uniform(0.5, 0.95))
    m = ndimage.gaussian_filter(m, 1.0) + 0.25 * (rng.random((s, s)) < 0.02)
    return np.clip(m, 0, 1).astype(np.float32)


def _box_area(box: np.ndarray) -> float:
    return float(np.linalg.norm(box[1] - box[0]) * np.linalg.norm(box[2] - box[1]))


_SCORE_TOL = {False: dict(rtol=0, atol=1e-6), True: dict(rtol=5e-5, atol=1e-7)}


@pytest.mark.parametrize("rank_ids", [True, False])
@pytest.mark.parametrize("seed,capacity,max_boundary", [(0, 256, 8192), (1, 256, 8192), (2, 16, 1200)])
def test_db_decode_matches_jax(seed, capacity, max_boundary, rank_ids):
    sm = _shrink_map(seed)
    jb, js, jv = (np.asarray(a) for a in jdb.db_decode_full_device(
        jnp.asarray(sm), 0.3, capacity, 90, max_boundary, rank_ids))
    tb, ts, tv = (a.numpy() for a in tdb.db_decode_full_device(
        torch.from_numpy(sm), 0.3, capacity, 90, max_boundary, rank_ids))
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() > 1
    np.testing.assert_allclose(ts, js, **_SCORE_TOL[rank_ids])
    far = np.abs(tb - jb).reshape(len(tb), -1).max(axis=1) > 1e-3
    flips = 0
    for i in np.nonzero(far)[0]:
        # only a flip between two f32-tied min-area angles may differ
        np.testing.assert_allclose(_box_area(tb[i]), _box_area(jb[i]), rtol=1e-4)
        flips += 1
    print(f"db decode seed {seed}: {int(jv.sum())} boxes, {flips} angle flips between tied areas")

    lines_t, sc_t = tdb.boxes_from_device_rects(tb, ts, tv, 512, 512, 256, 256)
    lines_j, sc_j = jdb.boxes_from_device_rects(jb, js, jv, 512, 512, 256, 256)
    if flips == 0:
        np.testing.assert_array_equal(lines_t, lines_j)
    np.testing.assert_allclose(sc_t, sc_j, **_SCORE_TOL[rank_ids])


def test_db_decode_of_the_nets_own_map():
    """The flagship net's shrink map of a rendered page, decoded by both."""
    from comic_text_detector_tpu_torch.models.detector import build_inference_model
    from comic_text_detector_tpu_torch.weights import load_npz, state_dict_from_jax

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = build_inference_model()
    model.load_state_dict(state_dict_from_jax(load_npz(os.path.join(root, "data", "flagship_r2.npz"))))
    img = trs.letterbox_device_u8(torch.from_numpy(_page(320, 256, seed=5, grey=True)), 256)
    with torch.no_grad():
        _, _, lines = model(img.permute(2, 0, 1)[None].float() / 255.0)
    sm = lines[0, 0].numpy()
    jb, js, jv = (np.asarray(a) for a in jdb.db_decode_full_device(jnp.asarray(sm), 0.3, rank_ids=True))
    tb, ts, tv = (a.numpy() for a in tdb.db_decode_full_device(torch.from_numpy(sm), 0.3))
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() > 0
    np.testing.assert_allclose(ts, js, **_SCORE_TOL[True])
    far = np.abs(tb - jb).reshape(len(tb), -1).max(axis=1) > 1e-3
    for i in np.nonzero(far)[0]:
        np.testing.assert_allclose(_box_area(tb[i]), _box_area(jb[i]), rtol=1e-4)
    print(f"net shrink map: {int(jv.sum())} boxes, {int(far.sum())} angle flips between tied areas")
