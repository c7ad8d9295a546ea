"""The port's training data path against the JAX package: PNG reading and
writing (stdlib zlib + NumPy) against Pillow, the Pillow-exact resize on
downscales, letterboxes, augmentations, DB ground-truth maps, the new
geometry, the metrics, and whole SegDataset / DBDataset batches (augment
on, rotate 0) from the same seed and files.  Integer and boolean outputs
bit for bit; float ones within 1e-6 (the code is the same, so they are in
fact equal).
"""

import json
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from comic_text_detector_tpu.data import augment as jax_augment
from comic_text_detector_tpu.data import maps as jax_maps
from comic_text_detector_tpu.data.db_dataset import create_dataloader as jax_db_loader
from comic_text_detector_tpu.data.seg_dataset import create_dataloader as jax_seg_loader
from comic_text_detector_tpu.ops import geometry as jax_geo
from comic_text_detector_tpu.ops import resize as jax_resize
from comic_text_detector_tpu.training import metrics as jax_metrics
from comic_text_detector_tpu.utils import io as jax_io
from comic_text_detector_tpu_torch.data import augment, maps
from comic_text_detector_tpu_torch.data.db_dataset import create_dataloader as db_loader
from comic_text_detector_tpu_torch.data.seg_dataset import create_dataloader as seg_loader
from comic_text_detector_tpu_torch.ops import geometry as geo
from comic_text_detector_tpu_torch.ops import resize
from comic_text_detector_tpu_torch.training import metrics
from comic_text_detector_tpu_torch.utils import io
from comic_text_detector_tpu_torch.utils.log import Loggers


def png_with_filter(samples, ftype):
    """A PNG of uint8 ``samples`` whose every row uses filter ``ftype``."""
    h, w = samples.shape[:2]
    ch = 1 if samples.ndim == 2 else samples.shape[2]
    rows = samples.reshape(h, w * ch).astype(np.int32)
    out = []
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        if ftype == 0:
            f = cur
        elif ftype == 1:
            f = cur - left
        elif ftype == 2:
            f = cur - prev
        elif ftype == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            f = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


MODES = {"L": (23, 31), "LA": (23, 31, 2), "RGB": (23, 31, 3), "RGBA": (23, 31, 4)}


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reader_matches_pillow(mode, tmp_path):
    """Every row filter, every supported mode; pixels and the grey / BGR
    conversions equal Pillow's (and the JAX package's imread)."""
    rng = np.random.default_rng(0)
    base = np.add.outer(np.arange(23) * 7, np.arange(31) * 3) % 256
    shape = MODES[mode]
    samples = (base if len(shape) == 2 else base[..., None]) + rng.integers(0, 40, shape)
    samples = (samples % 256).astype(np.uint8)
    for ftype in range(5):
        path = tmp_path / f"{mode}_{ftype}.png"
        path.write_bytes(png_with_filter(samples, ftype))
        np.testing.assert_array_equal(np.asarray(Image.open(path)), samples)
        for grey in (False, True):
            np.testing.assert_array_equal(io.imread(str(path), grey), jax_io.imread(str(path), grey))
    path = tmp_path / f"{mode}_pil.png"  # Pillow's own adaptive filtering
    Image.fromarray(samples, mode).save(path)
    for grey in (False, True):
        np.testing.assert_array_equal(io.imread(str(path), grey), jax_io.imread(str(path), grey))


@pytest.mark.parametrize("shape", [(23, 31), (23, 31, 3), (23, 31, 4)])
def test_png_writer_matches_pillow(shape, tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    io.imwrite(str(tmp_path / "port.jpg"), img)  # the extension is forced to .png
    jax_io.imwrite(str(tmp_path / "jax.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))
    assert io.imread(str(tmp_path / "port.png")).shape[:2] == shape[:2]


def test_other_formats_go_through_pillow(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (12, 9, 3), dtype=np.uint8)
    Image.fromarray(img).convert("P").save(tmp_path / "pal.png")  # palette PNG
    io.imwrite(str(tmp_path / "x"), img, ext=".bmp")
    for name in ("pal.png", "x.bmp"):
        for grey in (False, True):
            np.testing.assert_array_equal(io.imread(str(tmp_path / name), grey),
                                          jax_io.imread(str(tmp_path / name), grey))
    assert io.find_all_imgs(str(tmp_path)) == jax_io.find_all_imgs(str(tmp_path))
    obj = {"a": np.arange(3), "b": np.float32(1.5), "c": np.bool_(True), "d": np.int64(4)}
    assert json.dumps(obj, cls=io.NumpyEncoder) == json.dumps(obj, cls=jax_io.NumpyEncoder)


@pytest.mark.parametrize("src,dst", [((768, 544), (512, 363)), ((1400, 1000), (512, 366)), ((100, 300), (7, 100)),
                                     ((33, 47), (31, 40)), ((50, 50), (200, 13)), ((64, 48), (128, 96))])
def test_pillow_resize_matches_pillow(src, dst):
    rng = np.random.default_rng(3)
    for shape in (src, src + (3,)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BILINEAR))
        np.testing.assert_array_equal(resize.resize_pil_bilinear_u8_np(img, dst), ref)


def test_letterboxes_match_jax():
    rng = np.random.default_rng(4)
    for shape in ((700, 500, 3), (300, 640), (128, 128, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        for size in (256, (192, 256), 128):
            for fn in ("letterbox_fast_np", "letterbox_np"):
                a, b = getattr(resize, fn)(img, size), getattr(jax_resize, fn)(img, size)
                np.testing.assert_array_equal(a[0], b[0])
                assert a[1:] == b[1:]
            for fast in (True, False):
                np.testing.assert_array_equal(resize.resize_keepasp_np(img, 200, fast=fast),
                                              jax_resize.resize_keepasp_np(img, 200, fast=fast))
    f = rng.random((70, 50)).astype(np.float32)
    np.testing.assert_allclose(resize.letterbox_fast_np(f, 64)[0], jax_resize.letterbox_fast_np(f, 64)[0],
                               rtol=0, atol=1e-6)


def test_augments_match_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    a = augment.augment_hsv(img.copy(), rng=np.random.RandomState(9))
    b = jax_augment.augment_hsv(img.copy(), rng=np.random.RandomState(9))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(augment.flip_lr(img), jax_augment.flip_lr(img))
    np.testing.assert_array_equal(augment.negate(img), jax_augment.negate(img))
    ann = rng.uniform(0.1, 0.9, (3, 4, 2))
    for polys in (ann, np.zeros((0, 4, 2))):
        ia, pa = augment.rotate_image_and_polys(img, polys, 33.0)
        ib, pb = jax_augment.rotate_image_and_polys(img, polys, 33.0)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-6)


def random_polys(rng, n, h, w):
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(10, w - 10), rng.uniform(10, h - 10)
        r = rng.uniform(1, 25, 4)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 4))
        out.append(np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1))
    return out


def test_geometry_matches_jax():
    rng = np.random.default_rng(6)
    polys = random_polys(rng, 24, 120, 160)
    for a, b in zip(polys[::2], polys[1::2]):
        ra, rb = jax_geo.min_area_rect(b)[0], geo.min_area_rect(b)[0]
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_allclose(geo.clip_polygon_convex(a, ra), jax_geo.clip_polygon_convex(a, ra), rtol=0, atol=1e-6)
        assert geo.intersection_area_convex(a, ra) == pytest.approx(jax_geo.intersection_area_convex(a, ra), abs=1e-6)
        assert geo.iou_convex(a, ra) == pytest.approx(jax_geo.iou_convex(a, ra), abs=1e-6)
        np.testing.assert_array_equal(geo.fill_polygon(a, 120, 160), jax_geo.fill_polygon(a, 120, 160))
    np.testing.assert_array_equal(geo.fill_polygons(polys + [polys[0][:2]], 120, 160),
                                  jax_geo.fill_polygons(polys + [polys[0][:2]], 120, 160))
    m1, m2 = np.zeros((30, 40), np.uint8), np.zeros((30, 40), np.uint8)
    for p0, p1 in (((-5, 3), (45, 28)), ((3.4, 7.6), (3.4, 7.6)), ((39, 0), (0, 29))):
        geo._draw_line(m1, p0, p1)
        jax_geo._draw_line(m2, p0, p1)
    np.testing.assert_array_equal(m1, m2)


def test_maps_match_jax():
    rng = np.random.default_rng(7)
    h, w = 96, 128
    polys = np.stack([p for p in random_polys(rng, 8, h, w)])
    polys[0] = [[5, 5], [7, 5], [7, 6], [5, 6]]  # under min_text_size: ignored
    for shrink in (0.4, 0.6):
        assert np.allclose(maps.shrink_polygon(polys[1], shrink), jax_maps.shrink_polygon(polys[1], shrink), atol=1e-6)
    outs = []
    for mod in (maps, jax_maps):
        data = {"imgs": np.zeros((h, w, 3), np.uint8), "text_polys": polys.astype(np.int64).copy(),
                "ignore_tags": [False] * len(polys)}
        data = mod.MakeBorderMap(shrink_ratio=0.4)(mod.MakeShrinkMap(shrink_ratio=0.4)(data))
        outs.append(data)
    a, b = outs
    assert a["ignore_tags"] == b["ignore_tags"] and any(a["ignore_tags"])
    for k in ("shrink_map", "shrink_mask", "threshold_map", "threshold_mask"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)


def test_metrics_match_jax():
    rng = np.random.default_rng(8)
    quads = [geo.min_area_rect(p)[0] for p in random_polys(rng, 30, 200, 200)]
    gts = [dict(points=q, ignore=bool(i % 5 == 0)) for i, q in enumerate(quads[:12])]
    preds = [dict(points=q + rng.normal(0, 2, q.shape)) for q in quads[:10]] + [dict(points=q) for q in quads[20:26]]
    ev, jev = metrics.DetectionIoUEvaluator(), jax_metrics.DetectionIoUEvaluator()
    r1, r2 = ev.evaluate_image(gts, preds), jev.evaluate_image(gts, preds)
    assert r1 == r2 and 0 < r1["hmean"] < 1
    assert ev.combine_results([r1, r1]) == jev.combine_results([r2, r2])
    for a, b in zip(quads[:5], quads[5:10]):
        for method in ("union", "intersection"):
            assert metrics.iou_rotate(a, b, method) == pytest.approx(jax_metrics.iou_rotate(a, b, method), abs=1e-6)
    batch = {"text_polys": [np.stack([g["points"] for g in gts])], "ignore_tags": [[g["ignore"] for g in gts]]}
    out = ([np.stack([p["points"] for p in preds])], [rng.uniform(0.3, 1.0, len(preds))])
    for cls in (True, False):
        qa, qb = metrics.QuadMetric(cls), jax_metrics.QuadMetric(cls)
        ga = qa.gather_measure([qa.validate_measure(batch, out)])
        gb = qb.gather_measure([qb.validate_measure(batch, out)])
        assert {k: v.avg for k, v in ga.items()} == {k: v.avg for k, v in gb.items()}
    assert metrics.pixel_prf1(3.0, 10.0, 4.0) == jax_metrics.pixel_prf1(3.0, 10.0, 4.0)
    dets = [np.concatenate([rng.uniform(0, 50, (6, 2)), rng.uniform(50, 100, (6, 2)), rng.random((6, 1)),
                            rng.integers(0, 2, (6, 1))], 1) for _ in range(3)]
    gtb = [np.concatenate([rng.integers(0, 2, (4, 1)), rng.uniform(0, 50, (4, 2)), rng.uniform(50, 100, (4, 2))], 1)
           for _ in range(3)]
    pa, pb = metrics.per_class_ap50(dets, gtb), jax_metrics.per_class_ap50(dets, gtb)
    np.testing.assert_array_equal(pa["ap50"], pb["ap50"])
    assert pa["map50"] == pb["map50"]
    log = Loggers({"logger": {"type": "none"}, "train": {"epochs": 2}})
    log.on_train_epoch_end(0, {"x": 1.0})
    assert log.history == [{"epoch": 0, "x": 1.0}]


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    """Pages of several shapes (tall ones for the mini-mosaic), their masks,
    line files (one empty: a textless page), written by the JAX package's
    Pillow writer."""
    d = tmp_path_factory.mktemp("pages")
    rng = np.random.default_rng(9)
    for i, (h, w) in enumerate([(200, 140), (180, 120), (150, 210), (220, 150), (160, 160), (190, 130)]):
        img = rng.integers(150, 256, (h, w, 3), dtype=np.uint8)
        mask = np.zeros((h, w), np.uint8)
        lines = []
        for _ in range(0 if i == 4 else 3):
            y, x = int(rng.integers(5, h - 40)), int(rng.integers(5, w - 50))
            hh, ww = int(rng.integers(10, 30)), int(rng.integers(15, 45))
            img[y:y + hh, x:x + ww] = rng.integers(0, 60, (hh, ww, 3))
            mask[y:y + hh, x:x + ww] = 255
            lines.append([x, y, x + ww, y, x + ww, y + hh, x, y + hh])
        jax_io.imwrite(str(d / f"p{i}.png"), img)
        jax_io.imwrite(str(d / f"mask-p{i}.png"), mask)
        np.savetxt(str(d / f"line-p{i}.txt"), np.array(lines).reshape(-1, 8), fmt="%d")
    return str(d)


def same_batches(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        if isinstance(a, dict):
            assert set(a) == set(b)
            pairs = [(a[k], b[k]) for k in a]
        else:
            pairs = list(zip(a, b))
        for x, y in pairs:
            if isinstance(x, list):
                assert len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y))
            else:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def epochs(dataset, loader, n=2):
    out = []
    for _ in range(n):
        dataset.initialize()
        out += list(loader)
    return out


AUG = {"hsv": 0.5, "flip_lr": 0.5, "neg": 0.3, "mini_mosaic": 0.5, "rotate": 0.0, "rotate_range": [-70, 70],
       "size_range": [0.5, 1.0]}


def test_seg_dataset_matches_jax(pages):
    np.random.seed(0)  # the JAX augment_hsv draws from NumPy's global generator
    jd, jl = jax_seg_loader(pages, "", 256, 2, augment=True, aug_param=AUG, shuffle=True, as_uint8=True)
    ref = epochs(jd, jl)
    d, l = seg_loader(pages, "", 256, 2, augment=True, aug_param=AUG, shuffle=True, as_uint8=True)
    same_batches(epochs(d, l), ref)
    jd, jl = jax_seg_loader(pages, "", 128, 4)
    d, l = seg_loader(pages, "", 128, 4)
    same_batches(list(l), list(jl))


@pytest.mark.parametrize("prepared, rotate", [pytest.param(False, 0.0, id="False"), pytest.param(True, 0.0, id="True"),
                                              pytest.param(False, 0.5, id="rotate")])
def test_db_dataset_matches_jax(pages, prepared, rotate):
    aug = {k: v for k, v in AUG.items() if k not in ("mini_mosaic", "size_range")} if prepared else AUG
    aug = {**aug, "rotate": rotate}
    kw = dict(augment=True, aug_param=aug, shuffle=True, as_uint8=True)
    np.random.seed(0)
    jd, jl = jax_db_loader(pages, "", 256, 2, **kw)
    d, l = db_loader(pages, "", 256, 2, **kw)
    if prepared:
        jd.enable_prepared_cache()
        d.enable_prepared_cache()
    ref = epochs(jd, jl)
    same_batches(epochs(d, l), ref)
    jd, jl = jax_db_loader(pages, "", 128, 3, with_ann=True)
    d, l = db_loader(pages, "", 128, 3, with_ann=True)
    same_batches(list(l), list(jl))


ROTATE_ANGLES = [0, 90, -90, 180, 270, 360, 0.5, 15.01, 33, 45, -70, 70]


@pytest.mark.parametrize("degrees", ROTATE_ANGLES)
def test_rotate_matches_jax(degrees):
    """The port's NumPy rotate against the JAX package's Pillow one: images
    and polygons bit for bit, 3-channel and 2-D uint8 pages of odd sizes,
    with polygons and without."""
    rng = np.random.default_rng(int(degrees * 100) % 997)
    for shape in ((37, 53, 3), (53, 37), (40, 56, 3), (1, 9, 3), (9, 1), (2, 2)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        for polys in (rng.uniform(0.1, 0.9, (3, 4, 2)), np.zeros((0, 4, 2))):
            ia, pa = augment.rotate_image_and_polys(img, polys, degrees)
            ib, pb = jax_augment.rotate_image_and_polys(img, polys, degrees)
            assert ia.dtype == ib.dtype and ia.shape == ib.shape, shape
            np.testing.assert_array_equal(ia, ib)
            assert pa.dtype == pb.dtype
            np.testing.assert_array_equal(pa, pb)
    with pytest.raises(ValueError):
        augment.rotate_bilinear_expand(np.zeros((4, 4, 4), np.uint8), 10.0)


def test_db_epoch_rotates_without_pillow(pages, monkeypatch):
    """A DB dataset epoch with the rotate always on while Pillow cannot be
    imported: the port reads PNG and rotates in NumPy."""
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    aug = {**AUG, "rotate": 1.0}
    d, l = db_loader(pages, "", 128, 2, augment=True, aug_param=aug, shuffle=True, as_uint8=True)
    batches = epochs(d, l, 1)
    assert len(batches) == 3
    for batch in batches:
        for v in batch.values():
            assert np.isfinite(v.astype(np.float64)).all()
