"""The port's YOLO block trainer against the JAX package.

Narrow graph (YOLOv5s with width_multiple 0.125 and depth_multiple 0.1)
at 128x128, batch 2, with JAX-initialized variables carried across
(``weights.train_state_dict_from_jax``); the AP eval, the hand-off and the
trainer at full width from the flagship weights.

Tolerances, and why:

* dense targets (``_level_targets``): bit for bit, on random labels and on
  labels aimed at its edges (colliding candidates, centres within a cell
  of each border, zero-size and masked labels);
* the Detect bias prior: bit for bit (one float32 add a bias);
* ``ciou_xywh`` and ``yolo_loss`` on random maps: values within 1e-6
  relative (float32 sums in another order), gradients with respect to the
  raw maps within 1e-5 of their max-abs;
* eval-mode net outputs within 1e-4 absolute plus 1e-5 relative
  (decoded rows are pixels up to the canvas size); train-mode maps from
  the port's net in float64 against JAX's float32 ones, within 2e-4 on a
  noise batch and 1.5e-3 on the batch with painted boxes: there the
  eight-channel train-mode BatchNorms normalize near-constant channels
  of the boxes' uniform regions, and JAX's float32 maps lie up to 7.5e-4
  from the float64 ones (maps up to 9.2; the port's float32 ones up to
  9.3e-4, so the two float32 nets differ by up to 3.2e-3); BatchNorm
  running stats after a forward or a step within 1e-5 absolute and
  relative;
* a train step's loss terms within 1e-5 relative; its gradients in the
  pattern of ``tests/test_torch_train_model.py``: the port's float32 step
  within 2e-3 of JAX's in relative L2 over the tree, and the port's
  float64 gradients each leaf within 1e-3 of its max-abs (floor 5e-2 of
  the tree's), not 1e-4: on the same batch JAX's float32 gradients lie
  up to 4.6e-4 of a leaf's max-abs from the port's float64 ones and the
  port's float32 ones up to 2.2e-3 (1.4e-4 on a noise batch); the
  optimizer's update within 1e-6 of optax's on the port's own gradients;
* the AP eval: NMS rows within 1e-3 pixels (and 1e-5 in confidence) of
  JAX's and the same counts, so the matching, and AP50, are the same;
* ``resize_bilinear`` within 1e-5, ``scale_img`` and ``augmented_detect``
  within 1e-4 absolute plus 1e-5 relative (XLA may contract the lerp's
  multiply-adds);
* datasets: images, labels and masks equal, with augment on the same
  draws.
"""

import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from comic_text_detector_tpu.config import YOLOV5S_CFG, full_spec as jax_full_spec
from comic_text_detector_tpu.data.blk_dataset import BlkDataset as JaxBlkDataset
from comic_text_detector_tpu.data.render import ComicTextRenderer, render_comictext
from comic_text_detector_tpu.models.detector import build_blk_train_model as jax_build_blk
from comic_text_detector_tpu.models.yolo import YoloGraph as JaxYoloGraph
from comic_text_detector_tpu.models.yolo import augmented_detect as jax_augmented_detect
from comic_text_detector_tpu.models.yolo import initialize_detect_biases as jax_init_biases
from comic_text_detector_tpu.models.yolo import scale_img as jax_scale_img
from comic_text_detector_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from comic_text_detector_tpu.training import yolo_loss as JL
from comic_text_detector_tpu.training.checkpoint import load_compact as jax_load_compact
from comic_text_detector_tpu.training.steps import create_yolo_train_state as jax_create_state
from comic_text_detector_tpu.training.steps import make_yolo_eval_step as jax_eval_step
from comic_text_detector_tpu.training.yolo_trainer import eval_detection_ap as jax_eval_ap
from comic_text_detector_tpu_torch.config import OUT_INDICES
from comic_text_detector_tpu_torch.data.blk_dataset import MAX_LABELS, BlkDataset, create_dataloader
from comic_text_detector_tpu_torch.models.detector import build_blk_train_model
from comic_text_detector_tpu_torch.models.yolo import augmented_detect, initialize_detect_biases, scale_img
from comic_text_detector_tpu_torch.ops.resize import resize_bilinear
from comic_text_detector_tpu_torch.training import checkpoint, yolo_trainer
from comic_text_detector_tpu_torch.training import yolo_loss as PL
from comic_text_detector_tpu_torch.training.steps import (
    build_optimizer,
    create_yolo_train_state,
    yolo_eval_step,
    yolo_train_step,
)
from comic_text_detector_tpu_torch.weights import (
    blk_train_from_deploy,
    deploy_from_train,
    load_npz,
    train_from_deploy,
    train_state_dict_from_jax,
    variables_from_state_dict,
)
from tests.test_torch_train_model import check_grads, check_tree_l2, leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
CFG = dict(YOLOV5S_CFG, width_multiple=0.125, depth_multiple=0.1)
S, B, L = 128, 2, 8
GAINS = {"box": 0.07, "obj": 0.8, "cls": 0.5}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts several test processes on
    the same cores, and torch's spinning thread pool slows a train step
    there by 10x or more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_labels(rng, b=B, n=L, valid=5):
    labels = np.zeros((b, n, 5), np.float32)
    labels[..., 0] = rng.integers(0, 2, (b, n))
    labels[..., 1:3] = rng.uniform(0.1, 0.9, (b, n, 2))
    labels[..., 3:5] = rng.uniform(0.05, 0.5, (b, n, 2))
    mask = np.zeros((b, n), bool)
    mask[:, :valid] = True
    return labels, mask


def edge_labels():
    """Labels aimed at ``_level_targets``' edges at a 16x16 grid (and the
    others): a pair with the same box and other classes (their candidates
    collide on every cell and anchor), boxes whose centres sit within one
    cell of each border and on cell borders, a zero-size box, masked
    boxes."""
    rows = [
        [0, 0.40, 0.40, 0.20, 0.20], [1, 0.40, 0.40, 0.20, 0.20],  # collide everywhere
        [1, 0.43, 0.41, 0.19, 0.22],  # overlaps the pair's cells
        [0, 0.01, 0.02, 0.10, 0.08], [1, 0.99, 0.985, 0.12, 0.30],  # corners
        [0, 1.0 / 16, 0.5, 0.2, 0.2], [1, 0.5, 15.0 / 16, 0.2, 0.2],  # one cell from a border
        [0, 0.5, 0.5, 0.0, 0.3],  # zero size
        [1, 0.3, 0.7, 0.3, 0.2], [0, 0.3, 0.7, 0.3, 0.2],  # masked: must not count
        [1, 0.96875, 0.03125, 0.6, 0.9], [0, 0.5, 0.5, 0.95, 0.95],
    ]
    labels = np.asarray([rows, rows[::-1]], np.float32)
    mask = np.ones(labels.shape[:2], bool)
    mask[0, 8:10] = False
    mask[1, 2:4] = False
    return labels, mask


def jax_targets(labels, mask, ag, gh, gw):
    fn = jax.jit(JL._level_targets, static_argnums=(3, 4))
    return np.asarray(fn(jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(ag), gh, gw))


def level_anchors():
    spec = jax_full_spec(CFG)
    return [np.asarray(a, np.float32).reshape(-1, 2) / s for a, s in zip(spec.anchors, spec.strides)]


@pytest.mark.parametrize("case", ["random", "edges"])
def test_level_targets_bit_equal_to_jax(case):
    labels, mask = random_labels(np.random.default_rng(1), n=24, valid=20) if case == "random" else edge_labels()
    for ag, (gh, gw) in zip(level_anchors(), ((16, 16), (8, 12), (4, 4))):
        ref = jax_targets(labels, mask, ag, gh, gw)
        ours = PL._level_targets(torch.from_numpy(labels), torch.from_numpy(mask), torch.from_numpy(ag), gh, gw)
        np.testing.assert_array_equal(ours.numpy(), ref, err_msg=f"{case} {gh}x{gw}")
        assert ref[..., 5].sum() > 0
    if case == "edges":
        # the colliding pair: every cell it takes holds the later label (class 1)
        ag, (gh, gw) = level_anchors()[0], (16, 16)
        pair = PL._level_targets(torch.from_numpy(labels[:1, 1:2]), torch.from_numpy(mask[:1, 1:2]),
                                 torch.from_numpy(ag), gh, gw)
        both = PL._level_targets(torch.from_numpy(labels[:1, :2]), torch.from_numpy(mask[:1, :2]),
                                 torch.from_numpy(ag), gh, gw)
        assert pair[..., 5].sum() > 0 and torch.equal(pair, both)


def test_ciou_matches_jax():
    rng = np.random.default_rng(2)
    a = np.concatenate([rng.uniform(-1, 2, (64, 2)), rng.uniform(0.05, 3, (64, 2))], -1).astype(np.float32)
    b = np.concatenate([rng.uniform(-1, 2, (64, 2)), rng.uniform(0.05, 3, (64, 2))], -1).astype(np.float32)
    b[:8] = a[:8] + np.float32(1e-3)  # near-identical boxes (identical ones give 0 / 0 in both)
    ref_g = jax.grad(lambda x: JL.ciou_xywh(x, jnp.asarray(b)).sum())(jnp.asarray(a))
    ta = torch.tensor(a, requires_grad=True)
    ours = PL.ciou_xywh(ta, torch.from_numpy(b))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(JL.ciou_xywh(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-6)
    ours.sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gains", [None, GAINS])
def test_yolo_loss_matches_jax(gains):
    """Values and gradients with respect to the raw maps, at a 64x64 canvas
    (levels of 8x8, 4x4, 2x2) and with default and other gains."""
    rng = np.random.default_rng(3)
    spec = jax_full_spec(CFG)
    raw = [rng.normal(0, 1.5, (B, 3, 64 // s, 64 // s, 7)).astype(np.float32) for s in spec.strides]
    labels, mask = random_labels(rng)
    g = gains or {}
    kw = dict(box_gain=g.get("box", 0.05), obj_gain=g.get("obj", 1.0), cls_gain=g.get("cls", 0.3))

    def jax_loss(maps):
        return JL.yolo_loss(maps, jnp.asarray(labels), jnp.asarray(mask), spec.anchors, spec.strides, spec.nc, **kw)

    ref = jax.jit(jax_loss)([jnp.asarray(r) for r in raw])
    ref_g = jax.jit(jax.grad(lambda m: jax_loss(m)["loss"]))([jnp.asarray(r) for r in raw])
    maps = [torch.tensor(r, requires_grad=True) for r in raw]
    ours = PL.yolo_loss(maps, torch.from_numpy(labels), torch.from_numpy(mask), spec.anchors, spec.strides,
                        spec.nc, **kw)
    for k, v in ref.items():
        assert float(ours[k].detach()) == pytest.approx(float(v), rel=1e-6), k
    assert float(ref["lcls"]) > 0 and float(ref["lbox"]) > 0
    ours["loss"].backward()
    for m, rg in zip(maps, ref_g):
        rg = np.asarray(rg)
        assert np.abs(m.grad.numpy() - rg).max() <= 1e-5 * np.abs(rg).max()


@pytest.fixture(scope="module")
def jax_model():
    return jax_build_blk(CFG)


@pytest.fixture(scope="module")
def init_vars(jax_model):
    """JAX-initialized narrow variables with the Detect bias prior, as the
    JAX trainer makes them, and random batch statistics (so that eval mode
    reads something other than the identity)."""
    variables = jax.device_get(jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["params"]["blk_det"] = jax.device_get(
        jax_init_biases(dict(variables["params"]["blk_det"]), jax_full_spec(CFG), img_size=S))
    rng = np.random.default_rng(4)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32) if v.ndim else v, variables["batch_stats"])
    return jax.tree_util.tree_map(np.array, variables)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    labels, mask = random_labels(rng)
    for b in range(B):
        for cls, x, y, w, h in labels[b][mask[b]]:
            x0, y0 = int((x - w / 2) * S), int((y - h / 2) * S)
            imgs[b, max(y0, 0):int((y + h / 2) * S), max(x0, 0):int((x + w / 2) * S)] = 30 + 150 * cls
    return imgs, labels, mask


def port_model(variables, cfg=CFG):
    """``BlkDetTrain`` of ``cfg`` holding JAX-layout ``variables``; Detect's
    anchors buffer, which JAX has not, is the model's own."""
    model = build_blk_train_model(cfg)
    sd = train_state_dict_from_jax(variables)
    sd.update((k, v) for k, v in model.state_dict().items() if k.endswith(".anchors"))
    model.load_state_dict(sd, strict=True)
    return model


def nchw(imgs):
    return torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255.0


def test_initialize_detect_biases_bit_equal_to_jax(init_vars):
    variables = jax.tree_util.tree_map(np.array, init_vars)
    rng = np.random.default_rng(6)
    det = variables["params"]["blk_det"]["model_24"]
    for conv in det.values():
        conv["bias"] = rng.normal(0, 1, conv["bias"].shape).astype(np.float32)
    ref = jax.device_get(jax_init_biases(dict(variables["params"]["blk_det"]), jax_full_spec(CFG), img_size=512))
    model = initialize_detect_biases(port_model(variables), img_size=512)
    ours = variables_from_state_dict(model.state_dict())["params"]["blk_det"]
    ref, ours = leaves(ref), leaves(ours)
    assert set(ref) == set(ours)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert not np.array_equal(ref["['model_24']['m_0']['bias']"], det["m_0"]["bias"])


def test_blk_det_outputs_match_jax(jax_model, init_vars, batch):
    """Eval mode: decoded rows and raw maps; train mode: raw maps and the
    updated BatchNorm statistics."""
    imgs = batch[0]
    x = jnp.asarray(imgs).astype(jnp.float32) / 255.0
    model = port_model(init_vars)
    model.eval()
    with torch.no_grad():
        dets, taps = model(nchw(imgs), decode=True)
        raw, _ = model(nchw(imgs))
    ref_dets, ref_taps = jax_model.apply(init_vars, x, decode=True)
    ref_raw, _ = jax_model.apply(init_vars, x)
    np.testing.assert_allclose(dets.numpy(), np.asarray(ref_dets), rtol=1e-5, atol=1e-4)
    assert len(taps) == len(OUT_INDICES)
    for t, r in zip(taps, ref_taps):
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(r), rtol=1e-5, atol=1e-4)
    for o, r in zip(raw, ref_raw):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4)

    noise = np.random.default_rng(10).integers(0, 256, imgs.shape, dtype=np.uint8)
    for batch_imgs, atol in ((noise, 2e-4), (imgs, 1.5e-3)):
        model = port_model(init_vars).double().train()
        with torch.no_grad():
            raw, _ = model(nchw(batch_imgs).double())
        (ref_raw, _), new = jax_model.apply(init_vars, jnp.asarray(batch_imgs).astype(jnp.float32) / 255.0,
                                            train=True, mutable=["batch_stats"])
        for o, r in zip(raw, ref_raw):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=atol)
        got = leaves(variables_from_state_dict(model.state_dict())["batch_stats"])
        for k, v in leaves(jax.device_get(new["batch_stats"])).items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def jax_step(jax_model, init_vars, batch):
    """One jitted JAX value_and_grad of the YOLO step's loss (train mode)
    and the eval step's loss terms on the same state."""
    imgs, labels, mask = batch
    spec = jax_full_spec(CFG)
    params, stats = init_vars["params"], init_vars["batch_stats"]

    @jax.jit
    def run(params, stats):
        def loss_fn(p):
            (raw, _), new = jax_model.apply({"params": p, "batch_stats": stats},
                                            jnp.asarray(imgs).astype(jnp.float32) / 255.0, train=True,
                                            decode=False, mutable=["batch_stats"])
            m = JL.yolo_loss(raw, jnp.asarray(labels), jnp.asarray(mask), spec.anchors, spec.strides, spec.nc,
                             box_gain=GAINS["box"], obj_gain=GAINS["obj"], cls_gain=GAINS["cls"])
            return m["loss"], (m, new["batch_stats"])

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, (metrics, new_stats)), grads = run(params, stats)
    state = jax_create_state(init_vars, optax.adam(1e-3))
    ev = jax_eval_step(jax_model, spec, GAINS)(state, jnp.asarray(imgs), jnp.asarray(labels), jnp.asarray(mask))
    return jax.device_get((metrics, new_stats, grads, ev))


def port_grads(model):
    sd = dict(model.state_dict())
    sd.update({k: p.grad for k, p in model.named_parameters() if p.grad is not None})
    return leaves({"blk_det": variables_from_state_dict(sd)["params"]["blk_det"]})


def test_yolo_train_step_matches_jax(init_vars, batch, jax_step):
    metrics_ref, stats_ref, grads_ref, _ = jax_step
    imgs, labels, mask = batch
    model = port_model(init_vars)
    state = create_yolo_train_state(model, build_optimizer("adam", 1e-3, momentum=0.9, weight_decay=5e-4))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    metrics = yolo_train_step(state, torch.from_numpy(imgs), torch.from_numpy(labels), torch.from_numpy(mask), GAINS)
    for k, v in metrics_ref.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-5), k
    assert all(m.training for m in model.modules())  # every BatchNorm in train mode
    grads_ref = leaves({"blk_det": grads_ref["blk_det"]})
    check_tree_l2(port_grads(model), grads_ref, 2e-3)

    # the port's gradients in float64 (the loss in float32, as the step)
    m64 = port_model(init_vars).double()
    m64.train()
    raw, _ = m64(torch.from_numpy(imgs).permute(0, 3, 1, 2).double() / 255.0)
    spec = m64.spec
    PL.yolo_loss(raw, torch.from_numpy(labels), torch.from_numpy(mask), spec.anchors, spec.strides, spec.nc,
                 box_gain=GAINS["box"], obj_gain=GAINS["obj"], cls_gain=GAINS["cls"])["loss"].backward()
    check_grads(port_grads(m64), grads_ref, 1e-3)

    got = leaves(variables_from_state_dict(model.state_dict())["batch_stats"])
    for k, v in leaves(stats_ref).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
    # the update is optax's chain on the port's own gradients
    params = {k: before[k].numpy() for k in before}
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.adam(1e-3, b1=0.9, b2=0.999))
    upd, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, upd)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new[k], rtol=0, atol=1e-6, err_msg=k)


def test_yolo_eval_step_matches_jax(init_vars, batch, jax_step):
    ev_ref = jax_step[3]
    imgs, labels, mask = batch
    state = create_yolo_train_state(port_model(init_vars), build_optimizer("adam", 1e-3))
    ev = yolo_eval_step(state, torch.from_numpy(imgs), torch.from_numpy(labels), torch.from_numpy(mask), GAINS)
    for k, v in ev_ref.items():
        assert float(ev[k]) == pytest.approx(float(v), rel=1e-5), k
    assert not state.model.training


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    """Five rendered pages (PNG, YOLO labels, masks, line quads) from the
    JAX package's renderer, of three shapes."""
    root = tmp_path_factory.mktemp("blk")
    bg = root / "bg"
    bg.mkdir()
    from comic_text_detector_tpu_torch.utils.io import imwrite

    rng = np.random.default_rng(7)
    for i, (h, w) in enumerate([(400, 280), (300, 420), (360, 360), (420, 300), (256, 320)]):
        imwrite(str(bg / f"p{i}.png"), rng.integers(200, 256, (h, w, 3), dtype=np.uint8))
    out = str(root / "ds")
    assert render_comictext(str(bg), out, renderer=ComicTextRenderer(seed=3, bubble_prob=0.6)) == 5
    return out


@pytest.mark.parametrize("augment,as_uint8", [(False, False), (True, True), (True, False)])
def test_blk_dataset_matches_jax(pages, augment, as_uint8):
    aug = {"hsv": 0.7, "flip_lr": 0.5, "neg": 0.3}
    ref = JaxBlkDataset(pages, img_size=256, augment=augment, aug_param=aug, seed=3, as_uint8=as_uint8)
    ours = BlkDataset(pages, img_size=256, augment=augment, aug_param=aug, seed=3, as_uint8=as_uint8)
    assert ours.pairs == ref.pairs and len(ours) == 5
    np.random.seed(3)  # the JAX HSV jitter draws from NumPy's global generator
    n_labels = 0
    for i in range(len(ref)):
        got, want = ours[i], ref[i]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert got[1].shape == (MAX_LABELS, 5)
        n_labels += int(want[2].sum())
    assert n_labels >= 5


@pytest.fixture(scope="module")
def deploy():
    return jax_load_compact(WEIGHTS)


def test_eval_detection_ap_matches_jax(pages, deploy):
    """Flagship blk_det, 256x256, the 5 pages in batches of 2 (one
    dropped, as the loaders drop the last short batch)."""
    variables = blk_train_from_deploy(load_npz(WEIGHTS))
    state = jax_create_state({k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()},
                             optax.adam(1e-3))
    _, loader = create_dataloader(pages, 256, 2, augment=False, shuffle=False, as_uint8=True)
    ref = jax_eval_ap(jax_build_blk(), state, loader, nc=2)
    ours_state = create_yolo_train_state(yolo_trainer.build_model(variables), build_optimizer("adam", 1e-3))
    ours = yolo_trainer.eval_detection_ap(ours_state, loader, nc=2)
    np.testing.assert_array_equal(ours["n_gt"], ref["n_gt"])
    np.testing.assert_allclose(ours["ap50"], ref["ap50"], rtol=0, atol=1e-12)
    assert ref["n_gt"].sum() >= 4
    # the NMS rows the AP reads
    imgs = next(iter(loader))[0]
    rows, counts = yolo_trainer.detect_batch(ours_state, torch.from_numpy(imgs))
    dets, _ = jax_build_blk().apply({"params": variables["params"], "batch_stats": variables["batch_stats"]},
                                    jnp.asarray(imgs).astype(jnp.float32) / 255.0, decode=True)
    from comic_text_detector_tpu.ops.nms import nms_single as jax_nms

    for b in range(len(imgs)):
        ref_rows, ref_count = jax_nms(dets[b], 0.1, 0.45)
        assert int(counts[b]) == int(ref_count) and int(ref_count) > 0
        n = int(ref_count)
        np.testing.assert_allclose(rows[b, :n, :4].numpy(), np.asarray(ref_rows)[:n, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(rows[b, :n, 4:].numpy(), np.asarray(ref_rows)[:n, 4:], rtol=0, atol=1e-5)


def test_resize_bilinear_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (3, 37, 53)).astype(np.float32)
    for out_hw in ((30, 44), (37, 53), (64, 90), (1, 7)):
        ref = np.asarray(jax.jit(jax_resize_bilinear, static_argnums=1)(jnp.asarray(x.transpose(1, 2, 0)), out_hw))
        ours = resize_bilinear(torch.from_numpy(x)[None], out_hw)[0]
        np.testing.assert_allclose(ours.permute(1, 2, 0).numpy(), ref, rtol=0, atol=1e-5)


def test_scale_img_and_augmented_detect_match_jax(init_vars):
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    for ratio in (1.0, 0.83, 0.67):
        ref = np.asarray(jax_scale_img(jnp.asarray(x), ratio))
        ours = scale_img(torch.from_numpy(x).permute(0, 3, 1, 2), ratio)
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5, atol=1e-5)
    graph = JaxYoloGraph(spec=jax_full_spec(CFG), out_indices=OUT_INDICES, act="silu")
    variables = {"params": init_vars["params"]["blk_det"], "batch_stats": init_vars["batch_stats"]["blk_det"]}
    ref = np.asarray(jax.jit(lambda v, x: jax_augmented_detect(graph, v, x))(variables, jnp.asarray(x)))
    model = port_model(init_vars).eval()
    ours = augmented_detect(model.blk_det, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_yolo_train_tree_round_trips(deploy, tmp_path):
    """blk_det variables -> BlkDetTrain (strict) -> variables bit for bit;
    the tree saved compact reads back in JAX's load_compact; a trained
    blk_det replaces the deploy tree's."""
    ours = blk_train_from_deploy(load_npz(WEIGHTS))
    model = port_model(ours, YOLOV5S_CFG)
    back = variables_from_state_dict(model.state_dict())
    ref = leaves({col: {"blk_det": deploy[col]["blk_det"]} for col in deploy})
    got = leaves(back)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    checkpoint.save_compact(str(tmp_path / "yolo.npz"), back)
    read = leaves(jax_load_compact(str(tmp_path / "yolo.npz")))
    for k, v in leaves(checkpoint.load_compact(str(tmp_path / "yolo.npz"))).items():
        np.testing.assert_array_equal(v, read[k], err_msg=k)
    back["params"]["blk_det"]["model_24"]["m_1"]["bias"] = back["params"]["blk_det"]["model_24"]["m_1"]["bias"] + 1
    out = deploy_from_train(back, load_npz(WEIGHTS))
    np.testing.assert_array_equal(out["params"]["blk_det"]["model_24"]["m_1"]["bias"],
                                  deploy["params"]["blk_det"]["model_24"]["m_1"]["bias"] + 1)
    assert out["params"]["text_seg"].keys() == deploy["params"]["text_seg"].keys()


def test_handoff_gives_jax_backbone_split(deploy):
    """scripts/train_flagship.py: a YOLO train state's blk_det goes into
    the deploy tree (:246-247) and its layers 0-9 become the seg trainer's
    backbone (:162-178); through the port, train_from_deploy gives the same
    backbone as the JAX split, bit for bit."""
    yolo = blk_train_from_deploy(load_npz(WEIGHTS))
    yolo = jax.tree_util.tree_map(lambda v: v * np.float32(0.5) + np.float32(0.25), yolo)  # a "trained" graph
    state = jax_create_state(yolo, optax.adam(1e-3))
    blk_params, blk_stats = state.params["blk_det"], state.batch_stats["blk_det"]
    backbone_keys = [k for k in blk_params if int(k.split("_")[1]) <= 9]
    ref = {"params": {k: blk_params[k] for k in backbone_keys},
           "batch_stats": {k: blk_stats[k] for k in backbone_keys if k in blk_stats}}

    model = port_model(jax.device_get({"params": state.params, "batch_stats": state.batch_stats}), YOLOV5S_CFG)
    seg = train_from_deploy(deploy_from_train(variables_from_state_dict(model.state_dict()), load_npz(WEIGHTS)))
    got = leaves({col: seg[col]["backbone"] for col in ("params", "batch_stats")})
    want = leaves(jax.device_get(ref))
    assert set(got) == set(want) and len(want) > 100
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_yolo_trainer_runs_checkpoints_and_resumes(pages, tmp_path):
    """yolo_trainer.train on the CPU, full width, imgsz 64, batch 2: 2 steps
    with the loss and AP evals, yolo_last.ctd and yolo_best.ctd with
    best_loss; a state restored from yolo_last.ctd takes the next step;
    without variables the graph is drawn from seed 0 with the Detect bias
    prior; mesh= raises, and without device='cpu' it asks for the card."""
    hyp = {"data": {"train_img_dir": pages, "val_img_dir": pages, "imgsz": 64, "augment": True,
                    "aug_param": {"hsv": 0.5, "flip_lr": 0.5, "neg": 0.1}, "save_dir": str(tmp_path)},
           "train": {"epochs": 1, "batch_size": 2, "lr0": 2e-3, "lrf": 0.05, "optimizer": "adam", "momentum": 0.9,
                     "weight_decay": 0.0, "eval_interval": 1, "warmup_steps": 1}}
    out = yolo_trainer.train(hyp, max_steps=2, device="cpu")
    assert out["steps"] == 2 and np.isfinite(out["last_loss"]) and out["state"].step == 2
    assert out["ap"]["ap50"].shape == (2,) and out["ap"]["n_gt"].sum() >= 2
    for name in ("yolo_last.ctd", "yolo_best.ctd"):
        meta = json.load(open(tmp_path / f"{name}.meta.json"))
        assert meta["epoch"] == 0 and meta["best_loss"] == out["best_loss"] and np.isfinite(meta["best_loss"])

    restored = checkpoint.restore(str(tmp_path / "yolo_last.ctd"),
                                  create_yolo_train_state(yolo_trainer.build_model(),
                                                          build_optimizer("adam", 1e-3)))["state"]
    assert restored.step == 2 and restored.optimizer.count == 2
    for k, v in out["state"].model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    imgs, labels, mask = next(iter(create_dataloader(pages, 64, 2, shuffle=False, as_uint8=True)[1]))
    m = yolo_train_step(restored, torch.from_numpy(imgs), torch.from_numpy(labels), torch.from_numpy(mask))
    assert np.isfinite(float(m["loss"])) and restored.step == 3 and restored.optimizer.count == 3

    # variables=None: the shapes of the JAX init, biases 0 but for the prior
    fresh = yolo_trainer.build_model(img_size=64)
    shapes = jax.eval_shape(lambda: jax_build_blk().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    got = variables_from_state_dict(fresh.state_dict())
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), shapes) == jax.tree_util.tree_map(
        lambda x: tuple(x.shape), got)
    for i, s in enumerate((8, 16, 32)):
        b = fresh.blk_det.model[24].m[i].bias.detach().view(3, -1)
        assert torch.equal(b[:, 4], torch.full((3,), np.float32(np.log(8 / (64 / s) ** 2))))
        assert torch.equal(b[:, 5:], torch.full((3, 2), np.float32(np.log(0.6 / (2 - 0.999999)))))
        assert not b[:, :4].any()
    with pytest.raises(NotImplementedError):
        yolo_trainer.train(hyp, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            yolo_trainer.train(hyp)
