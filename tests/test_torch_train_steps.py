"""The port's optimizer, losses and trainers against the JAX package.

Optimizer: ``training/steps.py::Optimizer`` against the optax chains the
JAX trainers build (adam and sgd + nesterov, coupled weight decay, the
warm-up schedule whose first update has learning rate 0, MultiSteps with
k = 2) on identical gradients, 3 updates, parameters within 1e-6.  Losses:
each against the JAX function on random maps within 1e-6 relative,
including the DB loss on a 3-channel head.  Trainers: both run 2 steps on
the CPU on a tiny dataset, write their checkpoints and resume.
"""

import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from comic_text_detector_tpu.training import losses as jax_losses
from comic_text_detector_tpu.training import steps as jax_steps
from comic_text_detector_tpu.training.seg_trainer import make_lr_schedule as jax_make_lr_schedule
from comic_text_detector_tpu_torch.parallel.mesh import make_mesh
from comic_text_detector_tpu_torch.training import db_trainer, losses, seg_trainer
from comic_text_detector_tpu_torch.training.seg_trainer import make_lr_schedule
from comic_text_detector_tpu_torch.training.steps import Optimizer, build_optimizer, one_cycle
from comic_text_detector_tpu_torch.utils.io import imwrite
from comic_text_detector_tpu_torch.weights import load_npz, train_from_deploy, variables_from_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYP_TRAIN = {"epochs": 3, "lr0": 1e-2, "lrf": 0.1, "warmup_steps": 2}
NB = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts several test processes on
    the same cores, and torch's spinning thread pool slows a full-width
    train step there by 10x or more (measured 9 s against 102 s for the
    trainers test with the cores busy)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def optax_chain(kind, wd, lr, momentum, k):
    """The chain the JAX seg trainer builds (seg_trainer.py:112-121)."""
    inner = optax.adam(lr, b1=momentum, b2=0.999) if kind == "adam" else optax.sgd(lr, momentum=momentum,
                                                                                     nesterov=True)
    tx = optax.chain(optax.add_decayed_weights(wd), inner)
    return optax.MultiSteps(tx, every_k_schedule=k) if k > 1 else tx


@pytest.mark.parametrize("kind,wd,schedule,k", [
    ("adam", 0.0, False, 1),
    ("adam", 5e-4, True, 1),
    ("sgd", 5e-4, True, 1),
    ("adam", 5e-4, True, 2),
    ("sgd", 0.0, False, 2),
])
def test_optimizer_matches_optax(kind, wd, schedule, k):
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(4, 3, 3, 3)).astype(np.float32), "b": rng.normal(size=(7,)).astype(np.float32)}
    lr_jax = jax_make_lr_schedule(HYP_TRAIN, NB) if schedule else 1e-2
    lr_port = make_lr_schedule(HYP_TRAIN, NB) if schedule else 1e-2
    tx = optax_chain(kind, wd, lr_jax, 0.9, k)
    opt_state = tx.init(params)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.tensor(v, requires_grad=True) for n, v in params.items()}
    opt = Optimizer(tp.values(), kind=kind, lr=lr_port, momentum=0.9, weight_decay=wd, accumulation_steps=k)
    for i in range(3 * k):
        grads = {n: rng.normal(size=v.shape).astype(np.float32) for n, v in params.items()}
        upd, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, t in tp.items():
            t.grad = torch.from_numpy(grads[n])
        before = {n: t.detach().clone() for n, t in tp.items()}
        updated = opt.step()
        assert updated == ((i + 1) % k == 0)
        for n, t in tp.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[n]), rtol=0, atol=1e-6, err_msg=f"{n} {i}")
        if schedule and i == k - 1:  # the first update runs at learning rate 0: no change
            for n, t in tp.items():
                assert torch.equal(t, before[n]), n
    assert opt.count == 3


def test_build_optimizer_and_one_cycle_match_jax():
    """build_optimizer's lr0 * schedule(count) with one_cycle, as the JAX
    build_optimizer's."""
    rng = np.random.default_rng(4)
    p = rng.normal(size=(5, 5)).astype(np.float32)
    sched = one_cycle(1.0, 0.2, 5)
    tx = jax_steps.build_optimizer("sgd", 0.1, momentum=0.8, weight_decay=1e-3, schedule=jax_steps.one_cycle(1.0, 0.2, 5))
    st, jpar = tx.init(jnp.asarray(p)), jnp.asarray(p)
    t = torch.tensor(p, requires_grad=True)
    opt = build_optimizer("sgd", 0.1, momentum=0.8, weight_decay=1e-3, schedule=sched)([t])
    for _ in range(4):
        g = rng.normal(size=p.shape).astype(np.float32)
        u, st = tx.update(jnp.asarray(g), st, jpar)
        jpar = optax.apply_updates(jpar, u)
        t.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jpar), rtol=0, atol=1e-6)
    assert [sched(i) for i in range(6)] == pytest.approx([float(jax_steps.one_cycle(1.0, 0.2, 5)(i)) for i in range(6)])


def test_lr_schedule_matches_jax():
    for hyp in (HYP_TRAIN, {**HYP_TRAIN, "linear_lr": True}, {"epochs": 10, "lr0": 1e-3, "lrf": 0.1},
                {**HYP_TRAIN, "warmup_steps": 0, "schedule_epochs": 6}):
        ours, ref = make_lr_schedule(hyp, 100), jax_make_lr_schedule(hyp, 100)
        for step in (0, 1, 2, 50, 90, 99, 100, 250, 699, 700, 701, 1000):
            assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-12), (hyp, step)


def maps(rng, b=2, h=24, w=20):
    gt = (rng.random((b, h, w)) < 0.2).astype(np.float32)
    mask = (rng.random((b, h, w)) < 0.9).astype(np.float32)
    return gt, mask


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    gt, mask = maps(rng)
    logits = rng.normal(0, 3, gt.shape).astype(np.float32)
    prob = 1 / (1 + np.exp(-logits))
    t = torch.from_numpy
    pairs = [
        (losses.binary_dice_loss(t(prob), t(gt)), jax_losses.binary_dice_loss(prob, gt)),
        (losses.balance_bce_loss(t(logits), t(gt), t(mask)), jax_losses.balance_bce_loss(logits, gt, mask)),
        (losses.balance_bce_loss(t(logits), t(gt * 0), t(mask)), jax_losses.balance_bce_loss(logits, gt * 0, mask)),
        (losses.dice_loss(t(prob), t(gt), t(mask)), jax_losses.dice_loss(prob, gt, mask)),
        (losses.dice_loss(t(prob), t(gt), t(mask), weights=t(prob)), jax_losses.dice_loss(prob, gt, mask, weights=prob)),
        (losses.mask_l1_loss(t(prob), t(gt), t(mask)), jax_losses.mask_l1_loss(prob, gt, mask)),
    ]
    for ours, ref in pairs:
        assert float(ours) == pytest.approx(float(ref), rel=1e-6)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("use_bce", [True, False])
def test_db_loss_matches_jax(channels, use_bce):
    """The 3-channel head (shrink_with_sigmoid=True, the trainers') reads
    its "logits" from channel 2, as JAX's clamped pred[..., 3] does, and
    passes no gradient through that read; a 4-channel head reads channel
    3."""
    rng = np.random.default_rng(6 + channels)
    gt, smask = maps(rng)
    tmap = rng.uniform(0.3, 0.7, gt.shape).astype(np.float32)
    tmask = (rng.random(gt.shape) < 0.5).astype(np.float32)
    pred = rng.uniform(0.01, 0.99, (2, channels) + gt.shape[1:]).astype(np.float32)
    batch = {"shrink_map": gt, "shrink_mask": smask, "threshold_map": tmap, "threshold_mask": tmask}

    def jax_loss(p_nhwc):
        return jax_losses.db_loss(p_nhwc, {k: jnp.asarray(v) for k, v in batch.items()}, use_bce=use_bce)

    ref = jax_loss(jnp.asarray(pred.transpose(0, 2, 3, 1)))
    ref_grad = jax.grad(lambda p: jax_loss(p)["loss"])(jnp.asarray(pred.transpose(0, 2, 3, 1)))
    tp = torch.tensor(pred, requires_grad=True)
    ours = losses.db_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, use_bce=use_bce)
    for k, v in ref.items():
        assert float(ours[k]) == pytest.approx(float(v), rel=1e-6), k
    ours["loss"].backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(ref_grad).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-7)


def make_dataset(root, n=4, size=96):
    rng = np.random.default_rng(0)
    img_dir = root / "imgs"
    img_dir.mkdir(exist_ok=True)
    for i in range(n):
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        mask = np.zeros((size, size), np.uint8)
        x, y = int(rng.integers(5, 40)), int(rng.integers(5, 40))
        mask[y:y + 30, x:x + 40] = 255
        img[y:y + 30, x:x + 40] = 255
        imwrite(str(img_dir / f"p{i}.png"), img)
        imwrite(str(img_dir / f"mask-p{i}.png"), mask)
        np.savetxt(str(img_dir / f"line-p{i}.txt"), np.array([[x, y, x + 40, y, x + 40, y + 30, x, y + 30]]), fmt="%d")
    return str(img_dir)


def trainer_hyp(img_dir, save_dir, epochs=1):
    return {
        "data": {"train_img_dir": img_dir, "val_img_dir": img_dir, "imgsz": 64, "augment": True,
                 "aug_param": {"hsv": 0.3, "flip_lr": 0.5, "neg": 0.3, "rotate": 0.0, "size_range": [-1]},
                 "save_dir": str(save_dir)},
        "train": {"epochs": epochs, "batch_size": 2, "lr0": 1e-3, "lrf": 0.1, "optimizer": "adam",
                  "weight_decay": 0.0, "eval_interval": 1, "accumulation_steps": 1, "loss": "bce"},
    }


def test_trainers_run_checkpoint_and_resume(tmp_path):
    """seg_trainer.train and db_trainer.train on the CPU: 2 steps each from
    the flagship weights, *_last.ctd and its .meta.json written, and a
    resumed run continues the epoch count; the DB head is grafted from the
    trained U-Net.  Without device='cpu' they ask for the card."""
    img_dir = make_dataset(tmp_path)
    deploy = load_npz(os.path.join(ROOT, "data", "flagship_r2.npz"))
    out_dir = tmp_path / "out"
    hyp = trainer_hyp(img_dir, out_dir)
    seg = seg_trainer.train(hyp, variables=train_from_deploy(deploy), max_steps=2, device="cpu")
    assert seg["steps"] == 2 and np.isfinite(seg["last_loss"]) and seg["state"].step == 2
    meta = json.load(open(out_dir / "unet_last.ctd.meta.json"))
    assert meta["epoch"] == 0 and meta["best_f1"] == seg["best_f1"]
    unet = variables_from_state_dict(seg["state"].model.state_dict())

    db = db_trainer.train(hyp, variables=train_from_deploy(deploy, with_db=True), unet_variables=unet,
                          max_steps=2, device="cpu")
    assert db["steps"] == 2 and np.isfinite(db["last_metrics"]["loss"])
    assert json.load(open(out_dir / "db_last.ctd.meta.json"))["epoch"] == 0
    grafted = db["state"].model.dbnet.upconv3.conv[0].cv1.conv.weight
    assert grafted.shape == seg["state"].model.seg_net.upconv3.conv[0].cv1.conv.weight.shape

    for trainer, name, kw in ((seg_trainer, "unet_last.ctd", {"variables": train_from_deploy(deploy)}),
                              (db_trainer, "db_last.ctd", {})):
        hyp2 = trainer_hyp(img_dir, out_dir, epochs=2)
        hyp2["resume"] = {"resume_training": True, "ckpt": str(out_dir / name)}
        out = trainer.train(hyp2, device="cpu", **kw)
        assert json.load(open(out_dir / f"{name}.meta.json"))["epoch"] == 1
        assert out["steps"] == 2  # one epoch of 2 batches
        assert out["state"].optimizer.count == 4 and out["state"].step == 4

    with pytest.raises(ValueError, match="one device a process"):  # a trainer's mesh is one device a process
        seg_trainer.train(hyp, mesh=make_mesh(devices=["cpu", "cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            db_trainer.train(hyp)
