"""The port's train-mode net, train steps and weight trees against the JAX
package, at 128x128, batch 2, with the flagship_r2 weights carried into
the train trees (``weights.train_from_deploy``).

Tolerances: train-mode outputs within 1e-4 absolute, updated BatchNorm
running stats within 1e-5 absolute and relative (running variances reach
140; the frozen parts' stay bit-equal to their input), losses within 1e-5 relative, the optimizer's update of a step
within 1e-6 of optax's given the port's own gradients.  Gradients: the
port's with its net in float64 against JAX's float32 ones, each leaf
within 1e-4 of its max-abs (``check_grads`` has the floor); the port's float32 step against JAX's, the
whole tree within 2e-3 in relative L2.  In float32 one activation whose
sign differs from the float64 one moves a leaf's gradient by up to a few
percent: at 128x128 the port's float32 seg step has one such element (a
U-Net ReLU input, 2x256x16x16), JAX's none, and the seg tree then differs
by 6.8e-4 in relative L2 and by 2.5e-2 of a leaf's max-abs in upconv4;
JAX's float32 gradients are within 7e-6 of the float64 ones.  The JAX
side runs one jitted ``value_and_grad`` a mode.

The JAX DB loss's BCE term reads ``pred[..., 3]`` of a 3-channel head:
the read clamps to channel 2 and its gradient is dropped, so ``loss:
bce`` and ``loss: dice`` give the same gradients; the port computes the
same (``training/losses.py::db_loss``).
"""

import copy
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from comic_text_detector_tpu.constants import TEXTDET_DET, TEXTDET_MASK
from comic_text_detector_tpu.models.detector import build_train_model as jax_build_train_model
from comic_text_detector_tpu.models.detector import damp_output_biases as jax_damp
from comic_text_detector_tpu.training import losses as jax_losses
from comic_text_detector_tpu.training.checkpoint import load_compact as jax_load_compact
from comic_text_detector_tpu.training.checkpoint import save_compact as jax_save_compact
from comic_text_detector_tpu.training.db_trainer import graft_db_variables as jax_graft
from comic_text_detector_tpu.training.init import bilinear_kernel as jax_bilinear_kernel
from comic_text_detector_tpu_torch.models.detector import build_train_model, damp_output_biases, init_variables
from comic_text_detector_tpu_torch.training import checkpoint, losses
from comic_text_detector_tpu_torch.training.db_trainer import graft_db_variables
from comic_text_detector_tpu_torch.models.init import apply_reference_init
from comic_text_detector_tpu_torch.training.init import bilinear_kernel
from comic_text_detector_tpu_torch.training.steps import (
    build_optimizer,
    create_db_train_state,
    create_seg_train_state,
    db_train_step,
    seg_train_step,
)
from comic_text_detector_tpu_torch.weights import (
    deploy_from_train,
    load_npz,
    state_dict_from_jax,
    train_from_deploy,
    train_state_dict_from_jax,
    variables_from_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
S, B = 128, 2
DB_KEYS = ("shrink_map", "shrink_mask", "threshold_map", "threshold_mask")


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


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def deploy():
    return jax_load_compact(WEIGHTS)


def make_batch():
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    masks = np.zeros((B, S, S), np.uint8)
    shrink = np.zeros((B, S, S), np.float32)
    thresh = np.full((B, S, S), 0.3, np.float32)
    tmask = np.zeros((B, S, S), np.float32)
    for b in range(B):
        for _ in range(3):
            y, x = rng.integers(4, S - 40, 2)
            h, w = rng.integers(8, 30, 2)
            imgs[b, y:y + h, x:x + w] = 20
            masks[b, y:y + h, x:x + w] = 1
            shrink[b, y + 2:y + h - 2, x + 2:x + w - 2] = 1.0
            tmask[b, y - 3:y + h + 3, x - 3:x + w + 3] = 1.0
            thresh[b, y - 3:y + h + 3, x - 3:x + w + 3] = rng.uniform(0.3, 0.7, (h + 6, w + 6))
    smask = np.ones((B, S, S), np.float32)
    smask[:, :4] = 0.0
    return {"imgs": imgs, "masks": masks, "shrink_map": shrink, "shrink_mask": smask,
            "threshold_map": thresh, "threshold_mask": tmask}


@pytest.fixture(scope="module")
def batch():
    return make_batch()


def jax_value_and_grad(variables, batch, with_db):
    """One jitted JAX forward (train=True) + value_and_grad of the step's
    loss: (pred, new batch_stats, {loss name: (loss, grads)})."""
    model = jax_build_train_model(with_db=with_db)
    trainable = ("dbnet",) if with_db else ("seg_net",)
    params = variables["params"]
    frozen = {k: v for k, v in params.items() if k not in trainable}
    train = {k: v for k, v in params.items() if k in trainable}
    imgs = jnp.asarray(batch["imgs"]).astype(jnp.float32) / 255.0
    mode = TEXTDET_DET if with_db else TEXTDET_MASK

    @jax.jit
    def run(train, frozen, stats):
        def apply(t):
            return model.apply({"params": {**frozen, **t}, "batch_stats": stats}, imgs, forward_mode=mode,
                               train=True, mutable=["batch_stats"])

        def loss_fn(t, use_bce):
            pred, new = apply(t)
            if with_db:
                loss = jax_losses.db_loss(pred, {k: jnp.asarray(batch[k]) for k in DB_KEYS}, use_bce=use_bce)["loss"]
            else:
                loss = jax_losses.binary_dice_loss(pred[..., 0], jnp.asarray(batch["masks"]).astype(jnp.float32))
            return loss, (pred, new["batch_stats"])

        out = {}
        for name, use_bce in ((("bce", True), ("dice", False)) if with_db else (("dice", False),)):
            (loss, (pred, stats_new)), grads = jax.value_and_grad(loss_fn, has_aux=True)(train, use_bce)
            out[name] = (loss, grads)
        return pred, stats_new, out

    pred, new_stats, out = run(train, frozen, variables["batch_stats"])
    return np.asarray(pred), jax.device_get(new_stats), jax.device_get(out)


@pytest.fixture(scope="module")
def seg_case(deploy, batch):
    variables = train_from_deploy(deploy)
    return variables, jax_value_and_grad(variables, batch, with_db=False)


@pytest.fixture(scope="module")
def db_case(deploy, batch):
    variables = train_from_deploy(deploy, with_db=True)
    return variables, jax_value_and_grad(variables, batch, with_db=True)


def port_model(variables, with_db):
    model = build_train_model(with_db=with_db)
    model.load_state_dict(train_state_dict_from_jax(variables), strict=True)
    return model


def port_grads(model, trainable):
    """The trainable parameters' .grad as JAX-layout leaves."""
    sd = dict(model.state_dict())
    sd.update({k: p.grad for k, p in model.named_parameters() if p.grad is not None})
    tree = variables_from_state_dict(sd)["params"]
    return leaves({k: tree[k] for k in trainable})


def check_grads(ours, ref, tol):
    """Each leaf within ``tol`` of max(its max-abs, 5e-2 of the tree's):
    the floor covers the biases of convolutions in front of a train-mode
    BatchNorm, whose gradient is 0 in exact arithmetic and JAX's float32
    rounding noise (measured up to 1.2e-6 of the tree's max-abs)
    otherwise."""
    assert set(ours) == set(ref)
    gmax = max(np.abs(g).max() for g in ref.values())
    for k, g in ref.items():
        gap = np.abs(ours[k].astype(np.float64) - g).max()
        assert gap <= tol * max(np.abs(g).max(), 5e-2 * gmax), (k, gap, np.abs(g).max(), gmax)


def check_tree_l2(ours, ref, tol):
    num = sum(np.sum(np.square(ours[k].astype(np.float64) - g)) for k, g in ref.items())
    den = sum(np.sum(np.square(g.astype(np.float64))) for g in ref.values())
    assert np.sqrt(num / den) <= tol, np.sqrt(num / den)


def grads_f64(variables, batch, with_db, use_bce=False):
    """The port's gradients with the net in float64 (the loss in float32,
    as the step computes it)."""
    model = port_model(variables, with_db).double()
    model.train()
    pred = model(torch.from_numpy(batch["imgs"]).permute(0, 3, 1, 2).double() / 255.0).float()
    if with_db:
        loss = losses.db_loss(pred, {k: torch.from_numpy(batch[k]) for k in DB_KEYS}, use_bce=use_bce)["loss"]
    else:
        loss = losses.binary_dice_loss(pred[:, 0], torch.from_numpy(batch["masks"]).float())
    loss.backward()
    return port_grads(model, ("dbnet",) if with_db else ("seg_net",))


def check_stats(model, new_stats, variables, frozen_parts):
    got = leaves(variables_from_state_dict(model.state_dict())["batch_stats"])
    ref = leaves(new_stats)
    before = leaves(variables["batch_stats"])
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k.split("]")[0].strip("['") in frozen_parts:
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)  # frozen: stats do not move
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("with_db", [False, True])
def test_train_trees_match_jax_init(deploy, with_db):
    """train_from_deploy gives the tree the JAX DET/MASK-mode init creates,
    and the port's TextDetTrain carries it there and back bit for bit."""
    mode = TEXTDET_DET if with_db else TEXTDET_MASK
    shapes = jax.eval_shape(lambda: jax_build_train_model(with_db=with_db).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), forward_mode=mode))
    ours = train_from_deploy(deploy, with_db)
    assert jax.tree_util.tree_map(lambda x: x.shape, shapes) == jax.tree_util.tree_map(lambda x: x.shape, ours)
    back = leaves(variables_from_state_dict(port_model(ours, with_db).state_dict()))
    for k, v in leaves(ours).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_seg_step_matches_jax(seg_case, batch):
    variables, (pred_ref, stats_ref, out) = seg_case
    loss_ref, grads_ref = out["dice"]
    model = port_model(variables, False)
    model.train()
    assert all(not m.training for m in model.backbone.modules()) and model.seg_net.training
    with torch.no_grad():
        pred = model(torch.from_numpy(batch["imgs"]).permute(0, 3, 1, 2).float() / 255.0)
    np.testing.assert_allclose(pred.permute(0, 2, 3, 1).numpy(), pred_ref, rtol=0, atol=1e-4)

    model = port_model(variables, False)
    state = create_seg_train_state(model, build_optimizer("adam", 1e-3, momentum=0.9, weight_decay=5e-4))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    metrics = seg_train_step(state, torch.from_numpy(batch["imgs"]), torch.from_numpy(batch["masks"]))
    assert float(metrics["loss"]) == pytest.approx(float(loss_ref), rel=1e-5)
    check_tree_l2(port_grads(model, ("seg_net",)), leaves(grads_ref), 2e-3)
    check_grads(grads_f64(variables, batch, False), leaves(grads_ref), 1e-4)
    check_stats(model, stats_ref, variables, ("backbone",))
    # the update is optax's chain on the port's own gradients
    params = {k: before[k].numpy() for k, p in model.named_parameters() if p.requires_grad}
    grads = {k: p.grad.numpy() for k, p in model.named_parameters() if p.requires_grad}
    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.adam(1e-3, b1=0.9, b2=0.999))
    upd, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, upd)
    assert set(new) == {k for k in before if k.startswith("seg_net.")}
    for k, p in model.named_parameters():
        if k in new:
            np.testing.assert_allclose(p.detach().numpy(), new[k], rtol=0, atol=1e-6, err_msg=k)
        else:
            assert torch.equal(p, before[k]), k


@pytest.mark.parametrize("use_bce", [True, False])
def test_db_step_matches_jax(db_case, batch, use_bce):
    variables, (pred_ref, stats_ref, out) = db_case
    loss_ref, grads_ref = out["bce" if use_bce else "dice"]
    model = port_model(variables, True)
    model.train()
    assert not model.seg_net.training and model.dbnet.training
    with torch.no_grad():
        pred = model(torch.from_numpy(batch["imgs"]).permute(0, 3, 1, 2).float() / 255.0)
    assert pred.shape == (B, 3, S, S)  # shrink, thresh, binary: no logits channel
    np.testing.assert_allclose(pred.permute(0, 2, 3, 1).numpy(), pred_ref, rtol=0, atol=1e-4)

    model = port_model(variables, True)
    state = create_db_train_state(model, build_optimizer("sgd", 1e-3))
    tb = {k: torch.from_numpy(batch[k]) for k in ("imgs",) + DB_KEYS}
    metrics = db_train_step(state, tb, use_bce=use_bce)
    assert float(metrics["loss"]) == pytest.approx(float(loss_ref), rel=1e-5)
    check_tree_l2(port_grads(model, ("dbnet",)), leaves(grads_ref), 2e-3)
    check_grads(grads_f64(variables, batch, True, use_bce), leaves(grads_ref), 1e-4)
    check_stats(model, stats_ref, variables, ("backbone", "seg_net"))
    model.eval()
    with torch.no_grad():
        assert model(tb["imgs"].permute(0, 3, 1, 2).float() / 255.0).shape == (B, 2, S, S)


def test_deploy_train_round_trips(deploy):
    """deploy -> train -> deploy gives the deploy tree back; a DB train tree
    puts its trunk and DB head back; the inference state dict reads back
    into the deploy tree bit for bit."""
    ours = load_npz(WEIGHTS)
    same = leaves(deploy_from_train(train_from_deploy(ours), ours))
    for k, v in leaves(deploy).items():
        np.testing.assert_array_equal(same[k], v, err_msg=k)
    back = leaves(variables_from_state_dict(state_dict_from_jax(ours)))
    assert set(back) == set(leaves(deploy))
    for k, v in leaves(deploy).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    db = train_from_deploy(ours, with_db=True)
    db["params"]["dbnet"]["conv"]["seq0"]["bias"] = db["params"]["dbnet"]["conv"]["seq0"]["bias"] + 1.0
    out = deploy_from_train(db, ours)
    np.testing.assert_array_equal(out["params"]["text_det"]["conv"]["seq0"]["bias"],
                                  ours["params"]["text_det"]["conv"]["seq0"]["bias"] + 1.0)


def test_graft_matches_jax(deploy):
    db = train_from_deploy(deploy, with_db=True)
    unet = jax.tree_util.tree_map(lambda x: x + 0.5, train_from_deploy(deploy))
    ref, ours = leaves(jax_graft(db, unet)), leaves(graft_db_variables(db, unet))
    assert set(ref) == set(ours)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_save_compact_round_trips_through_jax(deploy, tmp_path):
    """The port's compact npz holds what the JAX package's holds and reads
    back in the JAX load_compact and the port's load_npz."""
    tree = {col: {"text_det": copy.deepcopy(deploy[col]["text_det"]),
                  "text_seg": copy.deepcopy(deploy[col]["text_seg"])} for col in deploy}
    tree["batch_stats"]["text_seg"]["upconv0"]["bn"]["var"] = np.full_like(
        tree["batch_stats"]["text_seg"]["upconv0"]["bn"]["var"], 1e5)  # stays float32
    checkpoint.save_compact(str(tmp_path / "port.npz"), tree)
    jax_save_compact(str(tmp_path / "jax.npz"), tree)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    ref = leaves(jax_load_compact(str(tmp_path / "port.npz")))
    for k, v in leaves(checkpoint.load_compact(str(tmp_path / "port.npz"))).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_damp_output_biases_matches_jax(deploy):
    ref = leaves(jax_damp(deploy, -6.0))
    ours = leaves(damp_output_biases(deploy, -6.0))
    assert set(ref) == set(ours)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_init_contract():
    """init_variables draws the JAX package's distributions (std within 5%
    on kernels of at least 20000 elements); apply_reference_init draws
    kaiming-normal kernels, zero biases, unit BN; the bilinear kernel is
    the JAX one, bit for bit, in torch's layout."""
    g = torch.Generator().manual_seed(3)
    model = init_variables(build_train_model(with_db=True), g)
    checked = 0
    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)) and mod.weight.numel() >= 20000:
            w = mod.weight
            tr = isinstance(mod, torch.nn.ConvTranspose2d)
            fan = (w.shape[0] if tr else w.shape[1]) * w.shape[2] * w.shape[3]
            want = np.sqrt(1.0 / fan) if tr else np.sqrt(2.0 / fan)
            assert abs(float(w.detach().std()) / want - 1) < 0.05, (tuple(w.shape), want)
            checked += 1
        if isinstance(mod, torch.nn.BatchNorm2d):
            assert torch.equal(mod.weight, torch.ones_like(mod.weight)) and not mod.bias.any()
    assert checked > 20
    apply_reference_init(model.dbnet, torch.Generator().manual_seed(4))
    w = model.dbnet.upconv3.conv[0].cv3.conv.weight  # (256, 512, 1, 1)
    assert abs(float(w.detach().std()) / np.sqrt(2.0 / 512) - 1) < 0.05
    wt = model.dbnet.upconv3.conv[1].weight  # transposed (512, 256, 4, 4): fan over its 512 inputs
    assert abs(float(wt.detach().std()) / np.sqrt(2.0 / (512 * 16)) - 1) < 0.05
    assert not model.dbnet.conv[0].bias.any()
    ref = jax_bilinear_kernel(3, 4, 4)
    np.testing.assert_array_equal(bilinear_kernel(3, 4, 4), np.transpose(ref[::-1, ::-1], (2, 3, 0, 1)))
