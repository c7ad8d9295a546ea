"""The port's data parallelism (``parallel/``, the trainers' and the batch
stream's ``mesh=``) against the one-process functions and the JAX package.

Ranks are processes started by ``parallel/mesh.py::spawn`` over gloo on
the CPU, one torch thread each, their rank functions in
``tests/torch_parallel_ranks.py`` (no JAX in the ranks).  Each rank holds
its contiguous block of the global batch; the test puts the ranks' blocks
back in rank order and holds them to the one-process function of the
global batch:

* each loss and the global-batch ``BatchNorm2d`` at world 2 and 4: values
  within 1e-6 relative, input gradients within 1e-6 of their max-abs,
  every rank reporting the same value; on OHEM negatives whose tied losses
  cross the rank seams, the same selected pixels;
* the seg, DB (``loss: bce``) and YOLO train steps at world 2, full width
  at 64x64 from the flagship weights, to the tolerances of
  ``tests/test_torch_train_model.py`` and ``test_torch_train_yolo.py``:
  loss terms within 1e-5 relative, trainable gradients within 1e-4 in
  relative L2 over the tree (measured 7.5e-7 to 7.5e-6; an all-reduce
  whose backward passes the gradient through in place of summing it puts
  them 0.31 to 0.73 apart), BatchNorm running statistics within 1e-5
  absolute and relative, and the two ranks' parameters bit-identical after
  the step; a batch of 3, which the data axis does not divide, runs whole
  on each rank and equals the one-process step bit for bit;
* the JAX seg step under ``make_mesh(2)`` (the conftest's virtual CPU
  devices) against the port's world-2 step on the same global batch, with
  the tolerances of ``test_seg_step_matches_jax`` (gradients 2e-3);
* the three trainers' ``train(mesh=)`` at world 2 for 2 steps against
  the one-process ``train``: the same steps, the loss within 1e-5
  relative, parameters within 1e-6, one set of checkpoints;
* ``BatchTextDetector(mesh=make_mesh(devices=["cpu", "cpu"]))`` at 256 in
  float32, bit-identical to the detector without a mesh (on an uneven
  split, to the detector without a mesh on the same blocks: a CPU float32
  net of one page rounds otherwise than in a batch of 3) and held to the
  JAX ``BatchTextDetector(mesh=make_mesh(2))`` within
  ``tests/test_torch_batch.py``'s tolerance, the grey mask within one
  level (see the test).
"""

import concurrent.futures
import contextlib
import inspect
import os
import time

import numpy as np
import optax
import pytest
import torch

import jax

from comic_text_detector_tpu.models.detector import build_train_model as jax_build_train_model
from comic_text_detector_tpu.parallel.loader import HostShardedDataset as JaxHostShardedDataset
from comic_text_detector_tpu.parallel.mesh import make_mesh as jax_make_mesh
from comic_text_detector_tpu.parallel.mesh import replicate as jax_replicate
from comic_text_detector_tpu.parallel.mesh import shard_batch as jax_shard_batch
from comic_text_detector_tpu.pipeline.batch import BatchTextDetector as JaxBatchTextDetector
from comic_text_detector_tpu.training import steps as jax_steps
from comic_text_detector_tpu.training.checkpoint import load_compact
from comic_text_detector_tpu_torch.models.detector import build_train_model
from comic_text_detector_tpu_torch.ops import nn as tnn
from comic_text_detector_tpu_torch.parallel import mesh as M
from comic_text_detector_tpu_torch.parallel.loader import HostShardedDataset
from comic_text_detector_tpu_torch.pipeline import BatchTextDetector
from comic_text_detector_tpu_torch.utils.io import imwrite
from comic_text_detector_tpu_torch.weights import load_npz, train_from_deploy, variables_from_state_dict
from tests import torch_parallel_ranks as R
from tests.test_torch_batch import _pages, _same_blocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
CPU2 = ["cpu", "cpu"]
S = 64  # the train steps' image size


@contextlib.contextmanager
def one_torch_thread():
    """One intra-op thread, as in every rank: the one-process references of
    the ranks' work run so (the tier-1 run shares the cores between test
    processes, and torch's CPU convolutions round by their thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_make_mesh():
    """The JAX ``tests/test_batch_parallel.py`` contract: a 1-D ``data``
    mesh, trailing axes of size 1, the first ``n_devices``; CUDA by default,
    which raises without a card."""
    mesh = M.make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"data": 8} and len(mesh.devices) == 8 and mesh.world == 1 and mesh.rank == 0
    mesh2 = M.make_mesh(2, axes=("data", "model"), devices=["cpu"] * 8)
    assert mesh2.shape == {"data": 2, "model": 1} and mesh2.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="data"):
        M.make_mesh(devices=CPU2, axes=("model",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            M.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            M.make_mesh(devices=["cuda:0"])


def test_shard_batch_and_replicate():
    """``shard_batch``: contiguous dim-0 blocks, one a device, on the
    device, JAX's ``P("data", None)``; a batch the axis does not divide
    raises.  ``replicate``: a copy of a module or tensor on each device."""
    mesh = M.make_mesh(devices=["cpu"] * 4)
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    blocks = M.shard_batch(mesh, x)
    assert [b.shape for b in blocks] == [(4, 4)] * 4
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), x)
    sx = jax_shard_batch(jax_make_mesh(4), x)
    assert sx.sharding.spec == jax.sharding.PartitionSpec("data", None)
    for b, shard in zip(blocks, sorted(sx.addressable_shards, key=lambda s: s.index[0].start)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(shard.data))
    with pytest.raises(ValueError, match="equal shards"):
        M.shard_batch(mesh, x[:6])

    net = tnn.BatchNorm2d(3)
    copies = M.replicate(mesh, net)
    assert len(copies) == 4 and all(c is not net for c in copies) and copies[0] is not copies[1]
    for c in copies:
        for a, b in zip(c.state_dict().values(), net.state_dict().values()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    rp = jax_replicate(jax_make_mesh(4), {"w": np.ones((3, 3), np.float32)})
    assert rp["w"].sharding.spec == jax.sharding.PartitionSpec()
    assert [torch.equal(t, torch.ones(3, 3)) for t in M.replicate(mesh, torch.ones(3, 3))] == [True] * 4


@pytest.mark.parametrize("n,count", [(10, 3), (7, 2), (5, 8)])
def test_host_sharded_dataset_matches_jax(n, count):
    data = list(range(n))
    seen = []
    for i in range(count):
        ours = HostShardedDataset(data, process_index=i, process_count=count)
        ref = JaxHostShardedDataset(data, process_index=i, process_count=count)
        assert len(ours) == len(ref)
        assert [ours[j] for j in range(len(ours))] == [ref[j] for j in range(len(ref))]
        seen += [ours[j] for j in range(len(ours))]
    assert sorted(seen) == data
    solo = HostShardedDataset(data)  # no launched group: rank 0 of 1
    assert (solo.pi, solo.pc, len(solo)) == (0, 1, n)


def test_spawn_raises_a_failed_rank():
    """A rank that raises makes ``spawn`` raise its exception, with its
    traceback chained, and stops the rank left waiting in a collective."""
    with pytest.raises(ValueError, match="on purpose") as info:
        M.spawn(R.failing_rank, 2, devices=CPU2, timeout=120)
    assert isinstance(info.value.__cause__, M.RemoteTraceback)
    assert "rank 1 of 2" in str(info.value.__cause__)


def test_spawn_deadline():
    """``timeout`` is a deadline for the whole run: past it the ranks are
    stopped and ``TimeoutError`` raised.  By default there is none (a
    training run takes hours)."""
    assert inspect.signature(M.spawn).parameters["timeout"].default is None
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="not joined within"):
        M.spawn(R.sleeping_rank, 1, devices=["cpu"], timeout=2, args=(600,))
    assert time.monotonic() - t0 < 60


# ----- losses and BatchNorm at world 2 and 4 --------------------------------------------------------------------

B = 4


def loss_cases():
    """{name: (global arrays, the keys that take a gradient)}."""
    rng = np.random.default_rng(0)
    u = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    binary = lambda p, *s: (rng.uniform(size=s) < p).astype(np.float32)  # noqa: E731
    h = w = 16
    ties = np.full((B, 8, 8), 0.5, np.float32)  # every negative loss equal
    tie_gt = np.zeros((B, 8, 8), np.float32)
    tie_gt[3].reshape(-1)[:60] = 1.0  # 60 positives in the last sample: 180 negatives of 196, cut in sample 0
    labels = np.concatenate([rng.integers(0, 2, (B, 6, 1)), rng.uniform(0.2, 0.8, (B, 6, 2)),
                             rng.uniform(0.05, 0.5, (B, 6, 2))], -1).astype(np.float32)
    label_mask = binary(0.7, B, 6)
    label_mask[0] = 0.0  # a sample without labels: its rank's own n_pos is 0 at world 4
    return {
        "binary_dice": ({"pred": u(B, 1, h, w), "target": binary(0.4, B, h, w)}, ("pred",)),
        "balance_bce": ({"logits": rng.normal(0, 2, (B, h, w)).astype(np.float32), "gt": binary(0.15, B, h, w),
                         "mask": binary(0.9, B, h, w)}, ("logits",)),
        "balance_bce_ties": ({"logits": ties, "gt": tie_gt, "mask": np.ones((B, 8, 8), np.float32)}, ("logits",)),
        "dice": ({"pred": u(B, h, w), "gt": binary(0.4, B, h, w), "mask": binary(0.9, B, h, w)}, ("pred",)),
        "mask_l1": ({"pred": u(B, h, w), "gt": u(B, h, w), "mask": binary(0.5, B, h, w)}, ("pred",)),
        **{f"db_loss_{kind}": ({"pred": rng.uniform(0.01, 0.99, (B, 3, h, w)).astype(np.float32),
                                "shrink_map": binary(0.2, B, h, w), "shrink_mask": binary(0.9, B, h, w),
                                "threshold_map": u(B, h, w), "threshold_mask": binary(0.5, B, h, w)}, ("pred",))
           for kind in ("bce", "dice")},
        "yolo": ({"p0": rng.normal(0, 1, (B, 3, 8, 8, 7)).astype(np.float32),
                  "p1": rng.normal(0, 1, (B, 3, 4, 4, 7)).astype(np.float32),
                  "p2": rng.normal(0, 1, (B, 3, 2, 2, 7)).astype(np.float32),
                  "labels": labels, "label_mask": label_mask}, ("p0", "p1", "p2")),
        "batchnorm": ({"x": rng.normal(3, 2, (B, 8, 6, 6)).astype(np.float32),
                       "weight": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                       "bias": rng.normal(0, 1, 8).astype(np.float32), "running_var": np.full(8, 2.0, np.float32),
                       "w_out": rng.normal(0, 1, (B, 8, 6, 6)).astype(np.float32)}, ("x",)),
    }


CASES = list(loss_cases())


@pytest.fixture(scope="module")
def loss_results():
    cases = loss_cases()
    with one_torch_thread():
        ref = {name: R.run_loss(name, arrays, keys) for name, (arrays, keys) in cases.items()}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # both worlds at once
        runs = {world: pool.submit(M.spawn, R.losses_rank, world, devices=["cpu"] * world, args=(cases,),
                                   timeout=300) for world in (2, 4)}
        return {world: (run.result(), ref) for world, run in runs.items()}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_mesh_loss_matches_global_batch(loss_results, world, name):
    ranks, ref = loss_results[world]
    value_ref, grads_ref, extras_ref = ref[name]
    values = [r[name][0] for r in ranks]
    if name == "batchnorm":  # the share of sum(y * w): each rank's own block
        np.testing.assert_allclose(sum(v.astype(np.float64) for v in values), value_ref, rtol=1e-6)
        y = np.concatenate([r[name][2]["y"] for r in ranks])
        np.testing.assert_allclose(y, extras_ref["y"], rtol=1e-6, atol=1e-6)
        for key in ("running_mean", "running_var"):
            for r in ranks:
                np.testing.assert_allclose(r[name][2][key], extras_ref[key], rtol=1e-6, err_msg=key)
    else:  # the global value on every rank
        assert all(np.array_equal(v, values[0]) for v in values)
        np.testing.assert_allclose(values[0], value_ref, rtol=1e-6)
    for key, g_ref in grads_ref.items():
        g = np.concatenate([r[name][1][key] for r in ranks])
        np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-6 * np.abs(g_ref).max(), err_msg=key)
        if name == "balance_bce_ties":  # the same tied negatives take the gradient, across the seams
            np.testing.assert_array_equal(g != 0, g_ref != 0)
            assert (g_ref[:, :, :] != 0).sum() == 60 + 180 and (g_ref[0] != 0).sum() == 180 - 132


# ----- train steps at world 2 ------------------------------------------------------------------------------------


def step_batches():
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    masks = np.zeros((B, S, S), np.uint8)
    shrink = np.zeros((B, S, S), np.float32)
    thresh = np.full((B, S, S), 0.3, np.float32)
    tmask = np.zeros((B, S, S), np.float32)
    for b in range(B):
        for _ in range(2):
            y, x = rng.integers(4, S - 24, 2)
            hh, ww = rng.integers(8, 20, 2)
            imgs[b, y:y + hh, x:x + ww] = 20
            masks[b, y:y + hh, x:x + ww] = 1
            shrink[b, y + 2:y + hh - 2, x + 2:x + ww - 2] = 1.0
            tmask[b, y - 3:y + hh + 3, x - 3:x + ww + 3] = 1.0
            thresh[b, y - 3:y + hh + 3, x - 3:x + ww + 3] = rng.uniform(0.3, 0.7, (hh + 6, ww + 6))
    smask = np.ones((B, S, S), np.float32)
    smask[:, :4] = 0.0
    seg = {"imgs": imgs, "masks": masks}
    db = {"imgs": imgs, "shrink_map": shrink, "shrink_mask": smask, "threshold_map": thresh, "threshold_mask": tmask}
    labels = np.concatenate([rng.integers(0, 2, (B, 8, 1)), rng.uniform(0.25, 0.75, (B, 8, 2)),
                             rng.uniform(0.1, 0.4, (B, 8, 2))], -1).astype(np.float32)
    yolo = {"imgs": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8), "labels": labels,
            "label_mask": (rng.uniform(size=(B, 8)) < 0.6).astype(np.float32)}
    odd = {k: v[:3] for k, v in seg.items()}
    return {"seg": ("seg", seg), "db": ("db", db), "yolo": ("yolo", yolo), "seg_odd": ("seg", odd)}


@pytest.fixture(scope="module")
def step_results():
    batches = step_batches()
    ranks = M.spawn(R.steps_rank, 2, devices=CPU2, args=(batches,), timeout=600)
    with one_torch_thread():
        ref = {name: R.run_step(kind, batch) for name, (kind, batch) in batches.items()}
    return ranks, ref


def tree_l2(ours, ref):
    num = sum(np.sum(np.square(ours[k].astype(np.float64) - g)) for k, g in ref.items())
    den = sum(np.sum(np.square(g.astype(np.float64))) for g in ref.values())
    return np.sqrt(num / den)


@pytest.mark.parametrize("name", ["seg", "db", "yolo"])
def test_mesh_step_matches_one_process(step_results, name):
    ranks, ref = step_results
    metrics_ref, grads_ref, stats_ref, _ = ref[name]
    (metrics, grads, stats, params), (metrics1, grads1, stats1, params1) = ranks[0][name], ranks[1][name]
    assert metrics == metrics1  # every rank reports the global terms
    for k, v in metrics_ref.items():
        assert metrics[k] == pytest.approx(v, rel=1e-5), k
    assert set(grads) == set(grads_ref) and grads_ref
    assert tree_l2(grads, grads_ref) <= 1e-4
    assert set(stats) == set(stats_ref)
    for k, v in stats_ref.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
    for k in params:  # the ranks stay in step
        assert np.array_equal(params[k], params1[k]) and np.array_equal(grads[k], grads1[k]), k
    for k in stats:
        assert np.array_equal(stats[k], stats1[k]), k


def test_indivisible_batch_runs_whole_on_each_rank(step_results):
    """A global batch of 3 at world 2: no collective, no gradient sum;
    each rank computes the one-process step bit for bit."""
    ranks, ref = step_results
    for rank in ranks:
        for got, want in zip(rank["seg_odd"], ref["seg_odd"]):
            assert got.keys() == want.keys()
            for k in want:
                assert np.array_equal(got[k], want[k]), k


def test_jax_seg_step_under_mesh_matches_port(step_results):
    """The JAX seg step (``make_seg_train_step``) jitted over a batch
    sharded on ``make_mesh(2)`` against the port's world-2 step on the same
    global batch and weights.  JAX's gradients are read from an sgd(1.0)
    update (``params - new_params``)."""
    ranks, _ = step_results
    metrics, grads, stats, _ = ranks[0]["seg"]
    batch = step_batches()["seg"][1]
    variables = train_from_deploy(load_compact(WEIGHTS))
    tx = optax.sgd(1.0)
    mesh = jax_make_mesh(2)
    state = jax_replicate(mesh, jax_steps.create_seg_train_state(variables, tx))
    step = jax_steps.make_seg_train_step(jax_build_train_model(), tx)
    new, jmetrics = step(state, jax_shard_batch(mesh, batch["imgs"]), jax_shard_batch(mesh, batch["masks"]))
    assert float(jmetrics["loss"]) == pytest.approx(metrics["loss"], rel=1e-5)
    jgrads = jax.tree_util.tree_map(lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
                                    state.params["seg_net"], new.params["seg_net"])

    def jax_leaves(tree):
        return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}

    sd = build_train_model().state_dict()
    sd.update({k: torch.from_numpy(v) for k, v in grads.items()})
    sd.update({k: torch.from_numpy(v) for k, v in stats.items()})
    ours = variables_from_state_dict(sd)
    assert tree_l2(jax_leaves(ours["params"]["seg_net"]), jax_leaves(jgrads)) <= 2e-3
    got, want = jax_leaves(ours["batch_stats"]["seg_net"]), jax_leaves(jax.device_get(new.batch_stats["seg_net"]))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


# ----- the trainers' train(mesh=) at world 2 ---------------------------------------------------------------------


def write_pages(root, n=8, size=96):
    """``n`` seeded pages with masks and line quads (seg, DB) in
    ``root/seg`` and with YOLO labels in ``root/blk``."""
    rng = np.random.default_rng(0)
    seg_dir, blk_dir = root / "seg", root / "blk"
    seg_dir.mkdir()
    blk_dir.mkdir()
    for i in range(n):
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        mask = np.zeros((size, size), np.uint8)
        x, y = int(rng.integers(5, 40)), int(rng.integers(5, 40))
        mask[y:y + 30, x:x + 40] = 255
        img[y:y + 30, x:x + 40] = 255
        imwrite(str(seg_dir / f"p{i}.png"), img)
        imwrite(str(blk_dir / f"p{i}.png"), img)
        imwrite(str(seg_dir / f"mask-p{i}.png"), mask)
        np.savetxt(str(seg_dir / f"line-p{i}.txt"),
                   np.array([[x, y, x + 40, y, x + 40, y + 30, x, y + 30]]), fmt="%d")
        np.savetxt(str(blk_dir / f"p{i}.txt"), np.array([[i % 2, (x + 20) / size, (y + 15) / size, 40 / size,
                                                         30 / size]]), fmt="%.6f")
    return str(seg_dir), str(blk_dir)


def trainer_hyps(root, tag):
    seg_dir, blk_dir = str(root / "seg"), str(root / "blk")
    # sgd: adam would turn the float32 noise of gradients that are 0 in exact
    # arithmetic (a convolution's bias before a train-mode BatchNorm) into
    # updates of the learning rate's size
    train = {"epochs": 1, "batch_size": 4, "lr0": 1e-2, "lrf": 0.1, "optimizer": "sgd", "weight_decay": 0.0,
             "eval_interval": 1, "accumulation_steps": 1, "loss": "bce", "warmup_steps": 1}
    aug = {"hsv": 0.3, "flip_lr": 0.5, "neg": 0.3, "rotate": 0.0, "size_range": [-1]}
    hyps = {}
    for kind, img_dir in (("seg", seg_dir), ("db", seg_dir), ("yolo", blk_dir)):
        out = root / f"{tag}_{kind}"
        out.mkdir()
        hyps[kind] = {"data": {"train_img_dir": img_dir, "val_img_dir": img_dir, "imgsz": S, "augment": True,
                               "aug_param": aug, "save_dir": str(out)}, "train": dict(train)}
    return hyps


@pytest.fixture(scope="module")
def trainer_results(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_trainers")
    write_pages(root)
    ranks = M.spawn(R.trainers_rank, 2, devices=CPU2, args=(trainer_hyps(root, "mesh"),), timeout=600)
    with one_torch_thread():
        ref = {kind: R.train_summary(kind, hyp) for kind, hyp in trainer_hyps(root, "one").items()}
    return ranks, ref


@pytest.mark.parametrize("kind", ["seg", "db", "yolo"])
def test_trainer_with_mesh_matches_one_process(trainer_results, kind):
    """Each rank runs the one-process loader and takes its block of every
    global batch (augments included), so 2 steps at world 2 follow the
    one-process run; rank 0 alone writes the checkpoints, and both ranks
    take the same best-checkpoint decision from rank 0's eval."""
    ranks, ref = trainer_results
    (summary, params, files), (summary1, params1, files1) = ranks[0][kind], ranks[1][kind]
    summary_ref, params_ref, files_ref = ref[kind]
    assert summary == summary1 and files == files1 == files_ref
    assert summary["steps"] == summary_ref["steps"] == 2
    assert summary["loss"] == pytest.approx(summary_ref["loss"], rel=1e-5)
    assert summary["best"] == pytest.approx(summary_ref["best"], rel=1e-5, abs=1e-6)
    for k, v in params_ref.items():
        assert np.array_equal(params[k], params1[k]), k
        np.testing.assert_allclose(params[k], v, rtol=0, atol=1e-6, err_msg=k)


# ----- BatchTextDetector(mesh=) ----------------------------------------------------------------------------------


def same_pages(got, want):
    assert len(got) == len(want)
    for (m, r, blks), (wm, wr, wblks) in zip(got, want):
        np.testing.assert_array_equal(m, wm)
        np.testing.assert_array_equal(r, wr)
        assert [(b.xyxy, b.language, b.vertical) for b in blks] == [(b.xyxy, b.language, b.vertical) for b in wblks]
        for a, b in zip(blks, wblks):
            np.testing.assert_array_equal(np.asarray(a.lines), np.asarray(b.lines))


def test_batch_detector_mesh():
    """Two replicas on two CPU devices.  Four pages split into blocks of 2
    and 2, bit-identical to the detector without a mesh (host refine, and
    device refine + packed masks); three pages split into blocks of 2 and
    1, bit-identical to the detector without a mesh on those blocks (on
    the CPU a float32 net of one page rounds otherwise than the same page
    in a batch of 3, by up to 4e-4 on the block rows, 2e-6 on the mask);
    and held to the JAX detector sharded on ``make_mesh(2)`` as
    ``tests/test_torch_batch.py`` holds the port to JAX, but for the grey
    mask, held within one level: at batch 4 XLA's and torch's float32 nets
    put 4 pixels of page 1 on either side of a level with one torch thread
    (1 with eight), mesh or not; the refined masks and blocks are exact.
    One torch thread, as the ranks: with the cores shared by the tier-1
    run's workers, torch's default thread pool made this test 20 times
    slower (573 s)."""
    with one_torch_thread():
        batch_detector_mesh()


def batch_detector_mesh():
    pages = _pages()
    pages4 = pages + [np.ascontiguousarray(pages[1][:, ::-1])]
    port_vars = load_npz(WEIGHTS)
    kw = dict(batch_size=4, input_size=256, half=False, device="cpu")
    for extra in ({}, dict(refine_backend="device", mask_transfer="packed")):
        one = BatchTextDetector(port_vars, **kw, **extra)
        meshed = BatchTextDetector(port_vars, mesh=M.make_mesh(devices=CPU2), **kw, **extra)
        assert len(meshed.replicas) == 2 and meshed.replicas[0] is meshed.model
        assert [len(block[1][2]) for block in meshed.submit(pages)] == [2, 1]
        got = list(meshed.stream(iter(pages4)))
        same_pages(got, list(one.stream(iter(pages4))))
        same_pages(meshed.process_batch(pages), one.process_batch(pages[:2]) + one.process_batch(pages[2:]))
        if not extra:
            host = got
    jdet = JaxBatchTextDetector(load_compact(WEIGHTS), batch_size=4, input_size=256, half=False,
                                mesh=jax_make_mesh(2))
    for (m, r, blks), (jm, jr, jblks) in zip(host, list(jdet.stream(iter(pages4)))):
        _same_blocks(blks, jblks)
        assert np.abs(m.astype(np.int16) - jm).max() <= 1 and (m != jm).mean() < 1e-4
        np.testing.assert_array_equal(r, jr)
