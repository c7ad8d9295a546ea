"""DB head fine-tuning: ``training/steps.py::db_train_step`` as
``training/db_trainer.py::train`` builds and runs it (the DB head on the
frozen trunk and U-Net trunk of the weights file, the mix's
``hyp_train``: ``DB_DEFAULTS``' Adam with coupled weight decay, warm-up
schedule and accumulation), on a seeded pool of device-resident batches.

Set-up builds the train state once and drives it through the check's
first ``checked_updates`` optimizer updates (``checked_updates`` x
accumulation mini-steps, each on its own batch of the pool), keeping their
losses, the first update's gradient as Adam took it (its first moment
over 1 - b1) and the parameters' change over them; the window then runs
the same state on.  ``train_step_ms``: the window's seconds over the
mini-steps completed in it, optimizer updates included (host clock from
one device synchronisation to another).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Dict

import torch

from ctd_bench import flops, traffic
from ctd_bench.harness import ROOT
from ctd_bench.trace import RANGE_PREFIX, Tracer

LOSS_KEYS = ("loss", "loss_shrink_maps", "loss_threshold_maps", "loss_binary_maps")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def upload(pool, device):
    return [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in pool]


def setup(config: Dict, mix: Dict, seed: int, device, trace: bool, batches=None) -> Dict:
    """``batches``: the gap probe's faulted pool in place of the seed's."""
    from comic_text_detector_tpu_torch.training.seg_trainer import build_model, make_lr_schedule
    from comic_text_detector_tpu_torch.training.steps import Optimizer, create_db_train_state, db_train_step
    from comic_text_detector_tpu_torch.weights import load_npz, train_from_deploy

    hyp = mix["hyp_train"]
    k = int(hyp["accumulation_steps"])
    checked = int(mix["checked_updates"]) * k
    if mix["pool"] < checked:
        raise ValueError("the check's mini-steps need a batch each")
    if batches is None:
        batches = upload(traffic.train_pool(mix, seed), device)
    variables = train_from_deploy(load_npz(os.path.join(ROOT, config["weights"])), with_db=True)
    model = build_model(variables, config["seg_db_act"], with_db=True).to(device)
    tx = functools.partial(Optimizer, kind="adam", lr=make_lr_schedule(hyp, mix["pool"]), momentum=hyp["momentum"],
                           weight_decay=hyp["weight_decay"], accumulation_steps=k)
    state = create_db_train_state(model, tx)
    use_bce = hyp["loss"] == "bce"
    names = [n for n, _ in model.dbnet.named_parameters()]
    params = dict(model.dbnet.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    losses, grad = [], None
    for i in range(checked):
        m = db_train_step(state, batches[i], use_bce)
        losses.append(torch.stack([m[key] for key in LOSS_KEYS]))
        if i == k - 1:  # the first update: Adam's first moment is (1 - b1) x the gradient it took
            b1 = state.optimizer.inner.param_groups[0]["betas"][0]
            adam = state.optimizer.inner.state
            # a step that took no gradient leaves no first moment: it took nothing
            grad = {n: (adam[params[n]]["exp_avg"].detach() / (1 - b1) if "exp_avg" in adam.get(params[n], {})
                        else torch.zeros_like(params[n])) for n in names}
    change = {n: params[n].detach() - before[n] for n in names}
    got = {"losses": torch.stack(losses).cpu().tolist(), "grad": {n: g.cpu() for n, g in grad.items()},
           "change": {n: c.cpu() for n, c in change.items()}}
    _sync(device)
    return {"state": state, "batches": batches, "mix": mix, "config": config, "device": torch.device(device),
            "use_bce": use_bce, "next": checked, "got": got, "step": db_train_step}


def window(st: Dict, seconds: float, trace: bool) -> Dict:
    """Untraced: the measured window.  Traced: the two phases of
    ``trace.Tracer``, one tick a mini-step, with the allocator's peak reset
    at its start."""
    state, batches, step = st["state"], st["batches"], st["step"]
    dev = st["device"]
    out = {"flops_per_unit": flops.db_train_flops(st["config"], st["mix"]["imgsz"], st["mix"]["batch"]),
           "peak_flops": flops.PEAK_FLOPS[st["config"]["dtype"]]}
    if trace:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        n = 0
        with Tracer() as tracer:
            while tracer.tick(n):
                with torch.profiler.record_function(RANGE_PREFIX + "step"):
                    step(state, batches[st["next"] % len(batches)], st["use_bce"])
                st["next"] += 1
                n += 1
        traced = tracer.result()
        out.update(traced=traced, attempted=traced["light"]["units"], failed=0)
        if dev.type == "cuda":
            out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        return out
    n = 0
    _sync(dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        step(state, batches[st["next"] % len(batches)], st["use_bce"])
        st["next"] += 1
        n += 1
    _sync(dev)
    out.update(train_step_ms=(time.perf_counter() - t0) / n * 1e3, attempted=n, failed=0)
    return out


def outputs(st: Dict) -> Dict:
    return {"got": st["got"], "batches": [{k: v for k, v in b.items()} for b in st["batches"]]}


def release(st: Dict) -> None:
    st.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_run(config: Dict, mix: Dict, device, batches, mode: str = "f32") -> Dict:
    """The reference's losses, first gradient and change over the checked
    updates, on the same batches (``mode`` as ``reference/pipeline.py::
    precision``)."""
    from ctd_bench.reference import pipeline as ref
    from ctd_bench.reference.train import DBTrainer

    model = ref.db_train_model(config, device)
    trainer = DBTrainer(model, mix["hyp_train"], mix["pool"])
    before = {n: p.detach().clone() for n, p in trainer.params.items()}
    losses = []
    with ref.precision(mode):
        for i in range(int(mix["checked_updates"]) * trainer.k):
            losses.append(trainer.mini_step(batches[i]))
    out = {"losses": losses, "grad": {n: g.cpu() for n, g in trainer.first_grad.items()},
           "change": {n: (p.detach() - before[n]).cpu() for n, p in trainer.params.items()}}
    del trainer, model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def check(config: Dict, mix: Dict, seed: int, device, outs: Dict) -> Dict[str, float]:
    from ctd_bench import compare

    ref = reference_run(config, mix, device, outs["batches"])
    return compare.train_numbers(outs["got"], ref)
