"""The batch stream, the main path: ``BatchTextDetector.stream`` over a
seeded pool of distinct pages, cycled, as a scanlation pipeline feeds it.

``pages_per_s``: the pages of the batches completed in the window over the
window, which runs from the first batch's completion to the last one
completed within ``seconds`` of it.  The pool holds a multiple of the
batch size, so every batch of the window holds the same pages as the
warm-up's: each page's outputs are compared as the timed path produced
them, the first time a sampled page completes in the window, with the net's
outputs for it taken by a wrapper around ``run_net``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict

import torch

from ctd_bench import flops, traffic
from ctd_bench.loops import common
from ctd_bench.harness import ROOT
from ctd_bench.trace import Tracer


def setup(config: Dict, mix: Dict, seed: int, device, trace: bool) -> Dict:
    from comic_text_detector_tpu_torch.pipeline.batch import BatchTextDetector
    from comic_text_detector_tpu_torch.weights import load_npz

    if mix["pool"] % mix["batch_size"]:
        raise ValueError("the pool must hold whole batches")
    pool = traffic.page_pool(mix, seed)
    det = BatchTextDetector(load_npz(os.path.join(ROOT, config["weights"])), batch_size=mix["batch_size"],
                            input_size=mix["input_size"], half=config["dtype"] == "bfloat16",
                            conf_thresh=config["conf_thresh"], nms_thresh=config["nms_thresh"],
                            refine_backend="device", mask_transfer="packed", device=str(device))
    for _ in det.stream(iter(pool), prefetch=mix["prefetch"]):  # builds the kernels, warms every shape
        pass
    return {"det": det, "pool": pool, "mix": mix, "config": config, "device": torch.device(device),
            "sample": traffic.sample_indices(mix, seed, len(pool)), "results": {}, "net": {}}


def reseed(st: Dict, seed: int) -> Dict:
    """The same detector on the pool of another seed, warmed on it (the
    gap probe's many seeds in one process)."""
    st["pool"] = traffic.page_pool(st["mix"], seed)
    st["sample"] = traffic.sample_indices(st["mix"], seed, len(st["pool"]))
    st["results"], st["net"] = {}, {}
    for _ in st["det"].stream(iter(st["pool"]), prefetch=st["mix"]["prefetch"]):
        pass
    return st


def _net_capture(st: Dict, run_net):
    """``run_net`` that keeps the outputs of the sampled pages the first time
    their batch runs (batch c holds pool positions c*B .. c*B+B-1)."""
    calls = [0]
    bs, n = st["mix"]["batch_size"], len(st["pool"])

    def wrapper(model, lb):
        out = run_net(model, lb)
        c = calls[0]
        calls[0] += 1
        for i in range(lb.shape[0]):
            pos = (c * bs + i) % n
            if pos in st["sample"] and pos not in st["net"]:
                st["net"][pos] = tuple(t[i].detach().clone() for t in out)
        return out

    return wrapper


def window(st: Dict, seconds: float, trace: bool) -> Dict:
    """Untraced: the measured window.  Traced: the two phases of
    ``trace.Tracer``, one tick a completed batch."""
    from comic_text_detector_tpu_torch.pipeline import batch

    det, pool, mix = st["det"], st["pool"], st["mix"]
    bs, n = mix["batch_size"], len(pool)
    tracer = Tracer() if trace else None
    patches = [(batch, "run_net", _net_capture(st, batch.run_net))]
    if trace:
        patches += [(batch, "db_decode_batch", common.ranged("decode", batch.db_decode_batch)),
                    (batch, "refine_pages", common.ranged("refine", batch.refine_pages))]
        patches += common.kernel_ranges(tracer.sample)
        det.submit = common.host_timed("submit", det.submit, tracer.sample)
        det.collect = common.host_timed("collect", det.collect, tracer.sample)
    stop = threading.Event()

    def source():
        i = 0
        while not stop.is_set():
            yield pool[i % n]
            i += 1

    t_first = t_last = None
    first_batch = last_batch = 0
    with tracer or contextlib.nullcontext(), common.patched(patches):
        for k, (mask, refined, blk_list) in enumerate(det.stream(source(), prefetch=mix["prefetch"])):
            if k % bs == 0 and not stop.is_set():  # a batch completes: its pages come out together
                now = time.perf_counter()
                if tracer is not None:
                    if not tracer.tick(k // bs):
                        stop.set()
                elif t_first is None:
                    t_first, first_batch = now, k // bs
                elif now - t_first <= seconds:
                    t_last, last_batch = now, k // bs
                else:
                    stop.set()
            pos = k % n
            if pos in st["sample"] and pos not in st["results"]:
                st["results"][pos] = (mask, refined, blk_list)
    out = {"flops_per_unit": flops.net_flops(st["config"], mix["input_size"]) * bs,
           "peak_flops": flops.PEAK_FLOPS[st["config"]["dtype"]]}
    if trace:
        del det.submit, det.collect
        traced = tracer.result()
        pages = traced["light"]["units"] * bs
        out.update(traced=traced, attempted=pages, failed=0)
        return out
    pages = (last_batch - first_batch) * bs
    out.update(pages_per_s=pages / (t_last - t_first), attempted=pages, failed=0)
    return out


def outputs(st: Dict) -> Dict:
    missing = [p for p in st["sample"] if p not in st["results"] or p not in st["net"]]
    if missing:
        raise RuntimeError(f"sampled pool positions {missing} were not served in the window")
    results = []
    for pos in st["sample"]:
        mask, refined, blk_list = st["results"][pos]
        net = tuple(t.float().cpu() for t in st["net"][pos])
        results.append(common.program_page(mask, refined, blk_list, (net[0], net[1][0], net[2][0])))
    return {"pages": [st["pool"][p] for p in st["sample"]], "results": results}


def release(st: Dict) -> None:
    st.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(config: Dict, mix: Dict, seed: int, device, outs: Dict) -> Dict[str, float]:
    return common.check_pages(config, mix, device, outs)
