"""One client, closed loop: ``TextDetector.__call__`` on the next page of a
seeded pool as soon as the last one returns, as a translation tool runs it
a page at a time.

``page_ms_p95``: the 95th percentile of the latency of every request of
the window (host clock around the call, which returns host arrays).  The
window is every request begun within ``seconds``.  Each sampled page's
outputs are compared the first time it is served in the window, with the
net's outputs taken by a wrapper around ``run_net``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import numpy as np
import torch

from ctd_bench import flops, traffic
from ctd_bench.loops import common
from ctd_bench.loops.stream import check, release  # noqa: F401 (this cell's check and release are the stream's)
from ctd_bench.harness import ROOT
from ctd_bench.trace import Tracer


def setup(config: Dict, mix: Dict, seed: int, device, trace: bool) -> Dict:
    from comic_text_detector_tpu_torch.pipeline.detector import TextDetector
    from comic_text_detector_tpu_torch.weights import load_npz

    pool = traffic.page_pool(mix, seed)
    det = TextDetector(variables=load_npz(os.path.join(ROOT, config["weights"])),
                       input_size=mix["input_size"], device=str(device), half=config["dtype"] == "bfloat16",
                       conf_thresh=config["conf_thresh"], nms_thresh=config["nms_thresh"],
                       refine_backend="device", mask_transfer="packed")
    for page in pool:  # builds the kernels, warms every shape
        det(page)
    return {"det": det, "pool": pool, "mix": mix, "config": config,
            "sample": traffic.sample_indices(mix, seed, len(pool)), "results": {}, "net": {}, "pos": [None]}


def reseed(st: Dict, seed: int) -> Dict:
    """The same detector on the pool of another seed, warmed on it (the
    gap probe's many seeds in one process)."""
    st["pool"] = traffic.page_pool(st["mix"], seed)
    st["sample"] = traffic.sample_indices(st["mix"], seed, len(st["pool"]))
    st["results"], st["net"] = {}, {}
    for page in st["pool"]:
        st["det"](page)
    return st


def _net_capture(st: Dict, run_net):
    def wrapper(model, lb):
        out = run_net(model, lb)
        pos = st["pos"][0]
        if pos in st["sample"] and pos not in st["net"]:
            st["net"][pos] = tuple(t[0].detach().clone() for t in out)
        return out

    return wrapper


def window(st: Dict, seconds: float, trace: bool) -> Dict:
    """Untraced: the measured window.  Traced: the two phases of
    ``trace.Tracer``, one tick a request."""
    from comic_text_detector_tpu_torch.pipeline import detector

    det, pool = st["det"], st["pool"]
    tracer = Tracer() if trace else None
    patches = [(detector, "run_net", _net_capture(st, detector.run_net))]
    if trace:
        patches += [(detector, "refine_page", common.ranged("refine", detector.refine_page))]
        patches += common.kernel_ranges(tracer.sample)
    lat = []
    with tracer or contextlib.nullcontext(), common.patched(patches):
        t_start = time.perf_counter()
        k = 0
        while tracer.tick(k) if tracer is not None else time.perf_counter() - t_start < seconds:
            pos = k % len(pool)
            st["pos"][0] = pos
            t = time.perf_counter()
            result = det(pool[pos])
            ms = (time.perf_counter() - t) * 1e3
            lat.append(ms)
            if tracer is not None:
                tracer.sample("request_ms", ms)
            if pos in st["sample"] and pos not in st["results"]:
                st["results"][pos] = result
            k += 1
        # a window shorter than one pass over the pool (the CPU tests') serves
        # the sampled pages it missed after it closes, through the same call
        for pos in st["sample"]:
            if pos not in st["results"]:
                st["pos"][0] = pos
                st["results"][pos] = det(pool[pos])
    out = {"flops_per_unit": flops.net_flops(st["config"], st["mix"]["input_size"]),
           "peak_flops": flops.PEAK_FLOPS[st["config"]["dtype"]]}
    if trace:
        traced = tracer.result()
        out.update(traced=traced, attempted=traced["light"]["units"], failed=0)
        return out
    print(f"ctd_bench: {len(lat)} requests in the window", flush=True)
    out.update(page_ms_p95=float(np.percentile(lat, 95)), attempted=len(lat), failed=0)
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
