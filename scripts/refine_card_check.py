"""Hold the device refine's card route against its plain route on the card,
and time both.

    python3 scripts/refine_card_check.py [--out refine_card.json]

Run from the root of a checkout on a machine with a CUDA card (it exits 1
without one).  It builds the kernels (``ops/cuda_build.py``), prints what
``nvcc -Xptxas -v`` reports for ``csrc/refine.cu``, then:

1. every case of ``tests/torch_refine_cases.py`` (each bucket with more
   windows than its old slot count, the resample fallback, both refine
   modes, two pages, a window past its cap, no window, the r4 caps, a call
   in several chains): the card route's canvases byte-equal to the plain
   route's on the CPU, no plain dispatch on the card, the chains expected;
   each case 5 times more,
   byte-identical (a race shows only now and then);
2. one call at the stream's scale (two 1500 x 1060 pages, 10 windows in
   the 256 x 256 to 512 x 512 buckets): host ms of the call, device ms
   (CUDA events around the call and a synchronise), kernels launched and
   device ms by kernel name (CUPTI through ``torch.profiler``), for the
   card route and for the plain ops on the card (``_refine_windows`` by
   bucket and slot count, as the route was before);
3. the batch stream (``BatchTextDetector``, flagship weights, batch 4,
   input 1024, bf16, device refine, packed masks) on 12 seeded pages of
   three shapes with the port's recorder on: the ``refine_windows``
   counter equals the blocks grouped (one window a block), one
   ``refine_dispatches`` a shape group of a batch, no plain dispatch, and
   the refined masks equal the stream's with the plain route on the card.

Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from comic_text_detector_tpu_torch.ops import cuda_build  # noqa: E402
from comic_text_detector_tpu_torch.ops import refine as R  # noqa: E402
from tests import torch_refine_cases as C  # noqa: E402


def say(msg: str) -> None:
    print(msg, flush=True)


def plain_on_card(imgs, masks, boxes, pids, mode):
    """refine_pages as it ran on the card before its own stages: the plain
    dispatches by bucket and slot count."""
    pad = (max(b[0] for b in R.BUCKETS), max(b[1] for b in R.BUCKETS))
    return R._refine_pages_plain(imgs, masks, np.asarray(boxes, np.int32).reshape(-1, 4), np.asarray(pids, np.int64),
                                 mode, pad)


def timed(fn, reps: int = 10) -> dict:
    """Host ms of a call (enqueue) and device ms (events to a synchronise),
    the medians of ``reps``; kernels a call and device ms by kernel name
    (CUPTI), from one profiled call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            by_name[ev.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"host_ms": float(np.median(host)), "event_ms": float(np.median(dev)),
            "kernels": sum(v[1] for v in by_name.values()),
            "device_ms": sum(v[0] for v in by_name.values()),
            "by_kernel": {k: {"ms": round(v[0], 4), "launches": v[1]} for k, v in top[:20]}}


def stream_counters(dev, n_pages: int = 12, input_size: int = 1024, half: bool = True) -> dict:
    """Phase 3: the stream's refine counters against the blocks it grouped,
    and its refined masks against the plain route's on the card."""
    from comic_text_detector_tpu_torch.pipeline import BatchTextDetector
    from comic_text_detector_tpu_torch.utils import profiling
    from comic_text_detector_tpu_torch.weights import load_npz
    from ctd_bench.pages import synthetic_page

    rng = np.random.default_rng(2024)
    shapes = ((1500, 1060), (1056, 1500), (1754, 1240))
    pages = [synthetic_page(rng, *shapes[i % 3], colour=i % 4 < 2) for i in range(n_pages)]
    det = BatchTextDetector(load_npz(os.path.join(ROOT, "data", "flagship_r2.npz")), batch_size=4,
                            input_size=input_size, half=half, refine_backend="device", mask_transfer="packed",
                            device=str(dev))
    list(det.stream(pages[:4]))  # warm up
    with C.patched(None) as plain:
        profiling.enable()
        try:
            got = list(det.stream(pages))
        finally:
            rec = profiling.disable()
    counted = defaultdict(int)
    for sp in rec.spans:
        for k, v in (sp.counts or {}).items():
            counted[k] += v
    blocks = sum(len(b) for _, _, b in got)
    groups = sum(len({p.shape[:2] for p in pages[i:i + 4]}) for i in range(0, len(pages), 4))
    # the same pages with the plain route on the card
    real = R._refine_pages_cuda
    R._refine_pages_cuda = R._refine_pages_plain
    try:
        ref = list(det.stream(pages))
    finally:
        R._refine_pages_cuda = real
    same = all(np.array_equal(a[1], b[1]) for a, b in zip(got, ref))
    res = {"pages": len(pages), "blocks": blocks, "refine_windows": counted["refine_windows"],
           "refine_windows_exact": counted["refine_windows_exact"],
           "refine_windows_resampled": counted["refine_windows_resampled"],
           "refine_dispatches": counted["refine_dispatches"], "shape_groups": groups,
           "plain_dispatches": plain[0], "refined_equal_plain_route": same}
    if (res["refine_windows"] != blocks or res["refine_dispatches"] != groups or plain[0] or not same
            or res["refine_windows_exact"] + res["refine_windows_resampled"] != blocks):
        raise SystemExit(f"FAIL: the stream's refine counters or masks: {res}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        say("no CUDA device")
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    say(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    say(f"built in {time.perf_counter() - t0:.1f} s: {built}")
    ptxas = subprocess.run([cuda_build._nvcc(), *[f for f in cuda_build.NVCC_FLAGS if f != "-shared"], "-Xptxas", "-v",
                            "-c", "-o", os.devnull, os.path.join(cuda_build.CSRC_DIR, "refine.cu")],
                           capture_output=True, text=True)
    say("ptxas: " + " | ".join(ln.strip() for ln in (ptxas.stdout + ptxas.stderr).splitlines()
                               if "registers" in ln or "spill" in ln or "error" in ln))
    dev = torch.device("cuda")
    out = {"card": smi, "cases": [], "repeats_identical": True}

    for name in C.CASES:
        got = C.check(name, dev)
        torch.cuda.synchronize()
        say(f"  {json.dumps(got)}")
        out["cases"].append(got)
        if got["diff"] or got["plain_dispatches_card"] or got["chains"] != got["chains_expected"]:
            raise SystemExit(f"FAIL: case {name} differs from the plain route: {got}")
        imgs, masks, boxes, pids, mode, caps = C.case(name)
        with C.patched(caps, C.CHAIN_WINDOWS.get(name)):
            it, mt = torch.from_numpy(imgs).to(dev), torch.from_numpy(masks).to(dev)
            first = R.refine_pages(it, mt, boxes, pids, mode).clone()
            for _ in range(5):
                again = R.refine_pages(it, mt, boxes, pids, mode)
                if not torch.equal(again, first):
                    out["repeats_identical"] = False
                    raise SystemExit(f"FAIL: case {name} is not repeatable")
    say("all cases byte-equal to the plain route, each repeated 5 times identically")

    # one call at the stream's scale
    imgs, masks = C.synthetic_pages(11, hw=(1500, 1060))
    rng = np.random.default_rng(5)
    boxes = np.concatenate([C._boxes_in_bucket(rng, bi, k, hw=(1500, 1060)) for bi, k in ((0, 4), (1, 2), (2, 2), (5, 2))])
    pids = rng.integers(0, 2, len(boxes))
    it, mt = torch.from_numpy(imgs).to(dev), torch.from_numpy(masks).to(dev)
    ref = R.refine_pages(torch.from_numpy(imgs), torch.from_numpy(masks), boxes, pids, 0)
    if not torch.equal(R.refine_pages(it, mt, boxes, pids, 0).cpu(), ref):
        raise SystemExit("FAIL: the stream-scale call differs from the plain route")
    out["stream_call"] = {"windows": len(boxes), "card_route": timed(lambda: R.refine_pages(it, mt, boxes, pids, 0)),
                          "plain_on_card": timed(lambda: plain_on_card(it, mt, boxes, pids, 0), reps=5)}
    for k, v in out["stream_call"].items():
        if isinstance(v, dict):
            say(f"  {k}: host {v['host_ms']:.2f} ms, events {v['event_ms']:.3f} ms, {v['kernels']} kernels, "
                f"CUPTI {v['device_ms']:.3f} ms; top: " + ", ".join(
                    f"{n[:48]} {d['ms']:.4f}/{d['launches']}" for n, d in list(v["by_kernel"].items())[:8]))
    out["stream"] = stream_counters(dev)
    say(f"  stream: {json.dumps(out['stream'])}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"ok": True, "cases": len(out["cases"]),
                      "card_route_ms": out["stream_call"]["card_route"]["event_ms"],
                      "plain_ms": out["stream_call"]["plain_on_card"]["event_ms"]}))


if __name__ == "__main__":
    main()
