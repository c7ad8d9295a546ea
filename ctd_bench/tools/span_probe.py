"""The port's spans and counters on the card: where a cell's idle device
time goes by the port's own stages, the clock check of the mapping onto
the profiler's trace, the recorder's cost, and the host's sync sites.

    python3 ctd_bench/tools/span_probe.py cell --workload <cell> --seed <n>
    python3 ctd_bench/tools/span_probe.py clock
    python3 ctd_bench/tools/span_probe.py cost
    python3 ctd_bench/tools/span_probe.py syncs --workload <serve or page cell> --seed <n> [--batches 20]

``cell`` sets the cell up as a run does, then runs its traced window with
``spans.SpanTracer`` in place of ``trace.Tracer`` (the port's recorder on
in both phases) and prints one JSON line: the per-layer metrics of
``spans.METRICS`` that apply to the cell, the light phase's idle seconds by
port span (also one line a span on stderr), host ms a unit by span (self
time), counters a unit, spans a unit, and the phase the launch readers
used.  No comparison with the reference is made.

``clock``: a float32 GEMM of several ms, then a span around
``torch.cuda.synchronize()``, 10 times under a CUDA-activity profile and 10
under a CPU and CUDA one; mapped onto the trace's clock each span must hold
its GEMM's end and close within 0.2 ms of it.  Prints the offsets.

``cost``: ns a call of ``span`` and ``count`` with the recorder off and
on, on this host.

``syncs``: ``--batches`` units of a serve or page cell's path (stream
batches, or page requests) under ``torch.cuda.set_sync_debug_mode
("warn")``: every synchronising call, by the innermost frame of the port
that made it and by the port span open then, a unit, beside the
``host_syncs`` counter's count.

Every mode appends its JSON line to ``--out`` too (default
``span_probe_<mode>.json`` in the working directory).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import timeit
import traceback
import warnings
from collections import Counter, defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".ctd_bench_cache", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".ctd_bench_cache", "triton"))
os.environ.setdefault("OMP_NUM_THREADS", "1")  # as ``run.py`` sets it

SUFFIX = {"stream": ".serve", "page": ".page", "train_db": ".train"}
PER = {"stream": "collect", "page": "page", "train_db": "train"}


def _cell(workload: str, traffic_dir=None):
    from ctd_bench import harness, traffic

    entry = harness.cell_entry(harness.benchmark(), workload)
    config = harness.load_config(entry["config"])
    mix = traffic.load_mix(entry["traffic"], traffic_dir or os.path.join(ROOT, "ctd_bench", "traffic"))
    return config, mix, harness.load_loop(mix["loop"])


def _device(name):
    import torch

    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("span_probe: no CUDA device (pass --device cpu for a CPU rehearsal)")
    return torch.device("cuda", 0)


def _phase_table(phase, per):
    """A phase's units, spans a unit, and by span path: host ms a unit
    (self time), counters a unit, (device ms, kernels) a unit launched."""
    from ctd_bench import spans

    rec = phase["spans"]
    paths = rec.paths()
    n = sum(1 for p in paths if p == per)
    counts = defaultdict(int)
    for p, s in zip(paths, rec.spans):
        for k, v in s.counts.items():
            counts[f"{p}:{k}"] += v
    own = sorted(set(paths))
    host = {p: spans.host_ms(phase, [p], per) for p in own}
    return {"units": n, "spans_per_unit": len(rec.spans) / max(n, 1), "dropped": rec.dropped,
            "host_ms_self": dict(sorted(host.items(), key=lambda kv: -(kv[1] or 0.0))),
            "counts": {k: v / max(n, 1) for k, v in sorted(counts.items())},
            "idle_s": spans.idle_by_span(phase),
            "launches": {p: spans.launched(phase, p, per) for p in own}}


def cell(args) -> dict:
    from ctd_bench import spans
    from ctd_bench.loops import common

    device = _device(args.device)
    config, mix, loop = _cell(args.workload, args.traffic)
    kind = mix["loop"]
    state = loop.setup(config, mix, args.seed, device, True)
    with common.patched([(loop, "Tracer", spans.SpanTracer)]):
        win = loop.window(state, 0.0, True)  # a traced window's phases are fixed
    traced = win["traced"]
    light = traced["light"]
    out = {"workload": args.workload, "seed": args.seed, "device": _device_name(device),
           "metrics": {}, "idle_share": common.idle_share(win)}
    for name, read in spans.METRICS.items():
        if name.endswith(SUFFIX[kind]):
            out["metrics"][name] = read(traced)
    out["launch_phase"] = spans.launch_phase(traced)[0]
    out["light_units"] = light["units"]
    out["light_window_s"] = light["window_s"]
    for phase_name in ("light", "full"):
        phase = traced[phase_name]
        tr = phase["trace"]
        launch_tids = Counter(tid for tid, _ in tr.get("launches", {}).values())
        out[phase_name + "_threads"] = {"main": threading.main_thread().native_id,
                                        "spans": sorted({s.tid for s in phase["spans"].spans}),
                                        "launches": launch_tids.most_common(4),
                                        "device_events": len(tr.get("device", [])),
                                        "window_us": spans.window_us(phase["spans"], tr.get("base_ns", 0)),
                                        "first_launch_us": min((ts for _, ts in tr.get("launches", {}).values()),
                                                               default=None)}
        out[phase_name] = _phase_table(phase, PER[kind])
    # the benchmark's own wrappers over the same light phase, for comparison
    for name in ("submit", "collect", "request_ms"):
        if traced["host"].get(name):
            out.setdefault("wrappers_ms", {})[name] = common.host_mean(win, name)
    for path, secs in (out["light"]["idle_s"] or {}).items():
        print(f"span_probe idle {args.workload} {path} {secs!r} s", file=sys.stderr)
    return out


def _device_name(device):
    import torch

    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def clock(args) -> dict:
    import torch

    from comic_text_detector_tpu_torch.utils import profiling
    from ctd_bench.spans import _Keeping, raw_trace
    from ctd_bench.trace import analyse, start_profiler

    device = _device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.randn(6144, 6144, device=device)
    for _ in range(3):
        a @ a
    torch.cuda.synchronize()
    out = {"device": _device_name(device)}
    for cpu in (False, True):
        prof = start_profiler(cpu=cpu)
        profiling.enable()
        for _ in range(10):
            b = a @ a
            with profiling.span("sync"):
                torch.cuda.synchronize()
        rec = profiling.disable()
        keeper = _Keeping(prof)
        analyse(keeper)
        raw = raw_trace(keeper.doc)
        base = raw["base_ns"]
        gemms = [(s, e) for s, e, name, _ in raw["device"] if e - s >= 2000.0]
        rows = []
        for sp, (ks, ke) in zip(rec.spans, gemms):
            s, e = rec.trace_us(sp.start_ns, base), rec.trace_us(sp.end_ns, base)
            rows.append({"kernel_us": ke - ks, "span_start_to_kernel_end_us": ke - s, "span_end_after_kernel_us": e - ke,
                         "holds_end": s <= ke <= e, "within_200us": 0.0 <= e - ke < 200.0})
        out["cpu_and_cuda" if cpu else "cuda"] = {"n_gemms": len(gemms), "rows": rows,
                                                   "ok": len(rows) == 10 and all(r["holds_end"] and r["within_200us"]
                                                                                 for r in rows)}
        del b
    return out


def cost(args) -> dict:
    from comic_text_detector_tpu_torch.utils import profiling

    n = 1_000_000

    def with_span():
        with profiling.span("x"):
            pass

    def call_span():
        profiling.span("x")

    def call_count():
        profiling.count("host_syncs")

    def empty():
        pass

    out = {"host": os.uname().nodename, "python": sys.version.split()[0]}
    for _ in range(2):  # the second round is kept
        out["off_ns"] = {name: min(timeit.repeat(fn, number=n, repeat=3)) / n * 1e9
                         for name, fn in (("span()", call_span), ("count()", call_count),
                                          ("with span()", with_span), ("empty call", empty))}
    m = 200_000
    profiling.enable()
    try:
        def with_span_count():
            with profiling.span("x"):
                profiling.count("host_syncs")

        out["on_ns"] = {"with span()": min(timeit.repeat(with_span, number=m, repeat=1)) / m * 1e9,
                        "with span() + count()": min(timeit.repeat(with_span_count, number=m, repeat=1)) / m * 1e9}
    finally:
        profiling.disable()
    return out


def syncs(args) -> dict:
    import torch

    from comic_text_detector_tpu_torch.utils import profiling

    device = _device(args.device)
    config, mix, loop = _cell(args.workload, args.traffic)
    if mix["loop"] not in ("stream", "page"):
        raise SystemExit("span_probe syncs: a serve or page cell")
    st = loop.setup(config, mix, args.seed, device, False)
    det, pool = st["det"], st["pool"]
    port = os.path.join(ROOT, "comic_text_detector_tpu_torch")
    sites, seen = Counter(), []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(port)]
        site = (f"{os.path.relpath(frames[-1].filename, ROOT)}:{frames[-1].lineno} {frames[-1].name}: "
                f"{frames[-1].line}" if frames else "outside the port")
        sites[site] += 1
        seen.append((time.perf_counter_ns(), threading.get_native_id()))

    batches = args.batches
    pages = [pool[i % len(pool)] for i in range(batches * mix.get("batch_size", 1))]
    show, filters = warnings.showwarning, warnings.filters[:]
    profiling.enable()
    warnings.simplefilter("always")
    warnings.showwarning = hook
    if device.type == "cuda":
        torch.cuda.set_sync_debug_mode("warn")
    try:
        if mix["loop"] == "stream":
            for _ in det.stream(iter(pages), prefetch=mix["prefetch"]):
                pass
        else:
            for page in pages:
                det(page)
    finally:
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = show
        warnings.filters[:] = filters
        rec = profiling.disable()
    counted = sum(s.counts.get("host_syncs", 0) for s in rec.spans) + rec.counts.get("host_syncs", 0)
    by_span = Counter()
    paths = rec.paths()
    for t, tid in seen:  # the innermost span of that thread open at the time
        inside = [i for i, s in enumerate(rec.spans) if s.tid == tid and s.start_ns <= t <= s.end_ns]
        by_span[paths[max(inside)] if inside else "outside"] += 1
    return {"device": _device_name(device), "batches": batches,
            "sync_calls_per_batch": sum(sites.values()) / batches,
            "host_syncs_counter_per_batch": counted / batches,
            "sites_per_batch": {k: v / batches for k, v in sites.most_common()},
            "by_span_per_batch": {k: v / batches for k, v in by_span.most_common()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("cell", "clock", "cost", "syncs"))
    p.add_argument("--workload", default="serve-bf16-1024")
    p.add_argument("--seed", type=int, default=3000000007)
    p.add_argument("--batches", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal")
    p.add_argument("--traffic", default=None, help="a directory of traffic mixes (the CPU tests' small ones)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    result = {"cell": cell, "clock": clock, "cost": cost, "syncs": syncs}[args.mode](args)
    result["probe_s"] = time.perf_counter() - t0
    line = json.dumps(result)
    print(line, flush=True)
    out = args.out or f"span_probe_{args.mode}.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
