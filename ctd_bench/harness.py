"""One run of one cell: set-up, the measured window, the check, the
result line.  Driven by data: the cell's entry in ``BENCHMARK.json`` names
its configuration (``configs/<name>.json``) and its traffic mix
(``traffic/<name>.json``), the mix names its loop (``loops/<name>.py``),
and each per-layer metric is read by ``metrics/<metric name>.py``.

A loop module provides:

* ``setup(config, mix, seed, device, trace) -> state``: weights, pool,
  warm-up of every shape the window uses;
* ``window(state, seconds, trace) -> dict``: untraced, the measured
  window and its end-to-end metrics by name; traced, the two phases of
  ``trace.Tracer`` under ``traced``, which the per-layer readers read;
  either way ``attempted``, ``failed``, ``flops_per_unit`` and
  ``peak_flops``;
* ``outputs(state)``: what the timed path produced for the check's sample,
  on the host;
* ``release(state)``: free the program's device memory;
* ``check(config, mix, seed, device, outputs) -> numbers``: the plain
  reference's comparison (``compare.py``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "comic_text_detector_tpu")


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Bench:
    """Where a run finds its pieces by name: the cells and metrics
    (``BENCHMARK.json``), the traffic mixes (``traffic/<name>.json``) and
    the device (the first card, which the cell's chips must be there for).
    The CPU tests give smaller mixes of the same names and the CPU."""

    def __init__(self, spec: str = os.path.join(ROOT, "BENCHMARK.json"), traffic: str = os.path.join(HERE, "traffic"),
                 device: Optional[str] = None):
        self.spec, self.traffic, self.device = spec, traffic, device


def benchmark(bench: Bench = Bench()) -> Dict:
    return load_json(bench.spec)


def cell_entry(spec: Dict, workload: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"ctd_bench: no workload {workload!r} in BENCHMARK.json")


def load_config(name: str) -> Dict:
    return load_json(HERE, "configs", f"{name}.json")


def load_loop(name: str):
    return importlib.import_module(f"ctd_bench.loops.{name}")


def load_reader(metric: str):
    """``metrics/<metric>.py``'s ``read(ctx)``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("ctd_bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: Dict, workload: str) -> Dict[str, List[Dict]]:
    """The end-to-end and per-layer metric entries this cell reports."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": layer}


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def device_info(torch, count: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(count)))}


def run(workload: str, seed: int, seconds: float, trace: bool, t0: float, bench: Bench = Bench()) -> Dict:
    """The whole run; returns the result dict (``correct`` and ``checks``
    included)."""
    import torch

    from ctd_bench import compare, traffic
    from ctd_bench.trace import breakdown, device_window

    spec = benchmark(bench)
    entry = cell_entry(spec, workload)
    if bench.device is None and (not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]):
        raise SystemExit(f"ctd_bench: {workload} needs {entry['chips']} CUDA device(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device = torch.device("cuda", 0) if bench.device is None else torch.device(bench.device)
    config = load_config(entry["config"])
    mix = traffic.load_mix(entry["traffic"], bench.traffic)
    loop = load_loop(mix["loop"])
    wanted = metrics_of(spec, workload)

    state = loop.setup(config, mix, seed, device, trace)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    win = loop.window(state, seconds, trace)
    metrics: Dict[str, Dict] = {}
    result: Dict = {"correct": False, "attempted": int(win["attempted"]), "failed": int(win["failed"])}
    if trace:
        for m in wanted["per_layer"]:
            value = load_reader(m["name"])(win)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in wanted["end_to_end"]:
            value = setup_s if m["name"] == "setup_s" else win.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result["metrics"] = metrics
    if device.type == "cuda":
        result["device"] = device_info(torch, entry["chips"])
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace:
        busy_s, window_s = device_window(win["traced"])
        result["device"]["busy_s"] = float(busy_s)
        result["device"]["window_s"] = float(window_s)
        result["breakdown"] = breakdown(win["traced"])

    outputs = loop.outputs(state)
    loop.release(state)
    del state
    numbers = loop.check(config, mix, seed, device, outputs)
    limits = compare.load_limits(workload)
    result["correct"] = compare.verdict(numbers, limits)
    result["checks"] = {k: {"value": float(numbers.get(k, math.nan)), "limit": limits[k]} for k in limits}
    return result


def main(workload: str, seed: int, seconds: float, trace: bool, t0: float) -> int:
    result = run(workload, seed, seconds, trace, t0)
    found = forbidden_modules()
    if found:
        print(f"ctd_bench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
