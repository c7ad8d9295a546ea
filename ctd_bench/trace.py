"""The traced window of a ``--trace 1`` run, and reading its
``torch.profiler`` traces.

A traced window has two phases, switched by ``Tracer`` at the loop's unit
boundaries (a batch, a request, a mini-step):

* ``light`` (``LIGHT_SECONDS``): the profiler records the device's
  activity alone (CUDA, CUPTI underneath), so the host runs at about its
  untraced speed.  From it come the device's busy seconds (the union of
  the intervals in which a kernel, a copy or a memset ran) over the span
  of its activity, the top device operations, the units completed over
  the phase's host-clock seconds, and the samples of the benchmark's
  host-clock wrappers;
* ``full`` (``FULL_SECONDS``): CPU and CUDA activity, so that each kernel
  is matched to its launch by CUPTI's correlation id and to the
  benchmark's own ``record_function`` range (``ctd_bench.<name>``) the
  launch was made in, by its time on the launching thread; and the idle
  gaps of the device by the innermost range the host's main thread was in
  when each began.  The CPU activity slows the host, so nothing timed by
  the host is read from this phase.

Each trace is exported as Chrome JSON into the run's temporary directory,
read back and deleted.  Where the full phase opened its
``ctd_bench.measured`` range, everything is clipped to it: device
intervals, the ranges begun inside it and the launches made inside it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

RANGE_PREFIX = "ctd_bench."
LIGHT_SECONDS = 5.0
FULL_SECONDS = 3.0
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def start_profiler(cpu: bool) -> torch.profiler.profile:
    """The profiler, recording CPU and CUDA activity (``cpu``) or the
    device's alone (the CPU's where there is no card, so that a CPU run
    still goes through every step)."""
    activities = [torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if cpu or not activities:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    prof = torch.profiler.profile(activities=activities, record_shapes=False, with_stack=False)
    prof.__enter__()
    return prof


class Tracer:
    """The two phases of a traced window (module docstring).  The loop
    calls ``tick(units)`` at every unit boundary with the units completed
    so far, and stops when it returns False; ``sample`` keeps a host-clock
    or a counter sample under the phase it falls in."""

    def __init__(self, light_s: float = LIGHT_SECONDS, full_s: float = FULL_SECONDS):
        self.light_s, self.full_s = light_s, full_s
        self.state = "off"
        self.prof = None
        self.measured = None
        self.t0 = self.u0 = None
        self.samples = {"light": defaultdict(list), "full": defaultdict(list)}
        self.phases: Dict[str, Dict] = {}

    def sample(self, name: str, value: float) -> None:
        if self.state in self.samples:
            self.samples[self.state][name].append(value)

    def _close(self, phase: str, now: float, units: int) -> None:
        if self.measured is not None:
            self.measured.__exit__(None, None, None)
            self.measured = None
        self.phases[phase] = {"window_s": now - self.t0, "units": units - self.u0, "trace": analyse(self.prof)}
        self.prof = None

    def tick(self, units: int) -> bool:
        now = time.perf_counter()
        if self.state == "off":  # the profiler's start is not timed: its phase begins at the next boundary
            self.prof, self.state = start_profiler(cpu=False), "light_start"
        elif self.state in ("light_start", "full_start"):
            self.state = self.state[:-len("_start")]
            self.t0, self.u0 = now, units
            if self.state == "full":
                self.measured = torch.profiler.record_function(RANGE_PREFIX + "measured")
                self.measured.__enter__()
        elif self.state == "light" and now - self.t0 >= self.light_s:
            self._close("light", now, units)
            self.prof, self.state = start_profiler(cpu=True), "full_start"
        elif self.state == "full" and now - self.t0 >= self.full_s:
            self._close("full", now, units)
            self.state = "done"
        return self.state != "done"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.measured is not None:
            self.measured.__exit__(None, None, None)
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
        return False

    def result(self) -> Dict:
        """What the readers read: ``light`` and ``full`` (each its
        ``window_s``, ``units`` and ``trace``) and the samples of each."""
        if self.state != "done":
            raise RuntimeError("the traced window ended before its two phases had run")
        return {"light": self.phases["light"], "full": self.phases["full"],
                "host": dict(self.samples["light"]), "full_host": dict(self.samples["full"])}


def _union_length(intervals) -> float:
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def analyse(prof: torch.profiler.profile, main_tid: Optional[int] = None) -> Dict:
    """Stop ``prof`` and read its trace (see the module docstring).  Times
    are in seconds."""
    prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    if main_tid is None:
        main_tid = threading.main_thread().native_id
    device, launches, ranges = [], {}, defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            device.append((ts, ts + dur, ev.get("name", ""), ev.get("args", {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev.get("tid"), ts)
        elif cat == "user_annotation" and ev.get("name", "").startswith(RANGE_PREFIX):
            name = ev["name"][len(RANGE_PREFIX):]
            ranges[name].append((ts, ts + dur, ev.get("tid")))
    # the measured window: the ``measured`` range where the loop opened
    # one (the steady part of the traced run), else the whole trace
    if ranges.get("measured"):
        ws, we, mtid = ranges["measured"][0]
        device = [(max(s, ws), min(e, we), n, c) for s, e, n, c in device if e > ws and s < we]
        ranges = {k: [sp for sp in v if ws <= sp[0] <= we] for k, v in ranges.items()}
        ranges["measured"] = [(ws, we, mtid)]
        launches = {c: v for c, v in launches.items() if ws <= v[1] <= we}
    out: Dict = {"n_device_events": len(device)}
    if not device:
        out["busy_s"] = 0.0
        return out
    intervals = [(s, e) for s, e, _, _ in device]
    out["busy_s"] = _union_length(intervals) * 1e-6
    out["device_span"] = (min(s for s, _ in intervals) * 1e-6, max(e for _, e in intervals) * 1e-6)

    # device time by kernel name
    by_name = defaultdict(float)
    for s, e, name, _ in device:
        by_name[name] += (e - s) * 1e-6
    out["device_ops"] = sorted(by_name.items(), key=lambda kv: -kv[1])

    # device time and launches inside each range
    range_dev: Dict[str, Dict] = {}
    for name, spans in ranges.items():
        spans = sorted(spans)
        starts = [s for s, _, _ in spans]
        per_kernel = defaultdict(float)
        count_in = 0
        for s, e, kname, corr in device:
            launch = launches.get(corr)
            if launch is None:
                continue
            tid, lts = launch
            i = bisect.bisect_right(starts, lts) - 1
            # ranges of one name do not nest; a launch belongs to the last one begun before it
            if i >= 0 and spans[i][1] >= lts and str(spans[i][2]) == str(tid):
                per_kernel[kname] += (e - s) * 1e-6
                count_in += 1
        range_dev[name] = {"calls": len(spans), "device_s": sum(per_kernel.values()), "kernels": dict(per_kernel),
                           "launches": count_in}
    out["ranges"] = range_dev

    # idle gaps of the device, by the innermost main-thread range at their start
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    window = ranges.get("window") or ranges.get("measured")
    main_tid = str(window[0][2]) if window else str(main_tid)
    main_ranges = sorted((s, e, name) for name, spans in ranges.items() for s, e, tid in spans
                         if str(tid) == main_tid)
    main_starts = [s for s, _, _ in main_ranges]
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        where = "outside"
        i = bisect.bisect_right(main_starts, e0) - 1
        # the innermost range holding e0 began last: walk back from the last begun
        for j in range(i, max(i - 64, -1), -1):
            if main_ranges[j][1] >= e0:
                where = main_ranges[j][2]
                break
        gaps[where] += (s1 - e0) * 1e-6
    out["idle_gaps"] = sorted(gaps.items(), key=lambda kv: -kv[1])
    return out


def breakdown(traced: Dict) -> Dict:
    """The result line's ``breakdown`` from a ``Tracer.result``: the top
    device operations of the light phase and the idle gaps of the full one
    by host range (at most 10 each), names cut to 160 characters."""
    return {
        "device_ops": [[n[:160], s] for n, s in traced["light"]["trace"].get("device_ops", [])[:10]],
        "idle_gaps": [[n, s] for n, s in traced["full"]["trace"].get("idle_gaps", [])[:10]],
    }


def device_window(traced: Dict):
    """(busy seconds, window seconds) of the light phase: the union of its
    device intervals over the span from the first to the last of them."""
    tr = traced["light"]["trace"]
    if not tr.get("n_device_events"):
        return 0.0, traced["light"]["window_s"]
    first, last = tr["device_span"]
    return tr["busy_s"], last - first
