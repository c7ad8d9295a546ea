"""The port's own spans and counters (``comic_text_detector_tpu_torch/
utils/profiling.py``) read against a ``torch.profiler`` trace.

``SpanTracer`` is ``trace.Tracer`` with the port's recorder on for each of
its two phases, from the phase's first unit boundary to its close; each
phase then also keeps its ``spans`` (the port's ``Recording``) and, under
``trace``, what the readers below need of the raw trace: ``base_ns`` (the
trace's ``baseTimeNanoseconds``), ``device`` (each kernel, copy and memset:
start and end in µs on the trace's clock, name, correlation id),
``merged`` (the device's busy intervals, merged, inside the recorder's
window) and ``launches`` (correlation id -> launching thread, time).
``SpanTracer``, ``_Keeping``, ``raw_trace`` and ``merge`` repeat part of
``trace.Tracer`` and ``trace.analyse``; they stand in until ``trace.py``
turns the recorder on and keeps those keys itself, and go then.

The readers take a phase of a ``SpanTracer`` result.  A span is named by
its path, ``collect/group``; ``per`` names the root span whose count is the
number of units (``submit`` or ``collect`` for stream batches, ``page`` for
requests, ``train`` for mini-steps).  Each returns None where it finds
nothing to read.

* :func:`host_ms` - host ms a unit in the spans of one or more paths, their
  self time (duration less the time their children cover) or whole;
* :func:`counter` - a counter a unit, summed over every span;
* :func:`idle_by_span` - the device's idle seconds by the innermost port
  span open on the main thread when each gap began (``outside`` where
  none was);
* :func:`launched` - device ms and kernels a unit launched inside the
  spans of a path, each kernel matched by its correlation id's launch time
  and the launching thread; a launch from a thread with no span of its own
  (autograd's device thread, which runs ``backward``'s kernels while the
  main thread waits in ``train/backward``) is matched against the main
  thread's spans.
"""

from __future__ import annotations

import bisect
import json
import threading
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ctd_bench.trace import _DEVICE_CATS, Tracer

OUTSIDE = "outside"


class _Keeping:
    """A profiler for ``trace.analyse`` that keeps the Chrome JSON it
    exports (a profiler exports its trace once)."""

    def __init__(self, prof):
        self.prof, self.doc = prof, None

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def export_chrome_trace(self, path: str) -> None:
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            self.doc = json.load(f)


def raw_trace(doc: Dict) -> Dict:
    """``base_ns``, ``device`` and ``launches`` (module docstring) of an
    exported trace."""
    device, launches = [], {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args", {})
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            device.append((ts, ts + dur, ev.get("name", ""), args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver") and args.get("correlation") is not None:
            launches[args["correlation"]] = (int(ev.get("tid")), ts)
    return {"base_ns": int(doc.get("baseTimeNanoseconds", 0)), "device": sorted(device), "launches": launches}


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def window_us(rec, base_ns: int) -> Tuple[float, float]:
    """The recorder's window (enable to disable) on the trace's clock."""
    (_, p0), (_, p1) = rec.anchors
    return rec.trace_us(p0, base_ns), rec.trace_us(p1, base_ns)


def annotate(phase: Dict, raw: Dict) -> None:
    """Put what the readers need of ``raw`` into ``phase["trace"]``, the
    device's intervals merged and clipped to the recorder's window."""
    tr = phase["trace"]
    tr.update(base_ns=raw["base_ns"], device=raw["device"], launches=raw["launches"])
    w0, w1 = window_us(phase["spans"], raw["base_ns"])
    tr["merged"] = merge((max(s, w0), min(e, w1)) for s, e, _, _ in raw["device"] if e > w0 and s < w1)


class SpanTracer(Tracer):
    """``trace.Tracer`` with the port's recorder on in each phase (module
    docstring)."""

    def tick(self, units: int) -> bool:
        from comic_text_detector_tpu_torch.utils import profiling

        before = self.state
        go = super().tick(units)
        if before in ("light_start", "full_start"):
            profiling.enable()
        return go

    def _close(self, phase: str, now: float, units: int) -> None:
        from comic_text_detector_tpu_torch.utils import profiling

        rec = profiling.disable()
        keeper = self.prof = _Keeping(self.prof)
        super()._close(phase, now, units)  # stops the profiler and analyses its trace
        self.phases[phase]["spans"] = rec
        annotate(self.phases[phase], raw_trace(keeper.doc))

    def __exit__(self, *exc):
        from comic_text_detector_tpu_torch.utils import profiling

        try:
            profiling.disable()  # a phase cut short leaves the recorder on
        except RuntimeError:
            pass  # it was off
        return super().__exit__(*exc)


def _units(paths: Sequence[str], per: str) -> int:
    return sum(1 for p in paths if p == per)


def host_ms(phase: Dict, names: Sequence[str], per: str, self_time: bool = True) -> Optional[float]:
    """Host ms a unit in the spans whose path is one of ``names``: their
    self time, or (``self_time=False``) their whole duration."""
    rec = phase.get("spans")
    if rec is None:
        return None
    paths = rec.paths()
    n = _units(paths, per)
    own = [i for i, p in enumerate(paths) if p in names and rec.spans[i].end_ns]
    if not n or not own:
        return None
    total = sum(rec.spans[i].end_ns - rec.spans[i].start_ns for i in own)
    if self_time:
        wanted = set(own)
        total -= sum(s.end_ns - s.start_ns for s in rec.spans if s.parent in wanted and s.end_ns)
    return total / n / 1e6


def counter(phase: Dict, name: str, per: str) -> Optional[float]:
    """The counter ``name`` a unit, over every span of the phase."""
    rec = phase.get("spans")
    if rec is None:
        return None
    n = _units(rec.paths(), per)
    total = sum(s.counts.get(name, 0) for s in rec.spans)
    return total / n if n and total else None


def idle_by_span(phase: Dict, main_tid: Optional[int] = None) -> Optional[Dict[str, float]]:
    """Seconds of the device's idle gaps inside the recorder's window, by
    the path of the innermost port span open on the main thread when each
    gap began, ``outside`` where none was."""
    rec, tr = phase.get("spans"), phase.get("trace", {})
    merged = tr.get("merged")
    if rec is None or not merged:
        return None
    base = tr["base_ns"]
    main = threading.main_thread().native_id if main_tid is None else main_tid
    paths = rec.paths()
    spans = sorted((rec.trace_us(s.start_ns, base), rec.trace_us(s.end_ns, base), paths[i])
                   for i, s in enumerate(rec.spans) if s.tid == main and s.end_ns)
    starts = [s for s, _, _ in spans]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        where = OUTSIDE
        # spans on one thread nest: the innermost holding e0 began last
        for j in range(bisect.bisect_right(starts, e0) - 1, -1, -1):
            if spans[j][1] >= e0:
                where = spans[j][2]
                break
            if spans[j][2].count("/") == 0:
                break  # a closed root: nothing earlier holds e0
        gaps[where] += (s1 - e0) * 1e-6
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


def idle_outside_share(phase: Dict) -> Optional[float]:
    """The share of the window's idle time in gaps that began outside every
    port span on the main thread, in %."""
    gaps = idle_by_span(phase)
    if not gaps:
        return None
    total = sum(gaps.values())
    return gaps.get(OUTSIDE, 0.0) / total * 100.0 if total > 0 else None


def launched(phase: Dict, path: str, per: str, main_tid: Optional[int] = None) -> Optional[Tuple[float, float]]:
    """(device ms, kernels) a unit launched inside the spans of ``path``
    (their children included): each device event's correlation id gives its
    launch's thread and time, which a span of ``path`` on that thread (the
    main thread's, for a thread with no spans) holds."""
    rec, tr = phase.get("spans"), phase.get("trace", {})
    if rec is None or not tr.get("launches"):
        return None
    base = tr["base_ns"]
    main = threading.main_thread().native_id if main_tid is None else main_tid
    paths = rec.paths()
    n = _units(paths, per)
    seen = {s.tid for s in rec.spans}
    by_tid: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    for i, s in enumerate(rec.spans):
        if paths[i] == path and s.end_ns:
            by_tid[s.tid].append((rec.trace_us(s.start_ns, base), rec.trace_us(s.end_ns, base)))
    if not n or not by_tid:
        return None
    starts = {tid: [s for s, _ in sorted(v)] for tid, v in by_tid.items()}
    ends = {tid: [e for _, e in sorted(v)] for tid, v in by_tid.items()}
    dev_us, kernels = 0.0, 0
    for s, e, _name, corr in tr["device"]:
        launch = tr["launches"].get(corr)
        if launch is None:
            continue
        tid, ts = launch
        tid = tid if tid in seen else main
        if tid not in starts:
            continue
        j = bisect.bisect_right(starts[tid], ts) - 1  # spans of one path on one thread do not overlap
        if j >= 0 and ts <= ends[tid][j]:
            dev_us += e - s
            kernels += 1
    if not kernels:
        return None
    return dev_us / n / 1e3, kernels / n


def _launched_part(phase: Dict, path: str, per: str, part: int) -> Optional[float]:
    got = launched(phase, path, per)
    return None if got is None else got[part]


def launch_phase(traced: Dict) -> Tuple[str, Dict]:
    """The phase whose trace holds launch records: the light one where it
    does, else the full one (CPU activity traced)."""
    light = traced["light"]
    if light.get("trace", {}).get("launches"):
        return "light", light
    return "full", traced["full"]


# the per-layer metrics these readers give, by the names a benchmark entry
# would take, each from the light phase (launches: ``launch_phase``)
METRICS = {
    "wait_ms.serve": lambda t: host_ms(t["light"], ["wait"], "submit"),
    "group_host_ms.serve": lambda t: host_ms(t["light"], ["collect/group"], "collect"),
    "download_ms.serve": lambda t: host_ms(t["light"], ["collect/download", "collect/fetch"], "collect",
                                           self_time=False),
    "syncs.serve": lambda t: counter(t["light"], "host_syncs", "collect"),
    "refine_host_ms.serve": lambda t: host_ms(t["light"], ["collect/refine"], "collect"),
    "refine_launches.serve": lambda t: _launched_part(launch_phase(t)[1], "collect/refine", "collect", 1),
    "idle_outside_spans.serve": lambda t: idle_outside_share(t["light"]),
    "step_host_ms.page": lambda t: host_ms(t["light"], ["page/step"], "page", self_time=False),
    "group_host_ms.page": lambda t: host_ms(t["light"], ["page/group"], "page"),
    "idle_outside_spans.page": lambda t: idle_outside_share(t["light"]),
    "backward_dev_ms.train": lambda t: _launched_part(launch_phase(t)[1], "train/backward", "train", 0),
    "update_dev_ms.train": lambda t: _launched_part(launch_phase(t)[1], "train/update", "train", 0),
}
