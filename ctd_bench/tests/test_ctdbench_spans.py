"""``spans.py`` on a synthetic trace and synthetic port spans: self time,
counters, idle gaps by span, launches by span; the trace's existing
analysis and readers unchanged by what ``SpanTracer`` adds; and
``SpanTracer`` on the CPU around the port's recorder."""

import json
import time

import pytest

from ctd_bench import spans
from ctd_bench.loops import common
from ctd_bench.trace import analyse, breakdown
from comic_text_detector_tpu_torch.utils import profiling
from comic_text_detector_tpu_torch.utils.profiling import Recording, Span

MAIN, OTHER, HELPER = 11, 22, 33
BASE_NS = 1_000_000_000_000
OFFSET_NS = 5_000_000_000  # Unix time minus perf_counter time


def _perf(us: float) -> int:
    """The perf_counter_ns time that maps to ``us`` on the trace's clock."""
    return int(BASE_NS + us * 1e3 - OFFSET_NS)


def _recording() -> Recording:
    """One batch: ``collect`` [0, 100] µs with ``group`` [10, 40] and
    ``refine`` [50, 90] on the main thread, and a span on another thread."""
    s = [Span("collect", _perf(0), _perf(100), MAIN, -1, 0, {}),
         Span("group", _perf(10), _perf(40), MAIN, 0, 0, {"host_syncs": 2}),
         Span("refine", _perf(50), _perf(90), MAIN, 0, 0, {"host_syncs": 1}),
         Span("collect", _perf(55), _perf(70), OTHER, -1, 1, {})]
    anchors = ((_perf(-10) + OFFSET_NS, _perf(-10)), (_perf(200) + OFFSET_NS, _perf(200)))
    return Recording(s, {}, 0, anchors)


def _chrome() -> dict:
    """Device events (µs): k1 [0, 20] launched at 5 (in ``collect``), k2
    [45, 60] at 55 (in ``refine``), k3 [95, 120] at 85 (in ``refine``), k4
    [130, 140] at 125 (outside), k5 [140, 150] launched at 60 from the
    other thread, k6 [150, 160] launched at 60 from a thread with no spans
    (as autograd's device thread launches ``backward``'s kernels); a
    benchmark range around the batch."""
    kernels = [(0, 20, 5, MAIN), (45, 60, 55, MAIN), (95, 120, 85, MAIN), (130, 140, 125, MAIN), (140, 150, 60, OTHER),
               (150, 160, 60, HELPER)]
    ev = []
    for corr, (s, e, launch, tid) in enumerate(kernels, 1):
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": s, "dur": e - s, "tid": 7,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch, "dur": 2,
                   "tid": tid, "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "user_annotation", "name": "ctd_bench.collect", "ts": -1, "dur": 102, "tid": MAIN})
    return {"traceEvents": ev, "baseTimeNanoseconds": BASE_NS}


class _FakeProf:
    """What ``trace.analyse`` takes: a stopped profiler that exports a
    given trace."""

    def __init__(self, doc):
        self.doc = doc

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump(self.doc, f)


def _phase():
    keeper = spans._Keeping(_FakeProf(_chrome()))
    phase = {"window_s": 1.0, "units": 1, "trace": analyse(keeper, main_tid=MAIN), "spans": _recording()}
    before = json.loads(json.dumps(phase["trace"]))
    spans.annotate(phase, spans.raw_trace(keeper.doc))
    return phase, before


def test_self_time_and_counters():
    phase, _ = _phase()
    assert spans.host_ms(phase, ["collect/group"], "collect") == pytest.approx(0.030 / 2)
    # collect's self time: 100 - 30 - 40 on the main thread, 15 on the other
    assert spans.host_ms(phase, ["collect"], "collect") == pytest.approx((0.030 + 0.015) / 2)
    assert spans.host_ms(phase, ["collect/group", "collect/refine"], "collect", self_time=False) == \
        pytest.approx(0.070 / 2)
    assert spans.counter(phase, "host_syncs", "collect") == 1.5
    assert spans.host_ms(phase, ["nothing"], "collect") is None
    assert spans.counter(phase, "host_syncs", "page") is None


def test_idle_by_span():
    phase, _ = _phase()
    got = spans.idle_by_span(phase, main_tid=MAIN)
    # gaps 20-45 (in group), 60-95 (in refine), 120-130 (outside)
    assert got == pytest.approx({"collect/refine": 35e-6, "collect/group": 25e-6, "outside": 10e-6})
    assert list(got) == ["collect/refine", "collect/group", "outside"]


def test_idle_outside_share_reads_the_main_thread():
    phase, _ = _phase()
    gaps = spans.idle_by_span(phase, main_tid=MAIN)
    assert gaps["outside"] / sum(gaps.values()) * 100 == pytest.approx(100 / 7)
    # seen from the other thread, the gap from 60 falls in its own collect
    assert spans.idle_by_span(phase, main_tid=OTHER) == pytest.approx({"collect": 35e-6, "outside": 35e-6})


def test_launches_by_span():
    phase, _ = _phase()
    # k2 and k3 from the main thread, and k6 from the thread with no spans;
    # k5 was launched from another thread in refine's time
    assert spans.launched(phase, "collect/refine", "collect", main_tid=MAIN) == pytest.approx((0.050 / 2, 1.5))
    # k1, k2, k3, k6 inside the main thread's collect, and k5 inside the other thread's
    assert spans.launched(phase, "collect", "collect", main_tid=MAIN) == pytest.approx((0.080 / 2, 2.5))
    assert spans.launched(phase, "collect/group", "collect") is None


def test_existing_analysis_and_readers_unchanged():
    phase, before = _phase()
    after = {k: phase["trace"][k] for k in before}
    assert json.loads(json.dumps(after)) == before
    assert before["busy_s"] == pytest.approx(90e-6)
    win = {"traced": {"light": phase, "full": phase, "host": {}, "full_host": {}}}
    assert common.idle_share(win) == pytest.approx((160 - 90) / 160 * 100)
    assert common.range_ms_per(win, "collect") == pytest.approx(0.060)
    plain = {"traced": {"light": {"window_s": 1.0, "units": 1, "trace": before},
                        "full": {"window_s": 1.0, "units": 1, "trace": before}, "host": {}, "full_host": {}}}
    assert common.idle_share(plain) == common.idle_share(win)
    assert breakdown(plain["traced"]) == breakdown(win["traced"])


def test_readers_find_nothing_without_spans():
    phase, _ = _phase()
    bare = {"window_s": 1.0, "units": 1, "trace": phase["trace"]}
    traced = {"light": bare, "full": bare}
    for name, read in spans.METRICS.items():
        assert read(traced) is None, name


def test_span_tracer_on_the_cpu():
    """Two phases, the port's recorder on in each from its first unit
    boundary to its close, off after."""
    tracer = spans.SpanTracer(light_s=0.2, full_s=0.2)
    n = 0
    with tracer:
        while tracer.tick(n):
            with profiling.span("train", profiling.new_unit()):
                with profiling.span("forward"):
                    time.sleep(0.01)
            n += 1
    assert profiling._REC is None
    got = tracer.result()
    for phase in ("light", "full"):
        rec = got[phase]["spans"]
        names = [s.name for s in rec.spans]
        assert names and names == ["train", "forward"] * (len(names) // 2)
        assert got[phase]["units"] == len(names) // 2
        assert {"base_ns", "device", "launches", "merged", "busy_s"} <= set(got[phase]["trace"])
    assert spans.host_ms(got["light"], ["train/forward"], "train", self_time=False) >= 10.0
