"""The port's span and counter recorder (``utils/profiling.py``) on the CPU:

* off, nothing is recorded and ``span`` returns one shared no-op context;
* a page on ``TextDetector`` (device refine, packed masks, input 128)
  records the ``page`` tree with its documented children, parents, one
  unit and its ``host_syncs`` counters;
* a two-batch ``BatchTextDetector.stream`` records each batch's
  ``submit`` and ``collect`` under one unit, and the consumer's ``wait``;
* ``db_train_step`` records ``train`` with ``forward``, ``loss``,
  ``backward`` and ``update``;
* mapped onto the profiler's clock, a span and a ``record_function``
  range opened inside it agree within 1 ms in a CPU-activity trace;
* a second ``enable`` raises; the span bound drops and counts the rest;
  threads keep their own nesting; the Chrome export loads back;
* the CLI's ``detect --trace`` writes the page's spans.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from comic_text_detector_tpu_torch import cli
from comic_text_detector_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "data", "flagship_r2.npz")
SIZE = 128
STEP_CHILDREN = ["upload", "letterbox", "net", "nms", "finalize", "decode", "resize"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off."""
    assert profiling._REC is None
    yield
    if profiling._REC is not None:
        profiling.disable()
        pytest.fail("the test left the recorder on")


@pytest.fixture(scope="module")
def variables():
    from comic_text_detector_tpu_torch.weights import load_npz

    return load_npz(WEIGHTS)


def _pages(n, seed=0):
    """White pages with a dark bar and light noise: quick to refine."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        page = rng.integers(235, 256, (150, 110, 3), dtype=np.uint8)
        y, x = rng.integers(10, 100), rng.integers(5, 40)
        page[y:y + 20, x:x + 60] = 0
        out.append(page)
    return out


def _record(fn):
    profiling.enable()
    try:
        out = fn()
    finally:
        got = profiling.disable()
    return got, out


def _children(got, i):
    return [s.name for s in got.spans if s.parent == i]


def test_off_records_nothing(variables):
    from comic_text_detector_tpu_torch.pipeline import TextDetector

    assert profiling.span("a") is profiling.span("b", 3)
    assert profiling.new_unit() is None
    profiling.count("host_syncs")
    det = TextDetector(variables=variables, input_size=SIZE, device="cpu", refine_backend="device",
                       mask_transfer="packed")
    det(_pages(1)[0])
    got, _ = _record(lambda: None)
    assert got.spans == [] and got.counts == {} and got.dropped == 0


def test_page_records_its_tree(variables):
    from comic_text_detector_tpu_torch.pipeline import TextDetector

    det = TextDetector(variables=variables, input_size=SIZE, device="cpu", refine_backend="device",
                       mask_transfer="packed")
    page = _pages(1)[0]
    got, out = _record(lambda: det(page))
    want = det(page)
    assert np.array_equal(out[0], want[0]) and np.array_equal(out[1], want[1])  # spans change nothing
    (root,) = [i for i, s in enumerate(got.spans) if s.parent == -1]
    assert got.spans[root].name == "page"
    assert _children(got, root) == ["step", "download", "group", "refine", "fetch"]
    step = got.spans.index(next(s for s in got.spans if s.name == "step"))
    assert _children(got, step) == STEP_CHILDREN
    assert {s.unit for s in got.spans} == {got.spans[root].unit}
    for s in got.spans:
        parent = got.spans[s.parent] if s.parent >= 0 else None
        assert parent is None or parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    by_path = dict(zip(got.paths(), (s.counts for s in got.spans)))
    assert by_path["page/download"] == {"host_syncs": 6}
    assert by_path["page/fetch"] == {"host_syncs": 1}
    assert by_path["page/step/nms"]["host_syncs"] >= 1  # each greedy step's test
    # the cv2 tap tables' six uploads; the decode's scalar store (K2's bound
    # check, the other sync there, runs on the card alone)
    assert by_path["page/step/letterbox"] == by_path["page/step/resize"] == {"host_syncs": 6}
    assert by_path["page/step/decode"] == {"host_syncs": 1}
    assert by_path["page/step/upload"] == {"host_syncs": 1}  # the page's pageable upload


def test_stream_shares_a_unit_per_batch(variables):
    from comic_text_detector_tpu_torch.pipeline import BatchTextDetector

    det = BatchTextDetector(variables, batch_size=2, input_size=SIZE, half=False, refine_backend="device",
                            mask_transfer="packed", device="cpu")
    got, out = _record(lambda: list(det.stream(iter(_pages(4, seed=1)), prefetch=1)))
    assert len(out) == 4
    roots = [(s.name, s.unit) for s in got.spans if s.parent == -1]
    assert [n for n, _ in roots if n != "wait"] == ["submit", "submit", "collect", "collect"]
    submits = [u for n, u in roots if n == "submit"]
    assert [u for n, u in roots if n == "collect"] == submits and len(set(submits)) == 2
    assert sum(n == "wait" for n, _ in roots) == 3  # two batches and the end of the source
    for i, s in enumerate(got.spans):
        if s.name == "submit":
            assert _children(got, i) == STEP_CHILDREN[:2] * 2 + STEP_CHILDREN[2:]
        if s.name == "collect":
            assert _children(got, i) == ["download", "group", "refine", "fetch", "fetch"]
    for i, s in enumerate(got.spans):
        if s.parent >= 0:
            assert s.unit == got.spans[s.parent].unit
    downloads = [s.counts for p, s in zip(got.paths(), got.spans) if p == "collect/download"]
    assert downloads == [{"host_syncs": 7}] * 2  # the rows, counts and DB outputs, and a mask a page


def test_db_train_step_records_its_stages(variables):
    from comic_text_detector_tpu_torch.training.seg_trainer import build_model
    from comic_text_detector_tpu_torch.training.steps import (
        build_optimizer,
        create_db_train_state,
        db_train_step,
    )
    from comic_text_detector_tpu_torch.weights import train_from_deploy

    torch.manual_seed(0)
    model = build_model(train_from_deploy(variables, with_db=True), "leaky", with_db=True)
    state = create_db_train_state(model, build_optimizer("sgd", 1e-3))
    rng = np.random.default_rng(2)
    s = 64
    batch = {"imgs": torch.from_numpy(rng.integers(0, 256, (2, s, s, 3), dtype=np.uint8))}
    for k in ("shrink_map", "shrink_mask", "threshold_map", "threshold_mask"):
        batch[k] = torch.from_numpy((rng.random((2, s, s)) > 0.5).astype(np.float32))
    got, _ = _record(lambda: [db_train_step(state, batch) for _ in range(2)])
    roots = [i for i, sp in enumerate(got.spans) if sp.parent == -1]
    assert [got.spans[i].name for i in roots] == ["train", "train"]
    assert [got.spans[i].unit for i in roots] == [0, 1]
    for i in roots:
        assert _children(got, i) == ["forward", "loss", "backward", "update"]


def test_spans_land_on_the_profiler_clock(tmp_path):
    profiling.enable()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiling.span("outer"):
                with torch.profiler.record_function("inner"):
                    torch.ones(256, 256).matmul(torch.ones(256, 256))
    finally:
        got = profiling.disable()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    (inner,) = [e for e in trace["traceEvents"] if e.get("name") == "inner" and e.get("ph") == "X"]
    (outer,) = got.spans
    start, end = got.trace_us(outer.start_ns, base), got.trace_us(outer.end_ns, base)
    assert abs(inner["ts"] - start) < 1e3
    assert abs(inner["ts"] + inner["dur"] - end) < 1e3
    assert int(inner["tid"]) == outer.tid


def test_double_enable_raises_and_disable_needs_enable():
    profiling.enable()
    try:
        with pytest.raises(RuntimeError):
            profiling.enable()
    finally:
        profiling.disable()
    with pytest.raises(RuntimeError):
        profiling.disable()


def test_bound_drops_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    profiling.enable()
    try:
        profiling.count("outside")
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    profiling.count("lost")
            with profiling.span("d"):
                pass
    finally:
        got = profiling.disable()
    assert [s.name for s in got.spans] == ["a", "b"]
    assert got.dropped == 2 and got.counts == {"outside": 1}


def test_threads_keep_their_own_nesting():
    """More threads than cores, each nesting spans, with a short switch
    interval: every span is kept, and each parent is on its own thread."""
    n_threads, depth, repeats = 16, 4, 50
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.enable()
    try:
        def work():
            for _ in range(repeats):
                def nest(d):
                    with profiling.span(f"d{d}", profiling.new_unit() if d == 0 else None):
                        profiling.count("n")
                        if d + 1 < depth:
                            nest(d + 1)
                nest(0)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        got = profiling.disable()
        sys.setswitchinterval(switch)
    assert len(got.spans) == n_threads * depth * repeats and got.dropped == 0
    assert len({s.unit for s in got.spans}) == n_threads * repeats
    for s in got.spans:
        assert s.counts == {"n": 1}
        if s.parent >= 0:
            p = got.spans[s.parent]
            assert p.tid == s.tid and p.unit == s.unit and int(p.name[1:]) + 1 == int(s.name[1:])


def test_chrome_export_loads_back(tmp_path):
    profiling.enable()
    try:
        with profiling.span("a", profiling.new_unit()):
            with profiling.span("b"):
                profiling.count("host_syncs", 3)
    finally:
        got = profiling.disable()
    path = str(tmp_path / "spans.json")
    base = 1_700_000_000_000_000_000
    got.write_chrome(path, base_ns=base)
    with open(path) as f:
        back = json.load(f)
    assert back["baseTimeNanoseconds"] == base
    a, b = back["traceEvents"]
    assert (a["name"], b["name"], a["ph"]) == ("a", "b", "X")
    assert b["args"] == {"unit": 0, "parent": 0, "host_syncs": 3}
    assert a["ts"] == pytest.approx(got.trace_us(got.spans[0].start_ns, base))
    assert a["ts"] <= b["ts"] and b["ts"] + b["dur"] <= a["ts"] + a["dur"] + 1e-3


def test_cli_detect_writes_its_spans(tmp_path):
    from comic_text_detector_tpu_torch.utils.io import imwrite

    image = str(tmp_path / "page.png")
    imwrite(image, _pages(1, seed=3)[0])
    path = str(tmp_path / "spans.json")
    cli.main(["detect", "--model", WEIGHTS, "--image", image, "--out-prefix", str(tmp_path / "p"),
              "--input-size", str(SIZE), "--device", "cpu", "--trace", path])
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]]
    assert names[0] == "page" and {"step", "download", "group", "refine"} <= set(names)
    assert os.path.exists(str(tmp_path / "p-mask.png"))
