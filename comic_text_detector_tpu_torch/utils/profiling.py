"""Spans and counters of the port's own stages.

The port's single recorder of where its host time goes.  Each stage of the
batch stream, the single page and the train steps is a named span (a
``with span("nms"):`` block) at the place its work is done, and each place
where the host waits on a device value adds to the ``host_syncs`` counter
(``count("host_syncs")``, or :func:`to_host` for a download).  The counter
counts the sites, not the device: on the CPU it counts the waits the same
path would make on the card, and none of them happens.  Nothing is recorded
unless the recorder is on:

* off (the default), the module global ``_REC`` is None: :func:`span`
  reads it and returns one shared no-op context, :func:`count` returns at
  once; nothing is allocated and no profiler range is opened;
* :func:`enable` turns it on (once: a second call raises), :func:`disable`
  turns it off and returns the :class:`Recording`.

A recorded span keeps its name, start and end (``time.perf_counter_ns``),
the OS thread id (``threading.get_native_id``, the ``tid`` of a
``torch.profiler`` trace), the index of its parent (the innermost span
open on the same thread), the unit it serves and its counters.  A unit is
one stream batch, one page request or one training mini-step: its root
span is given an id from :func:`new_unit`, and every span opened inside it
inherits that id (a stream batch's ``collect`` takes the id its
``submit`` gave the ticket).  :func:`count` adds to the innermost open
span of the calling thread, or to the recording's own counters outside
any span.  At most ``MAX_SPANS`` spans are kept; the rest are counted in
``Recording.dropped``.

The clock: :func:`enable` reads ``time.time_ns()`` and
``time.perf_counter_ns()`` together, and :func:`disable` reads them again,
so that a span's times map onto Unix time, which is the clock of a
``torch.profiler`` trace (``baseTimeNanoseconds + ts * 1000`` in its
Chrome JSON).  :meth:`Recording.trace_us` gives a time on that clock;
:meth:`Recording.write_chrome` writes the spans as Chrome ``"X"`` events
on it, to open in Perfetto beside a profiler trace (the CLI's ``--trace``).

Span names by path (``parent/child``):

* batch stream: ``wait`` (the consumer blocked on the producer's queue);
  ``submit`` with ``upload``, ``letterbox``, ``net``, ``nms``,
  ``finalize``, ``decode``, ``resize``; ``collect`` with ``download``,
  ``group``, ``refine``, ``fetch``;
* single page: ``page`` with ``step`` (the same children as ``submit``),
  ``download``, ``group``, ``refine``, ``fetch``;
* train steps: ``train`` with ``forward``, ``loss``, ``backward``,
  ``update``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

MAX_SPANS = 1_000_000  # read when the recorder is turned on
_NULL = contextlib.nullcontext()
_REC: Optional["_Recorder"] = None


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    tid: int  # threading.get_native_id()
    parent: int  # index into Recording.spans, -1 for a root
    unit: Optional[int]
    counts: Dict[str, int]


@dataclasses.dataclass
class Recording:
    """What :func:`disable` returns: the spans in the order they opened,
    the counters outside any span, the spans dropped over the bound, and
    the two clock anchors ``(time.time_ns(), time.perf_counter_ns())``
    read at :func:`enable` and :func:`disable`."""

    spans: List[Span]
    counts: Dict[str, int]
    dropped: int
    anchors: Tuple[Tuple[int, int], Tuple[int, int]]

    def trace_us(self, perf_ns: int, base_ns: int = 0) -> float:
        """A ``perf_counter_ns`` time on a profiler trace's clock (Unix
        time, interpolated between the two anchors, which absorbs any drift
        between the clocks): its ``ts`` in µs after ``baseTimeNanoseconds``
        (``base_ns``)."""
        (u0, p0), (u1, p1) = self.anchors
        rate = (u1 - u0) / (p1 - p0) if p1 > p0 else 1.0
        return (u0 + (perf_ns - p0) * rate - base_ns) / 1e3

    def paths(self) -> List[str]:
        """Each span's name after its ancestors', ``collect/group``."""
        out: List[str] = []
        for s in self.spans:
            out.append(s.name if s.parent < 0 else out[s.parent] + "/" + s.name)
        return out

    def write_chrome(self, path: str, base_ns: int = 0) -> None:
        """The spans as Chrome JSON ``"X"`` events on the profiler trace's
        clock (``ts`` in µs after ``base_ns``, which is written as the
        file's ``baseTimeNanoseconds``)."""
        pid = os.getpid()
        events = [{"ph": "X", "cat": "ctd_span", "name": s.name, "pid": pid, "tid": s.tid,
                   "ts": self.trace_us(s.start_ns, base_ns), "dur": (s.end_ns - s.start_ns) / 1e3,
                   "args": {"unit": s.unit, "parent": s.parent, **s.counts}}
                  for s in self.spans]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "baseTimeNanoseconds": base_ns, "displayTimeUnit": "ms",
                       "dropped": self.dropped, "counts": self.counts}, f)


class _Recorder:
    def __init__(self):
        self.max_spans = MAX_SPANS
        self.spans: List[list] = []  # [name, start, end, tid, parent, unit, counts]
        self.counts: Dict[str, int] = {}
        self.dropped = 0
        self.units = itertools.count()
        self.lock = threading.Lock()
        self.local = threading.local()
        self.anchor = (time.time_ns(), time.perf_counter_ns())

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
            self.local.tid = threading.get_native_id()
        return st


class _OpenSpan:
    __slots__ = ("rec", "name", "unit", "i")

    def __init__(self, rec: _Recorder, name: str, unit: Optional[int]):
        self.rec, self.name, self.unit = rec, name, unit

    def __enter__(self):
        rec = self.rec
        st = rec.stack()
        parent = st[-1] if st else -1
        unit = self.unit
        if unit is None and parent >= 0:
            unit = rec.spans[parent][5]
        with rec.lock:
            if len(rec.spans) < rec.max_spans:
                self.i = len(rec.spans)
                rec.spans.append([self.name, time.perf_counter_ns(), 0, rec.local.tid, parent, unit, None])
            else:
                self.i = -1
                rec.dropped += 1
        # a dropped span stays on the stack so that its children know it
        # (they are dropped too: the bound is reached)
        st.append(self.i)
        return self

    def __exit__(self, *exc):
        if self.i >= 0:
            self.rec.spans[self.i][2] = time.perf_counter_ns()
        self.rec.stack().pop()
        return False


def span(name: str, unit: Optional[int] = None):
    """A context that records the block as a span named ``name`` (module
    docstring); ``unit`` for a root span, else the parent's unit."""
    rec = _REC
    if rec is None:
        return _NULL
    return _OpenSpan(rec, name, unit)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span."""
    rec = _REC
    if rec is None:
        return
    st = rec.stack()
    if st and st[-1] >= 0:
        counts = rec.spans[st[-1]][6]
        if counts is None:
            counts = rec.spans[st[-1]][6] = {}
    elif st:  # inside a dropped span
        return
    else:
        counts = rec.counts
    counts[name] = counts.get(name, 0) + n


def to_host(t):
    """``t.cpu().numpy()``, counted as one ``host_syncs``: the download of
    a device tensor, which waits for the stream."""
    count("host_syncs")
    return t.cpu().numpy()


def new_unit() -> Optional[int]:
    """The next unit id (a batch, a request, a mini-step), or None with the
    recorder off."""
    rec = _REC
    return None if rec is None else next(rec.units)


def enable() -> None:
    """Turn the recorder on; raises if it is on already."""
    global _REC
    if _REC is not None:
        raise RuntimeError("the span recorder is already on")
    _REC = _Recorder()


def disable() -> Recording:
    """Turn the recorder off and return what it recorded.  Spans still open
    (on another thread) keep an end of 0."""
    global _REC
    rec = _REC
    if rec is None:
        raise RuntimeError("the span recorder is not on")
    _REC = None
    end = (time.time_ns(), time.perf_counter_ns())
    spans = [Span(n, s, e, t, p, u, c or {}) for n, s, e, t, p, u, c in rec.spans]
    return Recording(spans, dict(rec.counts), rec.dropped, (rec.anchor, end))

