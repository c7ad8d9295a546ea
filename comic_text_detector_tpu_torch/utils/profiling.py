"""Stage timing and tracing.

Counterpart of the JAX package's ``utils/profiling.py``:

* ``StageTimer``: time a pipeline loop by named stage.  On the card a
  stage is timed with CUDA events recorded on the current stream around it
  and read at :meth:`StageTimer.summary`, so that timing adds no host
  sync; on the CPU with the host's ``perf_counter``.  Each stage is also a
  ``torch.profiler.record_function`` range.
* ``trace``: a named ``record_function`` range, seen in profiler traces.
* ``device_trace``: a ``torch.profiler`` trace of the CPU and the card
  around a block, written to ``log_dir`` for TensorBoard.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch


class StageTimer:
    """Accumulates time a named stage.  ``device="cuda"`` times with CUDA
    events (the stage's time on the current stream), ``"cpu"`` with the
    host's clock."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.cuda = torch.device(device).type == "cuda"
        self._host: Dict[str, float] = defaultdict(float)
        self._events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = defaultdict(list)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        with torch.profiler.record_function(name):
            if self.cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
                self._events[name].append((start, end))
            else:
                t0 = time.perf_counter()
                yield
                self._host[name] += time.perf_counter() - t0
        self.counts[name] += 1

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds a stage (on the card: waits for its last event)."""
        out = dict(self._host)
        if self._events:
            torch.cuda.synchronize()
            for name, pairs in self._events.items():
                out[name] = sum(s.elapsed_time(e) for s, e in pairs) / 1e3
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_ms": 1e3 * v / max(self.counts[k], 1)}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def report(self) -> str:
        lines = [f"{'stage':<28}{'count':>8}{'mean ms':>12}{'total s':>10}"]
        for k, s in self.summary().items():
            lines.append(f"{k:<28}{s['count']:>8}{s['mean_ms']:>12.2f}{s['total_s']:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the CPU and, where there is one, the card around the block;
    the trace goes to ``log_dir`` (TensorBoard's profiler plugin reads it)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
