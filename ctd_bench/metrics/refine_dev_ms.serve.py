"""Device milliseconds a batch of the kernels launched inside
``ops/refine.py::refine_pages`` (K1 and the refine's float work), by CUPTI,
over the full phase's batches."""

from ctd_bench.loops.common import range_ms_per


def read(win):
    return range_ms_per(win, "refine")
