"""Device milliseconds a page of the kernels launched inside
``ops/refine.py::refine_page`` (through ``_refine_on_device``), by CUPTI,
over the full phase's pages."""

from ctd_bench.loops.common import range_ms_per


def read(win):
    return range_ms_per(win, "refine")
