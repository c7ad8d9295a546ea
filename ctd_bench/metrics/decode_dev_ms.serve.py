"""Device milliseconds a batch of the kernels launched inside
``ops/db_decode.py::db_decode_batch`` (K6 binarize, K2/K3 or the label
route, sorts, the angle scan), by CUPTI, over the full phase's batches."""

from ctd_bench.loops.common import range_ms_per


def read(win):
    return range_ms_per(win, "decode")
