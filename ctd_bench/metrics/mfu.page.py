"""The net's FLOPs over the light phase's pages (counted from its shapes,
``flops.py``) over its host-clock seconds times the configuration's peak,
in %."""

from ctd_bench.loops.common import mfu


def read(win):
    return mfu(win)
