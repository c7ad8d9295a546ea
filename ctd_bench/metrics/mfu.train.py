"""A DB mini-step's FLOPs (counted from its shapes, ``flops.py``) times
the light phase's mini-steps over its host-clock seconds times the configuration's peak,
in %."""

from ctd_bench.loops.common import mfu


def read(win):
    return mfu(win)
