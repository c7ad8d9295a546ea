"""The share of the traced window's light phase in which no kernel, copy
or memset ran on the device (CUPTI, with no CPU activity traced), in %."""

from ctd_bench.loops.common import idle_share


def read(win):
    return idle_share(win)
