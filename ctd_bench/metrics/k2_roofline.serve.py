"""K2 (``csrc/cc.cu``, ``cc_windows_local``): its byte bound (5 B a pixel
over 3.35 TB/s) over the device time of its own kernels a call, by CUPTI,
in %."""

from ctd_bench.loops.common import roofline
from ctd_bench.flops import HBM_BYTES_PER_S, KERNEL_BYTES_PER_PIXEL


def read(win):
    return roofline(win, "k2", KERNEL_BYTES_PER_PIXEL["k2"], HBM_BYTES_PER_S)
