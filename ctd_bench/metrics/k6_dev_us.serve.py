"""K6 (``csrc/finalize.cu``, ``mask_to_u8`` and ``binarize``): device
microseconds a call of its own kernels, by CUPTI.  Not a roofline share:
K6 reads the net's outputs from the L2 right after the net writes them, so
its HBM byte bound is no ceiling (it read 90-103% of it)."""

from ctd_bench.loops.common import own_us_per_call


def read(win):
    return own_us_per_call(win, "k6")
