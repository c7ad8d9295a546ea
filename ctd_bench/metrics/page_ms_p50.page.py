"""The median latency of the traced window's light-phase requests, host
clock, ms."""

import numpy as np


def read(win):
    v = win.get("traced", {}).get("host", {}).get("request_ms")
    return float(np.median(v)) if v else None
