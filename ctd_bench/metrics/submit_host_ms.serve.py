"""Host milliseconds a batch in ``BatchTextDetector.submit`` (upload,
letterbox, net, NMS, K6, DB decode and the refines enqueued), from the
benchmark's wrapper, over the traced window's light phase (the host at its
untraced speed)."""

from ctd_bench.loops.common import host_mean


def read(win):
    return host_mean(win, "submit")
