"""``torch.cuda.max_memory_allocated`` over the traced window, after a
reset at its start, GiB."""


def read(win):
    v = win.get("peak_mem_bytes")
    return v / 2**30 if v else None
