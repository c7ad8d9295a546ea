"""What the loops share: wrappers around calls into the port (installed
for one window and removed after it), the check of sampled pages against
the plain reference, and what the per-layer readers compute from a traced
window (``trace.Tracer.result`` under ``traced``)."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import numpy as np
import torch

from ctd_bench import compare
from ctd_bench.trace import RANGE_PREFIX, device_window


@contextlib.contextmanager
def patched(patches):
    """Set ``(module, name, value)`` attributes for the block, then put the
    originals back."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, value in patches:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def ranged(name: str, fn: Callable, sample: Callable = None) -> Callable:
    """``fn`` inside a profiler range ``ctd_bench.<name>``; with ``sample``
    (``Tracer.sample``) the element count of its first argument is kept
    under ``<name>_pixels``."""

    def wrapper(*args, **kw):
        if sample is not None:
            sample(name + "_pixels", float(args[0].numel()))
        with torch.profiler.record_function(RANGE_PREFIX + name):
            out = fn(*args, **kw)
        if hasattr(fn, "launches"):  # the port's launch counter counts on the name it calls by
            fn.launches = wrapper.launches
        return out

    if hasattr(fn, "launches"):
        wrapper.launches = fn.launches
    return wrapper


def host_timed(name: str, fn: Callable, sample: Callable) -> Callable:
    """``fn`` inside a range, its host-clock milliseconds kept by
    ``sample``."""

    def wrapper(*args, **kw):
        t = time.perf_counter()
        with torch.profiler.record_function(RANGE_PREFIX + name):
            out = fn(*args, **kw)
        sample(name, (time.perf_counter() - t) * 1e3)
        return out

    return wrapper


def kernel_ranges(sample: Callable):
    """Ranges around the hand-written kernels' wrappers the page path calls:
    K2 (``cc_windows_local``: the DB decode's split route up to 1024x1024,
its label route above) and K6
    (``mask_to_u8`` and ``binarize``)."""
    from comic_text_detector_tpu_torch.ops import cc, cc_kernels, db_decode
    from comic_text_detector_tpu_torch.pipeline import batch, detector

    return [
        (cc_kernels, "cc_windows_local", ranged("k2", cc_kernels.cc_windows_local, sample)),
        (cc, "cc_windows_local", ranged("k2", cc.cc_windows_local, sample)),
        (batch, "mask_to_u8", ranged("k6", batch.mask_to_u8, sample)),
        (detector, "mask_to_u8", ranged("k6", detector.mask_to_u8, sample)),
        (db_decode, "binarize", ranged("k6", db_decode.binarize, sample)),
    ]


def program_page(mask: np.ndarray, refined: np.ndarray, blk_list, net) -> Dict:
    """One page as the timed path produced it, in ``compare.py``'s form."""
    from comic_text_detector_tpu_torch.constants import LANG_LIST

    return {
        "net": net,
        "blocks": [(list(b.xyxy), LANG_LIST.index(b.language) if b.language in LANG_LIST else -1) for b in blk_list],
        "lines": [np.asarray(ln, np.int64).reshape(4, 2) for b in blk_list for ln in b.lines],
        "raw": np.asarray(mask) > 0,
        "refined": np.asarray(refined) > 0,
    }


def check_pages(config: Dict, mix: Dict, device, outputs: Dict, model=None) -> Dict[str, float]:
    """The reference's float32 outputs for each sampled page against the
    program's, and the reference's steps after the net on the program's
    own net outputs against the program's final outputs (``model``: a
    reference net to reuse)."""
    from ctd_bench.reference import pipeline as ref

    own = model is None
    model = ref.inference_model(config, device) if own else model
    size = mix["input_size"]
    want = [ref.detect_page(model, page, size, config, device) for page in outputs["pages"]]
    if own:
        del model
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    staged = [ref.page_stages(page, got["net"], size, config)
              for page, got in zip(outputs["pages"], outputs["results"])]
    numbers = compare.page_numbers(outputs["results"], want)
    numbers.update(compare.stage_numbers(outputs["results"], staged))
    return numbers


def idle_share(win: Dict):
    """The share of the light phase's device span with nothing running on
    the device, in %."""
    traced = win.get("traced")
    if not traced or not traced["light"]["trace"].get("n_device_events"):
        return None
    busy, span = device_window(traced)
    return max(0.0, 1.0 - busy / span) * 100.0 if span > 0 else None


def mfu(win: Dict):
    """The work's FLOPs (counted from its shapes, ``flops.py``) over the
    light phase's units, over its host-clock seconds times the peak, in %."""
    traced = win.get("traced")
    if not traced or not traced["light"]["units"] or traced["light"]["window_s"] <= 0:
        return None
    light = traced["light"]
    return win["flops_per_unit"] * light["units"] / light["window_s"] / win["peak_flops"] * 100.0


def host_mean(win: Dict, name: str):
    """The mean of the light phase's host-clock samples of ``name``."""
    v = win.get("traced", {}).get("host", {}).get(name)
    return float(np.mean(v)) if v else None


def _range(win: Dict, name: str):
    return win.get("traced", {}).get("full", {}).get("trace", {}).get("ranges", {}).get(name)


def range_ms_per(win: Dict, name: str):
    """Device milliseconds of the kernels launched in the range over the
    full phase's units (a batch, a page, a mini-step)."""
    r = _range(win, name)
    if not r or not r["launches"]:
        return None
    return r["device_s"] / win["traced"]["full"]["units"] * 1e3


def _own_seconds(r: Dict) -> float:
    """Device seconds of the hand-written kernels launched in a range: not
    PyTorch's fills and copies beside them."""
    return sum(s for k, s in r["kernels"].items() if "at::" not in k and not k.startswith(("Memset", "Memcpy")))


def roofline(win: Dict, name: str, bytes_per_pixel: float, hbm_bytes_per_s: float):
    """The byte bound of every call in the range over the device time of
    its own kernels, in %."""
    r = _range(win, name)
    px = win.get("traced", {}).get("full_host", {}).get(name + "_pixels", [])
    if not r or not px or _own_seconds(r) <= 0:
        return None
    return sum(px) * bytes_per_pixel / hbm_bytes_per_s / _own_seconds(r) * 100.0


def own_us_per_call(win: Dict, name: str):
    """Device microseconds a call of the range's own kernels."""
    r = _range(win, name)
    if not r or not r["calls"] or _own_seconds(r) <= 0:
        return None
    return _own_seconds(r) / r["calls"] * 1e6
