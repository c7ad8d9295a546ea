"""Mask finalize and binarize: kernel K6.

The JAX package's Pallas kernel K6 is two functions
(``comic_text_detector_tpu/ops/pallas_kernels.py``):

* ``mask_to_u8`` (``_finalize_kernel``): float32 sigmoid map -> uint8,
  ``x * 255`` rounded once in float32 and truncated toward zero;
* ``binarize`` (``_binarize_kernel``): float32 map > float32 threshold ->
  uint8 0/1.

The main path computes both once per page or batch: the grey mask's
finalize after the net, and the DB shrink map's bitmap before the
connected components.  Both are CUDA C++ (``csrc/finalize.cu``), built by
``nvcc`` on first use and bound with ``ctypes``.  Each wrapper launches its
kernel for a CUDA tensor, uses the plain PyTorch version beside it for a CPU
tensor, and counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from comic_text_detector_tpu_torch.ops import cuda_build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("finalize.cu")
    p = ctypes.c_void_p
    lib.ctd_mask_to_u8.argtypes = [p, p, ctypes.c_longlong, p]
    lib.ctd_mask_to_u8.restype = ctypes.c_int
    lib.ctd_binarize.argtypes = [p, p, ctypes.c_float, ctypes.c_longlong, p]
    lib.ctd_binarize.restype = ctypes.c_int
    lib.ctd_finalize_error_string.argtypes = [ctypes.c_int]
    lib.ctd_finalize_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 tensor, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.contiguous()


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: {_lib().ctd_finalize_error_string(rc).decode()}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU route and the kernels' yardstick)
# ---------------------------------------------------------------------------


def mask_to_u8_plain(x: torch.Tensor) -> torch.Tensor:
    return (x * 255.0).to(torch.uint8)


def binarize_plain(x: torch.Tensor, thresh: float) -> torch.Tensor:
    return (x > float(np.float32(thresh))).to(torch.uint8)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def launch_mask_to_u8(x: torch.Tensor, out: torch.Tensor) -> None:
    """Enqueue the finalize kernel on the current stream (no count, no sync)."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(_lib().ctd_mask_to_u8(x.data_ptr(), out.data_ptr(), x.numel(), stream), "mask_to_u8")


def launch_binarize(x: torch.Tensor, thresh: float, out: torch.Tensor) -> None:
    """Enqueue the binarize kernel on the current stream (no count, no sync)."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(_lib().ctd_binarize(x.data_ptr(), out.data_ptr(), float(thresh), x.numel(), stream), "binarize")


def mask_to_u8(x: torch.Tensor) -> torch.Tensor:
    """K6 finalize: float32 probabilities in [0, 1] -> uint8 ``x * 255``
    truncated toward zero, any shape."""
    x = _check(x, "mask_to_u8")
    if x.device.type == "cpu":
        return mask_to_u8_plain(x)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    launch_mask_to_u8(x, out)
    mask_to_u8.launches += 1
    return out


def binarize(x: torch.Tensor, thresh: float) -> torch.Tensor:
    """K6 binarize: float32 ``x > thresh`` (the threshold taken as float32)
    -> uint8 0/1, any shape."""
    x = _check(x, "binarize")
    if x.device.type == "cpu":
        return binarize_plain(x, thresh)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    launch_binarize(x, thresh, out)
    binarize.launches += 1
    return out


mask_to_u8.launches = 0
binarize.launches = 0
