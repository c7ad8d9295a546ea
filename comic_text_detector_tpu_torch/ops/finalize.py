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
``nvcc`` on first use and bound with ``ctypes``, one launch a call.  The
kernels read a stack of page-strided planes in place (:func:`plane_layout`),
so the batch's DB decode binarizes ``lines[:, 0]`` of the DB head's (B, 2,
H, W) output without copying it.  Each wrapper launches its kernel for a
CUDA tensor, uses the plain PyTorch version beside it for a CPU tensor, and
counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from comic_text_detector_tpu_torch.ops import cuda_build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("finalize.cu")
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.ctd_mask_to_u8.argtypes = [p, p, i64, i64, i64, p]
    lib.ctd_mask_to_u8.restype = ctypes.c_int
    lib.ctd_binarize.argtypes = [p, p, ctypes.c_float, i64, i64, i64, p]
    lib.ctd_binarize.restype = ctypes.c_int
    lib.ctd_finalize_error_string.argtypes = [ctypes.c_int]
    lib.ctd_finalize_error_string.restype = ctypes.c_char_p
    return lib


def plane_layout(x: torch.Tensor) -> Tuple[torch.Tensor, int, int, int]:
    """``(x, pages, plane, page_stride)`` as the kernels read it: ``pages``
    planes of ``plane`` elements, each contiguous, ``page_stride`` elements
    apart.  The planes are the last two dimensions (the last one of a 1-d
    tensor); the leading ones must step through them at one stride, at any
    distance.  ``x[:, 0]`` of a contiguous (B, 2, H, W) stack is read in place,
    at a page stride of 2 * H * W; a tensor of another form is copied to a
    contiguous one first."""
    if x.dim() == 0:
        x = x.reshape(1)
    inner = min(x.dim(), 2)
    plane = math.prod(x.shape[-inner:])
    # within a plane: unit steps along the last dimension, whole rows along
    # the one before (dimensions of size 1 take no step)
    step = 1
    dense = True
    for size, stride in reversed(list(zip(x.shape[-inner:], x.stride()[-inner:]))):
        if size != 1 and stride != step:
            dense = False
        step *= size
    lead = [(size, stride) for size, stride in zip(x.shape[:-inner], x.stride()[:-inner]) if size != 1]
    for (_, outer), (size, stride) in zip(lead, lead[1:]):
        if outer != stride * size:
            dense = False
    if not dense:
        x = x.contiguous()
        return x, x.numel() // max(plane, 1), plane, plane
    return x, math.prod(size for size, _ in lead), plane, lead[-1][1] if lead else plane


def _check(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 tensor, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


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


def launch_mask_to_u8(x: torch.Tensor, out: torch.Tensor, pages: int, plane: int, page_stride: int) -> None:
    """Enqueue the finalize kernel on the current stream over ``pages``
    planes of ``x`` laid out as :func:`plane_layout` gives them (no count,
    no sync)."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().ctd_mask_to_u8(x.data_ptr(), out.data_ptr(), pages, plane, page_stride, stream)
    _raise_on(rc, "mask_to_u8")


def launch_binarize(x: torch.Tensor, thresh: float, out: torch.Tensor, pages: int, plane: int,
                    page_stride: int) -> None:
    """Enqueue the binarize kernel on the current stream, as
    :func:`launch_mask_to_u8` (no count, no sync)."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().ctd_binarize(x.data_ptr(), out.data_ptr(), float(thresh), pages, plane, page_stride, stream)
    _raise_on(rc, "binarize")


def mask_to_u8(x: torch.Tensor) -> torch.Tensor:
    """K6 finalize: float32 probabilities in [0, 1] -> uint8 ``x * 255``
    truncated toward zero, any shape; page-strided planes are read in place
    (:func:`plane_layout`).  The output is contiguous."""
    _check(x, "mask_to_u8")
    if x.device.type == "cpu":
        return mask_to_u8_plain(x)
    xin, pages, plane, page_stride = plane_layout(x)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    launch_mask_to_u8(xin, out, pages, plane, page_stride)
    mask_to_u8.launches += 1
    return out


def binarize(x: torch.Tensor, thresh: float) -> torch.Tensor:
    """K6 binarize: float32 ``x > thresh`` (the threshold taken as float32)
    -> uint8 0/1, any shape; page-strided planes are read in place
    (:func:`plane_layout`).  The output is contiguous."""
    _check(x, "binarize")
    if x.device.type == "cpu":
        return binarize_plain(x, thresh)
    xin, pages, plane, page_stride = plane_layout(x)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    launch_binarize(xin, thresh, out, pages, plane, page_stride)
    binarize.launches += 1
    return out


mask_to_u8.launches = 0
binarize.launches = 0
