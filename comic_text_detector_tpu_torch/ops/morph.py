"""3x3 grey morphology with a replicate border: kernel K5.

The JAX package's Pallas kernel K5 (``comic_text_detector_tpu/ops/
pallas_kernels.py``: ``_morph_kernel`` and ``_ellipse_kernel``) is reached
through three functions:

* ``erode3x3``: the minimum over the full 3x3 square (cv2.erode);
* ``dilate3x3``: the maximum over the full 3x3 square (cv2.dilate);
* ``erode3x3_ellipse``: the minimum over the centre and its 4-neighbour
  cross (cv2's 3x3 MORPH_ELLIPSE).

The border replicates the edge pixels (cv2's default, scipy.ndimage
``mode="nearest"``).  Inputs are (H, W) uint8 or float32; other dtypes
raise.  No path of the JAX package calls them, and none of the port does:
they are an API of their own.  The device refine's stencils
(``ops/refine.py``) use a constant border and stay apart.

All three are CUDA C++ (``csrc/morph.cu``), one launch per call, built by
``nvcc`` on first use and bound with ``ctypes``: a register sliding window,
each thread a strip of 4 output pixels walking a band of 8 rows, the
neighbouring pixels from the adjacent lanes by warp shuffles, the border a
clamp of row and column.  It reads any contiguous (H, W) tensor in place,
one at an odd offset too.  Each wrapper launches its kernel for a CUDA
tensor, uses the plain PyTorch version beside it for a CPU tensor, and
counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from comic_text_detector_tpu_torch.ops import cuda_build

_ERODE, _DILATE, _CROSS = 0, 1, 2
_SQUARE = [(dy, dx) for dy in range(3) for dx in range(3) if (dy, dx) != (1, 1)]
_CROSS_TAPS = [(0, 1), (2, 1), (1, 0), (1, 2)]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("morph.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ctd_morph3x3_u8, lib.ctd_morph3x3_f32):
        fn.argtypes = [p, p, i, i, i, p]
        fn.restype = i
    lib.ctd_morph_error_string.argtypes = [i]
    lib.ctd_morph_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dim() != 2 or x.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"{name}: expected an (H, W) uint8 or float32 tensor, got {tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU route and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _taps_plain(x: torch.Tensor, taps, op) -> torch.Tensor:
    h, w = x.shape
    rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
    p = x[rows][:, cols]  # replicate border
    acc = x
    for dy, dx in taps:
        acc = op(acc, p[dy : dy + h, dx : dx + w])
    return acc


def erode3x3_plain(x: torch.Tensor) -> torch.Tensor:
    return _taps_plain(_check(x, "erode3x3"), _SQUARE, torch.minimum)


def dilate3x3_plain(x: torch.Tensor) -> torch.Tensor:
    return _taps_plain(_check(x, "dilate3x3"), _SQUARE, torch.maximum)


def erode3x3_ellipse_plain(x: torch.Tensor) -> torch.Tensor:
    return _taps_plain(_check(x, "erode3x3_ellipse"), _CROSS_TAPS, torch.minimum)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def launch_morph(x: torch.Tensor, out: torch.Tensor, op: int) -> None:
    """Enqueue K5 (``op``: 0 erode, 1 dilate, 2 cross erode) on contiguous
    (H, W) tensors, on the current stream (no count, no sync); raises if the
    launch was refused."""
    lib = _lib()
    fn = lib.ctd_morph3x3_u8 if x.dtype == torch.uint8 else lib.ctd_morph3x3_f32
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], op, stream)
    if rc != 0:
        raise RuntimeError(f"morph3x3: CUDA launch failed: {lib.ctd_morph_error_string(rc).decode()}")


def _run(x: torch.Tensor, op: int, wrapper, plain) -> torch.Tensor:
    x = _check(x, wrapper.__name__)
    if x.device.type == "cpu":
        return plain(x)
    out = torch.empty_like(x)
    launch_morph(x, out, op)
    wrapper.launches += 1
    return out


def erode3x3(x: torch.Tensor) -> torch.Tensor:
    """K5: grey erosion, 3x3 square, replicate border (cv2.erode)."""
    return _run(x, _ERODE, erode3x3, erode3x3_plain)


def dilate3x3(x: torch.Tensor) -> torch.Tensor:
    """K5: grey dilation, 3x3 square, replicate border (cv2.dilate)."""
    return _run(x, _DILATE, dilate3x3, dilate3x3_plain)


def erode3x3_ellipse(x: torch.Tensor) -> torch.Tensor:
    """K5: grey erosion with the 3x3 cross (cv2's MORPH_ELLIPSE), replicate
    border."""
    return _run(x, _CROSS, erode3x3_ellipse, erode3x3_ellipse_plain)


erode3x3.launches = 0
dilate3x3.launches = 0
erode3x3_ellipse.launches = 0
