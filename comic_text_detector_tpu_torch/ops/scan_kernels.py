"""Connected-components sweeps: kernel K4.

The JAX package's Pallas kernel K4 (``_scan_kernel`` in
``comic_text_detector_tpu/ops/pallas_kernels.py``) is reached through two
functions, each a forward then a backward segmented min-scan of int32
labels under a uint8 mask:

* ``cc_row_sweep`` along the rows;
* ``cc_col_sweep`` along the columns.

The segments are the nonzero runs of the mask along that axis: every pixel
whose mask is set ends with the minimum label of its whole run, and a pixel
whose mask is 0 keeps its input label, whatever its value.  Both accept an
(H, W) map or an (N, H, W) stack, whose pages then sweep in one launch.
``ops/cc.py::connected_components`` iterates them to a fixpoint on canvases
over 1M elements (the DB decode at input sizes above 1024).

Both are CUDA C++ (``csrc/scan.cu``), built by ``nvcc`` on first use and
bound with ``ctypes``.  Each wrapper launches its kernel for a CUDA tensor,
uses the plain PyTorch version beside it for a CPU tensor, and counts its
launches in ``<wrapper>.launches``.  The row kernel takes W <= 4096: one
warp a row, each lane a chunk of C contiguous pixels in registers (C the
least of 16, 32, 48, 64, 96, 128 with 32 * C >= W); each lane summarises
its chunk, two warp-shuffle scans carry each run's minimum across the lane
borders, and each lane resolves its runs and writes every pixel once.  The
column kernel takes any H and W: a
chunked segmented scan, one block per strip of 32 columns of a page, each
column cut into 32 row chunks, one thread a chunk.  Each thread summarises
its chunk (the runs touching its top and bottom), two scans over the
summaries carry each run's minimum across the chunk borders, and each
thread walks its chunk again, forward and back, with those carries.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from comic_text_detector_tpu_torch.ops import cuda_build

MAX_ROW = 4096  # the row kernel's widest row: 32 lanes x 128 pixels
_INT32_MAX = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("scan.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ctd_cc_row_sweep, lib.ctd_cc_col_sweep):
        fn.argtypes = [p, p, p, i, i, i, p]
        fn.restype = i
    lib.ctd_scan_error_string.argtypes = [i]
    lib.ctd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(labels: torch.Tensor, mask_u8: torch.Tensor, name: str):
    """Validate and return contiguous (N, H, W) views of both inputs."""
    if labels.dtype != torch.int32 or mask_u8.dtype != torch.uint8:
        raise ValueError(f"{name}: expected int32 labels and a uint8 mask, got {labels.dtype} and {mask_u8.dtype}")
    if labels.shape != mask_u8.shape or labels.dim() not in (2, 3):
        raise ValueError(f"{name}: expected (H, W) or (N, H, W) inputs of one shape, got "
                         f"{tuple(labels.shape)} and {tuple(mask_u8.shape)}")
    if labels.device != mask_u8.device or labels.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: inputs on {labels.device} and {mask_u8.device}")
    return labels.contiguous().view(-1, *labels.shape[-2:]), mask_u8.contiguous().view(-1, *labels.shape[-2:])


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU route and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _run_min_rows(labels: torch.Tensor, mask_u8: torch.Tensor) -> torch.Tensor:
    """(R, W) labels and mask -> the minimum label of each pixel's run of
    set mask pixels along its row; unset pixels keep their label."""
    fg = mask_u8 != 0
    start = fg.clone()
    start[:, 1:] &= ~fg[:, :-1]
    flat_fg = fg.reshape(-1)
    run = torch.cumsum(start.reshape(-1), 0) - 1  # each set pixel's run, numbered over the whole stack
    run_fg = run[flat_fg]
    mins = torch.full((flat_fg.numel(),), _INT32_MAX, dtype=torch.int32, device=labels.device)
    mins.scatter_reduce_(0, run_fg, labels.reshape(-1)[flat_fg], "amin")
    out = labels.reshape(-1).clone()
    out[flat_fg] = mins[run_fg]
    return out.view(labels.shape)


def cc_row_sweep_plain(labels: torch.Tensor, mask_u8: torch.Tensor) -> torch.Tensor:
    """Plain version of the row sweep, any device."""
    l3, m3 = _check(labels, mask_u8, "cc_row_sweep")
    w = l3.shape[-1]
    return _run_min_rows(l3.reshape(-1, w), m3.reshape(-1, w)).view(labels.shape)


def cc_col_sweep_plain(labels: torch.Tensor, mask_u8: torch.Tensor) -> torch.Tensor:
    """Plain version of the column sweep, any device."""
    l3, m3 = _check(labels, mask_u8, "cc_col_sweep")
    n, h, w = l3.shape
    lt = l3.transpose(1, 2).reshape(n * w, h)
    mt = m3.transpose(1, 2).reshape(n * w, h)
    out = _run_min_rows(lt, mt).view(n, w, h).transpose(1, 2)
    return out.contiguous().view(labels.shape)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _launch(fn_name: str, labels: torch.Tensor, mask_u8: torch.Tensor, out: torch.Tensor) -> None:
    n, h, w = labels.shape
    lib = _lib()
    stream = torch.cuda.current_stream(labels.device).cuda_stream
    rc = getattr(lib, fn_name)(labels.data_ptr(), mask_u8.data_ptr(), out.data_ptr(), n, h, w, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed: {lib.ctd_scan_error_string(rc).decode()}")


def launch_row_sweep(labels: torch.Tensor, mask_u8: torch.Tensor, out: torch.Tensor) -> None:
    """Enqueue the row kernel on contiguous (N, H, W) tensors, on the current
    stream (no count, no sync); raises if the launch was refused."""
    _launch("ctd_cc_row_sweep", labels, mask_u8, out)


def launch_col_sweep(labels: torch.Tensor, mask_u8: torch.Tensor, out: torch.Tensor) -> None:
    """Enqueue the column kernel on contiguous (N, H, W) tensors, on the
    current stream (no count, no sync); raises if the launch was refused."""
    _launch("ctd_cc_col_sweep", labels, mask_u8, out)


def cc_row_sweep(labels: torch.Tensor, mask_u8: torch.Tensor) -> torch.Tensor:
    """K4 rows: forward + backward segmented min-scan of int32 labels along
    the rows of an (H, W) map or (N, H, W) stack, segments being the runs of
    the uint8 mask's set pixels.  W <= 4096 on the card."""
    l3, m3 = _check(labels, mask_u8, "cc_row_sweep")
    if l3.device.type == "cpu":
        return cc_row_sweep_plain(labels, mask_u8)
    if l3.shape[-1] > MAX_ROW:
        raise ValueError(f"cc_row_sweep: rows of {l3.shape[-1]} pixels; the kernel takes at most {MAX_ROW}")
    out = torch.empty_like(l3)
    launch_row_sweep(l3, m3, out)
    cc_row_sweep.launches += 1
    return out.view(labels.shape)


def cc_col_sweep(labels: torch.Tensor, mask_u8: torch.Tensor) -> torch.Tensor:
    """K4 columns: forward + backward segmented min-scan of int32 labels
    along the columns of an (H, W) map or (N, H, W) stack."""
    l3, m3 = _check(labels, mask_u8, "cc_col_sweep")
    if l3.device.type == "cpu":
        return cc_col_sweep_plain(labels, mask_u8)
    out = torch.empty_like(l3)
    launch_col_sweep(l3, m3, out)
    cc_col_sweep.launches += 1
    return out.view(labels.shape)


cc_row_sweep.launches = 0
cc_col_sweep.launches = 0
