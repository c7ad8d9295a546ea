"""Connected-components kernels K1, K2 and K3, and the ids route.

The JAX package labels connected components with three Pallas kernels
(``comic_text_detector_tpu/ops/pallas_kernels.py``):

* K1 ``_cc_ids_kernel``, the fused branch of ``cc_ids_windows_local``:
  each foreground pixel gets its 8-connected component's 1-based id, the
  raster rank of the component's root (minimum window-local linear index);
  background gets 0.  It serves windows of at most 512x512, the device
  refine's candidate and hole masks.
* K2 ``_cc_window_kernel`` via ``cc_windows_local``: each foreground pixel
  gets its component's minimum window-local linear index; background gets
  2**30.
* K3 ``_min_prop_kernel`` via ``min_prop_windows_local``: each foreground
  pixel gets the minimum seed over its component; background gets 0.

``cc_ids_windows_local`` routes as the JAX function does: windows of at most
512x512 go to K1; larger ones (the DB decode's 1024x1024 bitmap) take the
split route, K2, a cumsum of the roots in raster order, K3; above 1024x1024
it raises.  Both routes give the same ids.

All three kernels are CUDA C++ (``csrc/cc.cu``), built by ``nvcc`` into a
plain-C shared library on first use (``ops/cuda_build.py``) and bound with
``ctypes``.  All three label inside shared-memory tiles of a window, then
join the tiles along their borders (the design is in the source's note);
K1 also ranks the roots over raster chunks of ``IDS_CHUNK`` pixels, and its
wrapper sizes that scratch with ``ids_chunk_count``.  K2 runs the same
local and border phases, then writes each pixel's root in place over its
parent array, which is its output.  Each wrapper launches
its kernel for a CUDA tensor, uses the plain PyTorch version beside it for
a CPU tensor, and counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from comic_text_detector_tpu_torch.ops import cuda_build
from comic_text_detector_tpu_torch.utils.profiling import count

CC_BIG = 2**30
_INT32_MAX = 2**31 - 1
FUSED_IDS_MAX_ELEMS = 512 * 512  # K1's largest window (pallas_kernels.py:389)
IDS_MAX_ELEMS = 1024 * 1024  # the split route's largest window (pallas_kernels.py:465)
IDS_CHUNK = 8192  # K1 ranks roots in raster chunks of this many pixels (kChunk in csrc/cc.cu)

# W, NW, N, NE: each 8-neighbour pair is visited once, from its later pixel
_BACK_NEIGHBOURS = ((0, -1), (-1, -1), (-1, 0), (-1, 1))
_BACK_NEIGHBOURS_4 = ((0, -1), (-1, 0))


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("cc.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ctd_cc_window.argtypes = [p, p, p, i, i, i, p]
    lib.ctd_cc_window.restype = i
    lib.ctd_min_prop_window.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.ctd_min_prop_window.restype = i
    lib.ctd_cc_ids_window.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.ctd_cc_ids_window.restype = i
    lib.ctd_error_string.argtypes = [i]
    lib.ctd_error_string.restype = ctypes.c_char_p
    return lib


def _check_windows(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype or t.dim() != 3:
        raise ValueError(f"{name}: expected a (N, H, W) {dtype} tensor, got {tuple(t.shape)} {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.shape[1] * t.shape[2] >= CC_BIG:
        raise ValueError(f"{name}: window {tuple(t.shape[1:])} too large for int32 labels")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU route and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _root_index_plain(fg: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """(N, H, W) bool -> int64 (N*H*W,) where every foreground pixel holds
    its 8- (or 4-) connected component's minimum flat index (hook-to-min
    union-find rounds, each followed by full pointer jumping)."""
    n, h, w = fg.shape
    flat = torch.arange(n * h * w, device=fg.device).view(n, h, w)
    src, dst = [], []
    for dy, dx in _BACK_NEIGHBOURS if connectivity == 8 else _BACK_NEIGHBOURS_4:
        rows = slice(1, h) if dy else slice(0, h)
        rows_q = slice(0, h - 1) if dy else slice(0, h)
        cols = slice(max(-dx, 0), w - max(dx, 0))
        cols_q = slice(max(dx, 0), w - max(-dx, 0))
        both = fg[:, rows, cols] & fg[:, rows_q, cols_q]
        src.append(flat[:, rows, cols][both])
        dst.append(flat[:, rows_q, cols_q][both])
    src, dst = torch.cat(src), torch.cat(dst)
    parent = flat.reshape(-1).clone()
    # each round that changes anything lowers sum(parent), so the bound is
    # never reached; real masks converge in a handful of rounds
    for _ in range(n * h * w + 1):
        rp, rq = parent[src], parent[dst]
        hi, lo = torch.maximum(rp, rq), torch.minimum(rp, rq)
        if not bool((hi != lo).any()):
            return parent
        parent.scatter_reduce_(0, hi, lo, "amin")
        for _ in range(64):  # pointer jumping halves every path: <= 64 rounds
            nxt = parent[parent]
            if torch.equal(nxt, parent):
                break
            parent = nxt
    raise RuntimeError("connected components did not converge")


def cc_windows_local_plain(masks_u8: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Plain version of K2: (N, H, W) uint8 -> int32 component-min local
    linear index on foreground, 2**30 on background.  ``connectivity=4``
    links only the 4-neighbours (K2 itself is 8-connected)."""
    n, h, w = masks_u8.shape
    fg = masks_u8 != 0
    root = _root_index_plain(fg, connectivity).view(n, h, w)
    base = (torch.arange(n, device=fg.device) * (h * w)).view(n, 1, 1)
    return torch.where(fg, root - base, CC_BIG).to(torch.int32)


def min_prop_windows_local_plain(masks_u8: torch.Tensor, seeds_i32: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: the minimum foreground seed of each component
    spread over it, 0 on background."""
    fg = masks_u8 != 0
    root = _root_index_plain(fg)
    fgf = fg.reshape(-1)
    slot = torch.full((fgf.numel(),), _INT32_MAX, dtype=torch.int64, device=fg.device)
    slot.scatter_reduce_(0, root[fgf], seeds_i32.reshape(-1)[fgf].long(), "amin")
    out = torch.where(fgf, slot[root], 0)
    return out.view(masks_u8.shape).to(torch.int32)


def cc_ids_windows_local_plain(masks_u8: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 and of the whole ids contract, on any device:
    (N, H, W) uint8 -> int32 1-based component ids in raster order of the
    component roots, 0 on background."""
    n, h, w = masks_u8.shape
    fg = masks_u8 != 0
    root = _root_index_plain(fg).view(n, h * w)
    local = root - (torch.arange(n, device=fg.device) * (h * w)).view(n, 1)
    fg = fg.view(n, h * w)
    is_root = fg & (local == torch.arange(h * w, device=fg.device))
    rank = torch.cumsum(is_root, dim=1, dtype=torch.int32)
    ids = torch.where(fg, rank.gather(1, local), 0)
    return ids.view(n, h, w).to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def launch_cc_window(masks_u8: torch.Tensor, out: torch.Tensor, err: torch.Tensor) -> None:
    """Enqueue K2 on the current stream (no count, no sync); raises if the
    launch was refused.  ``out`` is also K2's parent array and starts on 16
    bytes (its last phase moves four pixels at a time), as ``torch.empty``
    gives it.  ``err`` turns nonzero if a loop bound was hit."""
    if out.data_ptr() % 16:
        raise ValueError("cc_windows_local: out must start on 16 bytes")
    n, h, w = masks_u8.shape
    lib = _lib()
    stream = torch.cuda.current_stream(masks_u8.device).cuda_stream
    rc = lib.ctd_cc_window(masks_u8.data_ptr(), out.data_ptr(), err.data_ptr(), n, h, w, stream)
    if rc != 0:
        raise RuntimeError(f"cc_windows_local: CUDA launch failed: {lib.ctd_error_string(rc).decode()}")


def launch_min_prop_window(masks_u8: torch.Tensor, seeds_i32: torch.Tensor, parent: torch.Tensor,
                           out: torch.Tensor, err: torch.Tensor) -> None:
    """Enqueue K3 on the current stream (no count, no sync); raises if the
    launch was refused.  ``parent`` is int32 scratch of the masks' shape;
    ``parent`` and ``out`` start on 16 bytes (K3 moves four pixels at a
    time), as ``torch.empty`` gives them.  ``err`` turns nonzero if a loop
    bound was hit."""
    if parent.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("min_prop_windows_local: parent and out must start on 16 bytes")
    n, h, w = masks_u8.shape
    lib = _lib()
    stream = torch.cuda.current_stream(masks_u8.device).cuda_stream
    rc = lib.ctd_min_prop_window(
        masks_u8.data_ptr(), seeds_i32.data_ptr(), parent.data_ptr(), out.data_ptr(),
        err.data_ptr(), n, h, w, stream,
    )
    if rc != 0:
        raise RuntimeError(f"min_prop_windows_local: CUDA launch failed: {lib.ctd_error_string(rc).decode()}")


def ids_chunk_count(h: int, w: int) -> int:
    """K1's raster chunks a window of (h, w): the length of each window's
    row of the ``counts`` scratch."""
    return -(-h * w // IDS_CHUNK)


def launch_cc_ids_window(masks_u8: torch.Tensor, parent: torch.Tensor, counts: torch.Tensor,
                         out: torch.Tensor, err: torch.Tensor) -> None:
    """Enqueue K1 on the current stream (no count, no sync); raises if the
    launch was refused.  ``parent`` is int32 scratch of the masks' shape,
    ``counts`` int32 scratch of (N, ids_chunk_count(H, W)).  ``err`` turns
    nonzero if a loop bound was hit."""
    n, h, w = masks_u8.shape
    lib = _lib()
    stream = torch.cuda.current_stream(masks_u8.device).cuda_stream
    rc = lib.ctd_cc_ids_window(masks_u8.data_ptr(), parent.data_ptr(), counts.data_ptr(), out.data_ptr(),
                               err.data_ptr(), n, h, w, stream)
    if rc != 0:
        raise RuntimeError(f"cc_ids_fused: CUDA launch failed: {lib.ctd_error_string(rc).decode()}")


def _raise_on_bound(err: torch.Tensor, name: str) -> None:
    count("host_syncs")
    if int(err.item()) != 0:
        raise RuntimeError(f"{name}: a union-find loop exceeded its bound")


def cc_windows_local(masks_u8: torch.Tensor) -> torch.Tensor:
    """K2: per-window 8-connected CC of (N, H, W) uint8 masks -> (N, H, W)
    int32 component-min local linear index, 2**30 on background."""
    _check_windows(masks_u8, torch.uint8, "cc_windows_local")
    if masks_u8.device.type == "cpu":
        return cc_windows_local_plain(masks_u8)
    masks_u8 = masks_u8.contiguous()
    out = torch.empty(masks_u8.shape, dtype=torch.int32, device=masks_u8.device)
    err = torch.zeros(1, dtype=torch.int32, device=masks_u8.device)
    launch_cc_window(masks_u8, out, err)
    cc_windows_local.launches += 1
    _raise_on_bound(err, "cc_windows_local")
    return out


def min_prop_windows_local(masks_u8: torch.Tensor, seeds_i32: torch.Tensor) -> torch.Tensor:
    """K3: per-window component-min of int32 seeds -> (N, H, W) int32, the
    minimum seed of each foreground pixel's component, 0 on background."""
    _check_windows(masks_u8, torch.uint8, "min_prop_windows_local")
    _check_windows(seeds_i32, torch.int32, "min_prop_windows_local")
    if seeds_i32.shape != masks_u8.shape or seeds_i32.device != masks_u8.device:
        raise ValueError("min_prop_windows_local: masks and seeds differ in shape or device")
    if masks_u8.device.type == "cpu":
        return min_prop_windows_local_plain(masks_u8, seeds_i32)
    masks_u8, seeds_i32 = masks_u8.contiguous(), seeds_i32.contiguous()
    parent = torch.empty(masks_u8.shape, dtype=torch.int32, device=masks_u8.device)
    out = torch.empty(masks_u8.shape, dtype=torch.int32, device=masks_u8.device)
    err = torch.zeros(1, dtype=torch.int32, device=masks_u8.device)
    launch_min_prop_window(masks_u8, seeds_i32, parent, out, err)
    min_prop_windows_local.launches += 1
    _raise_on_bound(err, "min_prop_windows_local")
    return out


def cc_ids_fused(masks_u8: torch.Tensor) -> torch.Tensor:
    """K1: per-window CC + compact ids of (N, H, W) uint8 masks with
    H*W <= 512*512 -> int32 1-based component ids in raster order of the
    component roots, 0 on background."""
    _check_windows(masks_u8, torch.uint8, "cc_ids_fused")
    if masks_u8.shape[1] * masks_u8.shape[2] > FUSED_IDS_MAX_ELEMS:
        raise ValueError(f"cc_ids_fused: window {tuple(masks_u8.shape[1:])} exceeds 512*512 elements")
    if masks_u8.device.type == "cpu":
        return cc_ids_windows_local_plain(masks_u8)
    masks_u8 = masks_u8.contiguous()
    n, h, w = masks_u8.shape
    parent = torch.empty(masks_u8.shape, dtype=torch.int32, device=masks_u8.device)
    counts = torch.empty((n, ids_chunk_count(h, w)), dtype=torch.int32, device=masks_u8.device)
    out = torch.empty(masks_u8.shape, dtype=torch.int32, device=masks_u8.device)
    err = torch.zeros(1, dtype=torch.int32, device=masks_u8.device)
    launch_cc_ids_window(masks_u8, parent, counts, out, err)
    cc_ids_fused.launches += 1
    _raise_on_bound(err, "cc_ids_fused")
    return out


def cc_ids_fused_into(masks_u8: torch.Tensor, parent: torch.Tensor, counts: torch.Tensor, out: torch.Tensor,
                      err: torch.Tensor) -> None:
    """K1 into the caller's buffers (as :func:`launch_cc_ids_window` takes
    them), enqueued without reading ``err``: the caller reads it once for
    all its launches.  Counted in ``cc_ids_fused.launches``."""
    launch_cc_ids_window(masks_u8, parent, counts, out, err)
    cc_ids_fused.launches += 1


cc_windows_local.launches = 0
min_prop_windows_local.launches = 0
cc_ids_fused.launches = 0


def _split_ids(masks_u8: torch.Tensor, labels_fn, prop_fn) -> torch.Tensor:
    _check_windows(masks_u8, torch.uint8, "cc_ids_windows_local")
    n, h, w = masks_u8.shape
    labels = labels_fn(masks_u8)
    lin = torch.arange(h * w, dtype=torch.int32, device=masks_u8.device).view(1, h, w)
    is_root = (labels == lin) & (masks_u8 != 0)
    rank = torch.cumsum(is_root.view(n, h * w), dim=1, dtype=torch.int32).view(n, h, w)
    return prop_fn(masks_u8, torch.where(is_root, rank, CC_BIG))


def cc_ids_windows_local(masks_u8: torch.Tensor) -> torch.Tensor:
    """Per-window CC + compact ids: (N, H, W) uint8 -> int32 1-based
    component ids in raster order of component roots, 0 on background.

    Windows of at most 512x512 go to K1; larger ones take the split route:
    K2 labels, a raster cumsum ranks the roots, K3 spreads each root's rank
    over its component.  Above 1024x1024 it raises, as the JAX function
    does."""
    _check_windows(masks_u8, torch.uint8, "cc_ids_windows_local")
    hw = masks_u8.shape[1] * masks_u8.shape[2]
    if hw > IDS_MAX_ELEMS:
        raise ValueError(f"cc_ids_windows_local: window {tuple(masks_u8.shape[1:])} exceeds 1024*1024 elements")
    if hw <= FUSED_IDS_MAX_ELEMS:
        return cc_ids_fused(masks_u8)
    return _split_ids(masks_u8, cc_windows_local, min_prop_windows_local)

