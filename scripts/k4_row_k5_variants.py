"""Time variants of K4's row kernel and of K5 on one NVIDIA GPU.

    python3 scripts/k4_row_k5_variants.py [k4|k5]

Run from the root of a checkout; with no argument, both kernels.  Builds
``comic_text_detector_tpu_torch/csrc/scan.cu`` and ``csrc/morph.cu`` as
committed, variants of each that change one design choice through the
macros the sources read (``-D`` flags), and the design each replaced, its
source kept below:

* K4 rows (one warp a row, staged through a warp-private buffer in shared
  memory with coalesced accesses, lane chunks in registers, two shuffle
  scans): ``warps2`` (rows a block, 4 committed up to 64 pixels a lane),
  ``chunk64`` (the chunk template raised to at least 64 pixels a lane: at
  W = 1536, 24 lanes of 64 in place of 32 of 48), ``scalar`` (4-byte label
  and 1-byte mask accesses in place of 16-byte ones), ``direct`` (this
  design's first form: each lane loads and stores its own chunk, no
  staging) and ``replaced`` (one block a row in shared memory, two
  block-wide scans);
* K5 (strips of 4 pixels, a register window walking a band of rows):
  ``rows4`` and ``rows16`` (rows a band, 8 committed; 16 was the first
  committed and 32 the slowest of 8, 16 and 32), ``warps8`` (warps
  a block, 4 committed), ``scalar`` (byte or float loads and stores in
  place of 4- and 16-byte words), and ``replaced`` (32 x 32 output tiles
  staged with a halo in shared memory).

Holds each variant bit for bit against the plain version (K4 on masks
aimed at its lane borders at widths 1-4096 and on views at odd offsets; K5
in uint8 and float32, all three ops, at odd shapes, with NaN and infinities
in float32), then times each on the card's clock (CUPTI through
``torch.profiler``, a launch; both turns printed) and on CUDA events over
the Python launch loop (the host's issue rate for kernels of a few
microseconds), every variant twice, in turns:

* K4 rows at (4, 1536, 1536) and (4, 2048, 2048) on text-like blobs and
  on 45% noise, 2 copies cycled (more than the 50 MB L2);
* K5 at 1536 x 1536 (8 copies cycled in both types: the uint8 ones fit in
  the L2) and 4096 x 4096 (uint8 4 copies, 67 MB; float32 2 copies,
  268 MB), beside ``out.copy_(x)`` of the same bytes, the practical floor.

Prints the card's name and power limit, each build's registers and spills
(``-Xptxas -v``), and as its last line one JSON object of times in ms.
Builds go to ``comic_text_detector_tpu_torch/build/variants/``.  Exits 1
without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "comic_text_detector_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "comic_text_detector_tpu_torch", "build", "variants")

# K4's row kernel before its redesign: one block a row, the row staged in
# shared memory, 4 pixels a thread, two block-wide scans behind barriers.
_REPLACED_ROWS = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kItems = 4;                      // pixels per thread in the row kernel
constexpr int kMaxRow = 4096;                  // W limit of the row kernel: 1024 threads x 4
constexpr int kIdentity = 0x7fffffff;          // identity value of the min: INT32_MAX
constexpr unsigned kFull = 0xffffffffu;

// One pass of the segmented min-scan over a row in shared memory, forward
// (reverse == false) or backward.  Every thread must call it.
__device__ void row_pass(int* sl, const uint8_t* sm, int w, bool reverse, int* warp_g, int* warp_v) {
    int v[kItems];
    bool g[kItems];
    int first = threadIdx.x * kItems;  // position along the scan direction
    for (int k = 0; k < kItems; ++k) {
        int i = first + k;
        if (i < w) {
            int p = reverse ? w - 1 - i : i;
            int q = reverse ? p + 1 : p - 1;  // predecessor along the scan
            v[k] = sl[p];
            g[k] = i > 0 && sm[p] && sm[q];
        } else {
            v[k] = kIdentity;
            g[k] = false;
        }
    }
    // this thread's aggregate: (a, b) -> (a.g & b.g, b.g ? min(a.v, b.v) : b.v)
    bool tg = g[0];
    int tv = v[0];
    for (int k = 1; k < kItems; ++k) {
        tv = g[k] ? min(tv, v[k]) : v[k];
        tg = tg && g[k];
    }
    // inclusive scan of the aggregates within the warp
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int ig = tg, iv = tv;
    for (int d = 1; d < 32; d <<= 1) {
        int pg = __shfl_up_sync(kFull, ig, d);
        int pv = __shfl_up_sync(kFull, iv, d);
        if (lane >= d) {
            iv = ig ? min(pv, iv) : iv;
            ig = ig && pg;
        }
    }
    // exclusive within the warp: the inclusive value of the lane before
    int eg = __shfl_up_sync(kFull, ig, 1);
    int ev = __shfl_up_sync(kFull, iv, 1);
    if (lane == 0) {
        eg = 1;
        ev = kIdentity;
    }
    if (lane == 31) {
        warp_g[warp] = ig;
        warp_v[warp] = iv;
    }
    __syncthreads();
    int nwarps = blockDim.x >> 5;
    if (warp == 0) {
        int wg = lane < nwarps ? warp_g[lane] : 1;
        int wv = lane < nwarps ? warp_v[lane] : kIdentity;
        for (int d = 1; d < 32; d <<= 1) {
            int pg = __shfl_up_sync(kFull, wg, d);
            int pv = __shfl_up_sync(kFull, wv, d);
            if (lane >= d) {
                wv = wg ? min(pv, wv) : wv;
                wg = wg && pg;
            }
        }
        if (lane < nwarps) {
            warp_g[lane] = wg;
            warp_v[lane] = wv;
        }
    }
    __syncthreads();
    // the carry into this thread: all warps before it, then the lanes before it
    int carry = ev;
    if (warp > 0) carry = eg ? min(warp_v[warp - 1], ev) : ev;
    for (int k = 0; k < kItems; ++k) {
        v[k] = g[k] ? min(carry, v[k]) : v[k];
        carry = v[k];
    }
    for (int k = 0; k < kItems; ++k) {
        int i = first + k;
        if (i < w) sl[reverse ? w - 1 - i : i] = v[k];
    }
    __syncthreads();  // the next pass reads other threads' pixels
}

__global__ void __launch_bounds__(1024)
row_sweep_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ mask, int* __restrict__ out, int w) {
    __shared__ int sl[kMaxRow];
    __shared__ uint8_t sm[kMaxRow];
    __shared__ int warp_g[32], warp_v[32];
    long long base = (long long)blockIdx.x * w;
    for (int i = threadIdx.x; i < w; i += blockDim.x) {
        sl[i] = labels[base + i];
        sm[i] = mask[base + i] != 0;
    }
    __syncthreads();
    row_pass(sl, sm, w, false, warp_g, warp_v);
    row_pass(sl, sm, w, true, warp_g, warp_v);
    for (int i = threadIdx.x; i < w; i += blockDim.x) out[base + i] = sl[i];
}

}  // namespace

extern "C" {

// Row sweep of an (n, h, w) stack, w <= 4096.  Returns cudaGetLastError().
int ctd_cc_row_sweep(const int32_t* labels, const uint8_t* mask, int32_t* out, int n, int h, int w,
                     cudaStream_t stream) {
    long long rows = (long long)n * h;
    if (rows == 0 || w == 0) return (int)cudaGetLastError();
    if (w > kMaxRow) return (int)cudaErrorInvalidValue;
    int threads = ((w + kItems - 1) / kItems + 31) / 32 * 32;
    row_sweep_kernel<<<(unsigned int)rows, threads, 0, stream>>>(labels, mask, out, w);
    return (int)cudaGetLastError();
}

}  // extern "C"
"""

# The first design of this redesign, as prescribed: each lane loads and
# stores its own chunk of C pixels with 16-byte accesses, so that every
# load or store instruction of a warp touches 32 lines (a chunk is 192 B at
# W = 1536); no shared memory.
_DIRECT_ROWS = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#define CTD_ROW_MIN_CHUNK 16
#define CTD_ROW_VECTOR 1

namespace {

constexpr int kRowWarps = 4;
constexpr int kMaxRow = 4096;
constexpr unsigned kFull = 0xffffffffu;

// The nonzero bytes of a 4-byte word as 4 bits, byte 0 in bit 0.
__device__ __forceinline__ unsigned nonzero_bits4(unsigned word) {
    unsigned t = __vcmpne4(word, 0u) & 0x80808080u;
    return ((t >> 7) | (t >> 14) | (t >> 21) | (t >> 28)) & 0xfu;
}

__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Row sweep: warp r of the grid owns row r of the (rows, w) stack; lane i
// the pixels [i*C, i*C + C) of it.
template <int C>
__global__ void __launch_bounds__(kRowWarps * 32)
row_sweep_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ mask, int* __restrict__ out,
                 long long rows, int w) {
    constexpr int kWords = (C + 31) / 32;
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
    if (row >= rows) return;  // the whole warp: no shuffle is left waiting
    const long long row0 = row * w;
    const int x0 = lane * C;
    // whether the chunk is full is tested on w - x0 itself: from
    // n = max(0, min(C, w - x0)) and ``n == C``, nvcc 12.9's sm_90a build
    // took the predicate of the VIMNMX.RELU that clamps n as the test, and
    // partial chunks ran the full chunk's vector path (the checks on masks
    // aimed at the lane borders caught it)
    const int rest = w - x0;
    const bool full = rest >= C;
    const int n = full ? C : rest > 0 ? rest : 0;  // this lane's pixels
    const long long at = row0 + (rest > 0 ? x0 : w);
    const int* lp = labels + at;
    const uint8_t* mp = mask + at;
    int* op = out + at;
    const bool vec = CTD_ROW_VECTOR != 0;
    const bool lvec = vec && aligned16(labels + row0), ovec = vec && aligned16(out + row0);
    const bool m16 = vec && aligned16(mask + row0), m4 = vec && (reinterpret_cast<uintptr_t>(mask + row0) & 3) == 0;

    // every load first: the labels, then the mask as bits
    int v[C];
    unsigned bits[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) bits[i] = 0;
    if (full && lvec) {
#pragma unroll
        for (int k = 0; k < C; k += 4) {
            const int4 q = __ldg(reinterpret_cast<const int4*>(lp + k));
            v[k] = q.x;
            v[k + 1] = q.y;
            v[k + 2] = q.z;
            v[k + 3] = q.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < C; ++k) v[k] = k < n ? __ldg(lp + k) : 0;
    }
    if (full && m16) {
#pragma unroll
        for (int k = 0; k < C; k += 16) {
            const uint4 q = __ldg(reinterpret_cast<const uint4*>(mp + k));
            bits[k >> 5] |= (nonzero_bits4(q.x) | nonzero_bits4(q.y) << 4 | nonzero_bits4(q.z) << 8 |
                             nonzero_bits4(q.w) << 12) << (k & 31);
        }
    } else if (full && m4) {
#pragma unroll
        for (int k = 0; k < C; k += 4)
            bits[k >> 5] |= nonzero_bits4(__ldg(reinterpret_cast<const unsigned*>(mp + k))) << (k & 31);
    } else {
#pragma unroll
        for (int k = 0; k < C; ++k)
            if (k < n && __ldg(mp + k) != 0) bits[k >> 5] |= 1u << (k & 31);
    }

    // forward walk: each set pixel takes the minimum of its run up to it
    // inside the chunk; the leading run's length and minimum (top), the
    // trailing run's start and minimum (bot)
    int top = 0, bot = 0, top_len = 0, bot_start = 0;
    bool lead = true;
#pragma unroll
    for (int k = 0; k < C; ++k) {
        const bool s = (bits[k >> 5] >> (k & 31)) & 1u;
        if (k > 0 && s && ((bits[(k - 1) >> 5] >> ((k - 1) & 31)) & 1u)) v[k] = min(v[k], v[k - 1]);
        if (s && lead) {
            top = v[k];
            top_len = k + 1;
        }
        if (!s && k < n) {
            lead = false;
            bot_start = k + 1;
        }
        if (k == n - 1) bot = v[k];
    }
    const bool first = top_len > 0, last = bot_start < n, all = n > 0 && top_len == n;

    // the carries: a run crosses the border to the lane before where this
    // lane's first pixel and that lane's last are set, and to the lane
    // after where this lane's last pixel and that lane's first are set
    const bool prev_last = __shfl_up_sync(kFull, (int)last, 1) && lane > 0;
    const bool next_first = __shfl_down_sync(kFull, (int)first, 1) && lane < 31;
    int rg = all && prev_last, rv = bot;   // rightward: the run leaving each lane's right end
    int lg = all && next_first, lv = top;  // leftward: the run leaving its left end
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int pg = __shfl_up_sync(kFull, rg, d), pv = __shfl_up_sync(kFull, rv, d);
        const int qg = __shfl_down_sync(kFull, lg, d), qv = __shfl_down_sync(kFull, lv, d);
        if (lane >= d) {
            if (rg) rv = min(rv, pv);
            rg = rg && pg;
        }
        if (lane + d < 32) {
            if (lg) lv = min(lv, qv);
            lg = lg && qg;
        }
    }
    const int from_left = __shfl_up_sync(kFull, rv, 1), from_right = __shfl_down_sync(kFull, lv, 1);
    const bool take_left = prev_last && first, take_right = next_first && last;

    // backward walk: a run's last pixel holds its minimum in the chunk; the
    // runs at the chunk's ends take the carries; written over the run
    bool after = false;  // whether the pixel after k is set
    int r = 0;
#pragma unroll
    for (int k = C - 1; k >= 0; --k) {
        const bool s = (bits[k >> 5] >> (k & 31)) & 1u;
        if (s && !after) {
            r = v[k];
            if (take_right && k == n - 1) r = min(r, from_right);
            if (take_left && k < top_len) r = min(r, from_left);
        }
        if (s) v[k] = r;
        after = s;
    }
    if (full && ovec) {
#pragma unroll
        for (int k = 0; k < C; k += 4) *reinterpret_cast<int4*>(op + k) = make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    } else {
#pragma unroll
        for (int k = 0; k < C; ++k)
            if (k < n) op[k] = v[k];
    }
}

template <int C>
void launch_rows(const int32_t* labels, const uint8_t* mask, int32_t* out, long long rows, int w, unsigned blocks,
                 cudaStream_t stream) {
    row_sweep_kernel<C><<<blocks, kRowWarps * 32, 0, stream>>>(labels, mask, out, rows, w);
}

}  // namespace

extern "C" {

// Row sweep of an (n, h, w) stack, w <= 4096.  Returns cudaGetLastError().
int ctd_cc_row_sweep(const int32_t* labels, const uint8_t* mask, int32_t* out, int n, int h, int w,
                     cudaStream_t stream) {
    long long rows = (long long)n * h;
    if (rows == 0 || w == 0) return (int)cudaGetLastError();
    if (w > kMaxRow) return (int)cudaErrorInvalidValue;
    long long blocks = (rows + kRowWarps - 1) / kRowWarps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    // the least chunk C of 32 lanes that holds the row
    const int c = max((w + 31) / 32, CTD_ROW_MIN_CHUNK);
    if (c <= 16)
        launch_rows<16>(labels, mask, out, rows, w, (unsigned)blocks, stream);
    else if (c <= 32)
        launch_rows<32>(labels, mask, out, rows, w, (unsigned)blocks, stream);
    else if (c <= 48)
        launch_rows<48>(labels, mask, out, rows, w, (unsigned)blocks, stream);
    else if (c <= 64)
        launch_rows<64>(labels, mask, out, rows, w, (unsigned)blocks, stream);
    else if (c <= 96)
        launch_rows<96>(labels, mask, out, rows, w, (unsigned)blocks, stream);
    else
        launch_rows<128>(labels, mask, out, rows, w, (unsigned)blocks, stream);
    return (int)cudaGetLastError();
}

}  // extern "C"
"""

# (source, or None for the committed file; extra nvcc flags)
K4_VARIANTS = {
    "committed": (None, []),
    "warps2": (None, ["-DCTD_ROW_WARPS=2"]),
    "chunk64": (None, ["-DCTD_ROW_MIN_CHUNK=64"]),
    "scalar": (None, ["-DCTD_ROW_VECTOR=0"]),
    "direct": (_DIRECT_ROWS, []),
    "replaced": (_REPLACED_ROWS, []),
}
# K5 before its redesign: a block of 32 x 8 threads writes a 32 x 32 output
# tile from a 34 x 34 input tile staged in shared memory.
_REPLACED_MORPH = r"""
// 3x3 grey morphology kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel K5 of comic_text_detector_tpu/ops/pallas_kernels.py,
// which is two kernels behind three functions:
//
//   ctd_morph3x3_{u8,f32} op 0 <- _morph_kernel via erode3x3: the minimum over
//                                 the full 3x3 square;
//                         op 1 <- _morph_kernel via dilate3x3: the maximum
//                                 over the full 3x3 square;
//                         op 2 <- _ellipse_kernel via erode3x3_ellipse: the
//                                 minimum over the centre and its 4-neighbour
//                                 cross (cv2's 3x3 MORPH_ELLIPSE).
//   The border replicates the edge pixels (cv2's default border for
//   erode/dilate, scipy.ndimage mode="nearest").  Inputs are (H, W) uint8
//   or float32; a NaN wins every minimum and maximum, as torch.minimum and
//   jnp.minimum have it.
//
// Design.  A stencil with a 1-pixel halo.  A block of 32 x 8 threads writes
// a 32 x 32 tile of the output: it loads the 34 x 34 input tile into shared
// memory once, with coordinates clamped to the image (that clamping is the
// replicate border), then each thread takes the 9 (or 5) taps of 4 pixels.
// Arbitrary H and W; the ragged edge tiles mask their stores.  The bound is
// bytes: each input byte read once and each output byte written once, 2
// bytes a pixel in uint8 and 8 in float32 (1.4 us and 5.6 us at 1536x1536
// and 3.35 TB/s); the taps are a few integer or float compares a pixel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;  // block is kTile x (kTile / kRowsPerThread) threads

__device__ __forceinline__ uint8_t lo(uint8_t a, uint8_t b) { return a < b ? a : b; }
__device__ __forceinline__ uint8_t hi(uint8_t a, uint8_t b) { return a > b ? a : b; }
__device__ __forceinline__ float lo(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float hi(float a, float b) { return (a > b || a != a) ? a : b; }

template <typename T, int Op>
__global__ void morph3x3_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w) {
    __shared__ T tile[kTile + 2][kTile + 2];
    int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
    int tid = threadIdx.y * blockDim.x + threadIdx.x;
    int nthreads = blockDim.x * blockDim.y;
    for (int k = tid; k < (kTile + 2) * (kTile + 2); k += nthreads) {
        int ty = k / (kTile + 2), tx = k - ty * (kTile + 2);
        int gy = min(max(y0 + ty - 1, 0), h - 1);
        int gx = min(max(x0 + tx - 1, 0), w - 1);
        tile[ty][tx] = x[(long long)gy * w + gx];
    }
    __syncthreads();
    int cx = threadIdx.x + 1;
    int gx = x0 + threadIdx.x;
    for (int r = 0; r < kRowsPerThread; ++r) {
        int cy = threadIdx.y * kRowsPerThread + r + 1;
        int gy = y0 + cy - 1;
        if (gx >= w || gy >= h) continue;
        T c = tile[cy][cx];
        T acc;
        if (Op == 2) {
            acc = lo(lo(lo(lo(c, tile[cy - 1][cx]), tile[cy + 1][cx]), tile[cy][cx - 1]), tile[cy][cx + 1]);
        } else {
            acc = c;
            for (int dy = -1; dy <= 1; ++dy)
                for (int dx = -1; dx <= 1; ++dx) {
                    if (dy == 0 && dx == 0) continue;
                    T t = tile[cy + dy][cx + dx];
                    acc = Op == 0 ? lo(acc, t) : hi(acc, t);
                }
        }
        out[(long long)gy * w + gx] = acc;
    }
}

template <typename T>
int launch(const T* x, T* out, int h, int w, int op, cudaStream_t stream) {
    if (h <= 0 || w <= 0) return (int)cudaGetLastError();
    dim3 block(kTile, kTile / kRowsPerThread);
    dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
    switch (op) {
        case 0: morph3x3_kernel<T, 0><<<grid, block, 0, stream>>>(x, out, h, w); break;
        case 1: morph3x3_kernel<T, 1><<<grid, block, 0, stream>>>(x, out, h, w); break;
        case 2: morph3x3_kernel<T, 2><<<grid, block, 0, stream>>>(x, out, h, w); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// op: 0 erode (3x3 min), 1 dilate (3x3 max), 2 cross erode.  Returns cudaGetLastError().
int ctd_morph3x3_u8(const uint8_t* x, uint8_t* out, int h, int w, int op, cudaStream_t stream) {
    return launch(x, out, h, w, op, stream);
}

int ctd_morph3x3_f32(const float* x, float* out, int h, int w, int op, cudaStream_t stream) {
    return launch(x, out, h, w, op, stream);
}

const char* ctd_morph_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
"""

K5_VARIANTS = {
    "committed": (None, []),
    "rows4": (None, ["-DCTD_MORPH_ROWS=4"]),
    "rows16": (None, ["-DCTD_MORPH_ROWS=16"]),
    "warps8": (None, ["-DCTD_MORPH_WARPS=8"]),
    "scalar": (None, ["-DCTD_MORPH_VECTOR=0"]),
    "replaced": (_REPLACED_MORPH, []),
}


def build(kernel: str, name: str, source, flags) -> subprocess.Popen:
    from comic_text_detector_tpu_torch.ops import cuda_build

    cu = os.path.join(OUT, f"{kernel}_{name}.cu")
    with open(cu, "w") as f:
        f.write(source if source is not None else open(os.path.join(CSRC, "scan.cu" if kernel == "k4" else "morph.cu")).read())
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", *flags, "-o",
           os.path.join(OUT, f"{kernel}_{name}.so"), cu]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def usage(log: str, pattern: str) -> str:
    """Registers and spills of each entry function whose mangled name holds
    ``pattern``, from ``-Xptxas -v``."""
    out, entry = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1) if pattern in m.group(1) else None
            continue
        if entry and "spill" in ln:
            spill = re.search(r"(\d+) bytes spill stores", ln).group(1)
        if entry and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            t = re.findall(r"Li(\d+)E", entry)
            out.append(f"{'<' + ','.join(t) + '>' if t else entry[:40]} {regs} regs, {spill} B spilled")
            entry = None
    return "; ".join(out)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    which = sys.argv[1:] or ["k4", "k5"]
    sys.path.insert(0, ROOT)
    from chip_smoke import device_ms, fmt, row_lane_masks
    from comic_text_detector_tpu_torch.ops import morph as K5
    from comic_text_detector_tpu_torch.ops import scan_kernels as K4

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(OUT, exist_ok=True)
    variants = {"k4": K4_VARIANTS, "k5": K5_VARIANTS}
    procs = {(k, name): build(k, name, *spec) for k in which for name, spec in variants[k].items()}
    libs = {}
    for (k, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log, flush=True)
            raise RuntimeError(f"nvcc failed on {k} {name}")
        print(f"{k} {name}: " + usage(log, "row_sweep" if k == "k4" else "morph"), flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, f"{k}_{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        if k == "k4":
            lib.ctd_cc_row_sweep.argtypes = [p, p, p, i, i, i, p]
            lib.ctd_cc_row_sweep.restype = i
        else:
            for fn in (lib.ctd_morph3x3_u8, lib.ctd_morph3x3_f32):
                fn.argtypes = [p, p, i, i, i, p]
                fn.restype = i
        libs.setdefault(k, {})[name] = lib

    def k4_launch(lib, lab, m, out):
        n, h, w = lab.shape
        rc = lib.ctd_cc_row_sweep(lab.data_ptr(), m.data_ptr(), out.data_ptr(), n, h, w,
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    def k5_launch(lib, x, out, op):
        fn = lib.ctd_morph3x3_u8 if x.dtype == torch.uint8 else lib.ctd_morph3x3_f32
        rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], op, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    def event_ms(fn, args, iters=100):
        fn(*args[0])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*args[i % len(args)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results = {"card": smi}
    if "k4" in libs:
        checked = 0
        for w in (1, 33, 49, 129, 1535, 1536, 1537, 2047, 2049, 4095, 4096):
            for m_np in (row_lane_masks(2, w, rng), (rng.random((2, 7, w)) < 0.45).astype(np.uint8)):
                m = torch.from_numpy(m_np).to(dev)
                buf = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, m.numel() + 1, dtype=np.int64)
                                       .astype(np.int32)).to(dev)
                for lab in (buf[:-1].view(m.shape), buf[1:].view(m.shape)):  # aligned, and 4 bytes off
                    ref = K4.cc_row_sweep_plain(lab, m)
                    for name, lib in libs["k4"].items():
                        out = torch.empty_like(lab)
                        k4_launch(lib, lab, m, out)
                        torch.cuda.synchronize()
                        if not torch.equal(out, ref):
                            raise AssertionError(f"K4 rows {name} differs from the plain sweep at W = {w}: "
                                                 f"{int((out != ref).sum())} pixels")
                    checked += 1
        print(f"K4 rows: every variant bit-equal to the plain sweep ({checked} cases)", flush=True)

        def blobs(n, s):
            m = np.zeros((n, s, s), np.uint8)
            for p in range(n):
                for _ in range(s * s // 400):
                    y, x = rng.integers(0, s - 40, 2)
                    m[p, y:y + rng.integers(5, 40), x:x + rng.integers(5, 60)] = 1
            m[rng.random(m.shape) > 0.97] = 1
            return m

        order = list(libs["k4"]) + list(libs["k4"])[::-1]
        results["k4_rows"] = {}
        for s in (1536, 2048):
            for kind, m_np in (("blobs", blobs(4, s)), ("noise 45%", (rng.random((4, s, s)) < 0.45).astype(np.uint8))):
                m = torch.from_numpy(m_np).to(dev)
                lin = torch.arange(s * s, dtype=torch.int32, device=dev).view(1, s, s)
                lab = torch.where(m != 0, lin, 2**30).contiguous()
                args = [(lab.clone(), m.clone(), torch.empty_like(lab)) for _ in range(2)]
                case = f"(4, {s}, {s}) {kind}"
                row = {}
                for name in order:
                    lib = libs["k4"][name]
                    r = row.setdefault(name, {"device_ms": [], "event_ms": []})
                    r["device_ms"].append(device_ms(lambda a, b, c, lib=lib: k4_launch(lib, a, b, c), args, only="row_sweep"))
                    r["event_ms"].append(event_ms(lambda a, b, c, lib=lib: k4_launch(lib, a, b, c), args))
                results["k4_rows"][case] = row
                bound = m.numel() * 9 / 3.35e12 * 1e3
                print(f"K4 rows {case}, set {float(m.float().mean()):.3f}, ms a launch on the card's clock "
                      f"(both turns; events, the host's issue rate): " + ", ".join(
                          f"{k} {' / '.join(map(fmt, v['device_ms']))} ({min(v['event_ms']):.4f})"
                          for k, v in row.items()) + f"; bound {bound:.4f} ms; {smi}", flush=True)
    if "k5" in libs:
        results["k5"] = k5_variants(libs["k5"], k5_launch, event_ms, device_ms, fmt, K5, rng, dev, smi)
    print(json.dumps(results), flush=True)


def k5_variants(libs, k5_launch, event_ms, device_ms, fmt, K5, rng, dev, smi) -> dict:
    import numpy as np
    import torch

    from chip_smoke import same_values

    names = ("erode3x3", "dilate3x3", "erode3x3_ellipse")
    checked = 0
    for shape in ((1, 1), (2, 3), (3, 2), (3, 127), (5, 129), (37, 53), (1, 4097), (4097, 1), (1037, 1531),
                  (1536, 1536)):
        for dtype in ("uint8", "float32"):
            if dtype == "uint8":
                x_np = rng.integers(0, 256, shape, dtype=np.uint8)
            else:
                x_np = (rng.standard_normal(shape) * 100).astype(np.float32)
                for special in (np.nan, np.inf, -np.inf):
                    x_np[rng.random(shape) < 0.01] = special
            x = torch.from_numpy(x_np).to(dev)
            # contiguous, and a contiguous view one element off the buffer's start
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
            buf[1:] = x.reshape(-1)
            for xin in (x, buf[1:].view(shape)):
                for op, name in enumerate(names):
                    ref = getattr(K5, name + "_plain")(xin)
                    for vname, lib in libs.items():
                        out = torch.empty_like(xin)
                        k5_launch(lib, xin, out, op)
                        torch.cuda.synchronize()
                        if not same_values(out, ref):
                            raise AssertionError(f"K5 {vname} {name} differs from the plain version at {shape} {dtype}")
                    checked += 1
    print(f"K5: every variant equal to the plain version ({checked} cases; NaN compared as NaN)", flush=True)

    order = list(libs) + list(libs)[::-1]
    res = {}
    x8 = {s: torch.from_numpy(rng.integers(0, 256, (s, s), dtype=np.uint8)).to(dev) for s in (1536, 4096)}
    for s, dtype, copies in ((1536, "uint8", 8), (1536, "float32", 8), (4096, "uint8", 4), (4096, "float32", 2)):
        x = x8[s] if dtype == "uint8" else x8[s].float()
        args = [(x.clone(), torch.empty_like(x)) for _ in range(copies)]
        bound = x.numel() * x.element_size() * 2 / 3.35e12 * 1e3
        floor = device_ms(lambda a, o: o.copy_(a), args)
        for op, name in enumerate(names):
            row = {}
            for vname in order:
                lib = libs[vname]
                r = row.setdefault(vname, {"device_ms": [], "event_ms": []})
                r["device_ms"].append(device_ms(lambda a, o, lib=lib, op=op: k5_launch(lib, a, o, op), args,
                                                  only="morph3x3"))
                r["event_ms"].append(event_ms(lambda a, o, lib=lib, op=op: k5_launch(lib, a, o, op), args))
            case = f"{name} {s}x{s} {dtype}"
            res[case] = {"variants": row, "copy_floor_device_ms": floor, "bound_ms": bound, "copies": copies}
            print(f"K5 {case} ({copies} copies cycled), ms a launch on the card's clock (both turns; events, the "
                  f"host's issue rate): " + ", ".join(
                      f"{k} {' / '.join(map(fmt, v['device_ms']))} ({min(v['event_ms']):.4f})" for k, v in row.items())
                  + f"; out.copy_(x) {fmt(floor)}; bound {bound:.5f} ms; {smi}", flush=True)
    return res


if __name__ == "__main__":
    main()
