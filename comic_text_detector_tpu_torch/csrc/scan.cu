// Connected-components sweep kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel K4 of comic_text_detector_tpu/ops/pallas_kernels.py,
// _scan_kernel, reached through two functions:
//
//   ctd_cc_row_sweep <- cc_row_sweep
//   ctd_cc_col_sweep <- cc_col_sweep
//      (N, H, W) int32 labels l + (N, H, W) uint8 mask m -> int32: a forward
//      then a backward segmented min-scan of l along the rows (the columns).
//      The segments are the nonzero runs of m along that axis, so every pixel
//      with m != 0 gets the minimum of l over its whole run; a pixel with
//      m == 0 keeps its own l, whatever its value.
//
// Design.  The TPU kernel scans row bands or column strips held in VMEM by
// Hillis-Steele doubling (log W shifted copies).  Here:
//   rows     one thread block per row.  The row (W <= 4096 int32, 16 KB, and
//            its mask, 4 KB) is staged in shared memory with coalesced loads.
//            Each thread owns 4 neighbouring pixels.  A pass scans (gate,
//            value) pairs, gate = "this pixel and its predecessor are both
//            set": first within the thread, then across the block (warp
//            shuffles inside a warp, the warps' totals through shared
//            memory), then each thread rescans its 4 pixels with the carry
//            from the pixels before it.  The forward pass runs left to
//            right, the backward pass right to left on the forward result.
//   columns  one thread per column walks down the column carrying the run's
//            minimum, then up again spreading the run's minimum (the value
//            the forward pass left at the run's last pixel).  Neighbouring
//            threads read neighbouring addresses, so every row's loads
//            coalesce.
// Both move the least bytes a sweep can: l and m read once, the result
// written once (the column kernel reads its forward result back once more,
// mostly from L2), 9 bytes a pixel; at (4, 1536, 1536) that is 85 MB, a
// byte bound of 25 us at 3.35 TB/s.  This first version is simple: the
// column kernel runs only N*W threads, one per column, whose dependent walk
// down 1536 rows leaves the card mostly idle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kItems = 4;                      // pixels per thread in the row kernel
constexpr int kMaxRow = 4096;                  // W limit of the row kernel: 1024 threads x 4
constexpr int kColThreads = 128;
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

// One thread per (page, column).
__global__ void col_sweep_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ mask,
                                 int* __restrict__ out, int n, int h, int w) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)n * w) return;
    long long page = t / w;
    int col = (int)(t - page * w);
    long long base = page * h * w + col;
    // forward: prefix minimum of each run
    bool prev = false;
    int carry = 0;
    for (int r = 0; r < h; ++r) {
        long long i = base + (long long)r * w;
        bool set = mask[i] != 0;
        int v = labels[i];
        if (set && prev) v = min(carry, v);
        out[i] = v;
        carry = v;
        prev = set;
    }
    // backward: the run's last pixel holds the run's minimum; spread it up
    prev = false;
    for (int r = h - 1; r >= 0; --r) {
        long long i = base + (long long)r * w;
        bool set = mask[i] != 0;
        int v = out[i];
        if (set && prev) {
            v = carry;
            out[i] = v;
        }
        carry = v;
        prev = set;
    }
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

// Column sweep of an (n, h, w) stack.  Returns cudaGetLastError().
int ctd_cc_col_sweep(const int32_t* labels, const uint8_t* mask, int32_t* out, int n, int h, int w,
                     cudaStream_t stream) {
    long long cols = (long long)n * w;
    if (cols == 0 || h == 0) return (int)cudaGetLastError();
    unsigned int blocks = (unsigned int)((cols + kColThreads - 1) / kColThreads);
    col_sweep_kernel<<<blocks, kColThreads, 0, stream>>>(labels, mask, out, n, h, w);
    return (int)cudaGetLastError();
}

const char* ctd_scan_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
