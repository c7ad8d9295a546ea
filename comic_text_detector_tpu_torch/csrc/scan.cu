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
//   columns  a chunked segmented scan.  One block of 32 x 32 threads owns a
//            strip of 32 neighbouring columns of one page over all H rows:
//            threadIdx.x is the column, so a warp reads one row's 128
//            coalesced bytes, and threadIdx.y one of 32 row chunks of
//            c = ceil(H / 32) rows.  Pass 1: each thread walks its chunk's
//            mask and leaves a summary in shared memory (first pixel set,
//            last pixel set, all set; the minima of the runs touching the
//            chunk's top and bottom, whose labels are the only ones it
//            reads).  Carry: for each column, one thread scans the 32
//            summaries downward (the minimum entering each chunk's top run
//            from above) and one upward, as (gate, value) pairs: a run
//            crosses a chunk border only where both pixels at it are set,
//            and passes through a chunk only if the chunk is set
//            throughout; no value is a closed gate, never a sentinel, since
//            every int32 is a label.  Pass 2: each thread walks its chunk
//            forward (prefix minima, the top run seeded with the carry from
//            above; every pixel written) and back (each run's minimum, read
//            at its last pixel, the bottom run's taking the carry from
//            below, written over the rest of the run).  A page's chunks
//            never see another page's.  Every walk loads 8 rows before it
//            uses any, so 8 loads a thread are in flight; a chunk of at
//            most 64 rows keeps its mask bits in a register between the
//            passes.  At (4, 1536, 1536): 192 blocks of 1024 threads, 48
//            rows a chunk, one block an SM at 64 registers a thread (two
//            waves on 132 SMs), where one thread a column gave only N*W =
//            6144 threads, each walking 1536 rows down and up.  Measured
//            on an H100, these ran slower: two blocks an SM at 32 registers
//            (the 8-row tiles spill; 4-row tiles do not keep enough loads
//            in flight), 16, 24 or 28 row chunks at two or three blocks an
//            SM, 16 or 8 columns a strip with 64 or 128 chunks, 12- or
//            16-row tiles, and a forward walk that writes only the pixels
//            it makes final (partial sectors).
// The row kernel moves the least bytes a sweep can: l and m read once, the
// result written once, 9 bytes a pixel; at (4, 1536, 1536) that is 85 MB, a
// byte bound of 25 us at 3.35 TB/s.  The column kernel also reads the top
// and bottom runs' labels a second time and each run's last pixel back,
// writes each set pixel that is not the last of its run a second time
// (mostly in L2), and reads the mask again in both walks of pass 2 where a
// chunk has more than 64 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kItems = 4;                      // pixels per thread in the row kernel
constexpr int kMaxRow = 4096;                  // W limit of the row kernel: 1024 threads x 4
constexpr int kColLanes = 32;                  // columns of the column kernel's strip: one warp
constexpr int kColChunks = 32;                 // row chunks of each column: 1024 threads a block
constexpr int kTile = 8;                       // rows a column thread loads together
constexpr int kFirst = 1, kLast = 2, kAll = 4;  // chunk summary: first / last pixel set, all set
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

// Column sweep: one block per strip of kColLanes columns of one page, over
// all H rows.  threadIdx.x is the column lane, so every row a warp touches
// is one 128-byte line; threadIdx.y numbers the kColChunks row chunks of
// c = ceil(H / kColChunks) rows (the chunks past the last row are empty).
// Each thread walks its chunk in tiles of kTile rows whose loads are all
// issued before any is used, so that many loads are in flight at once.

// Whether row r of a thread's chunk is set: from the chunk's mask bits when
// it has at most 64 rows, else from memory.
__device__ __forceinline__ bool row_set(unsigned long long bits, bool in_bits, const uint8_t* mp, int r, int w) {
    return in_bits ? (bits >> r) & 1 : mp[(long long)r * w] != 0;
}

// The minimum label over rows [lo, hi) of a thread's chunk (hi > lo).
__device__ __forceinline__ int rows_min(const int* lp, int lo, int hi, int w) {
    int m = kIdentity;
    for (int q = lo; q < hi; q += kTile) {
        int v[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) v[t] = q + t < hi ? lp[(long long)(q + t) * w] : kIdentity;
#pragma unroll
        for (int t = 0; t < kTile; ++t) m = min(m, v[t]);
    }
    return m;
}

__global__ void __launch_bounds__(kColLanes * kColChunks)
col_sweep_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ mask, int* __restrict__ out,
                 int h, int w, int strips) {
    __shared__ int s_flags[kColChunks][kColLanes];       // kFirst | kLast | kAll of each chunk
    __shared__ int s_top[kColChunks][kColLanes];         // minimum of the run at the chunk's top
    __shared__ int s_bot[kColChunks][kColLanes];         // minimum of the run at its bottom
    __shared__ int s_down[kColChunks][kColLanes];        // carry into the top run from above
    __shared__ int s_up[kColChunks][kColLanes];          // carry into the bottom run from below
    __shared__ uint8_t s_down_g[kColChunks][kColLanes];  // gates: whether each carry holds a value
    __shared__ uint8_t s_up_g[kColChunks][kColLanes];

    const int lane = threadIdx.x, k = threadIdx.y;
    const long long page = blockIdx.x / strips;
    const int col = (int)(blockIdx.x - page * strips) * kColLanes + lane;
    const int c = (h + kColChunks - 1) / kColChunks;
    const int row0 = min(k * c, h);
    const int n = col < w ? min(c, h - row0) : 0;  // rows this thread walks
    const long long base = (page * h + row0) * (long long)w + col;  // the chunk's first pixel
    const int* lp = labels + base;
    const uint8_t* mp = mask + base;
    int* op = out + base;
    const bool in_bits = c <= 64;  // the chunk's mask stays in a register between the passes

    // pass 1: the chunk's summary.  The mask first: its bits, the length of
    // the run at the top and the start of the run at the bottom
    unsigned long long bits = 0;
    int top_len = 0, bot_start = 0;
    bool in_top = true;
    for (int q = 0; q < n; q += kTile) {
        bool s[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) s[t] = q + t < n && mp[(long long)(q + t) * w] != 0;
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
            if (q + t < n) {
                if (s[t]) {
                    bits |= 1ull << ((q + t) & 63);
                    if (in_top) top_len = q + t + 1;
                } else {
                    in_top = false;
                    bot_start = q + t + 1;
                }
            }
        }
    }
    // then the labels of those two runs only: the runs between them stay
    // inside the chunk and need nothing from the other chunks
    const bool first = top_len > 0, last = bot_start < n, all = first && top_len == n;
    const int top = first ? rows_min(lp, 0, top_len, w) : 0;
    const int bot = all ? top : last ? rows_min(lp, bot_start, n, w) : 0;
    s_flags[k][lane] = (first ? kFirst : 0) | (last ? kLast : 0) | (all ? kAll : 0);
    s_top[k][lane] = top;
    s_bot[k][lane] = bot;
    __syncthreads();

    // the carries: two segmented min-scans over the column's chunk summaries,
    // as (gate, value) pairs, since every int32 is a valid label.  A run
    // crosses a chunk border only where the pixels on both sides are set; it
    // passes through a chunk only if the chunk is set throughout.
    if (k == 0) {
        bool g = false;
        int v = 0;
        for (int j = 0; j < kColChunks; ++j) {  // downward: what enters chunk j's top from above
            s_down_g[j][lane] = g;
            s_down[j][lane] = v;
            int f = s_flags[j][lane];
            if (f & kLast) {
                int b = s_bot[j][lane];
                v = (f & kAll) && g ? min(b, v) : b;
            }
            g = (f & kLast) != 0;
        }
    } else if (k == 1) {
        bool g = false;
        int v = 0;
        for (int j = kColChunks - 1; j >= 0; --j) {  // upward: what enters chunk j's bottom from below
            s_up_g[j][lane] = g;
            s_up[j][lane] = v;
            int f = s_flags[j][lane];
            if (f & kFirst) {
                int t = s_top[j][lane];
                v = (f & kAll) && g ? min(t, v) : t;
            }
            g = (f & kFirst) != 0;
        }
    }
    __syncthreads();
    if (n == 0) return;

    // pass 2, forward: the prefix minimum of each run, the top run seeded
    // with the carry from above; every pixel is written (unset pixels and
    // each run's last pixel are then final)
    bool prev = first && s_down_g[k][lane];
    int carry = s_down[k][lane];
    for (int q = 0; q < n; q += kTile) {
        bool s[kTile];
        int v[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) s[t] = q + t < n && row_set(bits, in_bits, mp, q + t, w);
#pragma unroll
        for (int t = 0; t < kTile; ++t) v[t] = q + t < n ? lp[(long long)(q + t) * w] : 0;
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
            if (q + t < n) {
                if (s[t] && prev) v[t] = min(carry, v[t]);
                op[(long long)(q + t) * w] = v[t];
                carry = v[t];
                prev = s[t];
            }
        }
    }
    // back: a run's last pixel holds its minimum (the bottom run's with the
    // carry from below); the walk reads it there and writes it over the rest
    // of the run, so only set pixels are read back and written again
    int hi = n - 1;
    prev = false;
    if (last && s_up_g[k][lane]) {
        carry = min(op[(long long)hi * w], s_up[k][lane]);
        op[(long long)hi * w] = carry;
        prev = true;
        --hi;
    }
    for (; hi >= 0; hi -= kTile) {
        bool s[kTile];
        int v[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) s[t] = hi - t >= 0 && row_set(bits, in_bits, mp, hi - t, w);
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
            bool below = t == 0 ? prev : s[t - 1];
            v[t] = s[t] && !below ? op[(long long)(hi - t) * w] : 0;
        }
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
            if (s[t]) {
                if (prev)
                    op[(long long)(hi - t) * w] = carry;
                else
                    carry = v[t];
            }
            prev = s[t];
        }
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
    if (n == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
    int strips = (w + kColLanes - 1) / kColLanes;
    long long blocks = (long long)n * strips;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    col_sweep_kernel<<<(unsigned int)blocks, dim3(kColLanes, kColChunks), 0, stream>>>(labels, mask, out, h, w,
                                                                                         strips);
    return (int)cudaGetLastError();
}

const char* ctd_scan_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
