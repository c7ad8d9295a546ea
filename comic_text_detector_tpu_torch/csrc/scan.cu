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
//   rows     one warp a row, a chunked segmented scan in registers, with
//            no block barrier.  A block holds 4 rows (2 at C > 64).  Lane i
//            owns the C contiguous pixels [i*C, i*C + C) of its row, C the
//            smallest of 16, 32, 48, 64, 96, 128 with 32*C >= W (48 at
//            W = 1536), so one warp takes every width up to 4096: a row of
//            4096 takes C = 128 (168 registers a thread and 24 bytes spilled,
//            43 KB of shared memory a block of 2 warps), so no row needs
//            two warps or a loop of segments.  At C = 48 a thread takes 128
//            registers: 4 blocks of 4 warps an SM.  The row is staged
//            through a warp-private buffer in shared memory, padded so
//            that a quarter warp's 16-byte accesses to its lanes' chunks
//            hit distinct banks: coalesced asynchronous copies (cp.async),
//            every one issued before any is waited for and none holding a
//            register (16-byte words where the row's start allows, a
//            choice made per row, which is warp-uniform since a warp owns
//            the row; at W % 4 != 0 consecutive rows start at different
//            alignments), __syncwarp, each lane reads its chunk; and back
//            the same way, through registers, for the stores.  On an
//            NVIDIA H100 80GB HBM3 at 700 W, at (4, 1536, 1536): each lane
//            loading and storing its own chunk with 16-byte accesses (the
//            first form of this design) took 0.056-0.058 ms, every load
//            and store instruction touching 32 lines; staged through
//            registers, 0.047-0.049 (167 registers a thread); with cp.async,
//            0.044-0.046 (scripts/k4_row_k5_variants.py).  The mask is
//            kept as bits.  A forward walk leaves each pixel's prefix minimum over
//            its run inside the chunk and the chunk's summary: first pixel
//            set, last pixel set, all set, the minima of the runs at its
//            left and right ends.  Two warp-shuffle scans over (gate,
//            value) pairs carry each run's minimum across the lane
//            borders, rightward and leftward, side by side: a run crosses
//            a border only where both pixels at it are set, and passes
//            through a lane only if the lane is set throughout; no value
//            is a closed gate, never a sentinel, since every int32 is a
//            label.  A backward walk reads each run's minimum at its last
//            pixel (the carries added to the runs at the chunk's ends) and
//            writes it over the run; each pixel is stored once, unset
//            pixels with their input label.  Rows never exchange carries,
//            so neither do the pages of a stack.
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

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef CTD_ROW_WARPS
#define CTD_ROW_WARPS 4  // rows (warps) a block of the row kernel, at most 2 at C > 64
#endif
#ifndef CTD_ROW_MIN_CHUNK
#define CTD_ROW_MIN_CHUNK 16  // the row kernel's least chunk (scripts/k4_row_k5_variants.py raises it)
#endif
#ifndef CTD_ROW_VECTOR
#define CTD_ROW_VECTOR 1  // 16-byte global accesses where aligned (the mask's 4-byte too); 0: 4- and 1-byte ones
#endif

constexpr int kRowWarps = CTD_ROW_WARPS;
constexpr int kMaxRow = 4096;                  // W limit of the row kernel: 32 lanes x 128 pixels
constexpr int kColLanes = 32;                  // columns of the column kernel's strip: one warp
constexpr int kColChunks = 32;                 // row chunks of each column: 1024 threads a block
constexpr int kTile = 8;                       // rows a column thread loads together
constexpr int kFirst = 1, kLast = 2, kAll = 4;  // chunk summary: first / last pixel set, all set
constexpr int kIdentity = 0x7fffffff;          // identity value of the min: INT32_MAX
constexpr unsigned kFull = 0xffffffffu;

// The nonzero bytes of a 4-byte word as 4 bits, byte 0 in bit 0.
__device__ __forceinline__ unsigned nonzero_bits4(unsigned word) {
    unsigned t = __vcmpne4(word, 0u) & 0x80808080u;
    return ((t >> 7) | (t >> 14) | (t >> 21) | (t >> 28)) & 0xfu;
}

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The row kernel's layout for chunks of C pixels a lane: warps a block, and
// the strides of a warp's staging buffers in shared memory, padded so that
// a quarter warp's 16-byte accesses to its lanes' chunks hit distinct banks
// (C + 4 words between label chunks; C + 16 or C + 32 bytes between mask
// chunks, whichever is an odd number of 16-byte units).
template <int C>
struct RowLayout {
    static constexpr int kWarps = C <= 64 || kRowWarps < 2 ? kRowWarps : 2;  // 45 KB of shared memory at most
    static constexpr int kLabelStride = C + 4;
    static constexpr int kMaskStride = C + ((C / 4) % 8 == 0 ? 16 : 32);
};

// Row sweep: warp r of the grid owns row r of the (rows, w) stack; lane i
// the pixels [i*C, i*C + C) of it.
template <int C>
__global__ void __launch_bounds__(RowLayout<C>::kWarps * 32)
row_sweep_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ mask, int* __restrict__ out,
                 long long rows, int w) {
    using L = RowLayout<C>;
    constexpr int kWords = (C + 31) / 32;
    __shared__ __align__(16) int s_labels[L::kWarps][32 * L::kLabelStride];
    __shared__ __align__(16) uint8_t s_mask[L::kWarps][32 * L::kMaskStride];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long row = (long long)blockIdx.x * L::kWarps + warp;
    if (row >= rows) return;  // the whole warp: no shuffle is left waiting
    int* sl = s_labels[warp];
    uint8_t* sm = s_mask[warp];
    const int* lrow = labels + row * w;
    const uint8_t* mrow = mask + row * w;
    int* orow = out + row * w;
    const bool vec = CTD_ROW_VECTOR != 0;
    // where pixel e of the row sits in the staging buffers
    auto at_label = [](int e) { return e / C * L::kLabelStride + e % C; };
    auto at_mask = [](int e) { return e / C * L::kMaskStride + e % C; };

    // stage the row: asynchronous coalesced copies to the lanes' chunks in
    // shared memory, every one issued before any is waited for and none
    // holding a register (16-byte words where the row's start allows, else
    // 4-byte ones; a copy that runs past the row reads up to its end and
    // fills the rest with zeros; a mask row off 4-byte alignment goes byte
    // by byte through registers)
    if (vec && aligned(lrow, 16)) {
#pragma unroll
        for (int j = 0; j < C / 4; ++j) {
            const int e = 4 * (lane + 32 * j);
            if (e < w) __pipeline_memcpy_async(sl + at_label(e), lrow + e, 16, e + 4 <= w ? 0 : 4 * (e + 4 - w));
        }
    } else {
#pragma unroll
        for (int k = 0; k < C; ++k)
            if (lane + 32 * k < w) __pipeline_memcpy_async(sl + at_label(lane + 32 * k), lrow + lane + 32 * k, 4);
    }
    if (vec && aligned(mrow, 16)) {
#pragma unroll
        for (int j = 0; j < C / 16; ++j) {
            const int e = 16 * (lane + 32 * j);
            if (e < w) __pipeline_memcpy_async(sm + at_mask(e), mrow + e, 16, e + 16 <= w ? 0 : e + 16 - w);
        }
    } else if (vec && aligned(mrow, 4)) {
#pragma unroll
        for (int j = 0; j < C / 4; ++j) {
            const int e = 4 * (lane + 32 * j);
            if (e < w) __pipeline_memcpy_async(sm + at_mask(e), mrow + e, 4, e + 4 <= w ? 0 : e + 4 - w);
        }
    } else {
        uint8_t q[C];
#pragma unroll
        for (int k = 0; k < C; ++k) q[k] = lane + 32 * k < w ? __ldg(mrow + lane + 32 * k) : 0;
#pragma unroll
        for (int k = 0; k < C; ++k)
            if (lane + 32 * k < w) sm[at_mask(lane + 32 * k)] = q[k];
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();

    // this lane's chunk: its labels, and its mask as bits (none past the row)
    const int x0 = lane * C;
    // n is tested on w - x0 itself: from n = max(0, min(C, w - x0)) and
    // ``n == C``, nvcc 12.9's sm_90a build took the predicate of the
    // VIMNMX.RELU that clamps n as the test, and partial chunks ran the full
    // chunk's path (the checks on masks aimed at the lane borders caught it)
    const int rest = w - x0;
    const int n = rest >= C ? C : rest > 0 ? rest : 0;  // this lane's pixels
    int v[C];
    unsigned bits[kWords];
#pragma unroll
    for (int k = 0; k < C; k += 4) {
        const int4 q = *reinterpret_cast<const int4*>(sl + lane * L::kLabelStride + k);
        v[k] = q.x;
        v[k + 1] = q.y;
        v[k + 2] = q.z;
        v[k + 3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) bits[i] = 0;
#pragma unroll
    for (int k = 0; k < C; k += 16) {
        const uint4 q = *reinterpret_cast<const uint4*>(sm + lane * L::kMaskStride + k);
        bits[k >> 5] |= (nonzero_bits4(q.x) | nonzero_bits4(q.y) << 4 | nonzero_bits4(q.z) << 8 |
                         nonzero_bits4(q.w) << 12) << (k & 31);
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
        const int left = n - 32 * i;  // this word's pixels inside the row
        bits[i] &= left >= 32 ? ~0u : left > 0 ? (1u << left) - 1 : 0u;
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

    // the chunk back to the staging buffer, then coalesced stores, each
    // pixel once (unset pixels with their input label)
#pragma unroll
    for (int k = 0; k < C; k += 4)
        *reinterpret_cast<int4*>(sl + lane * L::kLabelStride + k) = make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    __syncwarp();
    if (vec && aligned(orow, 16)) {
#pragma unroll
        for (int j = 0; j < C / 4; ++j) {
            const int e = 4 * (lane + 32 * j);
            if (e + 4 <= w) {
                *reinterpret_cast<int4*>(orow + e) = *reinterpret_cast<const int4*>(sl + at_label(e));
            } else {
#pragma unroll
                for (int t = 0; t < 4; ++t)
                    if (e + t < w) orow[e + t] = sl[at_label(e + t)];
            }
        }
    } else {
#pragma unroll
        for (int k = 0; k < C; ++k)
            if (lane + 32 * k < w) orow[lane + 32 * k] = sl[at_label(lane + 32 * k)];
    }
}

template <int C>
int launch_rows(const int32_t* labels, const uint8_t* mask, int32_t* out, long long rows, int w, cudaStream_t stream) {
    constexpr int kWarps = RowLayout<C>::kWarps;
    const long long blocks = (rows + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    row_sweep_kernel<C><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(labels, mask, out, rows, w);
    return (int)cudaGetLastError();
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
    // the least chunk C of 32 lanes that holds the row
    const int c = max((w + 31) / 32, CTD_ROW_MIN_CHUNK);
    if (c <= 16) return launch_rows<16>(labels, mask, out, rows, w, stream);
    if (c <= 32) return launch_rows<32>(labels, mask, out, rows, w, stream);
    if (c <= 48) return launch_rows<48>(labels, mask, out, rows, w, stream);
    if (c <= 64) return launch_rows<64>(labels, mask, out, rows, w, stream);
    if (c <= 96) return launch_rows<96>(labels, mask, out, rows, w, stream);
    return launch_rows<128>(labels, mask, out, rows, w, stream);
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
