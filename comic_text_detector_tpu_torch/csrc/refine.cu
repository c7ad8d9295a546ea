// The device refine for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package runs its refine
// (comic_text_detector_tpu/ops/refine.py::refine_pages) as XLA ops in one
// jitted dispatch per bucket, and ops/refine.py::_refine_windows is those ops
// in PyTorch.  On the card that form issued several hundred small launches a
// dispatch of at most `slots` windows (a slot count that came from XLA's
// static shapes): on an H100 a stream batch of 4 pages at input 1024 spent
// 3,465-4,245 launches and 84-108 ms of host time on 20-26 device ms of work.
// These stages do the same arithmetic over every window of a refine_pages
// call at once, from a table of windows that the host builds in NumPy
// (ops/refine.py::window_table) and uploads in one copy; a call is about
// twenty launches (K1, csrc/cc.cu, labels the candidates and the inverse
// masks in between).
//
// What bounds them.  Bytes: the eight stages read and write about 130 bytes
// a window pixel in all (taps in, 8 bytes of pixel state, the candidate
// bytes, their labels once a rank, the inverse mask and its labels), so a
// batch's 19 windows, about 2 M pixels, need some 80 us at 3.35 TB/s.  What
// the design fights is the launch count and the host time: every kernel
// takes all windows of the call, a block a 32 x 32 tile of one window's
// plane, and the reductions that need a whole window (the thresholds, the
// hole area) run in the last of its blocks to finish (a threadfence and a
// ticket) instead of in a launch of their own.
//
// The windows.  Row w of the table (enum Col, ops/refine.py::_TABLE_COLS)
// gives its page, box, bucket shape (sh, sw), in-window rectangle
// [0, ny) x [0, nx), cap, exact or resampled, and where its state lives.
// Windows share a K1 "group" plane of (plane_h, stride) >= (sh, sw) so that
// K1 runs once a group; a window sits at the plane's top-left corner and the
// rest of its plane stays background, which leaves K1's ids unchanged
// (raster order of (y, x) is the same at any row stride).  Each window's
// plane is tiled; tile_start[w] is its first tile (block).
//
// Stages (each a launch over every tile of every window):
//   window_in   taps (1:1, or the bilinear blend of a resampled window),
//               in_window, grey, the rect-3 erode > 127 selection, the
//               ellipse-3 erode > 60 prediction, five 256-level histograms
//               (grey by selection and by in_window; B, G, R by in_window)
//               in shared memory; the window's last block rebins, picks the
//               band colours and the three Otsu thresholds.
//   xor         the 12 XOR sums: both polarities of 3 bands and 3 Otsu masks.
//   candidates  the chosen polarities and Otsu channel, the 4 candidates
//               (a pointwise function of the pixel state, so a tile with a
//               halo of 2 recomputes its neighbours) with tiny components
//               dropped, written in stable XOR order as K1's input.
//   merge r     (r = 0..3) the merge of rank r-1 and the signed component
//               sums of rank r (warp-aggregated integer atomics).
//   finish      the merge of rank 3 (with a halo), the inpaint dilate, the
//               inverse mask (K1's second input; the merge is its complement
//               from here) and the merged area.
//   fill_sums   the inverse components' signed sums and in-window areas;
//               the window's last block takes the second-largest area.
//   fill_paste  the accepted holes; exact windows OR 255 into the canvas.
//   paste       resampled windows only: the bilinear paste back to the box.
//
// Bit-equality.  The float work repeats ops/refine.py's PyTorch ops one by
// one with explicit intrinsics, so nvcc cannot contract or reorder it:
// __fmaf_rn where the plain route fuses (_fma), __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn where PyTorch rounds each op, rintf for
// torch.round, the Otsu cumsum in XLA's blocks of 16 (_cumsum_f32), the
// first maximum for argmax.  Counts and component sums are integers.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

// The buffers and sizes of one refine_pages call (ops/refine.py::_RefineArgs);
// outside the anonymous namespace, so that the extern "C" entry points that
// take it keep external linkage.
struct RefineArgs {
    const int* table;       // n_win rows of kNumCols
    const int* tile_start;  // n_win + 1
    const int* coords;
    const int* resampled;   // indices of the resampled windows
    const uint8_t* img;     // (P, img_h, img_w, 3) BGR
    const uint8_t* mask;    // (P, img_h, img_w)
    uint8_t* canvas;        // (P, canvas_h, canvas_w), zeroed
    int* acc;               // word 0: K1's error flag; then each window's accumulators, zeroed
    uint2* px;              // per pixel: B, G, R, mask bytes; grey | in_window << 8 | pred << 9
    uint8_t* merged;        // per pixel: the merge so far; a resampled window's final mask
    uint8_t* fgs;           // 4 candidate planes a window, in rank order (K1's input)
    const int* ids;         // their component ids (K1's output)
    uint8_t* inv;           // the inverse merge (K1's second input)
    const int* ids_inv;
    int n_win, n_tiles, n_resampled;
    int img_h, img_w, canvas_h, canvas_w;
    int inpaint;
};

namespace {

constexpr int kTile = 32;                        // a block's tile of a window plane
constexpr int kThreads = 256;                    // 8 rows of 32 lanes; a thread takes 4 pixels of a column
constexpr int kRowStep = kThreads / kTile;
constexpr int kPixelsPerThread = kTile / kRowStep;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInvalidXor = 1 << 30;             // ops/refine.py::_XOR_INVALID
constexpr int kPasteBlocks = 64;                 // blocks a resampled window's paste

// Columns of a window's row in the table (ops/refine.py::_TABLE_COLS).
enum Col {
    kPage, kX0, kY0, kX1, kY1,  // page and box (xyxy)
    kSh, kSw,                   // bucket shape
    kNy, kNx,                   // in-window rectangle
    kPlaneH, kStride,           // the window's plane in its K1 group
    kExact, kCap,
    kPx,                        // first pixel of its plane in the per-pixel buffers
    kCand, kCandStep,           // first pixel of its rank-0 candidate plane; pixels between ranks
    kRows, kCols,               // offsets in coords of its sampling rows and columns (i0, i1, frac bits)
    kAcc,                       // offset of its accumulators in acc
    kPasteRows, kPasteCols,     // resampled: offsets in coords of the paste's rows and columns
    kRy0, kRy1, kRx0, kRx1,     // resampled: the page region the paste may set
    kNumCols
};

// A window's accumulators, from acc + row[kAcc] (all start at 0).
enum Acc {
    kHist = 0,                // 5 x 256 counts: grey by selection, grey by in_window, B, G, R
    kXor = 5 * 256,           // 12 XOR sums: (positive, negative) x (3 bands, 3 channels)
    kDoneIn = kXor + 12,      // tickets of window_in's blocks
    kDoneFill,                // tickets of fill_sums' blocks
    kArea,                    // merged pixels inside the window
    kNColors,                 // written by window_in's last block:
    kColors,                  //   3 band colours (float bits), then
    kThresh = kColors + 3,    //   3 Otsu thresholds
    kHoleArea = kThresh + 3,  // written by fill_sums' last block
    kHeader = 1536            // then 4 x cap merge sums (rank-major), then 2 x cap fill sums (signed, area)
};


// ---------------------------------------------------------------------------
// Blocks, tiles and warps
// ---------------------------------------------------------------------------

struct Tile {
    int oy, ox;  // origin in the window plane
    int ntiles;  // tiles of the window
};

// The window whose tiles hold block b: the largest w with tile_start[w] <= b.
__device__ int find_window(const int* tile_start, int n, int b) {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
        int mid = (lo + hi + 1) >> 1;
        if (tile_start[mid] <= b) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// Loads the block's window row into shared `row` and returns its tile.
__device__ Tile block_tile(const RefineArgs& a, int* row) {
    __shared__ int w_s;
    if (threadIdx.x == 0) w_s = find_window(a.tile_start, a.n_win, blockIdx.x);
    __syncthreads();
    int w = w_s;
    if (threadIdx.x < kNumCols) row[threadIdx.x] = a.table[w * kNumCols + threadIdx.x];
    __syncthreads();
    Tile t;
    int local = blockIdx.x - a.tile_start[w];
    int across = (row[kStride] + kTile - 1) / kTile;
    t.oy = (local / across) * kTile;
    t.ox = (local % across) * kTile;
    t.ntiles = a.tile_start[w + 1] - a.tile_start[w];
    return t;
}

__device__ __forceinline__ size_t plane_at(const int* row, int y, int x) {
    return (size_t)row[kPx] + (size_t)y * row[kStride] + x;
}

__device__ __forceinline__ size_t cand_at(const int* row, int rank, int y, int x) {
    return (size_t)row[kCand] + (size_t)rank * row[kCandStep] + (size_t)y * row[kStride] + x;
}

// For each distinct key among the lanes with `on`, add to base[key] the
// number of such lanes (`count`) or their sum of +1 (`positive`) and -1: one
// atomic a key a warp.  Every lane of the warp calls it; lanes without `on`
// pass key -1, which no lane with `on` has.
__device__ __forceinline__ void warp_add(int* base, int key, bool on, bool positive, bool count) {
    unsigned on_mask = __ballot_sync(kFull, on);
    unsigned pos_mask = __ballot_sync(kFull, on && positive);
    unsigned grp = __match_any_sync(kFull, on ? key : -1) & on_mask;
    int lane = threadIdx.x & 31;
    if (on && (__ffs(grp) - 1) == lane) {
        int n = __popc(grp);
        int v = count ? n : 2 * __popc(grp & pos_mask) - n;
        if (v) atomicAdd(base + key, v);
    }
}

// As warp_add, two sums a key: the signed one into signed_base, the count
// into count_base.
__device__ __forceinline__ void warp_add2(int* signed_base, int* count_base, int key, bool on, bool positive) {
    unsigned on_mask = __ballot_sync(kFull, on);
    unsigned pos_mask = __ballot_sync(kFull, on && positive);
    unsigned grp = __match_any_sync(kFull, on ? key : -1) & on_mask;
    int lane = threadIdx.x & 31;
    if (on && (__ffs(grp) - 1) == lane) {
        int n = __popc(grp);
        int v = 2 * __popc(grp & pos_mask) - n;
        if (v) atomicAdd(signed_base + key, v);
        atomicAdd(count_base + key, n);
    }
}

__device__ __forceinline__ int warp_sum(int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    return v;
}

// True in every thread of the window's last block to finish (its global
// atomics done before the ticket), whose reads then see every block's.
__device__ bool last_block(int* done, int ntiles) {
    __shared__ int is_last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) is_last = atomicAdd(done, 1) == ntiles - 1;
    __syncthreads();
    if (is_last) __threadfence();
    return is_last;
}

// ---------------------------------------------------------------------------
// window_in: taps, pixel state, histograms; thresholds in the last block
// ---------------------------------------------------------------------------

__device__ __forceinline__ float blend2(float a, float b, float wa, float fb) {
    return __fmaf_rn(a, wa, __fmul_rn(b, fb));  // _fma(a, 1 - f, b * f)
}

// B, G, R, mask of window pixel (y, x), inside the window's true box.
__device__ uint32_t window_tap(const RefineArgs& a, const int* row, int y, int x) {
    const int* cr = a.coords + row[kRows] + 3 * y;
    const int* cc = a.coords + row[kCols] + 3 * x;
    size_t page = (size_t)row[kPage] * a.img_h;
    if (row[kExact]) {
        size_t p = (page + cr[0]) * a.img_w + cc[0];
        const uint8_t* c = a.img + 3 * p;
        return (uint32_t)c[0] | ((uint32_t)c[1] << 8) | ((uint32_t)c[2] << 16) | ((uint32_t)a.mask[p] << 24);
    }
    size_t p00 = (page + cr[0]) * a.img_w + cc[0], p01 = (page + cr[0]) * a.img_w + cc[1];
    size_t p10 = (page + cr[1]) * a.img_w + cc[0], p11 = (page + cr[1]) * a.img_w + cc[1];
    float fy = __int_as_float(cr[2]), fx = __int_as_float(cc[2]);
    float wy = __fsub_rn(1.0f, fy), wx = __fsub_rn(1.0f, fx);
    uint32_t out = 0;
    for (int ch = 0; ch < 4; ++ch) {
        float t00, t01, t10, t11;
        if (ch < 3) {
            t00 = a.img[3 * p00 + ch]; t01 = a.img[3 * p01 + ch];
            t10 = a.img[3 * p10 + ch]; t11 = a.img[3 * p11 + ch];
        } else {
            t00 = a.mask[p00]; t01 = a.mask[p01]; t10 = a.mask[p10]; t11 = a.mask[p11];
        }
        // rows first (at both column taps), then columns
        float at_x0 = blend2(t00, t10, wy, fy);
        float at_x1 = blend2(t01, t11, wy, fy);
        float v = fminf(fmaxf(rintf(blend2(at_x0, at_x1, wx, fx)), 0.0f), 255.0f);
        out |= (uint32_t)v << (8 * ch);
    }
    return out;
}

// cv2 BGR -> GRAY in XLA's fused order (bgr2gray_u8).
__device__ __forceinline__ int grey_u8(int b, int g, int r) {
    float v = __fmaf_rn((float)r, 0.299f, __fmaf_rn((float)b, 0.114f, __fmul_rn((float)g, 0.587f)));
    return (int)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

// _cumsum_f32 over 256 values: sequential sums within blocks of 16, plus the
// sequential sum of the blocks before.  Block-wide; the result in cum.
__device__ void cumsum_f32(const float* v, float* cum, float* off) {
    int t = threadIdx.x;
    if (t < 16) {
        float s = v[16 * t];
        cum[16 * t] = s;
        for (int j = 1; j < 16; ++j) {
            s = __fadd_rn(s, v[16 * t + j]);
            cum[16 * t + j] = s;
        }
    }
    __syncthreads();
    if (t == 0) {
        float o = 0.0f;
        off[0] = 0.0f;
        for (int b = 1; b < 16; ++b) {
            o = __fadd_rn(o, cum[16 * b - 1]);
            off[b] = o;
        }
    }
    __syncthreads();
    float r = __fadd_rn(cum[t], off[t / 16]);
    __syncthreads();
    cum[t] = r;
    __syncthreads();
}

// The index of the block's largest value, the first of equal ones.
__device__ int argmax_first(float val) {
    __shared__ float bv[kThreads / 32];
    __shared__ int bi[kThreads / 32];
    __shared__ int best;
    int idx = threadIdx.x;
    for (int o = 16; o > 0; o >>= 1) {
        float ov = __shfl_down_sync(kFull, val, o);
        int oi = __shfl_down_sync(kFull, idx, o);
        if (ov > val || (ov == val && oi < idx)) {
            val = ov;
            idx = oi;
        }
    }
    if ((threadIdx.x & 31) == 0) {
        bv[threadIdx.x / 32] = val;
        bi[threadIdx.x / 32] = idx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float v = bv[0];
        int i = bi[0];
        for (int k = 1; k < kThreads / 32; ++k) {
            if (bv[k] > v || (bv[k] == v && bi[k] < i)) {
                v = bv[k];
                i = bi[k];
            }
        }
        best = i;
    }
    __syncthreads();
    int r = best;
    __syncthreads();
    return r;
}

// The window's band colours (_topk_colors over the 255 rebinned grey bins)
// and per-channel Otsu thresholds (_otsu_from_hist), from its histograms.
// One block of 256 threads, one a level.
__device__ void thresholds(int* acc) {
    __shared__ int h[5][256];
    __shared__ int c255[256], sorted[256], order[256];
    __shared__ float colors[256], v[256], cum[256], off[16];
    __shared__ int lo_s, hi_s;
    const int t = threadIdx.x;
    for (int k = 0; k < 5; ++k) h[k][t] = __ldcg(acc + kHist + 256 * k + t);
    c255[t] = 0;
    if (t == 0) {
        lo_s = 256;
        hi_s = -1;
    }
    __syncthreads();
    // the selection's histogram, or in_window's where nothing is selected
    bool any_sel = __syncthreads_or(h[0][t] > 0);
    int wh = any_sel ? h[0][t] : h[1][t];
    if (wh > 0) {
        atomicMin(&lo_s, t);
        atomicMax(&hi_s, t);
    }
    __syncthreads();
    // np.histogram's 255 bins over [lo, hi]
    float lo = (float)lo_s, hi = (float)hi_s;
    float width = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1e-6f), 255.0f);
    float bin = fminf(fmaxf(__fdiv_rn(__fsub_rn((float)t, lo), width), 0.0f), 254.0f);
    atomicAdd(&c255[(int)bin], wh);
    __syncthreads();
    // stable descending order of the 255 bins
    if (t < 255) {
        int ci = c255[t], rank = 0;
        for (int j = 0; j < 255; ++j) {
            int cj = c255[j];
            rank += (cj > ci) || (cj == ci && j < t);
        }
        sorted[rank] = ci;
        order[rank] = t;
    }
    __syncthreads();
    if (t < 255) colors[t] = __fmaf_rn((float)order[t], width, lo);
    __syncthreads();
    if (t == 0) {
        // the greedy walk: bin k (k >= 1) is open while no bin 1..k-1 fell
        // under the tolerance; the second colour is the first open bin over
        // 10 from the first, the third the next one also over 10 from it
        int total = 0;
        for (int k = 0; k < 255; ++k) total += sorted[k];
        float tol = __fmul_rn((float)total, 0.001f);
        float c0 = colors[0];
        int i2 = -1, i3 = -1;
        for (int k = 1; k < 255; ++k) {
            if (fabsf(__fsub_rn(colors[k], c0)) > 10.0f) {
                i2 = k;
                break;
            }
            if ((float)sorted[k] < tol) break;
        }
        float c2 = colors[i2 >= 0 ? i2 : 0];
        if (i2 >= 0) {
            for (int k = 1; k < 255; ++k) {
                if (k > i2 && fabsf(__fsub_rn(colors[k], c0)) > 10.0f && fabsf(__fsub_rn(colors[k], c2)) > 10.0f) {
                    i3 = k;
                    break;
                }
                if ((float)sorted[k] < tol) break;
            }
        }
        float c3 = colors[i3 >= 0 ? i3 : 0];
        acc[kColors] = __float_as_int(c0);
        acc[kColors + 1] = __float_as_int(i2 >= 0 ? c2 : 1e9f);
        acc[kColors + 2] = __float_as_int(i3 >= 0 ? c3 : 1e9f);
        acc[kNColors] = 1 + (i2 >= 0) + (i3 >= 0);
    }
    // Otsu on B, G and R: maximise the between-class variance
    for (int ch = 0; ch < 3; ++ch) {
        float x = (float)h[2 + ch][t];
        v[t] = x;
        __syncthreads();
        cumsum_f32(v, cum, off);
        float w0 = cum[t], total = cum[255];
        __syncthreads();
        v[t] = __fmul_rn(x, (float)t);
        __syncthreads();
        cumsum_f32(v, cum, off);
        float s0 = cum[t], mu = cum[255];
        float w1 = __fsub_rn(total, w0);
        float m0 = w0 > 0.0f ? __fdiv_rn(s0, fmaxf(w0, 1.0f)) : 0.0f;
        float m1 = w1 > 0.0f ? __fdiv_rn(__fsub_rn(mu, s0), fmaxf(w1, 1.0f)) : 0.0f;
        float d = __fsub_rn(m0, m1);
        float between = __fmul_rn(__fmul_rn(w0, w1), __fmul_rn(d, d));
        int best = argmax_first(between);
        if (t == 0) acc[kThresh + ch] = best;
    }
}

__global__ void __launch_bounds__(kThreads) window_in_kernel(RefineArgs a) {
    __shared__ int row[kNumCols];
    __shared__ uint32_t tap[kTile + 2][kTile + 2];  // 0 outside the window's true box
    __shared__ uint8_t inw[kTile + 2][kTile + 2];
    __shared__ int hist[5 * 256];
    Tile t = block_tile(a, row);
    const int sh = row[kSh], sw = row[kSw], ny = row[kNy], nx = row[kNx];
    int* acc = a.acc + row[kAcc];
    for (int i = threadIdx.x; i < 5 * 256; i += kThreads) hist[i] = 0;
    for (int i = threadIdx.x; i < (kTile + 2) * (kTile + 2); i += kThreads) {
        int hy = i / (kTile + 2), hx = i % (kTile + 2);
        int y = t.oy - 1 + hy, x = t.ox - 1 + hx;
        bool iw = y >= 0 && x >= 0 && y < ny && x < nx;  // ny <= sh, nx <= sw
        tap[hy][hx] = iw ? window_tap(a, row, y, x) : 0u;
        inw[hy][hx] = iw;
    }
    __syncthreads();
    const int tx = threadIdx.x % kTile, ty0 = threadIdx.x / kTile;
    for (int i = 0; i < kPixelsPerThread; ++i) {
        int ty = ty0 + i * kRowStep;
        int y = t.oy + ty, x = t.ox + tx;
        bool on = y < sh && x < sw;
        int cy = ty + 1, cx = tx + 1;
        bool iw = inw[cy][cx];
        uint32_t v = tap[cy][cx];
        int b = v & 255, g = (v >> 8) & 255, r = (v >> 16) & 255;
        int grey = grey_u8(b, g, r);
        // erodes of the mask with +inf (255) outside the true box and the window
        int rect = 255, cross = 255;
        for (int dy = -1; dy <= 1; ++dy) {
            for (int dx = -1; dx <= 1; ++dx) {
                int q = inw[cy + dy][cx + dx] ? (int)(tap[cy + dy][cx + dx] >> 24) : 255;
                rect = min(rect, q);
                if (dy == 0 || dx == 0) cross = min(cross, q);
            }
        }
        bool sel = iw && rect > 127;
        bool pred = iw && cross > 60;
        bool in = on && iw;
        warp_add(hist, grey, in && sel, true, true);
        warp_add(hist + 256, grey, in, true, true);
        warp_add(hist + 512, b, in, true, true);
        warp_add(hist + 768, g, in, true, true);
        warp_add(hist + 1024, r, in, true, true);
        if (on) a.px[plane_at(row, y, x)] = make_uint2(v, (uint32_t)grey | ((uint32_t)iw << 8) | ((uint32_t)pred << 9));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 5 * 256; i += kThreads) {
        if (hist[i]) atomicAdd(acc + kHist + i, hist[i]);
    }
    if (!last_block(acc + kDoneIn, t.ntiles)) return;
    thresholds(acc);
}

// ---------------------------------------------------------------------------
// xor and candidates
// ---------------------------------------------------------------------------

// The 3 bands' [c_bot, c_top] from the window's colours.
__device__ __forceinline__ void band_bounds(const int* acc, int b, float* lo, float* hi) {
    float top = fminf(__fadd_rn(__int_as_float(acc[kColors + b]), 30.0f), 255.0f);
    *lo = __fsub_rn(top, 60.0f);
    *hi = top;
}

__global__ void __launch_bounds__(kThreads) xor_kernel(RefineArgs a) {
    __shared__ int row[kNumCols];
    __shared__ float blo[3], bhi[3];
    __shared__ int th[3];
    Tile t = block_tile(a, row);
    int* acc = a.acc + row[kAcc];
    if (threadIdx.x < 3) {
        band_bounds(acc, threadIdx.x, &blo[threadIdx.x], &bhi[threadIdx.x]);
        th[threadIdx.x] = acc[kThresh + threadIdx.x];
    }
    __syncthreads();
    const int sh = row[kSh], sw = row[kSw];
    const int tx = threadIdx.x % kTile, ty0 = threadIdx.x / kTile;
    int sums[12];
    for (int k = 0; k < 12; ++k) sums[k] = 0;
    for (int i = 0; i < kPixelsPerThread; ++i) {
        int y = t.oy + ty0 + i * kRowStep, x = t.ox + tx;
        if (y >= sh || x >= sw) continue;
        uint2 p = a.px[plane_at(row, y, x)];
        bool iw = (p.y >> 8) & 1;
        int m = p.x >> 24;
        float g = (float)(p.y & 255);
        for (int b = 0; b < 3; ++b) {
            bool band = g >= blo[b] && g <= bhi[b];
            sums[2 * b] += ((iw && band) ? 255 : 0) ^ m;
            sums[2 * b + 1] += ((iw && !band) ? 255 : 0) ^ m;
        }
        for (int ch = 0; ch < 3; ++ch) {
            bool above = (int)((p.x >> (8 * ch)) & 255) > th[ch];
            sums[6 + 2 * ch] += ((iw && above) ? 255 : 0) ^ m;
            sums[7 + 2 * ch] += ((iw && !above) ? 255 : 0) ^ m;
        }
    }
    for (int k = 0; k < 12; ++k) {
        int s = warp_sum(sums[k]);
        if ((threadIdx.x & 31) == 0 && s) atomicAdd(acc + kXor + k, s);
    }
}

// 4 candidate bits (bit c: candidate c) of one pixel, from its state.
struct Choice {
    float lo[3], hi[3];
    int ok, neg;       // bit c: candidate c is used; takes the negative polarity
    int ch, thresh;    // the Otsu candidate's channel and threshold
    int order[4];      // candidate of each rank
};

__device__ __forceinline__ int cand_bits(const Choice& c, uint2 p) {
    if (!((p.y >> 8) & 1)) return 0;  // outside the true box every candidate is 0
    float g = (float)(p.y & 255);
    int bits = 0;
    for (int b = 0; b < 3; ++b) {
        bool band = g >= c.lo[b] && g <= c.hi[b];
        if (((c.ok >> b) & 1) && band != (bool)((c.neg >> b) & 1)) bits |= 1 << b;
    }
    bool above = (int)((p.x >> (8 * c.ch)) & 255) > c.thresh;
    if (above != (bool)((c.neg >> 3) & 1)) bits |= 8;
    return bits;
}

// Four 1-bit planes as four 4-bit counters.
__device__ __forceinline__ int spread4(int b) {
    return (b & 1) | ((b & 2) << 3) | ((b & 4) << 6) | ((b & 8) << 9);
}

__global__ void __launch_bounds__(kThreads) candidates_kernel(RefineArgs a) {
    __shared__ int row[kNumCols];
    __shared__ Choice choice;
    __shared__ uint8_t cb[kTile + 4][kTile + 4];    // candidate bits, halo 2
    __shared__ uint8_t lone[kTile + 2][kTile + 2];  // bit c: set in c with exactly one 8-neighbour
    Tile t = block_tile(a, row);
    const int* acc = a.acc + row[kAcc];
    if (threadIdx.x == 0) {
        // _pick_polarity for each band and channel, the best Otsu channel,
        // and the stable XOR order of the 4 candidates
        Choice c;
        int n = acc[kNColors], xr[4];
        c.ok = 8;
        c.neg = 0;
        for (int b = 0; b < 3; ++b) {
            band_bounds(acc, b, &c.lo[b], &c.hi[b]);
            int xp = acc[kXor + 2 * b], xn = acc[kXor + 2 * b + 1];
            if (xn < xp) c.neg |= 1 << b;
            if (n > b) c.ok |= 1 << b;
            xr[b] = n > b ? min(xp, xn) : kInvalidXor;
        }
        int best = kInvalidXor;
        c.ch = 0;
        for (int ch = 0; ch < 3; ++ch) {
            int xp = acc[kXor + 6 + 2 * ch], xn = acc[kXor + 7 + 2 * ch];
            int x = min(xp, xn);
            if (x < best) {
                best = x;
                c.ch = ch;
                c.neg = (c.neg & 7) | ((xn < xp) << 3);
            }
        }
        xr[3] = best;
        c.thresh = acc[kThresh + c.ch];
        for (int i = 0; i < 4; ++i) {
            int rank = 0;
            for (int j = 0; j < 4; ++j) rank += xr[j] < xr[i] || (xr[j] == xr[i] && j < i);
            c.order[rank] = i;
        }
        choice = c;
    }
    __syncthreads();
    const int sh = row[kSh], sw = row[kSw];
    for (int i = threadIdx.x; i < (kTile + 4) * (kTile + 4); i += kThreads) {
        int hy = i / (kTile + 4), hx = i % (kTile + 4);
        int y = t.oy - 2 + hy, x = t.ox - 2 + hx;
        bool in = y >= 0 && x >= 0 && y < sh && x < sw;
        cb[hy][hx] = in ? cand_bits(choice, a.px[plane_at(row, y, x)]) : 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < (kTile + 2) * (kTile + 2); i += kThreads) {
        int ly = i / (kTile + 2), lx = i % (kTile + 2);
        int n8 = 0;
        for (int dy = 0; dy < 3; ++dy)
            for (int dx = 0; dx < 3; ++dx)
                if (dy != 1 || dx != 1) n8 += spread4(cb[ly + dy][lx + dx]);
        int fg = cb[ly + 1][lx + 1], bits = 0;
        for (int c = 0; c < 4; ++c) bits |= (((fg >> c) & 1) && ((n8 >> (4 * c)) & 15) == 1) << c;
        lone[ly][lx] = bits;
    }
    __syncthreads();
    // _drop_tiny_components: singletons and straight 2-pixel pairs go
    const int tx = threadIdx.x % kTile, ty0 = threadIdx.x / kTile;
    for (int i = 0; i < kPixelsPerThread; ++i) {
        int ty = ty0 + i * kRowStep;
        int y = t.oy + ty, x = t.ox + tx;
        if (y >= row[kPlaneH] || x >= row[kStride]) continue;
        int cy = ty + 2, cx = tx + 2;
        int n8 = 0;
        for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx)
                if (dy || dx) n8 += spread4(cb[cy + dy][cx + dx]);
        int n4 = spread4(cb[cy - 1][cx]) + spread4(cb[cy + 1][cx]) + spread4(cb[cy][cx - 1]) + spread4(cb[cy][cx + 1]);
        int partner = lone[cy - 2][cx - 1] | lone[cy][cx - 1] | lone[cy - 1][cx - 2] | lone[cy - 1][cx];
        int fg = cb[cy][cx], keep = 0;
        for (int c = 0; c < 4; ++c) {
            int a8 = (n8 >> (4 * c)) & 15, a4 = (n4 >> (4 * c)) & 15;
            bool tiny = a8 == 0 || (a8 == 1 && a4 == 1 && ((partner >> c) & 1));
            keep |= (((fg >> c) & 1) && !tiny) << c;
        }
        for (int r = 0; r < 4; ++r) a.fgs[cand_at(row, r, y, x)] = (keep >> choice.order[r]) & 1;
    }
}

// ---------------------------------------------------------------------------
// merge and finish
// ---------------------------------------------------------------------------

// Whether the component `id` of rank r was accepted (its signed sum > 0;
// ids >= cap, and background, never are).
__device__ __forceinline__ bool accepted(const int* sums, int cap, int id) {
    return id >= 1 && id < cap && sums[id] > 0;
}

// The merge of rank r - 1 into merged (r >= 1), and the signed component
// sums of rank r (r <= 3) over the pixels rank r would add.
__global__ void __launch_bounds__(kThreads) merge_kernel(RefineArgs a, int r) {
    __shared__ int row[kNumCols];
    Tile t = block_tile(a, row);
    const int sh = row[kSh], sw = row[kSw], cap = row[kCap];
    int* sums = a.acc + row[kAcc] + kHeader;
    const int tx = threadIdx.x % kTile, ty0 = threadIdx.x / kTile;
    for (int i = 0; i < kPixelsPerThread; ++i) {
        int y = t.oy + ty0 + i * kRowStep, x = t.ox + tx;
        bool on = y < sh && x < sw;
        bool add = false, pred = false;
        int id = 0;
        if (on) {
            size_t pp = plane_at(row, y, x);
            bool m = r >= 2 && a.merged[pp];
            if (r >= 1) {
                size_t cp = cand_at(row, r - 1, y, x);
                m = m || (a.fgs[cp] && accepted(sums + (r - 1) * cap, cap, a.ids[cp]));
                a.merged[pp] = m;
            }
            size_t cp = cand_at(row, r, y, x);
            id = a.ids[cp];
            add = a.fgs[cp] && !m && id < cap;
            pred = (a.px[pp].y >> 9) & 1;
        }
        warp_add(sums + r * cap, add ? id : -1, add, pred, false);
    }
}

// The merge of rank 3 (with a halo of 1), the inpaint dilate, the inverse
// mask (0 in the plane outside the window: K1's second input, and the
// merge's only record from here on) and the merged area.
__global__ void __launch_bounds__(kThreads) finish_kernel(RefineArgs a) {
    __shared__ int row[kNumCols];
    __shared__ uint8_t mf[kTile + 2][kTile + 2];
    Tile t = block_tile(a, row);
    const int sh = row[kSh], sw = row[kSw], cap = row[kCap];
    int* acc = a.acc + row[kAcc];
    const int* sums3 = acc + kHeader + 3 * cap;
    for (int i = threadIdx.x; i < (kTile + 2) * (kTile + 2); i += kThreads) {
        int hy = i / (kTile + 2), hx = i % (kTile + 2);
        int y = t.oy - 1 + hy, x = t.ox - 1 + hx;
        bool m = false;
        if (y >= 0 && x >= 0 && y < sh && x < sw) {
            size_t cp = cand_at(row, 3, y, x);
            m = a.merged[plane_at(row, y, x)] || (a.fgs[cp] && accepted(sums3, cap, a.ids[cp]));
        }
        mf[hy][hx] = m;
    }
    __syncthreads();
    const int tx = threadIdx.x % kTile, ty0 = threadIdx.x / kTile;
    int area = 0;
    for (int i = 0; i < kPixelsPerThread; ++i) {
        int ty = ty0 + i * kRowStep;
        int y = t.oy + ty, x = t.ox + tx;
        if (y >= row[kPlaneH] || x >= row[kStride]) continue;
        size_t pp = plane_at(row, y, x);
        bool in = y < sh && x < sw, m = false;
        if (in) {
            bool iw = (a.px[pp].y >> 8) & 1;
            m = mf[ty + 1][tx + 1];
            if (a.inpaint) {
                bool any = false;
                for (int dy = 0; dy < 3; ++dy)
                    for (int dx = 0; dx < 3; ++dx) any = any || mf[ty + dy][tx + dx];
                m = any && iw;
            }
            area += m && iw;
        }
        // merged stays as rank 2 left it (other blocks read it for their
        // halos); from here the merge is the complement of inv in the window
        a.inv[pp] = in && !m;
    }
    area = warp_sum(area);
    if ((threadIdx.x & 31) == 0 && area) atomicAdd(acc + kArea, area);
}

// ---------------------------------------------------------------------------
// fill holes and paste
// ---------------------------------------------------------------------------

// The second-largest of {merged area, the inverse components' in-window
// areas (slots 1 .. cap-1)}: topk(2)'s second value.  Block-wide.
__device__ void hole_threshold(int* acc, int cap) {
    __shared__ int top[kThreads / 32][2];
    const int* area = acc + kHeader + 5 * cap;
    int a1 = INT_MIN, a2 = INT_MIN;
    for (int i = threadIdx.x; i < cap; i += kThreads) {
        int v = i == 0 ? __ldcg(acc + kArea) : __ldcg(area + i);
        if (v > a1) {
            a2 = a1;
            a1 = v;
        } else if (v > a2) {
            a2 = v;
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        int b1 = __shfl_down_sync(kFull, a1, o), b2 = __shfl_down_sync(kFull, a2, o);
        a2 = max(min(a1, b1), max(a2, b2));
        a1 = max(a1, b1);
    }
    if ((threadIdx.x & 31) == 0) {
        top[threadIdx.x / 32][0] = a1;
        top[threadIdx.x / 32][1] = a2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        a1 = top[0][0];
        a2 = top[0][1];
        for (int k = 1; k < kThreads / 32; ++k) {
            int b1 = top[k][0], b2 = top[k][1];
            a2 = max(min(a1, b1), max(a2, b2));
            a1 = max(a1, b1);
        }
        acc[kHoleArea] = a2;
    }
}

__global__ void __launch_bounds__(kThreads) fill_sums_kernel(RefineArgs a) {
    __shared__ int row[kNumCols];
    Tile t = block_tile(a, row);
    const int sh = row[kSh], sw = row[kSw], cap = row[kCap];
    int* acc = a.acc + row[kAcc];
    int* fill = acc + kHeader + 4 * cap;
    const int tx = threadIdx.x % kTile, ty0 = threadIdx.x / kTile;
    for (int i = 0; i < kPixelsPerThread; ++i) {
        int y = t.oy + ty0 + i * kRowStep, x = t.ox + tx;
        bool add = false, pred = false;
        int id = 0;
        if (y < sh && x < sw) {
            size_t pp = plane_at(row, y, x);
            if (a.inv[pp]) {
                uint32_t s = a.px[pp].y;
                id = a.ids_inv[pp];
                add = ((s >> 8) & 1) && id < cap;
                pred = (s >> 9) & 1;
            }
        }
        warp_add2(fill, fill + cap, add ? id : -1, add, pred);
    }
    if (!last_block(acc + kDoneFill, t.ntiles)) return;
    hole_threshold(acc, cap);
}

__global__ void __launch_bounds__(kThreads) fill_paste_kernel(RefineArgs a) {
    __shared__ int row[kNumCols];
    Tile t = block_tile(a, row);
    const int sh = row[kSh], sw = row[kSw], cap = row[kCap];
    const int* acc = a.acc + row[kAcc];
    const int* fill = acc + kHeader + 4 * cap;
    const int thresh = acc[kHoleArea];
    // the 1:1 paste's start, clamped to the canvas padded by the bucket
    const int cy = min(max(row[kY0], 0), a.img_h), cx = min(max(row[kX0], 0), a.img_w);
    uint8_t* canvas = a.canvas + (size_t)row[kPage] * a.canvas_h * a.canvas_w;
    const int tx = threadIdx.x % kTile, ty0 = threadIdx.x / kTile;
    for (int i = 0; i < kPixelsPerThread; ++i) {
        int y = t.oy + ty0 + i * kRowStep, x = t.ox + tx;
        if (y >= sh || x >= sw) continue;
        size_t pp = plane_at(row, y, x);
        bool final = !a.inv[pp];
        if (!final && ((a.px[pp].y >> 8) & 1)) {
            int id = a.ids_inv[pp];
            final = id >= 1 && id < cap && fill[id] > 0 && fill[cap + id] < thresh;
        }
        if (row[kExact]) {
            if (final) canvas[(size_t)(cy + y) * a.canvas_w + cx + x] = 255;
        } else {
            a.merged[pp] = final ? 255 : 0;
        }
    }
}

// Resampled windows: each box pixel inside the page samples the window's
// final mask bilinearly and is set where the blend passes 127.
__global__ void __launch_bounds__(kThreads) paste_resampled_kernel(RefineArgs a) {
    const int* row = a.table + a.resampled[blockIdx.y] * kNumCols;
    const int ry0 = row[kRy0], rx0 = row[kRx0];
    const int cols = row[kRx1] - rx0, n = (row[kRy1] - ry0) * cols;
    const int stride = row[kStride];
    const uint8_t* mk = a.merged + row[kPx];
    uint8_t* canvas = a.canvas + (size_t)row[kPage] * a.canvas_h * a.canvas_w;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
        int ry = i / cols, rx = i % cols;
        const int* cr = a.coords + row[kPasteRows] + 3 * ry;
        const int* cc = a.coords + row[kPasteCols] + 3 * rx;
        float fy = __int_as_float(cr[2]), fx = __int_as_float(cc[2]);
        float wy = __fsub_rn(1.0f, fy), wx = __fsub_rn(1.0f, fx);
        const uint8_t* r0 = mk + (size_t)cr[0] * stride;
        const uint8_t* r1 = mk + (size_t)cr[1] * stride;
        float top = blend2((float)r0[cc[0]], (float)r0[cc[1]], wx, fx);
        float bot = blend2((float)r1[cc[0]], (float)r1[cc[1]], wx, fx);
        if (blend2(top, bot, wy, fy) > 127.0f) canvas[(size_t)(ry0 + ry) * a.canvas_w + rx0 + rx] = 255;
    }
}

}  // namespace

extern "C" {

// kNumCols, kHeader and kTile, for the Python side's check of its layout.
int ctd_refine_layout(int* out) {
    out[0] = kNumCols;
    out[1] = kHeader;
    out[2] = kTile;
    return 0;
}

// window_in, xor, candidates.
int ctd_refine_candidates(const RefineArgs* a, cudaStream_t stream) {
    window_in_kernel<<<a->n_tiles, kThreads, 0, stream>>>(*a);
    cudaError_t rc = cudaGetLastError();
    if (rc == cudaSuccess) {
        xor_kernel<<<a->n_tiles, kThreads, 0, stream>>>(*a);
        rc = cudaGetLastError();
    }
    if (rc == cudaSuccess) {
        candidates_kernel<<<a->n_tiles, kThreads, 0, stream>>>(*a);
        rc = cudaGetLastError();
    }
    return (int)rc;
}

// merge 0..3, finish.
int ctd_refine_merge(const RefineArgs* a, cudaStream_t stream) {
    cudaError_t rc = cudaSuccess;
    for (int r = 0; r < 4 && rc == cudaSuccess; ++r) {
        merge_kernel<<<a->n_tiles, kThreads, 0, stream>>>(*a, r);
        rc = cudaGetLastError();
    }
    if (rc == cudaSuccess) {
        finish_kernel<<<a->n_tiles, kThreads, 0, stream>>>(*a);
        rc = cudaGetLastError();
    }
    return (int)rc;
}

// fill_sums, fill_paste, and the resampled windows' paste.
int ctd_refine_fill(const RefineArgs* a, cudaStream_t stream) {
    fill_sums_kernel<<<a->n_tiles, kThreads, 0, stream>>>(*a);
    cudaError_t rc = cudaGetLastError();
    if (rc == cudaSuccess) {
        fill_paste_kernel<<<a->n_tiles, kThreads, 0, stream>>>(*a);
        rc = cudaGetLastError();
    }
    if (rc == cudaSuccess && a->n_resampled > 0) {
        paste_resampled_kernel<<<dim3(kPasteBlocks, a->n_resampled), kThreads, 0, stream>>>(*a);
        rc = cudaGetLastError();
    }
    return (int)rc;
}

const char* ctd_refine_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
