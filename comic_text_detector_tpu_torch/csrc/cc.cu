// Connected-components kernels for Hopper (sm_90a), plain C interface.
//
// Replaces three Pallas TPU kernels of comic_text_detector_tpu/ops/pallas_kernels.py:
//
//   K1 ctd_cc_ids_window  <- _cc_ids_kernel (the fused branch of cc_ids_windows_local)
//      (N, H, W) uint8 mask, H*W <= 512*512 -> int32: every foreground pixel
//      gets its 8-connected component's 1-based id, the rank of the
//      component's root (its minimum window-local linear index) in raster
//      order; background gets 0.
//   K2 ctd_cc_window      <- _cc_window_kernel (cc_windows_local)
//      (N, H, W) uint8 mask -> int32: every foreground pixel gets the
//      minimum window-local linear index (row * W + col) of its
//      8-connected component; background gets 2**30.
//   K3 ctd_min_prop_window <- _min_prop_kernel (min_prop_windows_local)
//      (N, H, W) uint8 mask + int32 seeds -> int32: every foreground pixel
//      gets the minimum seed over its component (the split path marks
//      "no seed" with 2**30); background gets 0.  Seeds on background
//      pixels are not read.
//
// Design.  The TPU kernels iterate row/column min-sweeps to a fixpoint with
// the whole window resident in VMEM.  A 1024x1024 int32 window is 4 MB, far
// beyond the 227 KB of shared memory a Hopper block can use, so the window
// lives in device memory instead and is labelled by a lock-free union-find
// over a parent array (Playne & Hawick's union with atomicMin):
//   init    parent[p] = p on foreground, 2**30 on background;
//   merge   each foreground pixel unites with its W, NW, N and NE foreground
//           neighbours (NW and NE are skipped where W or N already links
//           them); a union hooks the larger root under the smaller;
//   flatten parent[p] = find(p).
// Every parent link points to a smaller-or-equal index and links only ever
// decrease, so there are no cycles and the root of a component is its
// minimum linear index: exactly K2's output.  K3 runs the same three steps,
// then an atomicMin of each seed into its root's slot, then a gather.
//
// K1 runs the same three steps, then ranks the roots and gathers.  The
// Pallas kernel ranks with Hillis-Steele shifts over the VMEM-resident
// window and spreads the ranks with a second fixpoint; here a 256x256 int32
// window (256 KB) already exceeds a block's shared memory, so:
//   rank    one 1024-thread block per window; each thread counts the roots
//           of a contiguous run of the window, a block-wide scan in shared
//           memory turns the counts into offsets, and each thread writes
//           1 + (roots before it) at each root of its run;
//   gather  ids[p] = rank[parent[p]]: after the flatten every pixel already
//           holds its root, so no second fixpoint is needed.
// The ranks live in the output array itself, at the roots' slots (as K3's
// minima do), so the only scratch is the parent array: at most
// 12 x 512 x 512 x 4 B = 12.6 MB for a refine dispatch, inside the 50 MB L2.
//
// Termination.  A non-root always points to a strictly smaller index, so a
// find walks at most H*W links.  Each retry of a union strictly lowers one
// of its two operands, so a union retries at most 2*H*W times.  Both loops
// carry those counts as bounds; exceeding one (impossible unless memory is
// corrupted) sets *err and the Python wrapper raises.
//
// Cost.  At the main path's 1024x1024 window, K2 moves about 5 MB (1 MB of
// mask in, 4 MB of labels out) and K3 about 9 MB (mask + seeds in, ids out);
// K1 moves 5 bytes a pixel (mask in, ids out), 10.5 MB for 32 windows of
// 256x256: all three are bound by memory bandwidth, not arithmetic.  This first version
// is simple rather than fast: parent links live in device memory and are
// read through L2 (__ldcg), not in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define CC_BIG (1 << 30)

namespace {

constexpr int kThreads = 256;
constexpr int kRankThreads = 1024;  // 32 warps: one warp scans the warp totals

__device__ __forceinline__ int load_link(const int* p) { return __ldcg(p); }

// Root of x, halving the path on the way.  A link only ever moves to a
// smaller index in x's own component, so the atomicMin keeps every link
// valid whatever other threads do meanwhile.
__device__ int find_root(int* parent, int x, int limit, int* err) {
    for (int step = 0; step <= limit; ++step) {
        int p = load_link(parent + x);
        if (p == x) return x;
        int gp = load_link(parent + p);
        if (gp != p) atomicMin(parent + x, gp);
        x = p;
    }
    atomicExch(err, 1);
    return x;
}

__device__ void unite(int* parent, int a, int b, int limit, int* err) {
    for (int step = 0; step <= 2 * limit; ++step) {
        a = find_root(parent, a, limit, err);
        b = find_root(parent, b, limit, err);
        if (a == b) return;
        if (a < b) {
            int t = a;
            a = b;
            b = t;
        }
        // a > b: hook a under b.  If a was hooked elsewhere meanwhile, the
        // link a -> old survives as a -> min(old, b), and old must still be
        // united with b.
        int old = atomicMin(parent + a, b);
        if (old == a) return;
        a = old;
    }
    atomicExch(err, 1);
}

__global__ void init_kernel(const uint8_t* __restrict__ mask, int* __restrict__ parent,
                            int* __restrict__ out, int out_fill, long long total, int hw) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    int local = (int)(i % hw);
    bool fg = mask[i] != 0;
    parent[i] = fg ? local : CC_BIG;
    if (out != nullptr) out[i] = fg ? out_fill : 0;
}

__global__ void merge_kernel(const uint8_t* __restrict__ mask, int* parent, long long total,
                             int h, int w, int* err) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total || mask[i] == 0) return;
    int hw = h * w;
    long long base = i - i % hw;
    int p = (int)(i - base);
    int y = p / w, x = p - y * w;
    const uint8_t* m = mask + base;
    int* par = parent + base;
    bool west = x > 0 && m[p - 1];
    if (west) unite(par, p, p - 1, hw, err);
    if (y > 0) {
        int q = p - w;
        bool north = m[q] != 0;
        if (north) {
            unite(par, p, q, hw, err);
        } else {
            // NW is linked through W, NE through N, when those are foreground
            if (!west && x > 0 && m[q - 1]) unite(par, p, q - 1, hw, err);
            if (x + 1 < w && m[q + 1]) unite(par, p, q + 1, hw, err);
        }
    }
}

__global__ void flatten_kernel(const uint8_t* __restrict__ mask, int* parent, long long total,
                               int hw, int* err) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total || mask[i] == 0) return;
    long long base = i - i % hw;
    parent[i] = find_root(parent + base, (int)(i - base), hw, err);
}

__global__ void seed_min_kernel(const uint8_t* __restrict__ mask, const int* __restrict__ parent,
                                const int* __restrict__ seeds, int* out, long long total, int hw) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total || mask[i] == 0) return;
    long long base = i - i % hw;
    atomicMin(out + base + parent[i], seeds[i]);
}

// Each root's slot already holds its component's minimum seed; a non-root
// is never a slot and background is never a root, so these writes do not
// race with the reads.
__global__ void gather_kernel(const uint8_t* __restrict__ mask, const int* __restrict__ parent,
                              int* out, long long total, int hw) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total || mask[i] == 0) return;
    long long base = i - i % hw;
    out[i] = out[base + parent[i]];
}

// One block per window.  parent holds each pixel's root after the flatten
// (2**30 on background), so a pixel is a root iff parent[p] == p.  Writes
// the 1-based raster rank at each root's slot of out; other slots are left
// as they are.
__global__ void __launch_bounds__(kRankThreads)
rank_roots_kernel(const int* __restrict__ parent, int* __restrict__ out, int hw) {
    __shared__ int warp_total[kRankThreads / 32];
    long long base = (long long)blockIdx.x * hw;
    const int* par = parent + base;
    int* o = out + base;
    int run = (hw + kRankThreads - 1) / kRankThreads;
    int lo = min((int)threadIdx.x * run, hw);
    int hi = min(lo + run, hw);
    int count = 0;
    for (int p = lo; p < hi; ++p) count += par[p] == p;

    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = count;
    for (int d = 1; d < 32; d <<= 1) {
        int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int t = warp_total[lane];
        for (int d = 1; d < 32; d <<= 1) {
            int v = __shfl_up_sync(0xffffffffu, t, d);
            if (lane >= d) t += v;
        }
        warp_total[lane] = t;
    }
    __syncthreads();
    int rank = incl - count + (warp > 0 ? warp_total[warp - 1] : 0);
    for (int p = lo; p < hi; ++p)
        if (par[p] == p) o[p] = ++rank;
}

inline unsigned int blocks_for(long long total) {
    return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// K2.  out doubles as the parent array.  Returns cudaGetLastError().
int ctd_cc_window(const uint8_t* mask, int32_t* out, int32_t* err, int n, int h, int w,
                  cudaStream_t stream) {
    long long total = (long long)n * h * w;
    if (total == 0) return (int)cudaGetLastError();
    unsigned int g = blocks_for(total);
    init_kernel<<<g, kThreads, 0, stream>>>(mask, out, nullptr, 0, total, h * w);
    merge_kernel<<<g, kThreads, 0, stream>>>(mask, out, total, h, w, err);
    flatten_kernel<<<g, kThreads, 0, stream>>>(mask, out, total, h * w, err);
    return (int)cudaGetLastError();
}

// K3.  parent is int32 scratch of the same shape.  Returns cudaGetLastError().
int ctd_min_prop_window(const uint8_t* mask, const int32_t* seeds, int32_t* parent, int32_t* out,
                        int32_t* err, int n, int h, int w, cudaStream_t stream) {
    long long total = (long long)n * h * w;
    if (total == 0) return (int)cudaGetLastError();
    unsigned int g = blocks_for(total);
    init_kernel<<<g, kThreads, 0, stream>>>(mask, parent, out, INT32_MAX, total, h * w);
    merge_kernel<<<g, kThreads, 0, stream>>>(mask, parent, total, h, w, err);
    flatten_kernel<<<g, kThreads, 0, stream>>>(mask, parent, total, h * w, err);
    seed_min_kernel<<<g, kThreads, 0, stream>>>(mask, parent, seeds, out, total, h * w);
    gather_kernel<<<g, kThreads, 0, stream>>>(mask, parent, out, total, h * w);
    return (int)cudaGetLastError();
}

// K1.  parent is int32 scratch of the same shape.  Returns cudaGetLastError().
int ctd_cc_ids_window(const uint8_t* mask, int32_t* parent, int32_t* out, int32_t* err, int n, int h,
                      int w, cudaStream_t stream) {
    long long total = (long long)n * h * w;
    if (total == 0) return (int)cudaGetLastError();
    unsigned int g = blocks_for(total);
    init_kernel<<<g, kThreads, 0, stream>>>(mask, parent, out, 0, total, h * w);
    merge_kernel<<<g, kThreads, 0, stream>>>(mask, parent, total, h, w, err);
    flatten_kernel<<<g, kThreads, 0, stream>>>(mask, parent, total, h * w, err);
    rank_roots_kernel<<<n, kRankThreads, 0, stream>>>(parent, out, h * w);
    gather_kernel<<<g, kThreads, 0, stream>>>(mask, parent, out, total, h * w);
    return (int)cudaGetLastError();
}

const char* ctd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
