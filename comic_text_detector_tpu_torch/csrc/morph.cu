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
// Design.  A register sliding window; no shared memory and no barrier.
// Each thread owns a strip of 4 adjacent output pixels (one 32-bit word in
// uint8, a float4 in float32) of a warp's 128-column segment, and a band
// of kRows output rows.  It loads its strip of the kRows + 2 input rows
// that band needs (the row above and below included), every load issued
// before any is used.  The pixels left and right of its strip come from
// the neighbouring lanes by __shfl_sync, and at the warp's two ends from
// one extra load each (lanes 0 and 31).  The horizontal 3-tap is byte
// permutes and __vminu4 / __vmaxu4 in uint8 and the NaN-winning lo / hi in
// float32; the square's vertical 3-tap is the min (max) of three rows'
// horizontal results, the cross takes the centre row's horizontal result
// with the centre pixels of the rows above and below (never the corners).
// The replicate border is a clamp of the row index at 0 and H - 1 and of
// the column at 0 and W - 1.  A row's strips load and store as one 4-byte
// (uint8) or 16-byte (float32) access where the row's start allows it, a
// choice made per row, which is warp-uniform since a warp's lanes walk the
// same row (at W % 4 != 0 uint8 rows start at different alignments), and
// by single pixels where not and in a strip that crosses column W - 1.
// The bound is bytes: each input byte read once and each output byte
// written once, 2 bytes a pixel in uint8 and 8 in float32 (1.4 us and
// 5.6 us at 1536x1536 and 3.35 TB/s); the band reads its two halo rows
// again, 2 / kRows more, mostly from the L1 and L2.  Bands of 8 rows: on an
// NVIDIA H100 80GB HBM3 at 700 W, 16 and 32 rows ran slower (more registers,
// fewer warps an SM), 4 rows 2-6% faster in float32 and up to 8% slower in
// uint8 at 4096x4096 (scripts/k4_row_k5_variants.py).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef CTD_MORPH_ROWS
#define CTD_MORPH_ROWS 8  // output rows a band (scripts/k4_row_k5_variants.py sets others)
#endif
#ifndef CTD_MORPH_WARPS
#define CTD_MORPH_WARPS 4  // 128-column segments (warps) a block
#endif
#ifndef CTD_MORPH_VECTOR
#define CTD_MORPH_VECTOR 1  // 4- and 16-byte accesses where aligned; 0: single pixels only
#endif

namespace {

constexpr int kRows = CTD_MORPH_ROWS;
constexpr int kWarps = CTD_MORPH_WARPS;
constexpr int kStrip = 4;           // output pixels a thread
constexpr int kSeg = 32 * kStrip;   // columns a warp
constexpr bool kVector = CTD_MORPH_VECTOR != 0;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ float lo(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float hi(float a, float b) { return (a > b || a != a) ? a : b; }

// uint8: a strip is 4 pixels in one word, pixel t in byte t.
template <int Op>
__device__ __forceinline__ unsigned pick(unsigned a, unsigned b) {
    return Op == 1 ? __vmaxu4(a, b) : __vminu4(a, b);
}

__device__ __forceinline__ unsigned load_strip(const uint8_t* row, int col, int w, bool vec) {
    if (vec && col + 3 < w) return __ldg(reinterpret_cast<const unsigned*>(row + col));
    unsigned s = 0;
#pragma unroll
    for (int t = 0; t < kStrip; ++t) s |= (unsigned)__ldg(row + min(col + t, w - 1)) << (8 * t);
    return s;
}

// The horizontal 3-tap of a strip: ``e`` is lane 0's pixel left of the
// warp's columns and lane 31's pixel right of them.
template <int Op>
__device__ __forceinline__ unsigned horizontal(unsigned s, uint8_t e, int lane) {
    const unsigned up = __shfl_up_sync(kFull, s, 1), down = __shfl_down_sync(kFull, s, 1);
    const unsigned left = lane == 0 ? (unsigned)e << 24 : up;  // byte 3: the pixel left of the strip
    const unsigned right = lane == 31 ? (unsigned)e : down;    // byte 0: the pixel right of it
    return pick<Op>(pick<Op>(__byte_perm(left, s, 0x6543), s), __byte_perm(s, right, 0x4321));
}

__device__ __forceinline__ void store_strip(uint8_t* row, int col, int w, bool vec, unsigned v) {
    if (vec && col + 3 < w) {
        *reinterpret_cast<unsigned*>(row + col) = v;
        return;
    }
#pragma unroll
    for (int t = 0; t < kStrip; ++t)
        if (col + t < w) row[col + t] = (uint8_t)(v >> (8 * t));
}

// float32: a strip is a float4.
template <int Op>
__device__ __forceinline__ float pick(float a, float b) {
    return Op == 1 ? hi(a, b) : lo(a, b);
}

template <int Op>
__device__ __forceinline__ float4 pick(float4 a, float4 b) {
    return make_float4(pick<Op>(a.x, b.x), pick<Op>(a.y, b.y), pick<Op>(a.z, b.z), pick<Op>(a.w, b.w));
}

__device__ __forceinline__ float4 load_strip(const float* row, int col, int w, bool vec) {
    if (vec && col + 3 < w) return __ldg(reinterpret_cast<const float4*>(row + col));
    return make_float4(__ldg(row + min(col, w - 1)), __ldg(row + min(col + 1, w - 1)), __ldg(row + min(col + 2, w - 1)),
                       __ldg(row + min(col + 3, w - 1)));
}

template <int Op>
__device__ __forceinline__ float4 horizontal(float4 s, float e, int lane) {
    float left = __shfl_up_sync(kFull, s.w, 1), right = __shfl_down_sync(kFull, s.x, 1);
    if (lane == 0) left = e;
    if (lane == 31) right = e;
    return make_float4(pick<Op>(pick<Op>(left, s.x), s.y), pick<Op>(pick<Op>(s.x, s.y), s.z),
                       pick<Op>(pick<Op>(s.y, s.z), s.w), pick<Op>(pick<Op>(s.z, s.w), right));
}

__device__ __forceinline__ void store_strip(float* row, int col, int w, bool vec, float4 v) {
    if (vec && col + 3 < w) {
        *reinterpret_cast<float4*>(row + col) = v;
        return;
    }
    const float p[kStrip] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < kStrip; ++t)
        if (col + t < w) row[col + t] = p[t];
}

template <typename T>
struct StripOf;
template <>
struct StripOf<uint8_t> {
    using type = unsigned;
    static constexpr unsigned align = 4;
};
template <>
struct StripOf<float> {
    using type = float4;
    static constexpr unsigned align = 16;
};

// Block b owns band b / blocks_x of kRows output rows and kWarps segments
// of 128 columns, warp j of it columns [x0, x0 + 128) with
// x0 = ((b % blocks_x) * kWarps + j) * 128.
template <typename T, int Op>
__global__ void __launch_bounds__(kWarps * 32)
morph3x3_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w, int blocks_x) {
    using S = typename StripOf<T>::type;
    constexpr unsigned kAlign = StripOf<T>::align;
    const int lane = threadIdx.x & 31;
    const int band = (int)(blockIdx.x / blocks_x);
    const int x0 = ((int)(blockIdx.x - (unsigned)band * blocks_x) * kWarps + (threadIdx.x >> 5)) * kSeg;
    if (x0 >= w) return;  // the whole warp: no shuffle is left waiting
    const int col = x0 + lane * kStrip;
    const int ecol = lane == 0 ? max(x0 - 1, 0) : min(x0 + kSeg, w - 1);  // the warp's two extra pixels
    const int y0 = band * kRows;

    // every load first: the strip of the band's kRows + 2 input rows, the
    // row index clamped to the image (the replicate border)
    S c[kRows + 2];
    T e[kRows + 2];
#pragma unroll
    for (int i = 0; i < kRows + 2; ++i) {
        const T* row = x + (long long)min(max(y0 - 1 + i, 0), h - 1) * w;
        c[i] = load_strip(row, col, w, kVector && aligned(row, kAlign));
        e[i] = lane == 0 || lane == 31 ? __ldg(row + ecol) : T(0);
    }
    S hz[kRows + 2];
#pragma unroll
    for (int i = 0; i < kRows + 2; ++i) hz[i] = horizontal<Op>(c[i], e[i], lane);
#pragma unroll
    for (int i = 1; i <= kRows; ++i) {
        const int y = y0 + i - 1;
        if (y >= h) break;
        const S v = Op == 2 ? pick<Op>(pick<Op>(hz[i], c[i - 1]), c[i + 1]) : pick<Op>(pick<Op>(hz[i - 1], hz[i]), hz[i + 1]);
        T* row = out + (long long)y * w;
        store_strip(row, col, w, kVector && aligned(row, kAlign), v);
    }
}

template <typename T>
int launch(const T* x, T* out, int h, int w, int op, cudaStream_t stream) {
    if (h <= 0 || w <= 0) return (int)cudaGetLastError();
    const int blocks_x = ((w + kSeg - 1) / kSeg + kWarps - 1) / kWarps;
    const long long blocks = (long long)blocks_x * ((h + kRows - 1) / kRows);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)blocks;
    switch (op) {
        case 0: morph3x3_kernel<T, 0><<<grid, kWarps * 32, 0, stream>>>(x, out, h, w, blocks_x); break;
        case 1: morph3x3_kernel<T, 1><<<grid, kWarps * 32, 0, stream>>>(x, out, h, w, blocks_x); break;
        case 2: morph3x3_kernel<T, 2><<<grid, kWarps * 32, 0, stream>>>(x, out, h, w, blocks_x); break;
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
