// Mask finalize and binarize kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel K6 of comic_text_detector_tpu/ops/pallas_kernels.py,
// which is two functions:
//
//   ctd_mask_to_u8 <- _finalize_kernel (:92, mask_to_u8)
//      float32 x -> uint8: x * 255 rounded once in float32, then truncated
//      toward zero.  Inputs are sigmoid outputs in [0, 1]; outside that
//      range the conversion saturates to [0, 255] (NaN gives 0).
//   ctd_binarize   <- _binarize_kernel (:107, binarize)
//      float32 x, float32 t -> uint8 (x > t): 1 or 0.
//
// Layout.  The input is `pages` planes of `plane` float32 elements, each
// plane contiguous, plane p starting `page_stride` elements after plane
// p - 1 (any stride, 0 included): a (B, H, W) stack, or a page-strided view
// read in place, such as lines[:, 0] of the DB head's (B, 2, H, W) output.
// The output is a contiguous (pages, plane) uint8 array.
//
// What bounds it.  5 bytes a pixel (4 read, 1 written) against one or two
// floating-point operations: memory only, 6.26 us at (4, 1024, 1024) and
// 14.1 us at (4, 1536, 1536) at 3.35 TB/s.  So the design is about bytes in
// flight and the launch, not about shared memory or tensor cores.
//
// Design.
//   * A thread does 16 elements of one plane: four independent 16-byte loads
//     issued before it uses any of them (64 B in flight a thread), then four
//     4-byte stores.  A warp owns 32 chunks of 16 elements (2 KB of input),
//     and its k-th load and store are the k-th quarter of them, lane i the
//     i-th float4: each load instruction reads 512 contiguous bytes and each
//     store writes 128.  Giving each thread 16 consecutive elements and one
//     16-byte store instead made every load instruction touch 16 lines of
//     128 B where this one touches 4, and was 10-16% slower with the input
//     in the L2 (0.0041-0.0045 ms against 0.0037-0.0040 at (4, 1024, 1024)
//     on an NVIDIA H100 80GB HBM3 at 700 W; scripts/k6_variants.py keeps it
//     as "consecutive16"); from device memory the two are level.  Eight
//     elements a thread in twice the blocks ("per8", and PyTorch's own
//     layout, "torchlike") was 0.0003 ms faster from device memory at
//     (4, 1024, 1024) and level or slower in the L2, where the stream finds
//     the map; this layout is kept for the stream.
//   * blockIdx.y (and blockIdx.z past 65535 planes) is the plane and
//     blockIdx.x the chunk of 256 x 16 elements: no division and no
//     grid-stride loop in the kernel.  (4, 1024, 1024) is 1024 blocks of 256
//     threads, about one wave on 132 SMs.  A contiguous stack
//     (page_stride == plane) is launched as one plane of pages * plane.
//   * Edges.  A plane's 16-element chunks start at its first output byte that
//     is 16-byte aligned; a load or store of a chunk past the plane's last
//     whole chunk is skipped.  The head before it and the tail after the last
//     whole chunk (fewer than 16 elements each) are done by the first 16
//     threads of the plane's first block, one element each, with scalar
//     loads, in the same launch.  Where the input is not 16-byte aligned at
//     the chunk starts (a page stride or a base that breaks it) each float4
//     is loaded as four floats; the stores are the same.
//   * Caching: the default policy.  The DB decode reads the shrink map again
//     and K2 reads the bitmap right after, both best while still in the
//     50 MB L2; an evict-first load would push them out.
//
// The product is __fmul_rn so that no contraction can change its rounding,
// and __float2uint_rz truncates toward zero as the float32 -> uint8 cast of
// PyTorch and JAX does for values in [0, 255].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;  // the elements of a chunk, and of a thread
constexpr int kLoads = kPerThread / 4;
// a plane's head (< 16 elements) and tail (< kPerThread) take 16 threads
static_assert(kPerThread % 4 == 0 && kPerThread <= 16, "head and tail are done by 16 threads");
constexpr unsigned int kMaxGridY = 65535;

struct ToU8 {
    __device__ __forceinline__ unsigned int operator()(float x) const {
        unsigned int v = __float2uint_rz(__fmul_rn(x, 255.0f));
        return v > 255u ? 255u : v;
    }
};

struct Above {
    float t;
    __device__ __forceinline__ unsigned int operator()(float x) const { return x > t ? 1u : 0u; }
};

template <typename Op>
__device__ __forceinline__ unsigned int pack4(const Op& op, float a, float b, float c, float d) {
    return op(a) | (op(b) << 8) | (op(c) << 16) | (op(d) << 24);
}

template <typename Op>
__global__ void __launch_bounds__(kThreads)
    finalize_kernel(const float* __restrict__ x, uint8_t* __restrict__ out, long long pages, long long plane,
                    long long page_stride, Op op) {
    long long page = (long long)blockIdx.z * gridDim.y + blockIdx.y;
    if (page >= pages) return;
    const float* src = x + page * page_stride;
    uint8_t* dst = out + page * plane;
    long long head = (long long)((16u - ((uintptr_t)dst & 15u)) & 15u);
    if (head > plane) head = plane;
    long long chunks = (plane - head) / kPerThread;
    // warp w takes chunks 32 w .. 32 w + 31; lane i's k-th float4 is the
    // i-th of their k-th 512 bytes, in chunk 32 w + (32 k + i) / kLoads
    long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    int lane = threadIdx.x & 31;
    long long e = head + 32 * kPerThread * w + 4 * lane;
    bool vec = ((uintptr_t)(src + head) & 15u) == 0;
    float4 q[kLoads];
    bool ok[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
        ok[k] = 32 * w + (32 * k + lane) / kLoads < chunks;
        q[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        const float* p = src + e + 128 * k;
        if (ok[k])
            q[k] = vec ? __ldg(reinterpret_cast<const float4*>(p))
                       : make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
        if (ok[k]) *reinterpret_cast<unsigned int*>(dst + e + 128 * k) = pack4(op, q[k].x, q[k].y, q[k].z, q[k].w);
    if (blockIdx.x == 0 && threadIdx.x < 16) {
        long long t = threadIdx.x;
        if (t < head) dst[t] = (uint8_t)op(__ldg(src + t));
        long long tail = head + kPerThread * chunks + t;
        if (tail < plane) dst[tail] = (uint8_t)op(__ldg(src + tail));
    }
}

template <typename Op>
int launch(const float* x, uint8_t* out, long long pages, long long plane, long long page_stride, Op op,
           cudaStream_t stream) {
    if (pages <= 0 || plane <= 0) return (int)cudaGetLastError();
    if (pages == 1 || page_stride == plane) {  // one plane of every element
        plane *= pages;
        pages = 1;
        page_stride = plane;
    }
    long long blocks = (plane / kPerThread + kThreads - 1) / kThreads;
    unsigned int gy = pages < kMaxGridY ? (unsigned int)pages : kMaxGridY;
    unsigned int gz = (unsigned int)((pages + gy - 1) / gy);
    dim3 grid((unsigned int)(blocks < 1 ? 1 : blocks), gy, gz);
    finalize_kernel<<<grid, kThreads, 0, stream>>>(x, out, pages, plane, page_stride, op);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ctd_mask_to_u8(const float* x, uint8_t* out, long long pages, long long plane, long long page_stride,
                   cudaStream_t stream) {
    return launch(x, out, pages, plane, page_stride, ToU8{}, stream);
}

int ctd_binarize(const float* x, uint8_t* out, float thresh, long long pages, long long plane, long long page_stride,
                 cudaStream_t stream) {
    return launch(x, out, pages, plane, page_stride, Above{thresh}, stream);
}

const char* ctd_finalize_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
