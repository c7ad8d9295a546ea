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
