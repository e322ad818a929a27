// Fused relu + 2x2/stride-2 max-pool, forward and backward, on NHWC memory.
//
// Replaces the TPU kernel pair ops/pallas_pool_paired.py:relu_pool_fwd_4d /
// relu_pool_bwd_4d of the JAX package (block 1 of every VGG19 pass).
//
//   forward : y[b,i,j,c] = max(x[b,2i,2j,c], x[b,2i,2j+1,c],
//                              x[b,2i+1,2j,c], x[b,2i+1,2j+1,c], 0)
//   backward: g[b,h,w,c] = ct[b,h/2,w/2,c] where x > 0 and x == y (every
//             tied window maximum receives the full cotangent), else 0
//
// What bounds it: pure data movement.  At (64, 224, 224, 64) bf16 the
// forward reads 411 MB and writes 103 MB, the backward reads 411 + 2 x 103 MB
// and writes 411 MB; there are ~2 flops per byte, far below the ridge.  So
// the design is only about bytes: one pass, each element read once, no
// intermediate in device memory (the plain version writes a relu output and
// a full-size mask), and neighbouring threads on neighbouring channels so a
// warp's loads coalesce.  A block owns one pooled row (b, i): its two input
// rows start at 2 * (b*H/2 + i) * W * C, so no 64-bit division is needed.
// Comparisons run in float32; bf16 -> f32 is exact, so results are
// bit-identical to the plain version.
//
// C interface for ctypes: each entry returns cudaGetLastError() after the
// launch on the caller's stream; dtype 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kThreads = 256;

template <typename T>
__global__ void relu_pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                                     int64_t W, int64_t C) {
  const int64_t row = blockIdx.x;  // pooled row index b * (H/2) + i
  const int64_t Wo = W / 2;
  const int64_t row_len = Wo * C;
  const T* xr = x + 2 * row * W * C;  // input row 2i of image b
  T* yr = y + row * row_len;
  for (int64_t e = threadIdx.x; e < row_len; e += kThreads) {
    const int64_t c = (int)e % (int)C;  // the wrapper keeps W * C < 2^31
    const int64_t off = 2 * e - c;      // (2j) * C + c
    const float a = to_f32(xr[off]);
    const float b = to_f32(xr[off + C]);
    const float d = to_f32(xr[off + W * C]);
    const float f = to_f32(xr[off + W * C + C]);
    const float m = fmaxf(fmaxf(fmaxf(a, b), fmaxf(d, f)), 0.0f);
    yr[e] = from_f32<T>(m);
  }
}

template <typename T>
__global__ void relu_pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                     const T* __restrict__ ct, T* __restrict__ g,
                                     int64_t W, int64_t C) {
  const int64_t row = blockIdx.x;
  const int64_t Wo = W / 2;
  const int64_t row_len = Wo * C;
  const int64_t in_base = 2 * row * W * C;
  const T* xr = x + in_base;
  T* gr = g + in_base;
  const T* yr = y + row * row_len;
  const T* cr = ct + row * row_len;
  const T zero = from_f32<T>(0.0f);
  for (int64_t e = threadIdx.x; e < row_len; e += kThreads) {
    const int64_t c = (int)e % (int)C;
    const int64_t off = 2 * e - c;
    const float yv = to_f32(yr[e]);
    const T cv = cr[e];
    const int64_t offs[4] = {off, off + C, off + W * C, off + W * C + C};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xv = to_f32(xr[offs[k]]);
      gr[offs[k]] = (xv > 0.0f && xv == yv) ? cv : zero;
    }
  }
}

template <typename T>
int launch_fwd(const void* x, void* y, int64_t B, int64_t H, int64_t W, int64_t C,
               cudaStream_t stream) {
  const int64_t rows = B * (H / 2);
  if (rows > 0 && W >= 2 && C > 0) {
    relu_pool_fwd_kernel<T><<<(unsigned int)rows, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), W, C);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* y, const void* ct, void* g, int64_t B, int64_t H,
               int64_t W, int64_t C, cudaStream_t stream) {
  const int64_t rows = B * (H / 2);
  if (rows > 0 && W >= 2 && C > 0) {
    relu_pool_bwd_kernel<T><<<(unsigned int)rows, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(ct),
        static_cast<T*>(g), W, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int relu_pool_fwd(const void* x, void* y, int64_t B, int64_t H, int64_t W,
                             int64_t C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, y, B, H, W, C, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, y, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int relu_pool_bwd(const void* x, const void* y, const void* ct, void* g, int64_t B,
                             int64_t H, int64_t W, int64_t C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(x, y, ct, g, B, H, W, C, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(x, y, ct, g, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
