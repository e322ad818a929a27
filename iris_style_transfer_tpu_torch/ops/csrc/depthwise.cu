// Fused depthwise k x k conv + eval batchnorm + SiLU, stride 1, on NHWC memory.
//
// Replaces the TPU kernel ops/pallas_depthwise.py:dw_conv_bn_silu of the JAX
// package (the stride-1 depthwise of every EfficientNet-B7 MBConv block).
//
//   y[b,h,w,c] = silu(a[c] * sum_{dy,dx} x[b, h+dy-p, w+dx-p, c] * wt[dy,dx,c] + b[c])
//
// with p = (K-1)/2, zero padding outside the image, f32 accumulation and an
// f32 epilogue, and the output stored in x's dtype.  a and b are the eval
// batchnorm folded to a per-channel affine in f32 by the caller.  The taps
// are summed in (dy, dx) order, as the TPU kernel does.
//
// What bounds it: memory.  A tap costs 2 flops per element while each
// element is read once and written once, so at K = 3 there are ~4.5 flops
// per byte in bf16, far below the H100's ridge.  The plain form writes the
// conv output, the batchnorm output and the SiLU output as separate passes;
// this kernel reads x once (the K^2 re-reads of neighbours hit L1/L2) and
// writes y once.  One thread owns one output element, channels fastest, so
// a warp reads 32 neighbouring channels of one pixel and its loads coalesce.
// Block (row, chunk) covers 256 elements of image row b*H + h; the row base
// is computed in 64 bits ((128, 208, 320, 64) holds 545 M elements) and the
// in-row index in 32 bits (the wrapper keeps W * C below 2^24).  Shared-memory
// halo tiles and vector loads are later work.
//
// C interface for ctypes: returns cudaGetLastError() after the launch on the
// caller's stream; dtype 0 = float32, 1 = bfloat16; K must be 3 or 5.

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

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
dw_conv_bn_silu_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                       const float* __restrict__ a, const float* __restrict__ bias,
                       T* __restrict__ y, int H, int W, int C) {
  constexpr int P = (K - 1) / 2;
  const int row_len = W * C;
  const int e = blockIdx.y * kThreads + threadIdx.x;  // index inside the row
  if (e >= row_len) return;
  const int64_t row = blockIdx.x;  // b * H + h
  const int h = (int)(row % H);
  const int64_t img_base = (row - h) * row_len;  // element offset of (b, 0, 0, 0)
  const int c = e % C;
  const int wi = e / C;

  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const int ih = h + dy - P;
    if (ih < 0 || ih >= H) continue;
    const T* xr = x + img_base + (int64_t)ih * row_len;
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const int iw = wi + dx - P;
      if (iw < 0 || iw >= W) continue;
      acc += to_f32(xr[iw * C + c]) * to_f32(wt[(dy * K + dx) * C + c]);
    }
  }
  const float v = acc * a[c] + bias[c];
  y[row * row_len + e] = from_f32<T>(v / (1.0f + expf(-v)));
}

template <typename T, int K>
int launch(const void* x, const void* wt, const float* a, const float* b, void* y, int64_t B,
           int64_t H, int64_t W, int64_t C, cudaStream_t stream) {
  const int64_t rows = B * H;
  const int64_t chunks = (W * C + kThreads - 1) / kThreads;
  if (rows > 0 && chunks > 0) {
    const dim3 grid((unsigned int)rows, (unsigned int)chunks);
    dw_conv_bn_silu_kernel<T, K><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wt), a, b, static_cast<T*>(y), (int)H,
        (int)W, (int)C);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(const void* x, const void* wt, const float* a, const float* b, void* y, int64_t B,
             int64_t H, int64_t W, int64_t C, int K, cudaStream_t stream) {
  if (K == 3) return launch<T, 3>(x, wt, a, b, y, B, H, W, C, stream);
  if (K == 5) return launch<T, 5>(x, wt, a, b, y, B, H, W, C, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dw_conv_bn_silu(const void* x, const void* wt, const void* a, const void* b,
                               void* y, int64_t B, int64_t H, int64_t W, int64_t C, int K,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0) return launch_k<float>(x, wt, af, bf, y, B, H, W, C, K, s);
  if (dtype == 1) return launch_k<__nv_bfloat16>(x, wt, af, bf, y, B, H, W, C, K, s);
  return (int)cudaErrorInvalidValue;
}
