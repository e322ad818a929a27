// Fused relu + per-channel (sum, sum of squares) for the NST style taps,
// forward and backward, on NHWC memory.
//
// Replaces the TPU kernel pair ops/pallas_relu_stats.py:relu_stats_fwd /
// relu_stats_bwd of the JAX package (models/layers.py:relu_stats, the style
// taps relu{1..4}_1 under --stats_taps on).
//
//   forward : y = x where x > 0, else 0;  s1[b,c] = sum_hw y;  s2[b,c] = sum_hw y*y
//   backward: g = (x > 0) ? (ct_y + a[b,c]) + (2x) * b2[b,c] : 0,
//             a = dL/ds1, b2 = dL/ds2
//
// What bounds it: data movement.  At (64, 224, 224, 64) bf16 the forward
// reads x once and writes y once (0.82 GB); the backward reads x and ct_y
// and writes g (1.23 GB); a few flops per byte.  The plain torch form makes
// f32 copies of the tap and separate passes for the relu, the two sums and
// the gradient terms.
//
// Forward design.  The sums reduce over HW per (b, c) while c is the
// fastest axis in memory.  A block of 256 threads holds CT channels
// (CT = C up to 256) times P = 256 / CT pixel lanes, so neighbouring
// threads read neighbouring channels (coalesced) and a block is never thin
// at C = 64.  The HW axis of each image is cut into S splits so that small
// batches still fill the card; the 1-D grid numbers the blocks (split,
// channel tile, image) with the split fastest.  Each thread sums its pixels in
// order, the block reduces its P lanes through shared memory in order, and
// writes one (S, B, C) partial; a second launch sums the S partials in
// order.  No float atomics: a run repeats itself bit for bit.  y is stored
// from x's own bits (relu of a bf16 is a bf16), so y is bit-exact.
//
// Backward design: one thread per element of an image, grid (blocks of one
// image, min(B, 65535), ceil(B / 65535)), image z * 65535 + y (no batch
// limit, no loop and no division per element); per-(b, c) a and b2 read
// through the cache.  The kernel is instruction-bound enough that 64-bit index
// math, a loop over images or reading blockIdx.z costs 5-20% at
// (64, 224, 224, 64), so a specialization decided at launch by the shape
// keeps 32-bit indices and the image in blockIdx.y wherever B <= 65535 and
// B * C and an image's elements fit in 31 bits (every path's shape).  The arithmetic is
// __fadd_rn / __fmul_rn in the order the plain expression rounds, with no
// FMA contraction, and one cast at the end, so g is bit-exact with
// the plain version.
//
// C interface for ctypes: each entry returns cudaGetLastError() after its
// launches on the caller's stream; dtype 0 = float32, 1 = bfloat16.

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

// grid S x ceil(C / CT) x B, the split fastest; ws1/ws2 are (S, B, C)
template <typename T>
__global__ void relu_stats_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                                      float* __restrict__ ws1, float* __restrict__ ws2, int64_t B,
                                      int64_t HW, int C, int CT, int S, int64_t chunk) {
  __shared__ float sh1[kThreads];
  __shared__ float sh2[kThreads];
  const int split = (int)(blockIdx.x % S);
  const unsigned rest = blockIdx.x / S;
  const int ctiles = (C + CT - 1) / CT;
  const int64_t b = rest / ctiles;
  const int P = kThreads / CT;
  const int tid = threadIdx.x;
  const int lane = tid % CT;
  const int p = tid / CT;
  const int c = (int)(rest % ctiles) * CT + lane;
  const bool active = p < P && c < C;
  const int64_t pix0 = (int64_t)split * chunk;
  const int64_t pix1 = pix0 + chunk < HW ? pix0 + chunk : HW;
  float s1 = 0.0f, s2 = 0.0f;
  if (active) {
    const int64_t img = b * HW * C + c;
    for (int64_t pix = pix0 + p; pix < pix1; pix += P) {
      const int64_t off = img + pix * C;
      const float v = to_f32(x[off]);
      const float r = v > 0.0f ? v : 0.0f;
      y[off] = from_f32<T>(r);
      s1 = __fadd_rn(s1, r);
      s2 = __fadd_rn(s2, __fmul_rn(r, r));
    }
  }
  sh1[tid] = s1;
  sh2[tid] = s2;
  __syncthreads();
  if (p == 0 && c < C) {
    float t1 = sh1[lane], t2 = sh2[lane];
    for (int q = 1; q < P; ++q) {
      t1 = __fadd_rn(t1, sh1[q * CT + lane]);
      t2 = __fadd_rn(t2, sh2[q * CT + lane]);
    }
    const int64_t o = (split * B + b) * C + c;
    ws1[o] = t1;
    ws2[o] = t2;
  }
}

// one thread per (b, c): sums the S partials in split order
__global__ void relu_stats_reduce_kernel(const float* __restrict__ ws1,
                                         const float* __restrict__ ws2, float* __restrict__ s1,
                                         float* __restrict__ s2, int S, int64_t BC) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= BC) return;
  float t1 = 0.0f, t2 = 0.0f;
  for (int s = 0; s < S; ++s) {
    t1 = __fadd_rn(t1, ws1[s * BC + i]);
    t2 = __fadd_rn(t2, ws2[s * BC + i]);
  }
  s1[i] = t1;
  s2[i] = t2;
}

// grid (ceil(HW * C / 256), min(B, 65535), ceil(B / 65535)); block (x, y, z)
// covers elements [x * 256, +256) of image z * gridDim.y + y; kSmall: the
// grid has no z and every index fits in 31 bits
template <typename T, bool kSmall>
__global__ void relu_stats_bwd_kernel(const T* __restrict__ x, const T* __restrict__ ct,
                                      const float* __restrict__ a, const float* __restrict__ b2,
                                      T* __restrict__ g, int64_t B, int64_t n_img, int C) {
  int64_t off, bc;  // x's element, and a's (b, c)
  if (kSmall) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= (int)n_img) return;
    const int b = blockIdx.y;
    off = (int64_t)b * (int)n_img + i;
    bc = b * C + i % C;
  } else {
    const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    const int64_t b = (int64_t)blockIdx.z * gridDim.y + blockIdx.y;
    if (i >= n_img || b >= B) return;
    off = b * n_img + i;
    bc = b * C + i % C;
  }
  const float xv = to_f32(x[off]);
  const float av = a[bc];
  const float bv = b2[bc];
  const float gv = __fadd_rn(__fadd_rn(to_f32(ct[off]), av), __fmul_rn(__fmul_rn(2.0f, xv), bv));
  g[off] = xv > 0.0f ? from_f32<T>(gv) : from_f32<T>(0.0f);
}

template <typename T>
int launch_fwd(const void* x, void* y, void* ws1, void* ws2, void* s1, void* s2, int64_t B,
               int64_t HW, int64_t C, int64_t S, cudaStream_t stream) {
  const int CT = C < kThreads ? (int)C : kThreads;
  const int64_t chunk = (HW + S - 1) / S;
  if (B > 0 && C > 0) {
    if (HW > 0) {  // the wrapper keeps the grid below 2^31 blocks (ops/relu_stats.py:plan)
      const int64_t blocks = S * ((C + CT - 1) / CT) * B;
      relu_stats_fwd_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(y), static_cast<float*>(ws1),
          static_cast<float*>(ws2), B, HW, (int)C, CT, (int)S, chunk);
    }
    const int64_t BC = B * C;
    relu_stats_reduce_kernel<<<(unsigned)((BC + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        static_cast<const float*>(ws1), static_cast<const float*>(ws2), static_cast<float*>(s1),
        static_cast<float*>(s2), HW > 0 ? (int)S : 0, BC);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* ct, const void* a, const void* b2, void* g, int64_t B,
               int64_t HW, int64_t C, cudaStream_t stream) {
  const int64_t n_img = HW * C;
  if (B > 0 && n_img > 0) {  // the wrapper keeps grid.x below 2^31 (ops/relu_stats.py:plan)
    const int64_t rows = B < 65535 ? B : 65535;
    const dim3 grid((unsigned)((n_img + kThreads - 1) / kThreads), (unsigned)rows, (unsigned)((B + rows - 1) / rows));
    const T* xt = static_cast<const T*>(x);
    const T* ctt = static_cast<const T*>(ct);
    const float* af = static_cast<const float*>(a);
    const float* bf = static_cast<const float*>(b2);
    if (B <= 65535 && n_img <= INT32_MAX - kThreads && B * C <= INT32_MAX)
      relu_stats_bwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, ctt, af, bf, static_cast<T*>(g), B, n_img,
                                                                   (int)C);
    else
      relu_stats_bwd_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, ctt, af, bf, static_cast<T*>(g), B, n_img,
                                                                    (int)C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int relu_stats_fwd(const void* x, void* y, void* ws1, void* ws2, void* s1, void* s2,
                              int64_t B, int64_t HW, int64_t C, int64_t S, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, y, ws1, ws2, s1, s2, B, HW, C, S, st);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, y, ws1, ws2, s1, s2, B, HW, C, S, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int relu_stats_bwd(const void* x, const void* ct, const void* a, const void* b2,
                              void* g, int64_t B, int64_t HW, int64_t C, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(x, ct, a, b2, g, B, HW, C, st);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(x, ct, a, b2, g, B, HW, C, st);
  return (int)cudaErrorInvalidValue;
}
