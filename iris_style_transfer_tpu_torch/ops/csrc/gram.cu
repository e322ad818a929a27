// Blockwise Gram matrix of NHWC features: G[b] = X_b^T X_b / n, X_b the
// (H*W, C) pixels-by-channels matrix of image b, in float32.
//
// Replaces the TPU kernel ops/pallas_gram.py:gram_matrix_pallas
// (_gram_kernel) of the JAX package: the Gram-loss NST's style taps
// relu{1..4}_1, as the targets and in every closure.  Its VJP is a plain
// batched matmul, outside the kernel, as in the JAX package.
//
// What bounds it: at (4, 512, 512, 64) bf16 the contraction is 8.6 GFLOP
// over a 134 MB read, about 64 flops per byte: above the card's CUDA-core
// ridge, so the FMA rate and the shared-memory traffic feeding it bound it,
// not device memory.  And parallelism: B * (C / 64)^2 output tiles is only
// 4 at relu1_1 for 132 SMs.
//
// Design.  A block computes one 64 x 64 tile (i0.., j0..) of one image over
// one split of the HW axis (split-K; grid.x = tile pairs, grid.y = splits,
// grid.z = images).  It stages 32 pixels x 64 channels of both column slabs
// in shared memory as f32 (bf16 -> f32 is exact, so every product is exact
// in f32 and only the sums round), and each of its 256 threads keeps a 4 x 4
// register tile of f32 FMA sums.  Only tiles with i0 <= j0 are computed;
// off-diagonal tiles are written to both halves of the partial.  Each split
// writes its (C, C) partial to an (S, B, C, C) workspace and a second launch
// sums the S partials in split order and divides by n.  No float atomics: a
// run repeats itself bit for bit.  Offsets are 64-bit: (64, 224, 224, 64)
// holds 205 M elements.
//
// C interface for ctypes: the entry returns cudaGetLastError() after its
// launches on the caller's stream; dtype 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int kThreads = 256;
constexpr int kTile = 64;  // output tile edge
constexpr int kK = 32;     // pixels staged per step
constexpr int kR = 4;      // register tile edge per thread (16 x 16 threads)

template <typename T>
__device__ __forceinline__ void load_slab(float (*dst)[kTile], const T* __restrict__ x,
                                          int64_t row0, int64_t rows_left, int C, int col0) {
  // kK x kTile elements, 8 per thread, neighbouring threads on neighbouring channels
#pragma unroll
  for (int q = 0; q < kK * kTile / kThreads; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int k = e / kTile;
    const int col = e % kTile;
    float v = 0.0f;
    if (k < rows_left && col0 + col < C) v = to_f32(x[(row0 + k) * C + col0 + col]);
    dst[k][col] = v;
  }
}

// grid (tile pairs, S, B); ws is (S, B, C, C)
template <typename T>
__global__ void __launch_bounds__(kThreads) gram_kernel(const T* __restrict__ x,
                                                        float* __restrict__ ws, int64_t HW,
                                                        int C, int n_tiles, int64_t chunk) {
  __shared__ __align__(16) float As[kK][kTile];
  __shared__ __align__(16) float Bs[kK][kTile];
  // tile pair index -> (ti, tj), ti <= tj, row-major over the upper triangle
  int pair = blockIdx.x, ti = 0;
  while (pair >= n_tiles - ti) {
    pair -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + pair;
  const bool diag = ti == tj;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const int64_t p0 = (int64_t)split * chunk;
  const int64_t p1 = p0 + chunk < HW ? p0 + chunk : HW;
  const int64_t base = (int64_t)b * HW;
  float acc[kR][kR];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int s = 0; s < kR; ++s) acc[r][s] = 0.0f;

  for (int64_t p = p0; p < p1; p += kK) {
    load_slab<T>(As, x, base + p, p1 - p, C, i0);
    if (!diag) load_slab<T>(Bs, x, base + p, p1 - p, C, j0);
    __syncthreads();
    float (*bs)[kTile] = diag ? As : Bs;
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * kR]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[k][tx * kR]);
      const float av[kR] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[kR] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int s = 0; s < kR; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
    }
    __syncthreads();
  }

  float* out = ws + ((int64_t)split * B + b) * C * C;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + ty * kR + r;
    if (i >= C) continue;
#pragma unroll
    for (int s = 0; s < kR; ++s) {
      const int j = j0 + tx * kR + s;
      if (j >= C) continue;
      out[(int64_t)i * C + j] = acc[r][s];
      if (!diag) out[(int64_t)j * C + i] = acc[r][s];
    }
  }
}

// one thread per (b, i, j): sums the S partials in split order, then / n
__global__ void gram_reduce_kernel(const float* __restrict__ ws, float* __restrict__ g, int S,
                                   int64_t BCC, float n) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= BCC) return;
  float t = 0.0f;
  for (int s = 0; s < S; ++s) t = __fadd_rn(t, ws[s * BCC + e]);
  g[e] = __fdiv_rn(t, n);
}

template <typename T>
int launch(const void* x, void* ws, void* g, int64_t B, int64_t HW, int64_t C, int64_t S, float n,
           cudaStream_t stream) {
  if (B > 0 && C > 0) {
    if (HW > 0) {
      const int n_tiles = (int)((C + kTile - 1) / kTile);
      const int pairs = n_tiles * (n_tiles + 1) / 2;
      const int64_t chunk = ((HW + S - 1) / S + kK - 1) / kK * kK;
      dim3 grid((unsigned)pairs, (unsigned)S, (unsigned)B);
      gram_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                    static_cast<float*>(ws), HW, (int)C, n_tiles,
                                                    chunk);
    }
    const int64_t BCC = B * C * C;
    gram_reduce_kernel<<<(unsigned)((BCC + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<float*>(g), HW > 0 ? (int)S : 0, BCC, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gram(const void* x, void* ws, void* g, int64_t B, int64_t HW, int64_t C, int64_t S,
                    float n, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, ws, g, B, HW, C, S, n, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, ws, g, B, HW, C, S, n, st);
  return (int)cudaErrorInvalidValue;
}
