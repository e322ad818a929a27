// Per-channel spatial (sum, sum of squares) of a style tap, forward and
// backward: the BN style loss's statistics on its classic path
// (ops/losses.py:style_stats, where the relu has already been applied).
//
// Replaces no Pallas kernel.  In the JAX package this chain is plain jnp in
// ops/losses.py:style_stats, which XLA fuses into one reduction forward and
// one elementwise pass backward.  Eager PyTorch runs it as separate float32
// passes instead (a cast, two sums, two broadcast multiplies, adds and a
// cast back), so these kernels do what XLA's fusion does:
//
//   forward : s1[b,c] = sum_hw f;  s2[b,c] = sum_hw f*f      (float32)
//   backward: g = cast(g1[b,c] + 2 * (g2[b,c] * f))          g1 = dL/ds1, g2 = dL/ds2
//
// What bounds it: data movement.  At (64, 64, 224, 224) bf16 the forward
// reads the tap once (411 MB) and the backward reads it and writes the
// gradient once (822 MB), at about one flop a byte.
//
// Design.  Every thread moves 16 bytes a load (8 bf16 or 4 float32
// elements) where the innermost extent and the pointer allow it, else one
// element, and keeps kUnroll loads in flight before it adds.
//   * channels_last (NHWC) memory, the reduced HW axis outside the kept C
//     axis: a block of 256 threads holds CG channel groups of VEC channels
//     times P = 256 / CG pixel lanes, so neighbouring threads read
//     neighbouring bytes; the grid numbers (HW split, channel tile, image),
//     the split fastest.  Each thread sums its pixels in order into VEC
//     pairs of float32 registers; the block adds its P lanes through shared
//     memory in lane order and writes one (S, B, C) partial.
//   * NCHW-contiguous memory, HW innermost: one warp a (plane, HW split),
//     eight planes a block; a lane sums its vectors in order, the warp adds
//     its lanes by a fixed butterfly of shuffles.
//   A second launch adds the S partials of each (b, c) in split order.  No
//   float atomics, so a run repeats itself bit for bit.  The HW splits are
//   planned in ops/style_sums.py:plan so that small batches still fill the
//   card's 132 SMs.
//   The backward takes the same grid.  A thread's channels (NHWC) or a
//   warp's plane (NCHW) are fixed, so its g1 and g2 sit in registers for the
//   whole loop.  It rounds with __fmul_rn / __fadd_rn in the plain
//   expression's order, with no FMA contraction, and casts once, so g is
//   bit-exact with the plain version.
//
// The 2019 taps relu1_1..relu4_1 reach it in channels_last memory: the
// convs' weights are channels_last, so cuDNN writes NHWC even after the
// plain pools' NCHW output, and the relu keeps the layout.
//
// C interface for ctypes: each entry returns cudaGetLastError() after its
// launches on the caller's stream; dtype 0 = float32, 1 = bfloat16; layout
// 0 = NHWC, 1 = NCHW; vec 1 or 16 bytes' worth of elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

// VEC consecutive elements of T as float32, loaded and stored in one access
template <typename T, int VEC> struct Vec;

template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = p[0]; }
  static __device__ __forceinline__ void store(float* p, const float* v) { p[0] = v[0]; }
};

template <> struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) { v[0] = __bfloat162float(p[0]); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) { p[0] = __float2bfloat16(v[0]); }
};

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

template <int VEC>
__device__ __forceinline__ void accumulate(float* a1, float* a2, const float* v) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    a1[k] = __fadd_rn(a1[k], v[k]);
    a2[k] = __fadd_rn(a2[k], __fmul_rn(v[k], v[k]));
  }
}

// all VEC elements into one (sum, sum of squares), in order
template <int VEC>
__device__ __forceinline__ void accumulate_row(float& a1, float& a2, const float* v) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    a1 = __fadd_rn(a1, v[k]);
    a2 = __fadd_rn(a2, __fmul_rn(v[k], v[k]));
  }
}

// g1 + 2 * (g2 * f), rounded in that order
template <int VEC>
__device__ __forceinline__ void gradient(float* out, const float* w1, const float* w2, const float* v) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = __fadd_rn(w1[k], __fmul_rn(2.0f, __fmul_rn(w2[k], v[k])));
}

// The NHWC block's place: split, image, first channel of the tile, and the
// thread's channel group g and pixel lane p.
struct NhwcPlace {
  int split, g, p, P, CT, c0;
  int64_t b;
  __device__ __forceinline__ NhwcPlace(int C, int CG, int S, int vec) {
    split = (int)(blockIdx.x % S);
    const unsigned rest = blockIdx.x / S;
    CT = CG * vec;
    const int ctiles = (C + CT - 1) / CT;
    b = rest / ctiles;
    c0 = (int)(rest % ctiles) * CT;
    P = kThreads / CG;
    g = threadIdx.x % CG;
    p = threadIdx.x / CG;
  }
};

// grid S * ceil(C / (CG * VEC)) * B; ws1/ws2 are (S, B, C)
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    style_sums_nhwc_kernel(const T* __restrict__ f, float* __restrict__ ws1, float* __restrict__ ws2, int64_t B,
                           int64_t HW, int C, int CG, int S, int64_t chunk) {
  __shared__ float sh1[kThreads * VEC];
  __shared__ float sh2[kThreads * VEC];
  const NhwcPlace at(C, CG, S, VEC);
  const int c = at.c0 + at.g * VEC;
  float a1[VEC], a2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) a1[k] = a2[k] = 0.0f;
  if (at.p < at.P && c < C) {
    const int64_t pix0 = (int64_t)at.split * chunk;
    const int64_t pix1 = pix0 + chunk < HW ? pix0 + chunk : HW;
    const int64_t step = (int64_t)at.P * C;
    const T* q = f + (at.b * HW + pix0 + at.p) * C + c;
    int64_t pix = pix0 + at.p;
    for (; pix + (kUnroll - 1) * at.P < pix1; pix += kUnroll * at.P, q += kUnroll * step) {
      float v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) Vec<T, VEC>::load(q + u * step, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate<VEC>(a1, a2, v[u]);
    }
    for (; pix < pix1; pix += at.P, q += step) {
      float v[VEC];
      Vec<T, VEC>::load(q, v);
      accumulate<VEC>(a1, a2, v);
    }
  }
  if (at.p < at.P) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sh1[at.p * at.CT + at.g * VEC + k] = a1[k];
      sh2[at.p * at.CT + at.g * VEC + k] = a2[k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < at.CT && at.c0 + j < C; j += kThreads) {
    float t1 = sh1[j], t2 = sh2[j];
    for (int l = 1; l < at.P; ++l) {
      t1 = __fadd_rn(t1, sh1[l * at.CT + j]);
      t2 = __fadd_rn(t2, sh2[l * at.CT + j]);
    }
    const int64_t o = ((int64_t)at.split * B + at.b) * C + at.c0 + j;
    ws1[o] = t1;
    ws2[o] = t2;
  }
}

// grid S * ceil(BC / kWarps); warp w of block k holds plane (k / S) * kWarps
// + w, elements [split * chunk, +chunk) of it; chunk is a multiple of VEC
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    style_sums_nchw_kernel(const T* __restrict__ f, float* __restrict__ ws1, float* __restrict__ ws2, int64_t BC,
                           int64_t HW, int S, int64_t chunk) {
  const int split = (int)(blockIdx.x % S);
  const int64_t plane = (int64_t)(blockIdx.x / S) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (plane >= BC) return;  // the whole warp
  const int64_t e0 = (int64_t)split * chunk;
  const int64_t e1 = e0 + chunk < HW ? e0 + chunk : HW;
  const T* row = f + plane * HW;
  float a1 = 0.0f, a2 = 0.0f;
  int64_t e = e0 + lane * VEC;
  for (; e + (kUnroll - 1) * 32 * VEC < e1; e += kUnroll * 32 * VEC) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) Vec<T, VEC>::load(row + e + u * 32 * VEC, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate_row<VEC>(a1, a2, v[u]);
  }
  for (; e < e1; e += 32 * VEC) {
    float v[VEC];
    Vec<T, VEC>::load(row + e, v);
    accumulate_row<VEC>(a1, a2, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a1 = __fadd_rn(a1, __shfl_xor_sync(0xffffffffu, a1, o));
    a2 = __fadd_rn(a2, __shfl_xor_sync(0xffffffffu, a2, o));
  }
  if (lane == 0) {
    ws1[(int64_t)split * BC + plane] = a1;
    ws2[(int64_t)split * BC + plane] = a2;
  }
}

// one thread per (b, c): the S partials in split order
__global__ void style_sums_reduce_kernel(const float* __restrict__ ws1, const float* __restrict__ ws2,
                                         float* __restrict__ s1, float* __restrict__ s2, int S, int64_t BC) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= BC) return;
  float t1 = ws1[i], t2 = ws2[i];
  for (int s = 1; s < S; ++s) {
    t1 = __fadd_rn(t1, ws1[s * BC + i]);
    t2 = __fadd_rn(t2, ws2[s * BC + i]);
  }
  s1[i] = t1;
  s2[i] = t2;
}

// the forward's NHWC grid; each thread's VEC channels of g1 and g2 in registers
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    style_sums_grad_nhwc_kernel(const T* __restrict__ f, const float* __restrict__ g1, const float* __restrict__ g2,
                                T* __restrict__ g, int64_t HW, int C, int CG, int S, int64_t chunk) {
  const NhwcPlace at(C, CG, S, VEC);
  const int c = at.c0 + at.g * VEC;
  if (at.p >= at.P || c >= C) return;
  float w1[VEC], w2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    w1[k] = g1[at.b * C + c + k];
    w2[k] = g2[at.b * C + c + k];
  }
  const int64_t pix0 = (int64_t)at.split * chunk;
  const int64_t pix1 = pix0 + chunk < HW ? pix0 + chunk : HW;
  const int64_t step = (int64_t)at.P * C;
  const int64_t off0 = (at.b * HW + pix0 + at.p) * C + c;
  const T* q = f + off0;
  T* out = g + off0;
  int64_t pix = pix0 + at.p;
  for (; pix + (kUnroll - 1) * at.P < pix1; pix += kUnroll * at.P, q += kUnroll * step, out += kUnroll * step) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) Vec<T, VEC>::load(q + u * step, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float r[VEC];
      gradient<VEC>(r, w1, w2, v[u]);
      Vec<T, VEC>::store(out + u * step, r);
    }
  }
  for (; pix < pix1; pix += at.P, q += step, out += step) {
    float v[VEC], r[VEC];
    Vec<T, VEC>::load(q, v);
    gradient<VEC>(r, w1, w2, v);
    Vec<T, VEC>::store(out, r);
  }
}

// the forward's NCHW grid; the warp's plane's g1 and g2 in registers
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    style_sums_grad_nchw_kernel(const T* __restrict__ f, const float* __restrict__ g1, const float* __restrict__ g2,
                                T* __restrict__ g, int64_t BC, int64_t HW, int S, int64_t chunk) {
  const int split = (int)(blockIdx.x % S);
  const int64_t plane = (int64_t)(blockIdx.x / S) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (plane >= BC) return;
  float w1[VEC], w2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    w1[k] = g1[plane];
    w2[k] = g2[plane];
  }
  const int64_t e0 = (int64_t)split * chunk;
  const int64_t e1 = e0 + chunk < HW ? e0 + chunk : HW;
  const T* row = f + plane * HW;
  T* out = g + plane * HW;
  int64_t e = e0 + lane * VEC;
  for (; e + (kUnroll - 1) * 32 * VEC < e1; e += kUnroll * 32 * VEC) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) Vec<T, VEC>::load(row + e + u * 32 * VEC, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float r[VEC];
      gradient<VEC>(r, w1, w2, v[u]);
      Vec<T, VEC>::store(out + e + u * 32 * VEC, r);
    }
  }
  for (; e < e1; e += 32 * VEC) {
    float v[VEC], r[VEC];
    Vec<T, VEC>::load(row + e, v);
    gradient<VEC>(r, w1, w2, v);
    Vec<T, VEC>::store(out + e, r);
  }
}

template <typename T, int VEC>
int launch_fwd(const void* f, void* ws1, void* ws2, void* s1, void* s2, int64_t B, int64_t HW, int64_t C,
               int64_t S, int64_t CG, int64_t chunk, int64_t blocks, int layout, cudaStream_t stream) {
  const T* x = static_cast<const T*>(f);
  float* w1 = static_cast<float*>(ws1);
  float* w2 = static_cast<float*>(ws2);
  if (layout == 0)
    style_sums_nhwc_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(x, w1, w2, B, HW, (int)C, (int)CG,
                                                                             (int)S, chunk);
  else
    style_sums_nchw_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(x, w1, w2, B * C, HW, (int)S, chunk);
  const int64_t BC = B * C;
  style_sums_reduce_kernel<<<(unsigned)((BC + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      w1, w2, static_cast<float*>(s1), static_cast<float*>(s2), (int)S, BC);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd(const void* f, const void* g1, const void* g2, void* g, int64_t B, int64_t HW, int64_t C, int64_t S,
               int64_t CG, int64_t chunk, int64_t blocks, int layout, cudaStream_t stream) {
  const T* x = static_cast<const T*>(f);
  const float* a = static_cast<const float*>(g1);
  const float* b2 = static_cast<const float*>(g2);
  T* out = static_cast<T*>(g);
  if (layout == 0)
    style_sums_grad_nhwc_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(x, a, b2, out, HW, (int)C,
                                                                                  (int)CG, (int)S, chunk);
  else
    style_sums_grad_nchw_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(x, a, b2, out, B * C, HW,
                                                                                  (int)S, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper (ops/style_sums.py) hands the plan: S splits of `chunk`
// pixels (NHWC) or elements (NCHW), CG channel groups a block (NHWC), the
// grid's `blocks`, and vec, 1 or 16 bytes' worth; it keeps B, C and HW
// above 0 and the grid below 2^31 blocks.
extern "C" int style_sums_fwd(const void* f, void* ws1, void* ws2, void* s1, void* s2, int64_t B, int64_t HW,
                              int64_t C, int64_t S, int64_t CG, int64_t chunk, int64_t blocks, int layout, int vec,
                              int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch_fwd<float, 4>(f, ws1, ws2, s1, s2, B, HW, C, S, CG, chunk, blocks, layout, st);
  if (dtype == 0 && vec == 1) return launch_fwd<float, 1>(f, ws1, ws2, s1, s2, B, HW, C, S, CG, chunk, blocks, layout, st);
  if (dtype == 1 && vec == 8)
    return launch_fwd<__nv_bfloat16, 8>(f, ws1, ws2, s1, s2, B, HW, C, S, CG, chunk, blocks, layout, st);
  if (dtype == 1 && vec == 1)
    return launch_fwd<__nv_bfloat16, 1>(f, ws1, ws2, s1, s2, B, HW, C, S, CG, chunk, blocks, layout, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int style_sums_bwd(const void* f, const void* g1, const void* g2, void* g, int64_t B, int64_t HW,
                              int64_t C, int64_t S, int64_t CG, int64_t chunk, int64_t blocks, int layout, int vec,
                              int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch_bwd<float, 4>(f, g1, g2, g, B, HW, C, S, CG, chunk, blocks, layout, st);
  if (dtype == 0 && vec == 1) return launch_bwd<float, 1>(f, g1, g2, g, B, HW, C, S, CG, chunk, blocks, layout, st);
  if (dtype == 1 && vec == 8)
    return launch_bwd<__nv_bfloat16, 8>(f, g1, g2, g, B, HW, C, S, CG, chunk, blocks, layout, st);
  if (dtype == 1 && vec == 1)
    return launch_bwd<__nv_bfloat16, 1>(f, g1, g2, g, B, HW, C, S, CG, chunk, blocks, layout, st);
  return (int)cudaErrorInvalidValue;
}
