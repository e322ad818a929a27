// The compact L-BFGS step's passes over the (m, N) history: the NST's
// optimizer (transfer/lbfgs.py:lbfgs_step), one step a closure.
//
// Replaces no Pallas kernel.  In the JAX package the compact direction is
// plain jnp (transfer/lbfgs.py:_compact_direction), six products that XLA
// fuses with the buffers' casts.  Eager PyTorch ran it as a float32 copy of
// both bf16 buffers, six float32 products (two of them the (m, m) SY and YY
// in full, on a 32x32 FFMA GEMM tiling of K = N) and about ten float32
// passes over N.  These kernels do the same mathematics in three passes:
//
//   pair     : y = g - prev_g, s = prev_step;  y.s, y.y, |g|_1
//   dots     : slot w <- (T(s), T(y)) when the pair is accepted (T the
//              history's type); then, with gb = T(g) and the slot's rows
//              after the write, the 5m dots S_j.gb, Y_j.gb, s_w.Y_j,
//              S_j.y_w, y_w.Y_j
//   direction: update = lr * -(gamma*g + sum_j top_j S_j + gamma * sum_j bot_j Y_j)
//
// The (m,) and (m, m) algebra between the dots and the direction stays in
// torch (transfer/lbfgs.py:_coefficients), and the carried SY and YY take
// the new slot's row and column from the dots.
//
// What bounds it: data movement.  At N = 64*3*224*224 with m = 10 bf16
// rows a step must read the three float32 vectors twice (pair, dots) and
// g once more (direction), read S and Y twice (dots, direction), write the
// new pair once and the update once: 116 bytes an element, 1.12 GB, 0.33
// ms at 3.35 TB/s.  Each pass reads what it needs once, 16 bytes a load
// (8 bf16 or 4 float32 elements) where N and the pointers allow, else one
// element.
//
// Design.  The pair and dots passes run a fixed grid (the plan in
// ops/lbfgs.py) over N in a grid-stride loop; each thread sums its
// elements in order in float32 registers (fmaf), the block adds its
// threads by a fixed butterfly of shuffles in each warp and then its warps
// in order, and writes one row of partials.  A second launch adds each
// column of partials over the blocks in a fixed order (a warp a column:
// lane-strided sums, then the butterfly).  No float atomics, so a run
// repeats itself bit for bit.  The dots pass keeps kRows = 10 rows of S
// and of Y a block (the IST mains' m, so that its 5 x 10 sums stay in
// registers); a larger m takes more blocks along y, each of which reads
// the three float32 vectors again, and a smaller one leaves rows idle.  The slot write needs no ordering with the
// other blocks: each element of the slot is written by the one thread of
// the one row chunk that holds it, and every block forms T(s) and T(y)
// itself.  `accept` and `w` are read from device memory, so the host
// never waits for them.  The direction pass reads top, bot and gamma from
// device memory into shared memory and loops over the m rows.
//
// C interface for ctypes: each entry returns cudaGetLastError() after its
// launches on the caller's stream; dtype 0 = float32, 1 = bfloat16 (the
// history's; g, prev_g, prev_step and the update are float32); vec 1 or 16
// bytes' worth of history elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPair = 3;  // y.s, y.y, |g|_1
constexpr int kRows = 10;  // rows of S and of Y a dots block holds

// VEC float32 elements in loads of 16 bytes (VEC 4 or 8) or one (VEC 1)
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = p[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (VEC == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

// VEC history elements of type T as float32, in one access
template <typename T, int VEC> struct Hist;

template <int VEC> struct Hist<float, VEC> {
  static __device__ __forceinline__ void load(const float* p, float* v) { load_f32<VEC>(p, v); }
  static __device__ __forceinline__ void store(float* p, const float* v) { store_f32<VEC>(p, v); }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <> struct Hist<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) { v[0] = __bfloat162float(p[0]); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) { p[0] = __float2bfloat16(v[0]); }
  static __device__ __forceinline__ float round(float v) { return __bfloat162float(__float2bfloat16(v)); }
};

template <> struct Hist<__nv_bfloat16, 8> {
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
  // v holds values already rounded to bf16, so the conversion is exact
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
  static __device__ __forceinline__ float round(float v) { return __bfloat162float(__float2bfloat16(v)); }
};

// Each of the block's K per-thread sums added over the block in a fixed
// order (a butterfly of shuffles in each warp, then the warps in order);
// thread k < K gets sum k back, the others garbage.  Every thread calls it.
template <int K>
__device__ __forceinline__ float block_sums(float (&v)[K], float (*sh)[K]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] = __fadd_rn(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) sh[warp][k] = v[k];
  }
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x < K) {
    t = sh[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, sh[w][threadIdx.x]);
  }
  return t;
}

// grid `blocks`; ws is (blocks, 3)
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    lbfgs_pair_kernel(const float* __restrict__ g, const float* __restrict__ pg, const float* __restrict__ ps,
                      float* __restrict__ ws, int64_t N) {
  __shared__ float sh[kWarps][kPair];
  float acc[kPair] = {0.0f, 0.0f, 0.0f};
  const int64_t nv = N / VEC, stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < nv; i += stride) {
    float gv[VEC], pv[VEC], sv[VEC];
    load_f32<VEC>(g + i * VEC, gv);
    load_f32<VEC>(pg + i * VEC, pv);
    load_f32<VEC>(ps + i * VEC, sv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float y = __fsub_rn(gv[k], pv[k]);
      acc[0] = __fmaf_rn(y, sv[k], acc[0]);
      acc[1] = __fmaf_rn(y, y, acc[1]);
      acc[2] = __fadd_rn(acc[2], fabsf(gv[k]));
    }
  }
  const float t = block_sums<kPair>(acc, sh);
  if (threadIdx.x < kPair) ws[(int64_t)blockIdx.x * kPair + threadIdx.x] = t;
}

// grid (blocks, ceil(m / R)); block (b, c) holds rows [c * R, +rows) of S
// and Y, rows = min(R, m - c * R); ws is (blocks, 5, m): S_j.gb, Y_j.gb,
// s_w.Y_j, S_j.y_w, y_w.Y_j
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    lbfgs_dots_kernel(T* __restrict__ S, T* __restrict__ Y, const float* __restrict__ g,
                      const float* __restrict__ pg, const float* __restrict__ ps,
                      const bool* __restrict__ accept_p, const int64_t* __restrict__ w_p, float* __restrict__ ws,
                      int64_t N, int m) {
  constexpr int R = kRows;
  __shared__ float sh[kWarps][5 * R];
  const int r0 = (int)blockIdx.y * R;
  const int rows = m - r0 < R ? m - r0 : R;
  const int w = (int)*w_p;
  const bool write = *accept_p && w >= r0 && w < r0 + rows;  // this block's rows hold the new pair's slot
  float acc[5 * R];
#pragma unroll
  for (int k = 0; k < 5 * R; ++k) acc[k] = 0.0f;
  const int64_t nv = N / VEC, stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < nv; i += stride) {
    const int64_t e = i * VEC;
    float gb[VEC], sw[VEC], yw[VEC];
    {
      float gv[VEC], pv[VEC];
      load_f32<VEC>(g + e, gv);
      load_f32<VEC>(pg + e, pv);
      load_f32<VEC>(ps + e, sw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        gb[k] = Hist<T, VEC>::round(gv[k]);
        sw[k] = Hist<T, VEC>::round(sw[k]);
        yw[k] = Hist<T, VEC>::round(__fsub_rn(gv[k], pv[k]));
      }
    }
#pragma unroll
    for (int jj = 0; jj < R; ++jj) {
      if (jj < rows) {
        const int64_t off = (int64_t)(r0 + jj) * N + e;
        float sj[VEC], yj[VEC];
        if (write && r0 + jj == w) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            sj[k] = sw[k];
            yj[k] = yw[k];
          }
          Hist<T, VEC>::store(S + off, sw);
          Hist<T, VEC>::store(Y + off, yw);
        } else {
          Hist<T, VEC>::load(S + off, sj);
          Hist<T, VEC>::load(Y + off, yj);
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          acc[0 * R + jj] = __fmaf_rn(sj[k], gb[k], acc[0 * R + jj]);
          acc[1 * R + jj] = __fmaf_rn(yj[k], gb[k], acc[1 * R + jj]);
          acc[2 * R + jj] = __fmaf_rn(sw[k], yj[k], acc[2 * R + jj]);
          acc[3 * R + jj] = __fmaf_rn(sj[k], yw[k], acc[3 * R + jj]);
          acc[4 * R + jj] = __fmaf_rn(yw[k], yj[k], acc[4 * R + jj]);
        }
      }
    }
  }
  const float t = block_sums<5 * R>(acc, sh);
  const int q = threadIdx.x / R, jj = threadIdx.x % R;
  if (threadIdx.x < 5 * R && jj < rows) ws[((int64_t)blockIdx.x * 5 + q) * m + r0 + jj] = t;
}

// one warp a column c < width of the (blocks, width) partials: lane l adds
// rows l, l + 32, ... in order, then the butterfly
__global__ void __launch_bounds__(kThreads)
    lbfgs_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int blocks, int width) {
  const int c = (int)blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (c >= width) return;  // the whole warp
  float t = 0.0f;
  for (int b = lane; b < blocks; b += 32) t = __fadd_rn(t, ws[(int64_t)b * width + c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, o));
  if (lane == 0) out[c] = t;
}

// grid-stride over N / VEC; coefficients in shared memory
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    lbfgs_direction_kernel(const T* __restrict__ S, const T* __restrict__ Y, const float* __restrict__ g,
                           const float* __restrict__ top, const float* __restrict__ bot,
                           const float* __restrict__ gamma_p, float* __restrict__ out, float lr, int64_t N, int m) {
  extern __shared__ float coef[];  // top[m], then bot[m]
  for (int j = threadIdx.x; j < m; j += kThreads) {
    coef[j] = top[j];
    coef[m + j] = bot[j];
  }
  __syncthreads();
  const float gamma = *gamma_p;
  const int64_t nv = N / VEC, stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < nv; i += stride) {
    const int64_t e = i * VEC;
    float st[VEC], yb[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) st[k] = yb[k] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < m; ++j) {
      float sj[VEC], yj[VEC];
      Hist<T, VEC>::load(S + (int64_t)j * N + e, sj);
      Hist<T, VEC>::load(Y + (int64_t)j * N + e, yj);
      const float a = coef[j], b = coef[m + j];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        st[k] = __fmaf_rn(a, sj[k], st[k]);
        yb[k] = __fmaf_rn(b, yj[k], yb[k]);
      }
    }
    float gv[VEC], u[VEC];
    load_f32<VEC>(g + e, gv);
    // lr * -((gamma*g + St) + gamma*Yb), rounded in that order
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      u[k] = __fmul_rn(lr, -__fadd_rn(__fadd_rn(__fmul_rn(gamma, gv[k]), st[k]), __fmul_rn(gamma, yb[k])));
    store_f32<VEC>(out + e, u);
  }
}

int reduce(const float* ws, void* out, int64_t blocks, int64_t width, cudaStream_t stream) {
  lbfgs_reduce_kernel<<<(unsigned)((width + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      ws, static_cast<float*>(out), (int)blocks, (int)width);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_dots(void* S, void* Y, const float* g, const float* pg, const float* ps, const bool* accept,
                const int64_t* w, float* ws, int64_t N, int64_t m, int64_t blocks, int64_t chunks,
                cudaStream_t stream) {
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  lbfgs_dots_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(static_cast<T*>(S), static_cast<T*>(Y), g, pg, ps,
                                                           accept, w, ws, N, (int)m);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_direction(const void* S, const void* Y, const float* g, const float* top, const float* bot,
                     const float* gamma, float* out, float lr, int64_t N, int64_t m, int64_t blocks,
                     cudaStream_t stream) {
  lbfgs_direction_kernel<T, VEC><<<(unsigned)blocks, kThreads, (size_t)(2 * m) * sizeof(float), stream>>>(
      static_cast<const T*>(S), static_cast<const T*>(Y), g, top, bot, gamma, out, lr, N, (int)m);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper (ops/lbfgs.py) hands the plan: the grid's `blocks` (and, for
// the dots, `chunks` = ceil(m / kRows) along y), vec 1 or 16 bytes' worth, with N a multiple of
// vec and every pointer on 16 bytes where vec > 1; it keeps N and m above 0,
// m * N within the history and the grid below 2^31 blocks.  ws holds
// (blocks, 3) or (blocks, 5, m) float32 partials; out 3 or 5m sums.
extern "C" int lbfgs_pair(const void* g, const void* pg, const void* ps, void* ws, void* out, int64_t N,
                          int64_t blocks, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *a = static_cast<const float*>(g), *b = static_cast<const float*>(pg),
              *c = static_cast<const float*>(ps);
  float* w = static_cast<float*>(ws);
  if (vec == 4)
    lbfgs_pair_kernel<4><<<(unsigned)blocks, kThreads, 0, st>>>(a, b, c, w, N);
  else if (vec == 1)
    lbfgs_pair_kernel<1><<<(unsigned)blocks, kThreads, 0, st>>>(a, b, c, w, N);
  else
    return (int)cudaErrorInvalidValue;
  const int err = (int)cudaGetLastError();
  return err ? err : reduce(w, out, blocks, kPair, st);
}

extern "C" int lbfgs_dots(void* S, void* Y, const void* g, const void* pg, const void* ps, const void* accept,
                          const void* w, void* ws, void* out, int64_t N, int64_t m, int64_t blocks,
                          int64_t chunks, int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *a = static_cast<const float*>(g), *b = static_cast<const float*>(pg),
              *c = static_cast<const float*>(ps);
  const bool* acc = static_cast<const bool*>(accept);
  const int64_t* slot = static_cast<const int64_t*>(w);
  float* part = static_cast<float*>(ws);
  int err;
  if (dtype == 0 && vec == 4) err = launch_dots<float, 4>(S, Y, a, b, c, acc, slot, part, N, m, blocks, chunks, st);
  else if (dtype == 0 && vec == 1)
    err = launch_dots<float, 1>(S, Y, a, b, c, acc, slot, part, N, m, blocks, chunks, st);
  else if (dtype == 1 && vec == 8)
    err = launch_dots<__nv_bfloat16, 8>(S, Y, a, b, c, acc, slot, part, N, m, blocks, chunks, st);
  else if (dtype == 1 && vec == 1)
    err = launch_dots<__nv_bfloat16, 1>(S, Y, a, b, c, acc, slot, part, N, m, blocks, chunks, st);
  else
    return (int)cudaErrorInvalidValue;
  return err ? err : reduce(part, out, blocks, 5 * m, st);
}

extern "C" int lbfgs_direction(const void* S, const void* Y, const void* g, const void* top, const void* bot,
                               const void* gamma, void* out, float lr, int64_t N, int64_t m, int64_t blocks, int vec,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *a = static_cast<const float*>(g), *t = static_cast<const float*>(top),
              *b = static_cast<const float*>(bot), *gm = static_cast<const float*>(gamma);
  float* u = static_cast<float*>(out);
  if (dtype == 0 && vec == 4) return launch_direction<float, 4>(S, Y, a, t, b, gm, u, lr, N, m, blocks, st);
  if (dtype == 0 && vec == 1) return launch_direction<float, 1>(S, Y, a, t, b, gm, u, lr, N, m, blocks, st);
  if (dtype == 1 && vec == 8) return launch_direction<__nv_bfloat16, 8>(S, Y, a, t, b, gm, u, lr, N, m, blocks, st);
  if (dtype == 1 && vec == 1) return launch_direction<__nv_bfloat16, 1>(S, Y, a, t, b, gm, u, lr, N, m, blocks, st);
  return (int)cudaErrorInvalidValue;
}
