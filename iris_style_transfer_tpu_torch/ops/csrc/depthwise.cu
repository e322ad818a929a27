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
// are summed in (dy, dx) order with fmaf, as the TPU kernel orders them.
// SiLU is s / (1 + e^-s) with the MUFU exp2 and reciprocal (__expf,
// __fdividef), ~1e-6 relative off the plain version's expf and exact
// reciprocal; the bf16 results stay within one ulp of the plain version's
// (PERF.md gives the measured equal share).
//
// What bounds it on an H100: memory, then instruction issue.  At K = 3 a
// bf16 element is read once and written once for 9 FMAs (~4.5 flops per
// byte, far below the ridge), so the floor is the 2 * |x| bytes at 3.35
// TB/s; but the taps, the bf16 -> f32 widening and the epilogue cost ~20
// instructions per output, so the issue rate is a second floor close to
// the first.  This design:
//   - a thread owns VEC = 4 consecutive channels (an 8-byte bf16 or 16-byte
//     f32 vector) and a run of kRun = 8 output pixels along W; for each of
//     the K input rows it loads kRun + K - 1 vectors and slides the K taps
//     over them in registers, so an input vector is loaded and widened once
//     per row instead of once per tap;
//   - a block stages its (tile_h + K - 1) x (tile_w + K - 1) halo tile of a
//     cvb * VEC channel slice in shared memory with 16-byte cp.async copies
//     (the zero-fill form outside the image), plus the slice's K*K weights
//     and a, b in f32 -- what the TPU kernel does with its VMEM halo scratch;
//     the staging loops step through the tile without a division;
//   - neighbouring threads own neighbouring channel vectors, so the copies,
//     the shared-memory reads and the stores are contiguous;
//   - registers decide the speed: the dy loop stays rolled (unrolled, the
//     compiler hoists every row's loads and spills), so a bf16 thread fits
//     in 80 registers at K = 3 (three 256-thread blocks per SM); K = 5 and
//     f32 take two blocks per SM (chip_smoke.py's build line prints each
//     instantiation's registers, stack and spills); 8 channels a thread or
//     a 4-pixel run measured slower;
//   - the launch plan (VEC, cvb, runs, rows_t, tile_h) comes from the
//     wrapper (ops/depthwise.py:plan), sized so that every B7 shape puts
//     thousands of blocks of ~256 threads on the 132 SMs;
//   - C not a multiple of 8, or an x not 16-byte aligned, takes the VEC = 1
//     specialization of the same kernel (scalar channels, plain loads);
//   - blocks walk a linear tile index in 64 bits, so any B, H, W, C runs.
//
// C interface for ctypes: returns cudaGetLastError() after the launch on the
// caller's stream; dtype 0 = float32, 1 = bfloat16; K must be 3 or 5; vec 4
// or 1; C must be a multiple of cvb * vec, and of 8 when vec is 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRun = 8;  // output pixels of a thread's run along W
constexpr int kMaxSmem = 75 * 1024;  // the largest plan's shared memory (ops/depthwise.py:MAX_SMEM)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// two f32 -> one register of two bf16, rounded to nearest (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// VEC consecutive values (f32 taps and affine, or inputs) from shared
// memory, widened to f32
template <int VEC>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);  // a bf16 is the top half of its f32
    v[0] = __uint_as_float(u.x << 16); v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16); v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

// VEC results to device memory, rounded once to the output dtype
template <int VEC>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void st_vec(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  } else {
    p[0] = __float2bfloat16(v[0]);
  }
}

// 16 bytes global -> shared; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// floats of the parameter region of shared memory (K*K weight taps, then
// a and b), rounded up to 16 bytes
__host__ __device__ __forceinline__ int param_floats(int K, int pe) { return ((K * K + 2) * pe + 3) & ~3; }

// three blocks per SM (80 registers) only for bf16 at K = 3: f32's wider
// taps spilled at that cap
template <typename T, int K, int VEC>
__global__ void __launch_bounds__(kMaxThreads, K == 3 && sizeof(T) == 2 ? 3 : 2)
dw_conv_bn_silu_kernel(const T* __restrict__ x, const T* __restrict__ wt, const float* __restrict__ a,
                       const float* __restrict__ bias, T* __restrict__ y, int H, int W, int C, int cvb,
                       int runs, int rows_t, int tile_h, int tiles_h, int tiles_w, int slices,
                       int64_t ntiles) {
  constexpr int P = (K - 1) / 2;
  constexpr int kTaps = K * K;
  constexpr int kChunk = VEC == 1 ? 1 : 16 / (int)sizeof(T);  // elements of one staging copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int pe = cvb * VEC;  // channels of the block's slice
  const int tile_w = runs * kRun;
  const int cols_in = tile_w + K - 1, rows_in = tile_h + K - 1;
  float* ps = reinterpret_cast<float*>(smem);  // [K*K + 2][pe]: the weight taps, a, b
  T* xs = reinterpret_cast<T*>(smem + param_floats(K, pe) * sizeof(float));  // [rows_in][cols_in][pe]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int cv = tid % cvb, run = (tid / cvb) % runs, ty = tid / (cvb * runs);
  const int col0 = run * kRun;  // the thread's first output column in the tile
  // staging: thread tid copies chunks tid, tid + nthreads, ... of the halo
  // tile, each (row, column, chunk q of the pixel's slice); the stride is
  // split into those three once, so the loop divides nothing
  const int per_pix = pe / kChunk;
  const int q0 = tid % per_pix, pix0 = tid / per_pix;
  const int dq = nthreads % per_pix, dpix = nthreads / per_pix;
  const int dr = dpix / cols_in, dc = dpix % cols_in;

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int slice = (int)(tile % slices);
    int64_t rest = tile / slices;
    const int w0 = (int)(rest % tiles_w) * tile_w;
    rest /= tiles_w;
    const int h0 = (int)(rest % tiles_h) * tile_h;
    const int64_t img = (rest / tiles_h) * H;  // row index of (b, 0)
    const int cs = slice * pe;                 // the slice's first channel

    __syncthreads();  // the previous tile's readers are done with shared memory
    for (int tap = tid / cvb; tap < kTaps + 2; tap += nthreads / cvb) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int ch = cs + cv * VEC + v;
        const float pv = tap < kTaps ? to_f32(wt[(int64_t)tap * C + ch]) : (tap == kTaps ? a[ch] : bias[ch]);
        ps[tap * pe + cv * VEC + v] = pv;
      }
    }
    for (int r = pix0 / cols_in, c = pix0 % cols_in, q = q0; r < rows_in;) {
      const int ih = h0 - P + r, iw = w0 - P + c;
      const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W;
      const int64_t src = ((img + ih) * W + iw) * C + cs + q * kChunk;
      T* dst = xs + (r * cols_in + c) * pe + q * kChunk;
      if constexpr (VEC == 1) {
        dst[0] = ok ? x[src] : T(0.0f);
      } else {
        cp_async16(dst, ok ? x + src : x, ok);
      }
      q += dq;
      c += dc;
      r += dr;
      if (q >= per_pix) {
        q -= per_pix;
        ++c;
      }
      if (c >= cols_in) {
        c -= cols_in;
        ++r;
      }
    }
    if constexpr (VEC != 1) cp_async_wait_all();
    __syncthreads();
    if (w0 + col0 >= W) continue;

    const int nvalid = min(kRun, W - (w0 + col0));  // output pixels of the run inside the image
    for (int r = ty; r < tile_h && h0 + r < H; r += rows_t) {
      float acc[kRun][VEC];
#pragma unroll
      for (int p = 0; p < kRun; ++p)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[p][v] = 0.0f;
#pragma unroll 1
      for (int dy = 0; dy < K; ++dy) {  // rolled: one input row's loads in flight, no spills
        float wv[K][VEC];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) ld_vec<VEC>(ps + (dy * K + dx) * pe + cv * VEC, wv[dx]);
        const T* xr = xs + ((r + dy) * cols_in + col0) * pe + cv * VEC;
#pragma unroll
        for (int j = 0; j < kRun + K - 1; ++j) {  // input column j feeds outputs p = j - dx
          float xv[VEC];
          ld_vec<VEC>(xr + j * pe, xv);
#pragma unroll
          for (int p = 0; p < kRun; ++p) {
            const int dx = j - p;
            if (dx >= 0 && dx < K) {
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc[p][v] = fmaf(xv[v], wv[dx][v], acc[p][v]);
            }
          }
        }
      }
      float av[VEC], bv[VEC];
      ld_vec<VEC>(ps + kTaps * pe + cv * VEC, av);
      ld_vec<VEC>(ps + (kTaps + 1) * pe + cv * VEC, bv);
      T* yr = y + ((img + h0 + r) * W + w0 + col0) * C + cs + cv * VEC;
#pragma unroll
      for (int p = 0; p < kRun; ++p) {
        float o[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {  // silu(s) = s / (1 + e^-s), with the MUFU exp and reciprocal
          const float s = fmaf(acc[p][v], av[v], bv[v]);
          o[v] = __fdividef(s, 1.0f + __expf(-s));
        }
        if (p < nvalid) st_vec<VEC>(yr + (int64_t)p * C, o);
      }
    }
  }
}

template <typename T, int K, int VEC>
int launch(const void* x, const void* wt, const float* a, const float* b, void* y, int64_t B, int64_t H,
           int64_t W, int64_t C, int cvb, int runs, int rows_t, int tile_h, cudaStream_t stream) {
  const int pe = cvb * VEC, tile_w = runs * kRun, threads = cvb * runs * rows_t;
  if (cvb < 1 || runs < 1 || rows_t < 1 || tile_h < 1 || threads > kMaxThreads || C % pe != 0 ||
      (VEC != 1 && pe % 8 != 0) ||
      H >= (1LL << 31) || W >= (1LL << 31) || C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaGetLastError();
  const int64_t tiles_h = (H + tile_h - 1) / tile_h, tiles_w = (W + tile_w - 1) / tile_w;
  const int64_t slices = C / pe;
  const int64_t ntiles = B * tiles_h * tiles_w * slices;
  const size_t smem = param_floats(K, pe) * sizeof(float) +
                      (size_t)(tile_h + K - 1) * (tile_w + K - 1) * pe * sizeof(T);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = dw_conv_bn_silu_kernel<T, K, VEC>;
  // the shared-memory cap is raised to kMaxSmem once per instantiation and device
  static bool raised[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev] = true;
  }
  const unsigned int grid = (unsigned int)(ntiles < 0x7fffffffLL ? ntiles : 0x7fffffffLL);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), a, b, static_cast<T*>(y), (int)H, (int)W, (int)C,
      cvb, runs, rows_t, tile_h, (int)tiles_h, (int)tiles_w, (int)slices, ntiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(const void* x, const void* wt, const float* a, const float* b, void* y, int64_t B, int64_t H,
             int64_t W, int64_t C, int K, int vec, int cvb, int runs, int rows_t, int tile_h, cudaStream_t s) {
  if (K == 3 && vec == 4) return launch<T, 3, 4>(x, wt, a, b, y, B, H, W, C, cvb, runs, rows_t, tile_h, s);
  if (K == 3 && vec == 1) return launch<T, 3, 1>(x, wt, a, b, y, B, H, W, C, cvb, runs, rows_t, tile_h, s);
  if (K == 5 && vec == 4) return launch<T, 5, 4>(x, wt, a, b, y, B, H, W, C, cvb, runs, rows_t, tile_h, s);
  if (K == 5 && vec == 1) return launch<T, 5, 1>(x, wt, a, b, y, B, H, W, C, cvb, runs, rows_t, tile_h, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x and y must be 16-byte aligned when vec == 4 (the wrapper checks x; y is
// its own fresh allocation).
extern "C" int dw_conv_bn_silu(const void* x, const void* wt, const void* a, const void* b, void* y,
                               int64_t B, int64_t H, int64_t W, int64_t C, int K, int dtype, int vec, int cvb,
                               int runs, int rows_t, int tile_h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0) return launch_k<float>(x, wt, af, bf, y, B, H, W, C, K, vec, cvb, runs, rows_t, tile_h, s);
  if (dtype == 1) return launch_k<__nv_bfloat16>(x, wt, af, bf, y, B, H, W, C, K, vec, cvb, runs, rows_t, tile_h, s);
  return (int)cudaErrorInvalidValue;
}
