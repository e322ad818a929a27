// Fused depthwise k x k conv + eval batchnorm + SiLU, stride 1, on NHWC memory,
// and its gradient.
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
// The gradient under a cotangent gy (the JAX package has no backward kernel:
// its gradient is XLA's, through the grouped conv of models/efficientnet.py),
// with acc = dwconv(x, wt), z = a * acc + b, dz = gy * silu'(z), dacc = a * dz:
//
//   dx = the flipped-tap depthwise conv of dacc, in x's dtype
//   dw[c, dy, dx] = sum_BHW dacc * x shifted by (dy, dx);  da = sum_BHW dz * acc;  db = sum_BHW dz
//
// It is three kernels, all in f32 with no float atomics, so two runs give
// bit-equal gradients:
//   1. dw_bwd_tile_kernel: the forward's tiling and halo tile; acc
//      recomputed as the forward sums it; dacc written to device memory (f32,
//      for pass 2) and to shared memory, where the block's (channel, dy) work
//      items slide a K-wide window of x along each tile row for the dw taps;
//      each block writes its tile's per-channel partials of dw, da and db to
//      a workspace [tile][K*K + 2][C], summed in a fixed order;
//   2. dw_bwd_dx_kernel: the forward's conv body on the f32 dacc with the
//      flipped taps and no epilogue, stored in x's dtype;
//   3. dw_bwd_reduce_kernel: each (row, channel) of the workspace summed over
//      the tiles, 8 strided groups then the 8 in order.
// What bounds the pair: it moves x and gy in, dacc out and back in f32, and
// dx out (~14 B an element in bf16), so memory; the tile pass's dw items read
// two shared-memory values per K FMAs.  A one-pass design that recomputes
// dacc on a halo would drop the f32 round trip (later work).
//
// C interface for ctypes: each entry returns cudaGetLastError() after its
// launch on the caller's stream; dtype 0 = float32, 1 = bfloat16; K must be 3
// or 5; vec 4 or 1; C must be a multiple of cvb * vec, and of 8 when vec is 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRun = 8;  // output pixels of a thread's run along W
constexpr int kMaxSmem = 75 * 1024;  // the largest plan's shared memory (ops/depthwise.py:MAX_SMEM)
constexpr int kMaxSmemBwd = 110 * 1024;  // the tile pass's (ops/depthwise.py:MAX_SMEM_BWD): two blocks per SM
constexpr int kReduceLanes = 32, kReduceGroups = 8;  // the reduce kernel's block (ops/depthwise.py:REDUCE_*)
constexpr int kWantDx = 1, kWantW = 2, kWantAb = 4;  // the tile pass's flags

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// two f32 -> one register of two bf16, rounded to nearest (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// VEC consecutive values (f32 taps and affine, or inputs) from shared or
// device memory, widened to f32
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

// VEC results to shared or device memory, rounded once to the output dtype
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

__host__ __device__ __forceinline__ int64_t round16(int64_t bytes) { return (bytes + 15) & ~(int64_t)15; }

// row groups of the tile pass's dw items: (channel, dy) items times groups
// fill the block where there are fewer items than threads
__host__ __device__ __forceinline__ int bwd_groups(int K, int pe, int threads) {
  const int g = threads / (pe * K);
  return g > 1 ? g : 1;
}

// The tile pass's shared memory, in bytes from its start: the parameters,
// the halo tile of x, dacc's tile in f32, the da/db partials of every thread
// and the dw partials of every (group, tap, channel); returns the total.
__host__ __device__ __forceinline__ int64_t bwd_smem(int K, int pe, int vec, int tile_h, int tile_w, int itemsize,
                                                     int threads, int64_t* off_x, int64_t* off_d, int64_t* off_ab,
                                                     int64_t* off_w) {
  *off_x = (int64_t)param_floats(K, pe) * 4;
  *off_d = *off_x + round16((int64_t)(tile_h + K - 1) * (tile_w + K - 1) * pe * itemsize);
  *off_ab = *off_d + round16((int64_t)tile_h * tile_w * pe * 4);
  *off_w = *off_ab + round16((int64_t)threads * 2 * vec * 4);
  return *off_w + (int64_t)bwd_groups(K, pe, threads) * K * K * pe * 4;
}

// The thread's tile geometry, shared by the conv kernels and the tile pass:
// thread tid owns channel vector cv of the block's slice, run `run` along W
// and rows ty, ty + rows_t, ... of the tile.
struct TileGeom {
  int slice, w0, h0, cs;
  int64_t img;  // row index of (b, 0)
  int64_t tsp;  // the spatial tile: b * tiles_h * tiles_w + th * tiles_w + tw
};

__device__ __forceinline__ TileGeom tile_geom(int64_t tile, int H, int tile_h, int tile_w, int tiles_h, int tiles_w,
                                              int slices, int pe) {
  TileGeom g;
  g.slice = (int)(tile % slices);
  g.tsp = tile / slices;
  int64_t rest = g.tsp;
  g.w0 = (int)(rest % tiles_w) * tile_w;
  rest /= tiles_w;
  g.h0 = (int)(rest % tiles_h) * tile_h;
  g.img = (rest / tiles_h) * H;
  g.cs = g.slice * pe;
  return g;
}

// Stage the slice's nparams parameter rows (K*K taps from wt in Tw, in
// reverse order when kFlip, then a and b) in f32 and the halo tile of x (Tin)
// into shared memory, and wait.  The caller syncs before and after.
template <typename Tin, typename Tw, int K, int VEC, bool kFlip>
__device__ __forceinline__ void stage_tile(const Tin* __restrict__ x, const Tw* __restrict__ wt,
                                           const float* __restrict__ a, const float* __restrict__ bias, float* ps,
                                           Tin* xs, const TileGeom& g, int nparams, int H, int W, int C, int cvb,
                                           int cols_in, int rows_in) {
  constexpr int P = (K - 1) / 2;
  constexpr int kTaps = K * K;
  constexpr int kChunk = VEC == 1 ? 1 : 16 / (int)sizeof(Tin);  // elements of one staging copy
  const int pe = cvb * VEC;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int cv = tid % cvb;
  for (int tap = tid / cvb; tap < nparams; tap += nthreads / cvb) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int ch = g.cs + cv * VEC + v;
      // reversing the (dy, dx)-major tap index flips both dy and dx
      const int src = kFlip ? kTaps - 1 - tap : tap;
      const float pv = tap < kTaps ? to_f32(wt[(int64_t)src * C + ch]) : (tap == kTaps ? a[ch] : bias[ch]);
      ps[tap * pe + cv * VEC + v] = pv;
    }
  }
  // thread tid copies chunks tid, tid + nthreads, ... of the halo tile, each
  // (row, column, chunk q of the pixel's slice); the stride is split into
  // those three once, so the loop divides nothing
  const int per_pix = pe / kChunk;
  const int q0 = tid % per_pix, pix0 = tid / per_pix;
  const int dq = nthreads % per_pix, dpix = nthreads / per_pix;
  const int dr = dpix / cols_in, dc = dpix % cols_in;
  for (int r = pix0 / cols_in, c = pix0 % cols_in, q = q0; r < rows_in;) {
    const int ih = g.h0 - P + r, iw = g.w0 - P + c;
    const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W;
    const int64_t src = ((g.img + ih) * W + iw) * C + g.cs + q * kChunk;
    Tin* dst = xs + (r * cols_in + c) * pe + q * kChunk;
    if constexpr (VEC == 1) {
      dst[0] = ok ? x[src] : Tin(0.0f);
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
}

// acc[p][v] = the K x K taps of the staged tile for the thread's run of
// kRun outputs of tile row r, summed in (dy, dx) order with fmaf
template <typename Tin, int K, int VEC>
__device__ __forceinline__ void conv_run(const float* ps, const Tin* xs, int r, int col0, int cols_in, int pe, int cv,
                                         float (&acc)[kRun][VEC]) {
#pragma unroll
  for (int p = 0; p < kRun; ++p)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[p][v] = 0.0f;
#pragma unroll 1
  for (int dy = 0; dy < K; ++dy) {  // rolled: one input row's loads in flight, no spills
    float wv[K][VEC];
#pragma unroll
    for (int dx = 0; dx < K; ++dx) ld_vec<VEC>(ps + (dy * K + dx) * pe + cv * VEC, wv[dx]);
    const Tin* xr = xs + ((r + dy) * cols_in + col0) * pe + cv * VEC;
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
}

// The depthwise conv of a Tin input over the block's tiles, with the
// forward's epilogue silu(a * acc + b) (kSilu) or, for the dx pass, none and
// the taps flipped; stored in Tout.  wt holds the K*K taps in Tout, (dy,
// dx)-major, C innermost.
template <typename Tin, typename Tout, int K, int VEC, bool kSilu>
__device__ __forceinline__ void conv_tiles(const Tin* __restrict__ x, const Tout* __restrict__ wt,
                                           const float* __restrict__ a, const float* __restrict__ bias,
                                           Tout* __restrict__ y, int H, int W, int C, int cvb, int runs, int rows_t,
                                           int tile_h, int tiles_h, int tiles_w, int slices, int64_t ntiles) {
  constexpr int kTaps = K * K;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pe = cvb * VEC;  // channels of the block's slice
  const int tile_w = runs * kRun;
  const int cols_in = tile_w + K - 1, rows_in = tile_h + K - 1;
  float* ps = reinterpret_cast<float*>(smem);  // [K*K + 2][pe]: the weight taps, a, b
  Tin* xs = reinterpret_cast<Tin*>(smem + param_floats(K, pe) * sizeof(float));  // [rows_in][cols_in][pe]

  const int tid = threadIdx.x;
  const int cv = tid % cvb, run = (tid / cvb) % runs, ty = tid / (cvb * runs);
  const int col0 = run * kRun;  // the thread's first output column in the tile

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const TileGeom g = tile_geom(tile, H, tile_h, tile_w, tiles_h, tiles_w, slices, pe);
    __syncthreads();  // the previous tile's readers are done with shared memory
    stage_tile<Tin, Tout, K, VEC, !kSilu>(x, wt, a, bias, ps, xs, g, kSilu ? kTaps + 2 : kTaps, H, W, C, cvb,
                                          cols_in, rows_in);
    __syncthreads();
    if (g.w0 + col0 >= W) continue;

    const int nvalid = min(kRun, W - (g.w0 + col0));  // output pixels of the run inside the image
    for (int r = ty; r < tile_h && g.h0 + r < H; r += rows_t) {
      float acc[kRun][VEC];
      conv_run<Tin, K, VEC>(ps, xs, r, col0, cols_in, pe, cv, acc);
      float av[VEC], bv[VEC];
      if constexpr (kSilu) {
        ld_vec<VEC>(ps + kTaps * pe + cv * VEC, av);
        ld_vec<VEC>(ps + (kTaps + 1) * pe + cv * VEC, bv);
      }
      Tout* yr = y + ((g.img + g.h0 + r) * W + g.w0 + col0) * C + g.cs + cv * VEC;
#pragma unroll
      for (int p = 0; p < kRun; ++p) {
        float o[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          if constexpr (kSilu) {  // silu(s) = s / (1 + e^-s), with the MUFU exp and reciprocal
            const float s = fmaf(acc[p][v], av[v], bv[v]);
            o[v] = __fdividef(s, 1.0f + __expf(-s));
          } else {
            o[v] = acc[p][v];
          }
        }
        if (p < nvalid) st_vec<VEC>(yr + (int64_t)p * C, o);
      }
    }
  }
}

// three blocks per SM (80 registers) only for bf16 at K = 3: f32's wider
// taps spilled at that cap
template <typename T, int K, int VEC>
__global__ void __launch_bounds__(kMaxThreads, K == 3 && sizeof(T) == 2 ? 3 : 2)
dw_conv_bn_silu_kernel(const T* __restrict__ x, const T* __restrict__ wt, const float* __restrict__ a,
                       const float* __restrict__ bias, T* __restrict__ y, int H, int W, int C, int cvb,
                       int runs, int rows_t, int tile_h, int tiles_h, int tiles_w, int slices,
                       int64_t ntiles) {
  conv_tiles<T, T, K, VEC, true>(x, wt, a, bias, y, H, W, C, cvb, runs, rows_t, tile_h, tiles_h, tiles_w, slices,
                                 ntiles);
}

// pass 2 of the backward: dx = the conv of the f32 dacc with the flipped
// taps (wt[K-1-dy][K-1-dx] at (dy, dx)), in x's dtype
template <typename T, int K, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 2)
dw_bwd_dx_kernel(const float* __restrict__ dacc, const T* __restrict__ wt, T* __restrict__ dx, int H, int W, int C,
                 int cvb, int runs, int rows_t, int tile_h, int tiles_h, int tiles_w, int slices, int64_t ntiles) {
  conv_tiles<float, T, K, VEC, false>(dacc, wt, nullptr, nullptr, dx, H, W, C, cvb, runs, rows_t, tile_h, tiles_h,
                                      tiles_w, slices, ntiles);
}

// pass 1 of the backward, over the block's tiles (the forward's tiling):
// stage x's halo tile and the parameters; each thread recomputes acc for its
// runs, forms dz and dacc, writes dacc to device memory (kWantDx) and to the
// shared tile (kWantW), and keeps its da, db partials (kWantAb); then the
// block's (channel, dy, row group) items slide a K-wide window of x along the
// tile's rows against dacc for the dw taps, and the block writes its tile's
// K*K + 2 partial rows of its slice's channels to ws[tsp][row][C].
template <typename T, int K, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 2)
dw_bwd_tile_kernel(const T* __restrict__ x, const T* __restrict__ wt, const float* __restrict__ a,
                   const float* __restrict__ bias, const T* __restrict__ gy, float* __restrict__ dacc,
                   float* __restrict__ ws, int H, int W, int C, int cvb, int runs, int rows_t, int tile_h,
                   int tiles_h, int tiles_w, int slices, int64_t ntiles, int flags) {
  constexpr int kTaps = K * K;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pe = cvb * VEC;
  const int tile_w = runs * kRun;
  const int cols_in = tile_w + K - 1, rows_in = tile_h + K - 1;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int groups = bwd_groups(K, pe, nthreads);
  int64_t off_x, off_d, off_ab, off_w;
  bwd_smem(K, pe, VEC, tile_h, tile_w, (int)sizeof(T), nthreads, &off_x, &off_d, &off_ab, &off_w);
  float* ps = reinterpret_cast<float*>(smem);          // [K*K + 2][pe]
  T* xs = reinterpret_cast<T*>(smem + off_x);          // [rows_in][cols_in][pe]
  float* ds = reinterpret_cast<float*>(smem + off_d);  // [tile_h][tile_w][pe]: dacc
  float* rab = reinterpret_cast<float*>(smem + off_ab);  // [threads][2][VEC]: da, db
  float* rw = reinterpret_cast<float*>(smem + off_w);  // [groups][K*K][pe]: dw

  const int cv = tid % cvb, run = (tid / cvb) % runs, ty = tid / (cvb * runs);
  const int col0 = run * kRun;
  const bool want_dx = flags & kWantDx, want_w = flags & kWantW, want_ab = flags & kWantAb;

  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const TileGeom g = tile_geom(tile, H, tile_h, tile_w, tiles_h, tiles_w, slices, pe);
    __syncthreads();  // the previous tile's readers are done with shared memory
    stage_tile<T, T, K, VEC, false>(x, wt, a, bias, ps, xs, g, kTaps + 2, H, W, C, cvb, cols_in, rows_in);
    __syncthreads();

    const int nvalid = max(0, min(kRun, W - (g.w0 + col0)));  // the run's pixels inside the image
    float av[VEC], bv[VEC], da[VEC], db[VEC];
    ld_vec<VEC>(ps + kTaps * pe + cv * VEC, av);
    ld_vec<VEC>(ps + (kTaps + 1) * pe + cv * VEC, bv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) da[v] = db[v] = 0.0f;
    for (int r = ty; r < tile_h; r += rows_t) {  // every tile row, so that dacc's tile is written whole
      const bool row_ok = g.h0 + r < H;
      float acc[kRun][VEC];
      if (row_ok && nvalid > 0) {
        conv_run<T, K, VEC>(ps, xs, r, col0, cols_in, pe, cv, acc);
      }
      const int64_t pix = (g.img + g.h0 + r) * W + g.w0 + col0;
#pragma unroll
      for (int p = 0; p < kRun; ++p) {
        float d[VEC];
        if (row_ok && p < nvalid) {
          const int64_t at = (pix + p) * C + g.cs + cv * VEC;
          float gv[VEC];
          ld_vec<VEC>(gy + at, gv);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {  // silu'(z) = sig * (1 + z * (1 - sig)), accurate exp and divide
            const float z = fmaf(acc[p][v], av[v], bv[v]);
            const float sig = 1.0f / (1.0f + expf(-z));
            const float dz = gv[v] * (sig * (1.0f + z * (1.0f - sig)));
            d[v] = dz * av[v];
            da[v] = fmaf(dz, acc[p][v], da[v]);
            db[v] += dz;
          }
          if (want_dx) st_vec<VEC>(dacc + at, d);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) d[v] = 0.0f;
        }
        if (want_w) st_vec<VEC>(ds + (r * tile_w + col0 + p) * pe + cv * VEC, d);
      }
    }
    if (!(want_w || want_ab)) continue;
    if (want_ab) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        rab[tid * 2 * VEC + v] = da[v];
        rab[tid * 2 * VEC + VEC + v] = db[v];
      }
    }
    __syncthreads();

    float* wsr = ws + g.tsp * (kTaps + 2) * (int64_t)C + g.cs;  // this tile's partial rows, the slice's channels
    if (want_ab) {  // thread tid = cv + cvb * s: the slice's channel c sums its cvb-strided threads in order
      const int per_cv = nthreads / cvb;
      for (int c = tid; c < pe; c += nthreads) {
        const float* q = rab + (c / VEC) * 2 * VEC + c % VEC;
        float sa = 0.0f, sb = 0.0f;
        for (int s = 0; s < per_cv; ++s) {
          sa += q[s * cvb * 2 * VEC];
          sb += q[s * cvb * 2 * VEC + VEC];
        }
        wsr[(int64_t)kTaps * C + c] = sa;
        wsr[(int64_t)(kTaps + 1) * C + c] = sb;
      }
    }
    if (want_w) {
      for (int it = tid; it < groups * K * pe; it += nthreads) {  // item (c, dy, group)
        const int c = it % pe, dy = (it / pe) % K, grp = it / (pe * K);
        float part[K];
#pragma unroll
        for (int j = 0; j < K; ++j) part[j] = 0.0f;
        for (int r = grp; r < tile_h; r += groups) {
          const T* xr = xs + (r + dy) * cols_in * pe + c;
          const float* dr = ds + r * tile_w * pe + c;
          float win[K];  // x at columns q .. q + K - 1 of input row r + dy
#pragma unroll
          for (int j = 0; j < K - 1; ++j) win[j] = to_f32(xr[j * pe]);
#pragma unroll 4
          for (int q = 0; q < tile_w; ++q) {
            win[K - 1] = to_f32(xr[(q + K - 1) * pe]);
            const float dv = dr[q * pe];
#pragma unroll
            for (int j = 0; j < K; ++j) part[j] = fmaf(dv, win[j], part[j]);
#pragma unroll
            for (int j = 0; j < K - 1; ++j) win[j] = win[j + 1];
          }
        }
#pragma unroll
        for (int j = 0; j < K; ++j) rw[(grp * kTaps + dy * K + j) * pe + c] = part[j];
      }
      __syncthreads();
      for (int it = tid; it < kTaps * pe; it += nthreads) {
        const int c = it % pe, tap = it / pe;
        float s = 0.0f;
        for (int grp = 0; grp < groups; ++grp) s += rw[(grp * kTaps + tap) * pe + c];
        wsr[(int64_t)tap * C + c] = s;
      }
    }
  }
}

// pass 3: row `row0 + blockIdx.y` of the workspace summed over the tiles for
// 32 channels a block: 8 groups take the tiles g, g + 8, ... in order, then
// the 8 sums are added in order.  Rows below K*K are dw's taps, (C, K*K);
// row K*K is da, row K*K + 1 db.
__global__ void __launch_bounds__(kReduceLanes * kReduceGroups)
dw_bwd_reduce_kernel(const float* __restrict__ ws, int64_t tiles, int C, int K, int row0, float* __restrict__ dw,
                     float* __restrict__ da, float* __restrict__ db) {
  __shared__ float part[kReduceGroups][kReduceLanes];
  const int lane = threadIdx.x % kReduceLanes, grp = threadIdx.x / kReduceLanes;
  const int c = blockIdx.x * kReduceLanes + lane, row = row0 + blockIdx.y;
  const int taps = K * K, rows = taps + 2;
  float s = 0.0f;
  if (c < C) {
    const float* p = ws + (int64_t)row * C + c;
#pragma unroll 4
    for (int64_t t = grp; t < tiles; t += kReduceGroups) s += p[t * rows * (int64_t)C];
  }
  part[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && c < C) {
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < kReduceGroups; ++i) total += part[i][lane];
    if (row < taps) {
      dw[(int64_t)c * taps + row] = total;
    } else if (row == taps) {
      da[c] = total;
    } else {
      db[c] = total;
    }
  }
}

// raise a kernel's dynamic shared-memory cap to `bytes` once per device
template <typename F>
cudaError_t raise_smem_cap(F kernel, int bytes, bool (&raised)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) raised[dev] = true;
  return err;
}

bool bad_plan(int64_t H, int64_t W, int64_t C, int vec, int cvb, int runs, int rows_t, int tile_h) {
  const int pe = cvb * vec;
  return cvb < 1 || runs < 1 || rows_t < 1 || tile_h < 1 || cvb * runs * rows_t > kMaxThreads || C % pe != 0 ||
         (vec != 1 && pe % 8 != 0) || H >= (1LL << 31) || W >= (1LL << 31) || C >= (1LL << 31);
}

// the forward (kFwd: x in T, the silu epilogue) or the dx pass (the f32
// dacc in, no epilogue), output in T
template <typename T, int K, int VEC, bool kFwd>
int launch(const void* x, const void* wt, const float* a, const float* b, void* y, int64_t B, int64_t H, int64_t W,
           int64_t C, int cvb, int runs, int rows_t, int tile_h, cudaStream_t stream) {
  using Tin = typename std::conditional<kFwd, T, float>::type;
  const int pe = cvb * VEC, tile_w = runs * kRun, threads = cvb * runs * rows_t;
  if (bad_plan(H, W, C, VEC, cvb, runs, rows_t, tile_h)) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaGetLastError();
  const int64_t tiles_h = (H + tile_h - 1) / tile_h, tiles_w = (W + tile_w - 1) / tile_w;
  const int64_t slices = C / pe;
  const int64_t ntiles = B * tiles_h * tiles_w * slices;
  const size_t smem = param_floats(K, pe) * sizeof(float) +
                      (size_t)(tile_h + K - 1) * (tile_w + K - 1) * pe * sizeof(Tin);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool raised[64] = {false};
  const unsigned int grid = (unsigned int)(ntiles < 0x7fffffffLL ? ntiles : 0x7fffffffLL);
  if constexpr (kFwd) {
    auto kernel = dw_conv_bn_silu_kernel<T, K, VEC>;
    cudaError_t err = raise_smem_cap(kernel, kMaxSmem, raised);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wt), a, b, static_cast<T*>(y), (int)H, (int)W, (int)C,
        cvb, runs, rows_t, tile_h, (int)tiles_h, (int)tiles_w, (int)slices, ntiles);
  } else {
    auto kernel = dw_bwd_dx_kernel<T, K, VEC>;
    cudaError_t err = raise_smem_cap(kernel, kMaxSmem, raised);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const T*>(wt), static_cast<T*>(y), (int)H, (int)W, (int)C,
        cvb, runs, rows_t, tile_h, (int)tiles_h, (int)tiles_w, (int)slices, ntiles);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kFwd>
int launch_k(const void* x, const void* wt, const float* a, const float* b, void* y, int64_t B, int64_t H,
             int64_t W, int64_t C, int K, int vec, int cvb, int runs, int rows_t, int tile_h, cudaStream_t s) {
  if (K == 3 && vec == 4) return launch<T, 3, 4, kFwd>(x, wt, a, b, y, B, H, W, C, cvb, runs, rows_t, tile_h, s);
  if (K == 3 && vec == 1) return launch<T, 3, 1, kFwd>(x, wt, a, b, y, B, H, W, C, cvb, runs, rows_t, tile_h, s);
  if (K == 5 && vec == 4) return launch<T, 5, 4, kFwd>(x, wt, a, b, y, B, H, W, C, cvb, runs, rows_t, tile_h, s);
  if (K == 5 && vec == 1) return launch<T, 5, 1, kFwd>(x, wt, a, b, y, B, H, W, C, cvb, runs, rows_t, tile_h, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int K, int VEC>
int launch_tile(const void* x, const void* wt, const float* a, const float* b, const void* gy, float* dacc,
                float* ws, int64_t B, int64_t H, int64_t W, int64_t C, int cvb, int runs, int rows_t, int tile_h,
                int flags, cudaStream_t stream) {
  const int pe = cvb * VEC, tile_w = runs * kRun, threads = cvb * runs * rows_t;
  if (bad_plan(H, W, C, VEC, cvb, runs, rows_t, tile_h) || (flags & ~(kWantDx | kWantW | kWantAb)) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaGetLastError();
  const int64_t tiles_h = (H + tile_h - 1) / tile_h, tiles_w = (W + tile_w - 1) / tile_w;
  const int64_t slices = C / pe;
  const int64_t ntiles = B * tiles_h * tiles_w * slices;
  int64_t off_x, off_d, off_ab, off_w;
  const int64_t smem = bwd_smem(K, pe, VEC, tile_h, tile_w, (int)sizeof(T), threads, &off_x, &off_d, &off_ab, &off_w);
  if (smem > kMaxSmemBwd) return (int)cudaErrorInvalidValue;
  auto kernel = dw_bwd_tile_kernel<T, K, VEC>;
  static bool raised[64] = {false};
  cudaError_t err = raise_smem_cap(kernel, kMaxSmemBwd, raised);
  if (err != cudaSuccess) return (int)err;
  const unsigned int grid = (unsigned int)(ntiles < 0x7fffffffLL ? ntiles : 0x7fffffffLL);
  kernel<<<grid, threads, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), a, b, static_cast<const T*>(gy), dacc, ws, (int)H,
      (int)W, (int)C, cvb, runs, rows_t, tile_h, (int)tiles_h, (int)tiles_w, (int)slices, ntiles, flags);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile_k(const void* x, const void* wt, const float* a, const float* b, const void* gy, float* dacc,
                  float* ws, int64_t B, int64_t H, int64_t W, int64_t C, int K, int vec, int cvb, int runs,
                  int rows_t, int tile_h, int flags, cudaStream_t s) {
  if (K == 3 && vec == 4)
    return launch_tile<T, 3, 4>(x, wt, a, b, gy, dacc, ws, B, H, W, C, cvb, runs, rows_t, tile_h, flags, s);
  if (K == 3 && vec == 1)
    return launch_tile<T, 3, 1>(x, wt, a, b, gy, dacc, ws, B, H, W, C, cvb, runs, rows_t, tile_h, flags, s);
  if (K == 5 && vec == 4)
    return launch_tile<T, 5, 4>(x, wt, a, b, gy, dacc, ws, B, H, W, C, cvb, runs, rows_t, tile_h, flags, s);
  if (K == 5 && vec == 1)
    return launch_tile<T, 5, 1>(x, wt, a, b, gy, dacc, ws, B, H, W, C, cvb, runs, rows_t, tile_h, flags, s);
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
  if (dtype == 0) return launch_k<float, true>(x, wt, af, bf, y, B, H, W, C, K, vec, cvb, runs, rows_t, tile_h, s);
  if (dtype == 1)
    return launch_k<__nv_bfloat16, true>(x, wt, af, bf, y, B, H, W, C, K, vec, cvb, runs, rows_t, tile_h, s);
  return (int)cudaErrorInvalidValue;
}

// Pass 1.  x and gy in `dtype`, NHWC; wt the (K, K, C) taps in `dtype`; a, b
// f32.  flags: 1 = write dacc (f32, NHWC), 2 = dw's partials, 4 = da's and
// db's, into ws (f32, [tiles][K*K + 2][C], tiles = B * tiles_h * tiles_w).
// x, gy and dacc must be 16-byte aligned when vec == 4.
extern "C" int dw_bwd_tile(const void* x, const void* wt, const void* a, const void* b, const void* gy, void* dacc,
                           void* ws, int64_t B, int64_t H, int64_t W, int64_t C, int K, int dtype, int vec, int cvb,
                           int runs, int rows_t, int tile_h, int flags, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* d = static_cast<float*>(dacc);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return launch_tile_k<float>(x, wt, af, bf, gy, d, w, B, H, W, C, K, vec, cvb, runs, rows_t, tile_h, flags, s);
  if (dtype == 1)
    return launch_tile_k<__nv_bfloat16>(x, wt, af, bf, gy, d, w, B, H, W, C, K, vec, cvb, runs, rows_t, tile_h,
                                        flags, s);
  return (int)cudaErrorInvalidValue;
}

// Pass 2.  dacc f32 NHWC; wt the (K, K, C) taps in `dtype`, as the forward
// and pass 1 take them (the kernel flips them); dx in `dtype`, NHWC.  dacc
// and dx must be 16-byte aligned when vec == 4.
extern "C" int dw_bwd_dx(const void* dacc, const void* wt, void* dx, int64_t B, int64_t H, int64_t W, int64_t C,
                         int K, int dtype, int vec, int cvb, int runs, int rows_t, int tile_h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_k<float, false>(dacc, wt, nullptr, nullptr, dx, B, H, W, C, K, vec, cvb, runs, rows_t, tile_h, s);
  if (dtype == 1)
    return launch_k<__nv_bfloat16, false>(dacc, wt, nullptr, nullptr, dx, B, H, W, C, K, vec, cvb, runs, rows_t,
                                          tile_h, s);
  return (int)cudaErrorInvalidValue;
}

// Pass 3.  Rows row0 .. row0 + nrows - 1 of ws summed over its `tiles`: dw
// (f32, (C, K*K)) for rows below K*K, da and db (f32, (C,)) for rows K*K and
// K*K + 1; an output whose rows are not asked for may be null.
extern "C" int dw_bwd_reduce(const void* ws, int64_t tiles, int64_t C, int K, int row0, int nrows, void* dw,
                             void* da, void* db, void* stream) {
  if ((K != 3 && K != 5) || row0 < 0 || nrows < 1 || row0 + nrows > K * K + 2 || C < 1 || C >= (1LL << 31) ||
      tiles < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)((C + kReduceLanes - 1) / kReduceLanes), (unsigned int)nrows);
  dw_bwd_reduce_kernel<<<grid, kReduceLanes * kReduceGroups, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), tiles, (int)C, K, row0, static_cast<float*>(dw), static_cast<float*>(da),
      static_cast<float*>(db));
  return (int)cudaGetLastError();
}
