// 3x3, stride-1, zero-pad-1 convolution with a tiny input depth (C_in 1..4)
// plus bias, on NHWC memory: VGG19's conv1_1 (3 -> 64).
//
// Replaces the TPU kernel ops/pallas_conv1.py:conv1_fwd (_kernel) of the
// JAX package.  Its W-in-lanes layout, lane rolls and strip expansion are
// TPU devices and are not carried over.
//
//   y[b,i,j,o] = round( sum_{kh,kw,ci} xpad[b,i+kh,j+kw,ci] * w[kh,kw,ci,o]
//                       + bias[o] )
//
// in f32, the bias added last, and the result rounded once to the output
// dtype.  Weights and bias arrive as f32 (the wrapper rounds the weights to
// the input dtype first, as the plain version does).
//
// What bounds it: the output.  At (64, 224, 224, 3) -> 64 bf16 it reads
// 19.3 MB and writes 411 MB: 0.128 ms at 3.35 TB/s.  Its 5.5 G MACs take
// 0.166 ms at the 67 TFLOP/s f32 rate of the CUDA cores, so no CUDA-core
// design reaches the byte bound; on the tensor cores they are ~0.02 ms.
//
// bfloat16 (every main path) is an implicit GEMM on the tensor cores,
// conv1_mma_kernel:
//   - M is the output pixels (16 consecutive pixels of a row per
//     mma.sync.m16n8k16), N the output channels in chunks of 64 (8 n-tiles),
//     K = 9 taps x 4 channels (C_in zero-padded to 4 in shared memory) =
//     36, padded to 3 k-steps of 16; the products of bf16 values are exact,
//     the sums are the tensor cores' f32;
//   - A fragments are read straight from a bf16 halo tile (kTCH + 2 rows of
//     kTCW + 2 pixels x 4 channels) with 4-byte shared-memory loads: one
//     k pair is two channels of one tap, so im2col costs nothing;
//   - B fragments (the weights, exact in bf16) and the bias live in
//     registers for the block's life, and blocks are persistent (one wave,
//     each walking many tiles), so they are loaded once per block;
//   - the epilogue adds the f32 bias, rounds once, and stages the warp's
//     m-tile in the warp's own slot of shared memory (a padded stride:
//     conflict-free), so each lane stores 16 bytes and the warp the 16
//     pixels' contiguous 2 KB of the NHWC output, with no block barrier;
//   - the halo tile is double-buffered, so a tile costs one block barrier
//     and the warps drift apart: one warp's stores overlap another's MMAs.
// mma.sync and not wgmma: at K = 36 the products are ~0.02 ms of a 0.128 ms
// store-bound kernel, so the warpgroup machinery would buy nothing.
//
// float32 (off the main paths) stays on the CUDA cores, conv1_kernel: TF32
// would break its 1e-5 * max|y| bound.  The 9*C_in products are summed with
// fmaf in the fixed order (kh, ci, kw):
//   - a block owns a kTH x kTW tile of output pixels of one image and
//     stages the tile plus its one-pixel halo (zeros outside the image) in
//     shared memory as f32, and all 9*C_in*C_out weights and the bias;
//   - a thread owns a run of kP neighbouring pixels of one row and a group
//     of kG output channels, so each weight it loads from shared memory
//     serves kP pixels and each input value serves kG channels;
//   - neighbouring threads hold neighbouring channel groups of one pixel,
//     so a warp's 32-byte stores cover whole runs of the NHWC output.
//
// Offsets are 64-bit; B, H and W are arbitrary (edge tiles mask).  The
// bf16 kernel's blocks walk a 64-bit tile index; the f32 kernel has one
// block per tile on a 1-D grid, so B * tiles < 2^31 (1.1e12 pixels).
//
// C interface for ctypes: the entry returns cudaGetLastError() after the
// launch on the caller's stream; dtype 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- bfloat16: implicit GEMM on the tensor cores ----

constexpr int kTCThreads = 128;  // 4 warps
constexpr int kTCWarps = kTCThreads / 32;
constexpr int kTCH = 16;                   // output rows of a tile
constexpr int kTCW = 32;                   // output columns of a tile: 2 m-tiles of 16 pixels
constexpr int kMTiles = kTCH * kTCW / 16;  // m-tiles of a tile
constexpr int kHaloW = kTCW + 2;           // halo row, pixels
constexpr int kCP = 4;                     // channels of a halo pixel (C_in zero-padded)
constexpr int kKReal = 9 * kCP;            // k = (kh * 3 + kw) * 4 + ci
constexpr int kKSteps = (kKReal + 15) / 16;
constexpr int kNT = 8;          // n-tiles of 8 output channels in a chunk
constexpr int kNC = kNT * 8;    // output channels of a chunk
constexpr int kYS = kNC + 8;    // staging stride, bf16: rows 36 words apart, so writes miss no bank

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// B[k][n] of the GEMM: the HWIO f32 weight of k = (kh*3+kw)*4 + ci, zero
// for the padding
__device__ __forceinline__ float w_at(const float* w, int k, int n, int cin, int cout) {
  if (k >= kKReal || n >= cout || k % kCP >= cin) return 0.0f;
  return w[((k / kCP) * cin + k % kCP) * cout + n];
}

__global__ void __launch_bounds__(kTCThreads)
conv1_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int64_t H, int64_t W,
                 int cin, int cout, int64_t tiles_h, int64_t tiles_w, int64_t ntiles) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][(kTCH + 2) * kHaloW * kCP];  // halo, double-buffered
  __shared__ __align__(16) __nv_bfloat16 ys[kTCWarps][16 * kYS];             // each warp's m-tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row group and column pair
  const int nchunks = (cout + kNC - 1) / kNC;

  // the thread's A offsets from a pixel's halo slot, in bf16, for
  // k = ks*16 + 2t (half 0) and + 8 (half 1); -1 where k is padding
  int aoff[kKSteps][2];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = ks * 16 + half * 8 + 2 * t, tap = k / kCP;
      aoff[ks][half] = k < kKReal ? ((tap / 3) * kHaloW + tap % 3) * kCP + k % kCP : -1;
    }

  uint32_t bfr[kKSteps][kNT][2];
  float bia[kNT][2];
  auto load_weights = [&](int chunk) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = chunk * kNC + j * 8 + g;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const int k = ks * 16 + 2 * t;
        bfr[ks][j][0] = pack_bf16(w_at(w, k, n, cin, cout), w_at(w, k + 1, n, cin, cout));
        bfr[ks][j][1] = pack_bf16(w_at(w, k + 8, n, cin, cout), w_at(w, k + 9, n, cin, cout));
      }
      const int nb = chunk * kNC + j * 8 + 2 * t;
      bia[j][0] = nb < cout ? bias[nb] : 0.0f;
      bia[j][1] = nb + 1 < cout ? bias[nb + 1] : 0.0f;
    }
  };
  if (nchunks == 1) load_weights(0);

  __nv_bfloat16* yw = ys[warp];
  for (int64_t tile = blockIdx.x, it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const int64_t w0 = (tile % tiles_w) * kTCW;
    const int64_t rest = tile / tiles_w;
    const int64_t h0 = (rest % tiles_h) * kTCH;
    const int64_t img = (rest / tiles_h) * H;  // row index of (b, 0)
    __nv_bfloat16* xt = xs[it & 1];  // the other buffer may still be read by a slower warp

    // the halo tile, one pixel per thread: C_in values, zeros past C_in and outside the image
    for (int p = threadIdx.x; p < (kTCH + 2) * kHaloW; p += kTCThreads) {
      const int64_t hh = h0 - 1 + p / kHaloW, ww = w0 - 1 + p % kHaloW;
      __align__(8) __nv_bfloat16 v[kCP];
#pragma unroll
      for (int ci = 0; ci < kCP; ++ci) v[ci] = __float2bfloat16(0.0f);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        const __nv_bfloat16* src = x + ((img + hh) * W + ww) * cin;
#pragma unroll
        for (int ci = 0; ci < kCP; ++ci)
          if (ci < cin) v[ci] = src[ci];
      }
      *reinterpret_cast<uint2*>(xt + p * kCP) = *reinterpret_cast<const uint2*>(v);
    }
    __syncthreads();  // the only block-wide barrier of a tile

    for (int chunk = 0; chunk < nchunks; ++chunk) {
      if (nchunks > 1) load_weights(chunk);
      const int nc = min(kNC, cout - chunk * kNC);
      for (int mt = warp; mt < kMTiles; mt += kTCWarps) {
        const int r = mt / (kTCW / 16), c0 = (mt % (kTCW / 16)) * 16;
        const __nv_bfloat16* px = xt + (r * kHaloW + c0 + g) * kCP;  // row g; row g + 8 is 8 pixels on
        float acc[kNT][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t a[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int o = aoff[ks][half];
            a[2 * half] = o >= 0 ? *reinterpret_cast<const uint32_t*>(px + o) : 0u;
            a[2 * half + 1] = o >= 0 ? *reinterpret_cast<const uint32_t*>(px + 8 * kCP + o) : 0u;
          }
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_bf16(acc[j], a, bfr[ks][j][0], bfr[ks][j][1]);
        }
        // the m-tile + bias, rounded once, staged in the warp's slot
        __syncwarp();  // the warp's stores of its previous m-tile have read the slot
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          *reinterpret_cast<uint32_t*>(yw + g * kYS + j * 8 + 2 * t) =
              pack_bf16(acc[j][0] + bia[j][0], acc[j][1] + bia[j][1]);
          *reinterpret_cast<uint32_t*>(yw + (g + 8) * kYS + j * 8 + 2 * t) =
              pack_bf16(acc[j][2] + bia[j][0], acc[j][3] + bia[j][1]);
        }
        __syncwarp();
        // 16 pixels of one output row, contiguous in NHWC: 16-byte stores
        const int64_t hh = h0 + r;
        const int64_t wc = w0 + c0;  // the m-tile's first column
        __nv_bfloat16* yrow = y + ((img + hh) * W + wc) * cout + chunk * kNC;
        if (hh < H) {
          if (nc == kNC && cout % 8 == 0) {
#pragma unroll
            for (int i = 0; i < 16 * kNC / 8 / 32; ++i) {
              const int e = lane + 32 * i, px16 = e / (kNC / 8), v = e % (kNC / 8);
              if (wc + px16 < W)
                *reinterpret_cast<uint4*>(yrow + (int64_t)px16 * cout + v * 8) =
                    *reinterpret_cast<const uint4*>(yw + px16 * kYS + v * 8);
            }
          } else {
            for (int e = lane; e < 16 * nc; e += 32) {
              const int px16 = e / nc, o = e % nc;
              if (wc + px16 < W) yrow[(int64_t)px16 * cout + o] = yw[px16 * kYS + o];
            }
          }
        }
      }
    }
  }
}

int launch_mma(const void* x, const float* w, const float* bias, void* y, int64_t B, int64_t H, int64_t W,
               int cin, int cout, cudaStream_t stream) {
  const int64_t tiles_h = (H + kTCH - 1) / kTCH, tiles_w = (W + kTCW - 1) / kTCW;
  const int64_t ntiles = B * tiles_h * tiles_w;
  if (ntiles > 0) {
    // one wave of persistent blocks: SMs x resident blocks, found once per device
    static int64_t waves[64] = {0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    int64_t wave = dev < 64 ? waves[dev] : 0;
    if (wave == 0) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv1_mma_kernel, kTCThreads, 0);
      if (err != cudaSuccess) return (int)err;
      wave = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
      if (dev < 64) waves[dev] = wave;
    }
    const unsigned int grid = (unsigned int)(ntiles < wave ? ntiles : wave);
    conv1_mma_kernel<<<grid, kTCThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(x), w, bias,
                                                       static_cast<__nv_bfloat16*>(y), H, W, cin, cout,
                                                       tiles_h, tiles_w, ntiles);
  }
  return (int)cudaGetLastError();
}

// ---- float32: the CUDA cores ----

constexpr int kThreads = 256;
constexpr int kTH = 16;  // output rows of a tile
constexpr int kTW = 32;  // output columns of a tile
constexpr int kP = 4;    // pixels of a thread's run along W
constexpr int kG = 8;    // output channels of a thread's group
constexpr int kMaxCin = 4;
constexpr int kMaxCout = 128;

// kG results of one pixel to NHWC memory; `full` when all kG channels
// exist and the address is 16-byte aligned (C_out % 8 == 0)
__device__ __forceinline__ void store_group(float* dst, const float* v, int n, bool full) {
  if (full) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int g = 0; g < n; ++g) dst[g] = v[g];
  }
}

template <int CIN>
__global__ void __launch_bounds__(kThreads)
conv1_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
             float* __restrict__ y, int64_t H, int64_t W, int cout, int tiles_h, int tiles_w) {
  __shared__ float xs[(kTH + 2) * (kTW + 2) * CIN];
  __shared__ __align__(16) float ws[9 * CIN * kMaxCout];
  __shared__ float bs[kMaxCout];

  const int ngroups = (cout + kG - 1) / kG;
  const int coutp = ngroups * kG;  // weights zero-padded to whole groups
  // grid.x = B * tiles_h * tiles_w, the image slowest
  const int64_t b = blockIdx.x / ((int64_t)tiles_h * tiles_w);
  const int rest = (int)(blockIdx.x % ((int64_t)tiles_h * tiles_w));
  const int64_t h0 = (int64_t)(rest / tiles_w) * kTH;
  const int64_t w0 = (int64_t)(rest % tiles_w) * kTW;

  // weights, HWIO f32 [(kh*3+kw)*CIN+ci][cout] -> ws[..][coutp]
  for (int e = threadIdx.x; e < 9 * CIN * coutp; e += kThreads) {
    const int k = e / coutp, o = e % coutp;
    ws[e] = o < cout ? w[k * cout + o] : 0.0f;
  }
  for (int o = threadIdx.x; o < coutp; o += kThreads) bs[o] = o < cout ? bias[o] : 0.0f;
  // the input tile with its halo, [r][c][ci]; a tile row is contiguous in
  // NHWC memory, so consecutive threads read consecutive elements
  constexpr int kRowLen = (kTW + 2) * CIN;
  for (int e = threadIdx.x; e < (kTH + 2) * kRowLen; e += kThreads) {
    const int r = e / kRowLen, rem = e % kRowLen;
    const int64_t hh = h0 - 1 + r, ww = w0 - 1 + rem / CIN;
    float v = 0.0f;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W) v = x[((b * H + hh) * W + ww) * CIN + rem % CIN];
    xs[e] = v;
  }
  __syncthreads();

  const int nslots = kThreads / ngroups;
  const int cg = threadIdx.x % ngroups;
  const int slot = threadIdx.x / ngroups;
  if (slot >= nslots) return;  // when kThreads % ngroups != 0
  constexpr int kRunsPerRow = kTW / kP;
  const int nvalid = min(kG, cout - cg * kG);
  const bool full = (cout % kG) == 0;

  for (int run = slot; run < kTH * kRunsPerRow; run += nslots) {
    const int r = run / kRunsPerRow;
    const int c0 = (run % kRunsPerRow) * kP;
    const int64_t hh = h0 + r;
    if (hh >= H || w0 + c0 >= W) continue;
    float acc[kP][kG];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[p][g] = 0.0f;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        float xv[kP + 2];
#pragma unroll
        for (int q = 0; q < kP + 2; ++q) xv[q] = xs[((r + kh) * (kTW + 2) + c0 + q) * CIN + ci];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4* wp =
              reinterpret_cast<const float4*>(&ws[((kh * 3 + kw) * CIN + ci) * coutp + cg * kG]);
          const float4 wa = wp[0], wb = wp[1];
          const float wv[kG] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < kP; ++p)
#pragma unroll
            for (int g = 0; g < kG; ++g) acc[p][g] = fmaf(xv[p + kw], wv[g], acc[p][g]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int64_t ww = w0 + c0 + p;
      if (ww >= W) break;
      float v[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) v[g] = acc[p][g] + bs[cg * kG + g];
      store_group(y + ((b * H + hh) * W + ww) * cout + cg * kG, v, nvalid, full);
    }
  }
}

template <int CIN>
int launch(const void* x, const float* w, const float* bias, void* y, int64_t B, int64_t H,
           int64_t W, int cout, cudaStream_t stream) {
  const int64_t tiles_h = (H + kTH - 1) / kTH, tiles_w = (W + kTW - 1) / kTW;
  if (B > 0 && H > 0 && W > 0) {  // the wrapper keeps B * tiles_h * tiles_w < 2^31 (ops/conv1.py:plan)
    conv1_kernel<CIN><<<(unsigned int)(B * tiles_h * tiles_w), kThreads, 0, stream>>>(
        static_cast<const float*>(x), w, bias, static_cast<float*>(y), H, W, cout, (int)tiles_h, (int)tiles_w);
  }
  return (int)cudaGetLastError();
}

int launch_f32(const void* x, const float* w, const float* bias, void* y, int64_t B, int64_t H,
               int64_t W, int cin, int cout, cudaStream_t s) {
  switch (cin) {
    case 1: return launch<1>(x, w, bias, y, B, H, W, cout, s);
    case 2: return launch<2>(x, w, bias, y, B, H, W, cout, s);
    case 3: return launch<3>(x, w, bias, y, B, H, W, cout, s);
    case 4: return launch<4>(x, w, bias, y, B, H, W, cout, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int conv1_fwd(const void* x, const void* w, const void* bias, void* y, int64_t B,
                         int64_t H, int64_t W, int cin, int cout, int dtype, void* stream) {
  if (cin < 1 || cin > kMaxCin || cout < 1 || cout > kMaxCout) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == 0) return launch_f32(x, wf, bf, y, B, H, W, cin, cout, s);
  if (dtype == 1) return launch_mma(x, wf, bf, y, B, H, W, cin, cout, s);
  return (int)cudaErrorInvalidValue;
}
