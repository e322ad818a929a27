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
// in f32: the 9*C_in products are summed with fmaf in the fixed order
// (kh, ci, kw), the bias is added last, and the result is rounded once to
// the output dtype.  Weights and bias arrive as f32 (the wrapper rounds the
// weights to the input dtype first, as the plain version does).
//
// What bounds it: the output.  At (64, 224, 224, 3) -> 64 bf16 it reads
// 19.3 MB and writes 411 MB (0.128 ms at 3.35 TB/s), and its 5.5 G FMAs
// take 0.166 ms at the 67 TFLOP/s f32 rate of the CUDA cores, so on the
// CUDA cores the arithmetic is the bound.  The design keeps the FMA units
// fed and the stores coalesced:
//   - a block owns a kTH x kTW tile of output pixels of one image and
//     stages the tile plus its one-pixel halo (zeros outside the image) in
//     shared memory as f32, and all 9*C_in*C_out weights and the bias;
//   - a thread owns a run of kP neighbouring pixels of one row and a group
//     of kG output channels, so each weight it loads from shared memory
//     serves kP pixels and each input value serves kG channels;
//   - neighbouring threads hold neighbouring channel groups of one pixel,
//     so a warp's 16-byte (bf16) or 32-byte (f32) stores cover whole
//     runs of the NHWC output;
//   - offsets are 64-bit; B, H and W are arbitrary (edge tiles mask).
//
// C interface for ctypes: the entry returns cudaGetLastError() after the
// launch on the caller's stream; dtype 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 16;  // output rows of a tile
constexpr int kTW = 32;  // output columns of a tile
constexpr int kP = 4;    // pixels of a thread's run along W
constexpr int kG = 8;    // output channels of a thread's group
constexpr int kMaxCin = 4;
constexpr int kMaxCout = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

__device__ __forceinline__ void store_group(__nv_bfloat16* dst, const float* v, int n, bool full) {
  if (full) {
    __align__(16) __nv_bfloat162 p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
  } else {
    for (int g = 0; g < n; ++g) dst[g] = __float2bfloat16(v[g]);
  }
}

template <typename T, int CIN>
__global__ void __launch_bounds__(kThreads)
conv1_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
             T* __restrict__ y, int64_t H, int64_t W, int cout, int tiles_w) {
  __shared__ float xs[(kTH + 2) * (kTW + 2) * CIN];
  __shared__ __align__(16) float ws[9 * CIN * kMaxCout];
  __shared__ float bs[kMaxCout];

  const int ngroups = (cout + kG - 1) / kG;
  const int coutp = ngroups * kG;  // weights zero-padded to whole groups
  const int64_t b = blockIdx.y;
  const int64_t h0 = (int64_t)(blockIdx.x / tiles_w) * kTH;
  const int64_t w0 = (int64_t)(blockIdx.x % tiles_w) * kTW;

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
    if (hh >= 0 && hh < H && ww >= 0 && ww < W) v = to_f32(x[((b * H + hh) * W + ww) * CIN + rem % CIN]);
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

template <typename T, int CIN>
int launch(const void* x, const float* w, const float* bias, void* y, int64_t B, int64_t H,
           int64_t W, int cout, cudaStream_t stream) {
  const int64_t tiles_h = (H + kTH - 1) / kTH, tiles_w = (W + kTW - 1) / kTW;
  if (B > 0 && H > 0 && W > 0) {
    const dim3 grid((unsigned int)(tiles_h * tiles_w), (unsigned int)B);
    conv1_kernel<T, CIN><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), w, bias, static_cast<T*>(y), H, W, cout, (int)tiles_w);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cin(const void* x, const float* w, const float* bias, void* y, int64_t B, int64_t H,
               int64_t W, int cin, int cout, cudaStream_t s) {
  switch (cin) {
    case 1: return launch<T, 1>(x, w, bias, y, B, H, W, cout, s);
    case 2: return launch<T, 2>(x, w, bias, y, B, H, W, cout, s);
    case 3: return launch<T, 3>(x, w, bias, y, B, H, W, cout, s);
    case 4: return launch<T, 4>(x, w, bias, y, B, H, W, cout, s);
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
  if (dtype == 0) return launch_cin<float>(x, wf, bf, y, B, H, W, cin, cout, s);
  if (dtype == 1) return launch_cin<__nv_bfloat16>(x, wf, bf, y, B, H, W, cin, cout, s);
  return (int)cudaErrorInvalidValue;
}
