// Blockwise Gram matrix of NHWC features: G[b] = X_b^T X_b / n, X_b the
// (H*W, C) pixels-by-channels matrix of image b, in float32.
//
// Replaces the TPU kernel ops/pallas_gram.py:gram_matrix_pallas
// (_gram_kernel) of the JAX package: the Gram-loss NST's style taps
// relu{1..4}_1, as the targets and in every closure.  Its VJP is a plain
// batched matmul, outside the kernel, as in the JAX package.
//
// What bounds it: device memory.  At (4, 512, 512, 64) bf16 the contraction
// is 8.6 GFLOP over a 134 MB read: 0.009 ms on the bf16 tensor cores
// against 0.040 ms for the bytes at 3.35 TB/s.  Only at C = 512 do the
// operations come near the bytes.
//
// Two kernels; which one runs is decided before launch, by dtype, shape and
// alignment alone (ops/blockwise_gram.py:plan):
//
// gram_tc_kernel (bfloat16, C % 8 == 0, x 16-byte aligned; every main path).
//   - A work item is (image, output tile pair ti <= tj, HW split).  The
//     output tile is 64 * WG channels square: WG = 1 consumer warpgroup for
//     C <= 64, else 2, each owning 64 rows of the tile.  Only upper-
//     triangle tiles are computed (and on a diagonal 128-tile, not its
//     lower-left 64 x 64 block); an off-diagonal tile is stored and
//     mirrored, a diagonal tile's upper triangle too, so G is exactly
//     symmetric.
//   - Both operands are the same (pixels x 64 channels) slabs, channels
//     contiguous, as TMA copies them from the NHWC features with the
//     128-byte swizzle: A = X^T is M-major, B = X is N-major, and wgmma
//     reads both transposed (MN-major) from shared-memory descriptors, so
//     there is no transpose pass.  A diagonal tile loads only A and reads
//     it as B too.
//   - One producer warp keeps TMA loads in flight through a ring of six
//     32 KB stages (128 pixels at WG = 1, 64 at WG = 2), each with a full
//     and an empty mbarrier.  TMA zero-fills pixels past HW and channels
//     past C.
//   - The product of two bf16 values is exact in f32, so wgmma with f32
//     accumulation computes the same function as f32 FMAs; only the sums
//     differ.  The tensor cores' own f32 accumulation rounds worse than
//     IEEE adds over a long chain (1.4e-5 of max|G| over 504 wgmma at
//     512 px, over the 1e-5 bound), so a stage is two chains of 4
//     m64n64k16, each into a fresh register tile that round-to-nearest
//     adds fold into the item's sums while the next chain runs.
//   - Blocks are persistent, one per SM, and walk the items with the tile
//     pair fastest, so blocks in flight together read the same pixel range
//     and the re-reads of a slab by other tile pairs come from L2.
// gram_fma_kernel (float32, and bfloat16 with C % 8 != 0 or x unaligned):
//   the CUDA cores.  A block stages 32 pixels x 64 channels of both column
//   slabs as f32 and each of its 256 threads keeps a 4 x 4 register tile of
//   fmaf sums; one block per work item.
//
// The reduction over splits is a second launch, gram_reduce_kernel: each
// split writes its (C, C) partial to an (S, B, C, C) workspace, and the
// reduction sums the S partials in split order and divides by n: ordered,
// with no float atomics, so a run repeats itself bit for bit.  With one
// split the tensor-core kernel writes G / n itself and nothing else runs
// (at (64, 512, 28, 28) the partials are 67 MB, more than the input).  A
// block that completes an (image, tile pair) last and sums its partials
// was tried: one block's chain of L2 loads took longer than the launch.
// Offsets are 64-bit and the work is a 1-D list of items, so there is no
// batch limit: (64, 224, 224, 64) holds 205 M elements, and B = 70,000 is
// one item per image and tile pair.
//
// C interface for ctypes: the entry returns cudaGetLastError() after its
// launches on the caller's stream (or a negative code when the TMA tensor
// map cannot be made); dtype 0 = float32, 1 = bfloat16; wg 0 = the FMA
// kernel, 1 or 2 = the tensor-core kernel with that many warpgroups.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the FMA and reduce kernels' block

// (image, tile pair, split) of a work item: the tile pair fastest, then the
// split; pair p counts the upper triangle row by row
struct Item {
  int64_t b;
  int ti, tj, split;
};

__device__ __forceinline__ Item decode(int64_t item, int pairs, int S, int n_tiles) {
  Item it;
  int pair = (int)(item % pairs);
  const int64_t rest = item / pairs;
  it.split = (int)(rest % S);
  it.b = rest / S;
  int ti = 0;
  while (pair >= n_tiles - ti) {
    pair -= n_tiles - ti;
    ++ti;
  }
  it.ti = ti;
  it.tj = ti + pair;
  return it;
}

// ---- the CUDA cores: float32, and bfloat16 that TMA cannot read ----

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// one block per work item; ws is (S, B, C, C)
template <typename T>
__global__ void __launch_bounds__(kThreads) gram_fma_kernel(const T* __restrict__ x,
                                                            float* __restrict__ ws, int64_t B,
                                                            int64_t HW, int C, int n_tiles,
                                                            int pairs, int S, int64_t chunk) {
  __shared__ __align__(16) float As[kK][kTile];
  __shared__ __align__(16) float Bs[kK][kTile];
  const Item it = decode(blockIdx.x, pairs, S, n_tiles);
  const bool diag = it.ti == it.tj;
  const int i0 = it.ti * kTile, j0 = it.tj * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const int64_t p0 = (int64_t)it.split * chunk;
  const int64_t p1 = p0 + chunk < HW ? p0 + chunk : HW;
  const int64_t base = it.b * HW;
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

  float* out = ws + ((int64_t)it.split * B + it.b) * C * C;
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

// ---- the tensor cores: bfloat16 through TMA and wgmma ----

constexpr int kRingBytes = 192 * 1024;

template <int WG>
struct TC {
  static constexpr int kTileC = 64 * WG;                    // output tile edge
  static constexpr int kStepPx = 128 / WG;                  // pixels of a stage
  static constexpr int kSlabBytes = kStepPx * 128;          // one TMA box: kStepPx pixels x 64 bf16 channels
  static constexpr int kStageBytes = 2 * WG * kSlabBytes;   // A's slabs, then B's: 32 KB
  static constexpr int kStages = kRingBytes / kStageBytes;  // 6
  static constexpr int kChainK = 4;                         // k16 steps of a chain
  static constexpr int kThreads = 128 * WG + 32;            // consumers, then the producer warp
  static constexpr int kSmem = kRingBytes + 1024 + 2 * kStages * 8;  // + 1 KB alignment + barriers
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one (pixels x 64 channels) box of image b at (channel c, pixel p)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c,
                                         int p, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, "
      "%5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(p), "r"(b)
      : "memory");
}

// wgmma's shared-memory descriptor of a 64-wide MN-major bf16 operand in
// the 128-byte swizzle: 8-pixel groups of 128-byte rows 1024 B apart (SBO;
// one 64-channel slab, so the LBO is never stepped); addr 1024-byte aligned
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// D (64 x 64, f32) = A (64 x 16) B (16 x 64) + (accumulate ? D : 0), both
// operands bf16 MN-major in shared memory
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a chain of kChainK wgmma into d, from 16-pixel (2048-byte) steps of the
// operands at a and b; skipped (an empty group) when `skip`
template <int WG>
__device__ __forceinline__ void chain(float (&d)[32], uint32_t a, uint32_t b, bool skip) {
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  if (!skip) {
#pragma unroll
    for (int k = 0; k < TC<WG>::kChainK; ++k) mma(d, smem_desc(a + k * 2048), smem_desc(b + k * 2048), k > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// acc[o ..] += d in round-to-nearest f32, once d's chain has completed
template <int N>
__device__ __forceinline__ void fold(float (&acc)[N], float (&d)[32], int o) {
  fence_acc(d);
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[o + r] = __fadd_rn(acc[o + r], d[r]);
}

// persistent blocks, one per SM; ws is (S, B, C, C)
template <int WG>
__global__ void __launch_bounds__(TC<WG>::kThreads, 1)
    gram_tc_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ ws, float* __restrict__ g,
                   int64_t B, int64_t HW, int C, int n_tiles, int pairs, int S, int64_t chunk, int64_t n_items,
                   float n) {
  using P = TC<WG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = ring + kRingBytes;      // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * P::kStages;  // empty[s] at empty0 + 8 s
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);             // the producer's arrive + the TMA bytes
      mbar_init(empty0 + 8 * s, 4 * WG);       // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WG) {
    // producer: one thread starts every copy
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Item it = decode(item, pairs, S, n_tiles);
      const bool diag = it.ti == it.tj;
      const int64_t p0 = (int64_t)it.split * chunk;
      const int64_t p1 = p0 + chunk < HW ? p0 + chunk : HW;
      const uint32_t bytes = (diag ? 1 : 2) * WG * P::kSlabBytes;
      for (int64_t p = p0; p < p1; p += P::kStepPx) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t a = ring + stage * P::kStageBytes;
        mbar_expect_tx(full, bytes);
#pragma unroll
        for (int q = 0; q < WG; ++q) {
          tma_load(a + q * P::kSlabBytes, &map, full, it.ti * P::kTileC + 64 * q, (int)p, (int)it.b);
          if (!diag)
            tma_load(a + (WG + q) * P::kSlabBytes, &map, full, it.tj * P::kTileC + 64 * q, (int)p,
                     (int)it.b);
        }
        if (++stage == P::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile.
  // Each stage is two chains of 4 wgmma, each into a fresh 64 x 64 register
  // tile (x, then y), which round-to-nearest f32 adds fold into the item's
  // acc once the chain completes: the tensor cores' own accumulation over
  // long chains rounds worse than the 1e-5 * max|G| bound allows (1.4e-5 at
  // 512 px over 504 wgmma).  WG = 1: the chains are the stage's two halves
  // of pixels; WG = 2: its two 64-column halves.  x's chain is folded while
  // y's runs, and y's while the next stage's x runs (wait_group 1), so the
  // adds hide behind the tensor cores; a stage is released when its y is
  // folded.
  const int wg = warp / 4;
  float acc[32 * WG], x[32] = {}, y[32] = {};
  int stage = 0, held = -1;  // held: the stage whose y chain is in flight
  uint32_t phase = 0;
  for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Item it = decode(item, pairs, S, n_tiles);
    const bool diag = it.ti == it.tj;
    const bool skip_x = WG == 2 && diag && wg == 1;  // rows 64-127 x columns 0-63: below the diagonal
    const int64_t p0 = (int64_t)it.split * chunk;
    const int64_t p1 = p0 + chunk < HW ? p0 + chunk : HW;
#pragma unroll
    for (int r = 0; r < 32 * WG; ++r) acc[r] = 0.0f;
    for (int64_t p = p0; p < p1; p += P::kStepPx) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t a = ring + stage * P::kStageBytes;
      const uint32_t aslab = a + wg * P::kSlabBytes;
      const uint32_t bslab = diag ? a : a + WG * P::kSlabBytes;
      constexpr int kHalf = P::kChainK * 2048;  // WG = 1: y's pixels follow x's
      chain<WG>(x, aslab, bslab, skip_x);
      if (held >= 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fold(acc, y, WG == 1 ? 0 : 32);
        if (lane == 0) mbar_arrive(empty0 + 8 * held);
      }
      if (WG == 1) chain<WG>(y, aslab + kHalf, bslab + kHalf, false);
      else chain<WG>(y, aslab, bslab + P::kSlabBytes, false);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (!skip_x) fold(acc, x, 0);
      held = stage;
      if (++stage == P::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fold(acc, y, WG == 1 ? 0 : 32);
    if (lane == 0) mbar_arrive(empty0 + 8 * held);
    held = -1;

    // The store: one split writes G itself, divided by n (as
    // gram_reduce_kernel would), else this split's partial.  m64n64k16's
    // accumulator layout: register 4 v2 + 2 v1 + v0 of half h holds row
    // 16 (warp % 4) + lane / 4 + 8 v1, column 64 h + 8 v2 + 2 (lane % 4) +
    // v0; acc[32 h + r] is register r of half h.
    const bool direct = S == 1;
    float* out = direct ? g + it.b * C * C : ws + ((int64_t)it.split * B + it.b) * C * C;
    const int i_base = it.ti * P::kTileC + 64 * wg + 16 * (warp % 4) + lane / 4;
    const int j_base = it.tj * P::kTileC + 2 * (lane % 4);
#pragma unroll
    for (int v2 = 0; v2 < 8 * WG; ++v2) {
#pragma unroll
      for (int v1 = 0; v1 < 2; ++v1) {
        const int i = i_base + 8 * v1, j = j_base + 8 * v2;  // j even, C % 8 == 0: j + 1 < C too
        if (i >= C || j >= C) continue;
        float d0 = acc[4 * v2 + 2 * v1], d1 = acc[4 * v2 + 2 * v1 + 1];
        if (direct) {
          d0 = __fdiv_rn(d0, n);
          d1 = __fdiv_rn(d1, n);
        }
        if (!diag) {
          *reinterpret_cast<float2*>(out + (int64_t)i * C + j) = make_float2(d0, d1);
          out[(int64_t)j * C + i] = d0;
          out[(int64_t)(j + 1) * C + i] = d1;
        } else {  // the upper triangle, mirrored
          if (j >= i) {
            out[(int64_t)i * C + j] = d0;
            out[(int64_t)j * C + i] = d0;
          }
          if (j + 1 >= i) {
            out[(int64_t)i * C + j + 1] = d1;
            out[(int64_t)(j + 1) * C + i] = d1;
          }
        }
      }
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kErrNoEncode = -1;       // the CUDA driver library has no cuTensorMapEncodeTiled
constexpr int kErrEncode = -1000;      // minus the CUresult of a refused tensor map

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int WG>
int launch_tc(const void* x, float* ws, float* g, int64_t B, int64_t HW, int64_t C, int n_tiles, int pairs,
              int S, int64_t chunk, int64_t items, int64_t blocks, float n, cudaStream_t stream) {
  using P = TC<WG>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  // (C, HW, B), channels innermost; zeros past HW and C
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)HW, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)(HW * C * 2)};
  const cuuint32_t box[3] = {64, P::kStepPx, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides,
                            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrEncode - (int)r;
  // the shared-memory attribute, once per device
  static bool raised[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(gram_tc_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev] = true;
  }
  gram_tc_kernel<WG><<<(unsigned)blocks, P::kThreads, P::kSmem, stream>>>(
      map, ws, g, B, HW, (int)C, n_tiles, pairs, S, chunk, items, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fma(const void* x, float* ws, int64_t B, int64_t HW, int64_t C, int n_tiles, int pairs, int S,
               int64_t chunk, int64_t items, cudaStream_t stream) {
  gram_fma_kernel<T><<<(unsigned)items, kThreads, 0, stream>>>(static_cast<const T*>(x), ws, B, HW, (int)C,
                                                               n_tiles, pairs, S, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// S splits of `chunk` pixels (a multiple of the kernel's step), `items` =
// B * S * pairs work items on `blocks` blocks, as ops/blockwise_gram.py:plan
// sets them; ws is (S, B, C, C) f32 (unused by the tensor-core kernel at
// S = 1, which writes G itself).  items = 0 (HW = 0) launches only the
// reduction, which then writes 0 / n.
extern "C" int gram(const void* x, void* ws, void* g, int64_t B, int64_t HW, int64_t C, int64_t S,
                    int64_t chunk, int64_t items, int64_t blocks, float n, int dtype, int wg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  float* gf = static_cast<float*>(g);
  if (B <= 0 || C <= 0) return (int)cudaGetLastError();
  const int tile = wg == 0 ? kTile : 64 * wg;
  const int n_tiles = (int)((C + tile - 1) / tile);
  const int pairs = n_tiles * (n_tiles + 1) / 2;
  if (items > 0) {
    int err = 0;
    if (wg == 0 && dtype == 0) err = launch_fma<float>(x, wsf, B, HW, C, n_tiles, pairs, (int)S, chunk, items, st);
    else if (wg == 0 && dtype == 1)
      err = launch_fma<__nv_bfloat16>(x, wsf, B, HW, C, n_tiles, pairs, (int)S, chunk, items, st);
    else if (wg == 1 && dtype == 1)
      err = launch_tc<1>(x, wsf, gf, B, HW, C, n_tiles, pairs, (int)S, chunk, items, blocks, n, st);
    else if (wg == 2 && dtype == 1)
      err = launch_tc<2>(x, wsf, gf, B, HW, C, n_tiles, pairs, (int)S, chunk, items, blocks, n, st);
    else
      return (int)cudaErrorInvalidValue;
    if (err != 0 || (wg > 0 && S == 1)) return err;
  }
  const int64_t BCC = B * C * C;
  gram_reduce_kernel<<<(unsigned)((BCC + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      wsf, gf, items > 0 ? (int)S : 0, BCC, n);
  return (int)cudaGetLastError();
}
