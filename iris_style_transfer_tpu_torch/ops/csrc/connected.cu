// Connected-component labelling of a batch of binary masks by union-find in
// shared-memory tiles, with an optional per-label pixel count.
//
// Replaces the JAX package's iris_style_transfer_tpu/ops/connected.py:
// connected_components, which is not a Pallas kernel but min-label
// propagation inside a lax.while_loop whose convergence test stays on the
// TPU.  PyTorch has no device-side loop, so the card gets this kernel.
//
//   labels[b, y, x] = 0 for background; for a foreground pixel, 1 + the
//   least per-image linear index y * W + x of its component (4- or
//   8-connected), the converged labelling of the JAX loop;
//   areas[b, l] (optional, (B, H * W + 1) int32) = the pixels labelled l,
//   with areas[b, 0] = 0 for the background.
//
// Design: three kernels on one int32 array L (the labels), where a
// foreground pixel holds its parent's index + 1 and a root r holds r + 1,
// so that 0 stays background (Playne & Hawick's and Allegretti's block-based
// union-find).
//   tile     : one block labels a TH x TW tile.  It loads the mask tile into
//              shared memory (16 bytes a thread where W % 16 == 0) and takes
//              each row's foreground bits with warp ballots; a row's runs of
//              foreground are joined by construction (a pixel's node is its
//              run's first pixel, found with a count of leading zeros), so a
//              union-find in shared memory joins runs, not pixels.  Warp 0
//              works a row a lane: it unites each pair of runs in adjacent
//              rows that touch, once (atomicMin on local indices), finding
//              them with bit operations on the 64-bit row words, and
//              flattens every run to its root.  Every thread then reads its
//              pixels' roots back and writes each pixel's tile root as its
//              global index + 1 with
//              coalesced stores.  A tile without foreground writes zeros (16
//              bytes a store) and stops.  With areas it
//              also counts the pixels of each tile root in shared memory
//              (one atomic per warp and root, __match_any_sync), writes the
//              count at the root's area entry and 0 at every other pixel's
//              (so the wrapper needs no zeroing pass), and one bit a pixel
//              saying which pixels are tile roots.
//   seam     : only pixels on a tile's first row or first column have
//              neighbours in another tile; each such foreground pixel unites
//              with them in global memory (W, N; under 8-connectivity also
//              NW, NE and SW, the diagonals across tile corners, skipping
//              the unions that another pixel's imply, after Wu, Otoo &
//              Suzuki) by min-root linking with atomicMin and path halving.
//              A tile whose root is linked is marked dirty.  That is about
//              1/TH + 1/TW of the pixels, against every foreground pixel in
//              a union-find without tiles; a seam pixel whose tile has no
//              foreground on
//              that edge (the tile kernel writes a byte a tile that says so)
//              returns after reading that byte.
//   finalize : one block a tile; a tile that no link marked returns at once,
//              its labels already final.  Elsewhere each foreground pixel
//              follows its tile root to the root and stores the label where
//              it changed; with areas, a tile root that was linked adds its
//              count to its root's entry (one atomic per linked tile root, so
//              an all-true 400x640 image sends 129 atomics to one word, not
//              256,000) and zeroes its own.
//
// Why the labels are JAX's, bit for bit: inside one tile the order of two
// pixels by local index ly * TW + lx equals their order by global index
// y * W + x (rows of the tile are rows of the image, and a tile is at most W
// wide), so min-root linking in shared memory makes each tile component's
// root its least global index.  The seam unions then link roots under the
// smaller root, so every pointer goes to a smaller index of the same
// component, and each component's root is its least index.  atomicMin with
// a retry when the root written was linked meanwhile keeps every union; path
// halving only ever lowers a pointer to an ancestor, so it is safe against
// concurrent links.  Loads in seam go through L2 (__ldcg): L1 is not coherent
// across SMs.  In finalize nothing but final labels is written, and every
// value of L, old or new, points to an ancestor, so plain loads are safe.
//
// Tile: 32 x 64 = 2,048 pixels, 256 threads of 8 pixels; a 64-pixel row is
// one 64-bit word of foreground bits.  Shared memory is 8 KB of union-find,
// 2 KB of mask and 256 bytes of row bits a block (of 227 KB), and the kernel
// is held to 32 registers, so 8 blocks of 256 threads fill an SM's 2,048
// threads: an empty tile is a short chain of one load and its stores, and
// only many tiles in flight hide its latency.  A 64-wide row is two warps'
// 128-byte label lines, and W = 640 is 10 tiles wide.  Seams: 1/32 + 1/64 =
// 4.7% of the pixels; the tile rows, where the seam reads are coalesced, are
// the shorter side.  Allegretti's 2x2 block labelling (BUF) is not used: it
// holds under 8-connectivity only, and row runs already cut the nodes of a
// dense tile to its runs.
//
// What bounds it: the bytes are 5 per pixel (the 1-byte mask read, the
// 4-byte label written: 81.9 MB at (64, 400, 640), 0.0245 ms at 3.35 TB/s),
// 9 with areas (the 4-byte count written: 0.0440 ms).  The tile kernel is
// one pass over those bytes; the seam and finalize kernels add the dirty
// tiles' labels read again and rewritten where they changed.
//
// Indices inside an image are int32 (the wrapper keeps H * W + 1 < 2^31);
// the batch offset is 64-bit.  C interface for ctypes: the entry launches
// the three kernels on the caller's stream and returns the first
// cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTH = 32, kTW = 64, kTile = kTH * kTW;
constexpr int kThreads = 256, kPer = kTile / kThreads;  // 8 pixels a thread
constexpr int kWords = kTile / 32;                      // root bits of a tile
constexpr unsigned kAll = 0xffffffffu;
static_assert(kTH == 32 && kTW == 64 && kTile % kThreads == 0, "tile shape: a lane a row, a 64-bit word a row");

// ---- shared memory: local indices, a root holds its own index ----

__device__ __forceinline__ int sfind(volatile int* s, int i) {
  while (true) {
    const int p = s[i];
    if (p == i) return i;
    const int g = s[p];
    if (g == p) return p;
    atomicMin((int*)&s[i], g);  // halve: i skips to its grandparent
    i = g;
  }
}

__device__ __forceinline__ void sunite(volatile int* s, int a, int b) {
  while (true) {
    a = sfind(s, a);
    b = sfind(s, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin((int*)&s[b], a);
    if (old == b) return;  // b was still a root: now linked under a
    b = old;               // b was linked meanwhile; unite a with where it went
  }
}

// ---- global memory: L holds parent index + 1 ----

__device__ __forceinline__ int ld(const int* p) { return __ldcg(p); }

__device__ __forceinline__ int find_halving(int* L, int i) {
  while (true) {
    const int p = ld(L + i) - 1;
    if (p == i) return i;
    const int g = ld(L + p) - 1;
    if (g == p) return p;
    atomicMin(L + i, g + 1);
    i = g;
  }
}

// unite the components of a and b; marks the tile of every root it links
__device__ __forceinline__ void unite(int* L, uint8_t* dirty, int W, int ntx, int a, int b) {
  while (true) {
    a = find_halving(L, a);
    b = find_halving(L, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int by = b / W;
    dirty[(by / kTH) * ntx + (b - by * W) / kTW] = 1;
    const int old = atomicMin(L + b, a + 1) - 1;
    if (old == b) return;
    b = old;
  }
}

struct Tile {
  int64_t b;       // image
  int y0, x0;      // first pixel
  int th, tw;      // pixels inside the image
};

__device__ __forceinline__ Tile tile_of(int64_t tile, int H, int W, int nty, int ntx) {
  const int ntiles = nty * ntx;
  Tile t;
  t.b = tile / ntiles;
  const int k = (int)(tile - t.b * ntiles);
  const int ty = k / ntx, tx = k - ty * ntx;
  t.y0 = ty * kTH;
  t.x0 = tx * kTW;
  t.th = min(kTH, H - t.y0);
  t.tw = min(kTW, W - t.x0);
  return t;
}

// the start (least column) of the run of set bits of row m that holds bit lx
__device__ __forceinline__ int run_start(uint64_t m, int lx) {
  const uint64_t starts = m & ~(m << 1);
  return 63 - __clzll(starts & ((2ull << lx) - 1));
}

__device__ __forceinline__ uint64_t row_bits(const uint32_t* rows, int ly) {
  return rows[2 * ly] | (uint64_t)rows[2 * ly + 1] << 32;
}

__global__ void __launch_bounds__(kThreads, 8) ccl_tile_kernel(const uint8_t* __restrict__ mask, int* __restrict__ L,
                                                          int* __restrict__ areas, uint32_t* __restrict__ rootbits,
                                                          uint8_t* __restrict__ dirty, uint8_t* __restrict__ edge,
                                                          int H, int W, int nty, int ntx, int conn8, int vec) {
  __shared__ int s[kTile];                      // union-find over the runs' first pixels
  __shared__ __align__(16) uint8_t sm[kTile];   // the mask tile
  __shared__ uint32_t rows[2 * kTH];            // each row's foreground bits, two 32-pixel halves
  const int64_t tile = blockIdx.x;
  const Tile t = tile_of(tile, H, W, nty, ntx);
  const int64_t hw = (int64_t)H * W;
  const uint8_t* m = mask + t.b * hw;
  int* Lb = L + t.b * hw;
  int* Ab = areas ? areas + t.b * (hw + 1) + 1 : nullptr;  // Ab[g]: the count of label g + 1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (vec) {  // rows start 16-byte aligned and tw % 16 == 0
    constexpr int chunks = kTW / 16;
    const int ly = tid / chunks, k = tid - ly * chunks;
    if (tid < kTile / 16 && ly < t.th && 16 * k < t.tw)
      *reinterpret_cast<uint4*>(sm + 16 * tid) =
          __ldg(reinterpret_cast<const uint4*>(m + (int64_t)(t.y0 + ly) * W + t.x0 + 16 * k));
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      const int ly = i / kTW, lx = i - ly * kTW;
      if (ly < t.th && lx < t.tw) sm[i] = m[(int64_t)(t.y0 + ly) * W + t.x0 + lx];
    }
  }
  __syncthreads();

  // pixel i = tid + k * kThreads: row 4k + warp / 2, column 32 (warp % 2) + lane
  bool fg[kPer];
  bool any = false;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    const int ly = i / kTW, lx = i - ly * kTW;
    fg[k] = ly < t.th && lx < t.tw && sm[i] != 0;
    const uint32_t bits = __ballot_sync(kAll, fg[k]);
    if (lane == 0) rows[i / 32] = bits;
    any |= fg[k];
  }
  const bool any_fg = __syncthreads_or(any);
  if (tid == 0) {
    dirty[tile] = 0;
    uint32_t col = 0;  // foreground in the tile's first column, where the seams start
    for (int ly = 0; ly < kTH; ++ly) col |= rows[2 * ly];
    edge[tile] = ((rows[0] | rows[1]) != 0) | (col & 1u) << 1;
    if (Ab && t.y0 == 0 && t.x0 == 0) Ab[-1] = 0;  // the background's entry
  }
  if (!any_fg) {  // no foreground: zeros, and nothing to link
    if (vec) {  // label rows 16-byte aligned: 4 labels a store
      constexpr int quads = kTW / 4;
      for (int c = tid; c < t.th * quads; c += kThreads) {
        const int ly = c / quads, lx = 4 * (c - ly * quads);
        if (lx < t.tw) *reinterpret_cast<int4*>(Lb + (t.y0 + ly) * W + t.x0 + lx) = make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      const int ly = i / kTW, lx = i - ly * kTW;
      if (ly < t.th && lx < t.tw) {
        const int g = (t.y0 + ly) * W + t.x0 + lx;
        if (!vec) Lb[g] = 0;
        if (Ab) Ab[g] = 0;  // one int past a 16-byte boundary: scalar stores
      }
    }
    return;
  }

  // Each row's runs of foreground are joined by construction: a pixel's
  // node is its run's first pixel.  Warp 0 then works a row a lane, on the
  // rows' 64-bit words: lane ly makes its runs' nodes, then unites each run
  // with the runs of row ly - 1 that touch it, one union a pair: under
  // 4-connectivity at the run's first pixel for the run over it and at each
  // pixel where a run above starts; under 8 also across the corners, at the
  // run's first pixel for the run that covers its NW or N pixel and at each
  // pixel whose NE starts a run.  Then every run flattens to its root.  The
  // other warps only wait: the per-pixel work is reading the roots back.
  if (warp == 0) {
    const int ly = lane;
    const uint64_t row = row_bits(rows, ly);
    const uint64_t starts = row & ~(row << 1);
    for (uint64_t left = starts; left; left &= left - 1) {
      const int i = ly * kTW + __ffsll(left) - 1;
      s[i] = i;
    }
    __syncwarp();
    if (ly > 0) {
      const uint64_t up = row_bits(rows, ly - 1);
      const int here = ly * kTW, above = (ly - 1) * kTW;
      if (!conn8) {
        for (uint64_t left = row & up & (starts | ~(up << 1)); left; left &= left - 1) {
          const int lx = __ffsll(left) - 1;
          sunite(s, here + run_start(row, lx), above + run_start(up, lx));
        }
      } else {
        for (uint64_t left = starts & (up | up << 1); left; left &= left - 1) {
          const int lx = __ffsll(left) - 1;
          sunite(s, here + lx, above + run_start(up, lx > 0 && (up >> (lx - 1) & 1) ? lx - 1 : lx));
        }
        for (uint64_t left = row & (up >> 1) & ~up; left; left &= left - 1) {
          const int lx = __ffsll(left) - 1;
          sunite(s, here + run_start(row, lx), above + lx + 1);
        }
      }
    }
    __syncwarp();
    for (uint64_t left = starts; left; left &= left - 1) {
      const int i = ly * kTW + __ffsll(left) - 1;
      int r = s[i];
      while (s[r] != r) r = s[r];
      s[i] = r;
    }
  }
  __syncthreads();

  int root[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    const int ly0 = i / kTW;
    // flat: a run's first pixel points at its root
    const int r = fg[k] ? s[ly0 * kTW + run_start(row_bits(rows, ly0), i - ly0 * kTW)] : i;
    root[k] = r;
    const int ly = i / kTW, lx = i - ly * kTW;
    if (ly < t.th && lx < t.tw) {
      const int ry = r / kTW;
      Lb[(t.y0 + ly) * W + t.x0 + lx] = fg[k] ? (t.y0 + ry) * W + t.x0 + (r - ry * kTW) + 1 : 0;
    }
  }
  if (!Ab) return;

  // the pixels of each tile root, counted in shared memory
  __syncthreads();  // every read of s above is done before s turns into counts
#pragma unroll
  for (int k = 0; k < kPer; ++k) s[tid + k * kThreads] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const unsigned act = __ballot_sync(kAll, fg[k]);
    if (fg[k]) {
      const unsigned peers = __match_any_sync(act, root[k]);
      if (lane == __ffs(peers) - 1) atomicAdd(&s[root[k]], __popc(peers));
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    const bool is_root = fg[k] && root[k] == i;
    const unsigned bits = __ballot_sync(kAll, is_root);
    if (lane == 0) rootbits[tile * kWords + k * (kThreads / 32) + warp] = bits;
    const int ly = i / kTW, lx = i - ly * kTW;
    if (ly < t.th && lx < t.tw) Ab[(t.y0 + ly) * W + t.x0 + lx] = is_root ? s[i] : 0;
  }
}

// one thread a seam pixel: the tiles' first rows (y = TH, 2 TH, ...; every
// x), then their first columns (x = TW, 2 TW, ...; every y off those rows);
// a pixel whose tile has no foreground on that edge returns at once
__device__ __forceinline__ void seam_pixel(int* L, uint8_t* __restrict__ dirty, const uint8_t* __restrict__ edge,
                                           int64_t b, int j, int H, int W, int nty, int ntx, int conn8) {
  const int row_pixels = (nty - 1) * W;
  const uint8_t* eb = edge + b * (int64_t)nty * ntx;
  int y, x;
  if (j < row_pixels) {
    y = (j / W + 1) * kTH;
    x = j - (j / W) * W;
    if (!(eb[(y / kTH) * ntx + x / kTW] & 1)) return;
  } else {
    j -= row_pixels;
    x = (j / H + 1) * kTW;
    y = j - (j / H) * H;
    if (y % kTH == 0 && y > 0) return;  // a corner: the row part has it
    if (!(eb[(y / kTH) * ntx + x / kTW] & 2)) return;
  }
  int* Lb = L + b * (int64_t)H * W;
  uint8_t* db = dirty + b * (int64_t)nty * ntx;
  const int i = y * W + x;
  if (!ld(Lb + i)) return;
  const bool first_row = y % kTH == 0 && y > 0, first_col = x % kTW == 0 && x > 0;
  int to[4], n = 0;  // the neighbours in other tiles to unite with
  if (!conn8) {
    if (first_col && ld(Lb + i - 1)) to[n++] = i - 1;
    if (first_row && ld(Lb + i - W)) to[n++] = i - W;
  } else {
    if (first_row) {
      if (ld(Lb + i - W)) {  // NW and NE touch N, and N is joined to them
        to[n++] = i - W;
      } else {
        if (x > 0 && ld(Lb + i - W - 1)) to[n++] = i - W - 1;
        if (x + 1 < W && ld(Lb + i - W + 1)) to[n++] = i - W + 1;
      }
    }
    if (first_col) {
      if (ld(Lb + i - 1)) {  // NW and SW touch W, and W is joined to them
        to[n++] = i - 1;
      } else {
        if (!first_row && y > 0 && ld(Lb + i - W - 1)) to[n++] = i - W - 1;
        if (y + 1 < H && ld(Lb + i + W - 1)) to[n++] = i + W - 1;
      }
    }
  }
#pragma unroll 1
  for (int k = 0; k < n; ++k) unite(Lb, db, W, ntx, i, to[k]);
}

// a thread a seam pixel of an image: x of the grid over the pixels, y over
// the images (a stride of gridDim.y past 65,535 of them)
__global__ void ccl_seam_kernel(int* L, uint8_t* __restrict__ dirty, const uint8_t* __restrict__ edge, int64_t B,
                                int per_image, int H, int W, int nty, int ntx, int conn8) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= per_image) return;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) seam_pixel(L, dirty, edge, b, j, H, W, nty, ntx, conn8);
}

__global__ void __launch_bounds__(kThreads) ccl_finalize_kernel(int* L, int* __restrict__ areas,
                                                              const uint32_t* __restrict__ rootbits,
                                                              const uint8_t* __restrict__ dirty, int H, int W,
                                                              int nty, int ntx) {
  const int64_t tile = blockIdx.x;
  if (!dirty[tile]) return;
  const Tile t = tile_of(tile, H, W, nty, ntx);
  const int64_t hw = (int64_t)H * W;
  int* Lb = L + t.b * hw;
  int* Ab = areas ? areas + t.b * (hw + 1) + 1 : nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t bits = Ab ? rootbits[tile * kWords + k * (kThreads / 32) + warp] : 0u;
    const int i = tid + k * kThreads;
    const int ly = i / kTW, lx = i - ly * kTW;
    if (ly >= t.th || lx >= t.tw) continue;
    const int g = (t.y0 + ly) * W + t.x0 + lx;
    const int v = Lb[g];
    if (v == 0) continue;
    int r = v - 1;
    for (int p = Lb[r] - 1; p != r; p = Lb[r] - 1) r = p;
    if (r != v - 1) Lb[g] = r + 1;
    if ((bits >> lane & 1u) && r != g) {  // a tile root that a seam linked: its count moves to the root
      atomicAdd(Ab + r, Ab[g]);
      Ab[g] = 0;
    }
  }
}

}  // namespace

extern "C" int connected_components(const void* mask, void* labels, void* areas, void* rootbits, void* flags,
                                    int64_t B, int64_t H, int64_t W, int conn8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = (int)H, w = (int)W;
  const int nty = (h + kTH - 1) / kTH, ntx = (w + kTW - 1) / kTW;
  const int64_t tiles = B * nty * ntx;
  const int per_image = (nty - 1) * w + (ntx - 1) * h;  // below H * W
  const int vec = w % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  int* L = static_cast<int*>(labels);
  int* A = static_cast<int*>(areas);
  uint32_t* R = static_cast<uint32_t*>(rootbits);
  uint8_t* dirty = static_cast<uint8_t*>(flags);  // a byte a tile: a seam linked one of its roots
  uint8_t* edge = dirty + tiles;                  // a byte a tile: foreground on its first row (1), column (2)
  ccl_tile_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(static_cast<const uint8_t*>(mask), L, A, R, dirty, edge, h, w,
                                                       nty, ntx, conn8, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // at least one block, so that every call launches all three kernels
  const dim3 seam_grid(std::max(1, (per_image + kThreads - 1) / kThreads), (unsigned)std::min<int64_t>(B, 65535));
  ccl_seam_kernel<<<seam_grid, kThreads, 0, s>>>(L, dirty, edge, B, per_image, h, w, nty, ntx, conn8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ccl_finalize_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(L, A, R, dirty, h, w, nty, ntx);
  return (int)cudaGetLastError();
}
