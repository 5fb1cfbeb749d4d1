// Block-sparse (BSR / block-ELL) SpMM for Hopper (sm_90a), float32 or
// float64:
//
//   y[i*R + r, j] = sum_w sum_c blocks[i, w, r, c] * x[block_cols[i, w]*C + c, j]
//
// over block rows i < nbr, slots w < width and the (R, C) block of each
// slot.  Padding slots carry block_cols = 0 and an all-zero block; they are
// computed like any other slot (0 * x, never skipped, so a non-finite x
// gives what the plain version gives).
//
// Replaces the TPU kernel _kernel of eddy_currents_3d_tpu/ops/pallas_sparse.py
// (:39, launched at :73).  There the block columns are a scalar-prefetch
// operand that drives the BlockSpec index map of x, and the output block
// accumulates in VMEM across the sequential width axis of the grid.  Here
// each warp loads its own block row's block_cols, keeps the sum in
// registers over the whole width and writes each output once: no carry
// across blocks of the grid, no atomics, so runs repeat bit for bit.  Sums
// are in the blocks' type with FFMA / DFMA (no TF32, no tensor cores).
//
// What bounds it on an H100: at k = 1 (the matrix-form solve) the blocks'
// bytes, read once: team7's exported operator as (8, 8) blocks is 99,396
// block rows of width 17, 432.6 MB in float32 (445.8 MB with block_cols, x
// and y), at least 133 us at 3.35 TB/s.
// At k = 128 in float32 the FMAs: 2 * nbr * width * R * C * k flops,
// 27.7 GFLOP there, at least 413 us at 67 TFLOP/s (FFMA); the bytes
// (blocks, x and y once: 1.25 GB) need 374 us.  In float64 the bytes:
// 2.50 GB, at least 746 us at 3.35 TB/s; the FMAs need 413 us at 67
// TFLOP/s (the card's float64 peak, on its FP64 tensor cores; the kernel
// runs DFMA, so it cannot reach it, but the bound is the card's).
// Four thread mappings; the wrapper (ops/bsr_cuda.py spmm_route) picks
// one, the launch refuses a route that does not fit the shape:
//
//   * vec route (k = 1, 16-byte blocks, x and y, C a multiple of the
//     16-byte vector's V elements, R*C/V dividing 32): one warp per block
//     row, which is one contiguous span of width*R*C values.  A warp load
//     of 16 bytes a lane covers 32*V/(R*C) slots ((8, 8) float32: two), so
//     lane l always holds vector l mod P of a block (P = R*C/V): one row r
//     and V columns of it, and one sum.  The warp issues every load of a
//     batch of up to kBatch loads a lane before its first FMA: the
//     block_cols, the blocks (streaming loads, so they do not push x out
//     of L2), then the x vectors they select; then FMAs, and a fixed
//     butterfly of shuffles over the lanes that share a row.  At team7 one
//     batch holds the whole row (9 loads a lane).  One warp a CTA measured
//     fastest of 1, 2, 4 and 8 at team7 on an H100 (PERF.md).
//   * warp route (other k < 32, C a power of two <= 32, R*C <= 256): one
//     warp per (block row, column j).  Lanes run over the R*C products of
//     a block, so each slot's block is read as contiguous, coalesced words;
//     a lane's column c = lane mod C is fixed, so it loads one x value per
//     slot; a shuffle reduction over the C lanes of each row ends the sum.
//   * tiles route (k >= 32 with 16-byte rows of x and of a block, R <= 8,
//     R*C <= 256, 16-byte aligned blocks, x and y, and a CTA's shared
//     memory within the SM's 227 KB): a block-row SpMM staged in shared
//     memory, below.  The wrapper sends it block rows of at most 50 slots
//     (100 where a CTA's 128 columns are full), where it measured faster
//     than lanes (PERF.md); wider rows cost it set-up and occupancy.
//   * lanes route (everything else: ragged k, unaligned views, large
//     blocks, wide block rows): one warp per (block row, 32 columns),
//     lanes along j, so x reads coalesce along the row of x; each lane
//     keeps up to 8 rows of the block row in registers, and the block
//     values are warp-uniform (broadcast) loads.
//
// The tiles route.  The lanes route measured 6123 us at team7 and k = 128
// (6.7% of the bound, PERF.md): per slot it issues R*C = 64 warp-uniform
// global loads of block values and C = 8 of x, each x load feeding a
// chain of 8 dependent FMAs, about one load instruction per FMA; four
// warps reload the same block values; and each slot names an x block of
// C rows x k columns (4 KB), so a call moves 1,689,732 slots x 4 KB = 6.9
// GB of x through L2 against 0.41 GB of x in device memory.  Here a CTA
// owns kTileRows (G) consecutive block rows, one warp each, and a chunk
// of up to kChunk = 128 columns:
//   - one bulk copy (cp.async.bulk, TMA without a tensor map) brings the
//     group's blocks, one contiguous span, into shared memory; the block
//     values are then warp-uniform 16-byte shared loads (broadcasts);
//   - the group's block columns are deduplicated in shared memory: x
//     blocks the G rows share (a 7-point stencil's consecutive block rows
//     name mostly the same ones) are fetched once.  team7 names 12.5
//     distinct x blocks a row at G = 1, 7.2 at G = 4 and 6.3 at G = 8
//     (padding slots all name block 0), against 17 slots;
//   - the distinct x blocks, in ascending block column, stream through a
//     ring of two windows of kRingBytes / 2 each, one mbarrier a window:
//     one bulk copy a block where the chunk is all of k (the block is one
//     contiguous span), else one a row of it; the next window's copies
//     are in flight while the warps compute on the current one;
//   - a lane keeps an R x 4 register tile (rows of its block row, 4
//     consecutive columns: 32 f32 or f64 sums at R = 8), reads x from
//     shared memory as 16-byte vectors and multiplies with FFMA (DFMA at
//     float64): per 4 columns of a block (f32), 8 broadcast and 4 lane
//     loads feed 128 FMAs.  No tensor cores and no TF32: the bound above
//     is FFMA's, and TF32 would change what the kernel computes;
//   - each row sums its slots in the order of their x blocks' columns
//     (slot order where the row's block columns ascend, as bsr_from_scipy
//     makes them, but for padding), then c = 0..C-1 in a slot, with no
//     atomics: runs repeat bit for bit.
// G, the ring's bytes and the thread tile were measured at team7, k = 128
// (split_bench.py --spmm-sweep, PERF.md); the source keeps one setting.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsA = 8;   // warps per CTA, warp route
constexpr int kMaxT = 8;     // R*C <= 32 * kMaxT on the warp route
constexpr int kWarpsB = 4;   // warps per CTA, lanes route
constexpr int kRB = 8;       // rows per register pass, lanes route
constexpr int kWarpsV = 1;   // warps per CTA, vec route
constexpr int kBatch = 9;    // loads a lane issues before its FMAs, vec route
enum Route : int { kWarp = 0, kLanes = 1, kVec = 2, kTiles = 3 };

// the tiles route (see the source note)
constexpr int kTileRows = 4;               // G: block rows a CTA, a warp each
constexpr int kRingBytes = 32 * 1024;      // the x ring's stages
constexpr int kStages = 2;                 // windows of x blocks in flight
constexpr int kChunk = 128;                // columns a CTA: 32 lanes x 4
constexpr int kTR = 8;                     // rows a lane's tile holds (R <= 8)
constexpr int kSmemMax = 227 * 1024;       // a CTA's shared memory on sm_90
constexpr int kStaticSmem = 256;           // the tiles kernel's mbarriers

__device__ __forceinline__ float mad(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsA * 32)
bsr_warp_kernel(const int32_t* __restrict__ bcols, const T* __restrict__ blocks,
                const T* __restrict__ x, T* __restrict__ y, int64_t nbr,
                int width, int R, int C, int64_t k) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsA + (threadIdx.x >> 5);
  if (warp >= nbr * k) return;  // warp-uniform
  const int64_t i = warp / k;
  const int64_t j = warp - i * k;
  const int RC = R * C;
  const int nt = (RC + 31) / 32;
  const int c = lane & (C - 1);  // C divides 32: (lane + 32 t) mod C == c
  const int32_t* bc_row = bcols + i * width;
  const T* blk_row = blocks + i * width * RC;

  T acc[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) acc[t] = T(0);

  for (int w0 = 0; w0 < width; w0 += 32) {
    const int n = min(32, width - w0);
    const int bc_l = lane < n ? __ldg(bc_row + w0 + lane) : 0;
#pragma unroll 4
    for (int ww = 0; ww < n; ++ww) {
      const int64_t bc = __shfl_sync(kFull, bc_l, ww);
      const T xv = __ldg(x + (bc * C + c) * k + j);
      const T* blk = blk_row + static_cast<int64_t>(w0 + ww) * RC;
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        const int p = lane + 32 * t;
        if (t < nt && p < RC) acc[t] = mad(__ldg(blk + p), xv, acc[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    if (t < nt) {  // warp-uniform: every lane takes part in the shuffles
      for (int off = C >> 1; off > 0; off >>= 1) {
        acc[t] += __shfl_xor_sync(kFull, acc[t], off);
      }
      const int p = lane + 32 * t;
      if (c == 0 && p < RC) y[(i * R + p / C) * k + j] = acc[t];
    }
  }
}

// the 16-byte vector of T, its products with another summed into acc in
// the vector's order
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float dot(const float4& a,
                                              const float4& b, float acc) {
    acc = mad(a.x, b.x, acc);
    acc = mad(a.y, b.y, acc);
    acc = mad(a.z, b.z, acc);
    return mad(a.w, b.w, acc);
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static __device__ __forceinline__ double2 zero() {
    return make_double2(0.0, 0.0);
  }
  static __device__ __forceinline__ double dot(const double2& a,
                                               const double2& b,
                                               double acc) {
    acc = mad(a.x, b.x, acc);
    return mad(a.y, b.y, acc);
  }
};

// k = 1: warp i owns block row i; see the source note.
template <typename T>
__global__ void __launch_bounds__(kWarpsV * 32)
bsr_vec_kernel(const int32_t* __restrict__ bcols,
               const T* __restrict__ blocks, const T* __restrict__ x,
               T* __restrict__ y, int64_t nbr, int width, int R, int C) {
  using V = typename Vec<T>::type;
  constexpr int VL = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsV + (threadIdx.x >> 5);
  if (i >= nbr) return;  // warp-uniform
  const int CV = C / VL;        // vectors in a row of a block
  const int P = R * CV;         // vectors in a block; divides 32
  const int G = 32 / P;         // slots a warp load covers
  const int g = lane / P;       // the lane's slot within a load
  const int e = lane - g * P;   // the lane's vector within a block
  const int r = e / CV;
  const int cg = e - r * CV;
  const int32_t* bc_row = bcols + i * width;
  const V* span = reinterpret_cast<const V*>(blocks) + i * width * P;
  const V* xv = reinterpret_cast<const V*>(x);
  const int nload = (width + G - 1) / G;

  T acc = T(0);
  for (int t0 = 0; t0 < nload; t0 += kBatch) {
    int col[kBatch];
    V b[kBatch];
    V xs[kBatch];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int w = (t0 + t) * G + g;
      col[t] = w < width ? __ldg(bc_row + w) : 0;
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int w = (t0 + t) * G + g;
      // vector (t0 + t) * 32 + lane of the span is vector e of slot w
      b[t] = w < width ? __ldcs(span + static_cast<int64_t>(t0 + t) * 32 +
                                lane)
                       : Vec<T>::zero();
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int w = (t0 + t) * G + g;
      xs[t] = w < width ? __ldg(xv + static_cast<int64_t>(col[t]) * CV + cg)
                        : Vec<T>::zero();
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) acc = Vec<T>::dot(b[t], xs[t], acc);
  }
  // the lanes of row r: the CV lanes of its columns in each of the G slots
  for (int off = 1; off < CV; off <<= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
  }
  for (int off = P; off < 32; off <<= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
  }
  if (g == 0 && cg == 0) y[i * R + r] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsB * 32)
bsr_lanes_kernel(const int32_t* __restrict__ bcols,
                 const T* __restrict__ blocks, const T* __restrict__ x,
                 T* __restrict__ y, int64_t nbr, int width, int R, int C,
                 int64_t k) {
  const int lane = threadIdx.x & 31;
  const int64_t nchunk = (k + 31) / 32;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsB + (threadIdx.x >> 5);
  if (warp >= nbr * nchunk) return;
  const int64_t i = warp / nchunk;
  const int64_t j = (warp - i * nchunk) * 32 + lane;
  if (j >= k) return;  // no shuffles below
  const int RC = R * C;
  const int32_t* bc_row = bcols + i * width;
  const T* blk_row = blocks + i * width * RC;

  for (int r0 = 0; r0 < R; r0 += kRB) {
    const int nr = min(kRB, R - r0);
    T acc[kRB];
#pragma unroll
    for (int r = 0; r < kRB; ++r) acc[r] = T(0);
    for (int w = 0; w < width; ++w) {
      const int64_t bc = __ldg(bc_row + w);
      const T* blk = blk_row + static_cast<int64_t>(w) * RC + r0 * C;
      const T* xc = x + bc * C * k + j;
      for (int c = 0; c < C; ++c) {
        const T xv = __ldg(xc + c * k);
#pragma unroll
        for (int r = 0; r < kRB; ++r) {
          if (r < nr) acc[r] = mad(__ldg(blk + r * C + c), xv, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      if (r < nr) y[(i * R + r0 + r) * k + j] = acc[r];
    }
  }
}


// ---- the tiles route (see the source note) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` of bulk copies in this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// waits for the phase of parity `parity` to complete; a wait that never
// ends (a fault of the schedule) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// global -> shared, `bytes` a multiple of 16, both addresses 16-byte
// aligned; completes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The tiles kernel's dynamic shared memory, in bytes: the group's block
// columns, their distinct columns' ranks, each row's slots in that order
// and the distinct columns (4 ints an entry), the group's blocks, and
// kStages windows of nw x blocks of C rows x kcmax columns.  nw: as many
// as a stage's share of kRingBytes holds, at least 1, within kSmemMax; 0
// when even one a stage does not fit.
struct TilesShape {
  int nw;
  int64_t bytes;
  int64_t index_bytes;
};

TilesShape tiles_shape(int width, int R, int C, int64_t kcmax, int isz) {
  const int64_t n = static_cast<int64_t>(kTileRows) * width;
  const int64_t index = n * 16;
  const int64_t blk = n * R * C * isz;
  const int64_t xb = C * kcmax * isz;
  int64_t nw = kRingBytes / (kStages * xb);
  const int64_t room =
      (kSmemMax - kStaticSmem - index - blk) / (kStages * xb);
  nw = std::min(std::min(std::max<int64_t>(nw, 1), room), n);
  if (nw < 1) return {0, 0, index};
  return {static_cast<int>(nw), index + blk + kStages * nw * xb, index};
}

// acc[r][q] += blk[r][c] * x[c][4 lane + q] over c = 0..C-1 for one slot:
// bk the slot's (R, C) block, xs its x block (C rows of kc columns) in
// shared memory; on0 (float64: and on1, its second 16 bytes): the lane's 4
// columns lie in the chunk.  A block value feeds 4 FMAs, an x value R.
__device__ __forceinline__ void tile_slot(const float* __restrict__ bk,
                                          const float* __restrict__ xs,
                                          int R, int C, int kc, int lane,
                                          bool on0, bool,
                                          float (&acc)[kTR][4]) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < C; c0 += 4) {
    float4 b[kTR];
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      b[r] = r < R ? *reinterpret_cast<const float4*>(bk + r * C + c0) : z;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 xv =
          on0 ? *reinterpret_cast<const float4*>(xs + (c0 + cc) * kc +
                                                 4 * lane)
              : z;
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const float bv = cc == 0 ? b[r].x : cc == 1 ? b[r].y
                       : cc == 2 ? b[r].z : b[r].w;
        acc[r][0] = mad(bv, xv.x, acc[r][0]);
        acc[r][1] = mad(bv, xv.y, acc[r][1]);
        acc[r][2] = mad(bv, xv.z, acc[r][2]);
        acc[r][3] = mad(bv, xv.w, acc[r][3]);
      }
    }
  }
}

__device__ __forceinline__ void tile_slot(const double* __restrict__ bk,
                                          const double* __restrict__ xs,
                                          int R, int C, int kc, int lane,
                                          bool on0, bool on1,
                                          double (&acc)[kTR][4]) {
  const double2 z = make_double2(0.0, 0.0);
  for (int c0 = 0; c0 < C; c0 += 2) {
    double2 b[kTR];
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      b[r] = r < R ? *reinterpret_cast<const double2*>(bk + r * C + c0) : z;
    }
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const double* row = xs + (c0 + cc) * kc + 4 * lane;
      const double2 x0 = on0 ? *reinterpret_cast<const double2*>(row) : z;
      const double2 x1 = on1 ? *reinterpret_cast<const double2*>(row + 2) : z;
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const double bv = cc == 0 ? b[r].x : b[r].y;
        acc[r][0] = mad(bv, x0.x, acc[r][0]);
        acc[r][1] = mad(bv, x0.y, acc[r][1]);
        acc[r][2] = mad(bv, x1.x, acc[r][2]);
        acc[r][3] = mad(bv, x1.y, acc[r][3]);
      }
    }
  }
}

// a lane's 4 sums of one output row into y (16-byte stores)
__device__ __forceinline__ void store_row(float* p, const float (&a)[4],
                                          bool on0, bool) {
  if (on0) *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_row(double* p, const double (&a)[4],
                                          bool on0, bool on1) {
  if (on0) *reinterpret_cast<double2*>(p) = make_double2(a[0], a[1]);
  if (on1) *reinterpret_cast<double2*>(p + 2) = make_double2(a[2], a[3]);
}

// blockIdx.x: the group of kTileRows block rows from i0, warp g its row
// i0 + g; blockIdx.y: the chunk of columns from j0.  kcmax = min(k,
// kChunk), the ring's row length; nw x blocks a window (tiles_shape).
template <typename T>
__global__ void __launch_bounds__(kTileRows * 32)
bsr_tiles_kernel(const int32_t* __restrict__ bcols,
                 const T* __restrict__ blocks, const T* __restrict__ x,
                 T* __restrict__ y, int64_t nbr, int width, int R, int C,
                 int64_t k, int kcmax, int nw, int index_bytes) {
  constexpr int G = kTileRows;
  constexpr int NT = G * 32;
  constexpr int S = kStages;
  __shared__ uint64_t full[S];   // a stage's x blocks have landed
  __shared__ uint64_t empty[S];  // every warp is done with a stage
  __shared__ uint64_t blk_bar;   // the group's blocks have landed
  __shared__ int n_distinct;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 5;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * G;
  const int gv = nbr - i0 < G ? static_cast<int>(nbr - i0) : G;
  const int nv = gv * width;     // the group's slots, row-major
  const int RC = R * C;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * kChunk;
  const int kc = k - j0 < kChunk ? static_cast<int>(k - j0) : kChunk;
  int* cols = reinterpret_cast<int*>(smem);
  int* xpos = cols + G * width;  // the rank of each slot's column
  int* order = xpos + G * width; // each row's slots by that rank
  int* ucol = order + G * width; // the distinct columns, ascending
  T* blk = reinterpret_cast<T*>(smem + index_bytes);
  T* ring = blk + static_cast<int64_t>(G) * width * RC;
  const int xb = C * kcmax;      // a ring slot's elements

  if (tid == 0) {
    for (int q = 0; q < S; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], G);
    }
    mbar_init(&blk_bar, 1);
    n_distinct = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bytes = static_cast<uint32_t>(nv) * RC * sizeof(T);
    mbar_expect(&blk_bar, bytes);
    bulk_load(blk, blocks + i0 * width * RC, bytes, &blk_bar);
  }
  for (int e = tid; e < nv; e += NT) cols[e] = __ldg(bcols + i0 * width + e);
  __syncthreads();
  // first occurrences of each column (flags in `order` for now) ...
  for (int e = tid; e < nv; e += NT) {
    const int c = cols[e];
    int first = 1;
    for (int f = 0; f < e; ++f) first &= cols[f] != c;
    order[e] = first;
  }
  __syncthreads();
  // ... then each slot's rank among the distinct columns
  for (int e = tid; e < nv; e += NT) {
    const int c = cols[e];
    int rank = 0;
    for (int f = 0; f < nv; ++f) rank += order[f] & (cols[f] < c);
    xpos[e] = rank;
    if (order[e]) {
      ucol[rank] = c;
      atomicAdd(&n_distinct, 1);
    }
  }
  __syncthreads();
  // each row's slots by (rank, slot)
  if (g < gv) {
    const int* xr = xpos + g * width;
    for (int w = lane; w < width; w += 32) {
      const int key = xr[w];
      int rank = 0;
      for (int v = 0; v < width; ++v) {
        rank += xr[v] < key || (xr[v] == key && v < w);
      }
      order[g * width + rank] = w;
    }
  }
  const int nd = n_distinct;
  __syncthreads();

  // window m: distinct columns [m nw, (m + 1) nw) in stage m % S.  Warp 0
  // issues its copies once every warp is done with window m - S (the
  // stage's last use), lane 0 arming the stage's barrier first.
  const int nwin = (nd + nw - 1) / nw;
  const bool whole = kc == k;    // an x block is one contiguous span
  auto issue = [&](int m) {
    const int q = m % S;
    if (m >= S) mbar_wait(&empty[q], ((m - S) / S) & 1);
    const int u0 = m * nw;
    const int nu = min(nw, nd - u0);
    const uint32_t row_bytes = static_cast<uint32_t>(kc) * sizeof(T);
    if (lane == 0) mbar_expect(&full[q], nu * C * row_bytes);
    __syncwarp();
    T* stage = ring + static_cast<int64_t>(q) * nw * xb;
    const int ncopy = whole ? nu : nu * C;
    for (int j = lane; j < ncopy; j += 32) {
      const int u = whole ? j : j / C;
      const int c = whole ? 0 : j - u * C;
      const T* src = x + (static_cast<int64_t>(ucol[u0 + u]) * C + c) * k + j0;
      bulk_load(stage + static_cast<int64_t>(u) * xb + c * kc, src,
                whole ? C * row_bytes : row_bytes, &full[q]);
    }
  };
  if (g == 0) {
    for (int m = 0; m < S - 1 && m < nwin; ++m) issue(m);
  }

  T acc[kTR][4];
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = T(0);
  }
  const bool on0 = 4 * lane < kc;
  const bool on1 = 4 * lane + 2 < kc;   // float64's second 16 bytes
  const int* xr = xpos + g * width;
  const int* ord = order + g * width;
  const T* brow = blk + static_cast<int64_t>(g) * width * RC;
  int p = 0;                     // the row's next slot in `ord`
  for (int m = 0; m < nwin; ++m) {
    if (g == 0 && m + S - 1 < nwin) issue(m + S - 1);
    const int q = m % S;
    mbar_wait(&full[q], (m / S) & 1);
    if (m == 0) mbar_wait(&blk_bar, 0);
    const int u0 = m * nw;
    const T* stage = ring + static_cast<int64_t>(q) * nw * xb;
    if (g < gv) {
      for (; p < width; ++p) {
        const int s = ord[p];
        const int u = xr[s] - u0;
        if (u >= nw) break;
        tile_slot(brow + s * RC, stage + static_cast<int64_t>(u) * xb, R, C,
                  kc, lane, on0, on1, acc);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[q]);
  }
  if (g < gv) {
#pragma unroll
    for (int r = 0; r < kTR; ++r) {
      if (r < R) {
        store_row(y + ((i0 + g) * R + r) * k + j0 + 4 * lane, acc[r], on0,
                  on1);
      }
    }
  }
}

bool warp_route(int R, int C, int64_t k) {
  return k < 32 && C > 0 && C <= 32 && (C & (C - 1)) == 0 &&
         R * C <= 32 * kMaxT;
}

// the vec route takes (R, C) blocks of vl-element vectors at k = 1
bool vec_route(int R, int C, int64_t k, int vl) {
  if (k != 1 || C % vl != 0) return false;
  const int p = R * (C / vl);
  return p > 0 && p <= 32 && 32 % p == 0;
}

// the tiles route takes k >= 32 columns of isz-byte values with 16-byte
// rows of x and of a block, R <= 8 rows, R*C <= 256, where a CTA's shared
// memory fits
bool tiles_route(int width, int R, int C, int64_t k, int isz) {
  return k >= 32 && (k * isz) % 16 == 0 && (C * isz) % 16 == 0 && R <= kTR &&
         R * C <= 256 &&
         tiles_shape(width, R, C, std::min<int64_t>(k, kChunk), isz).nw > 0;
}

template <typename T>
int launch_tiles(const int32_t* bcols, const T* b, const T* x, T* y,
                 int64_t nbr, int width, int R, int C, int64_t k,
                 cudaStream_t st) {
  const int kcmax = static_cast<int>(std::min<int64_t>(k, kChunk));
  const TilesShape s = tiles_shape(width, R, C, kcmax, sizeof(T));
  const auto kern = bsr_tiles_kernel<T>;
  const int bytes = static_cast<int>(s.bytes);
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((nbr + kTileRows - 1) / kTileRows),
                  static_cast<unsigned>((k + kChunk - 1) / kChunk));
  kern<<<grid, kTileRows * 32, bytes, st>>>(
      bcols, b, x, y, nbr, width, R, C, k, kcmax, s.nw,
      static_cast<int>(s.index_bytes));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const int32_t* bcols, const void* blocks, const void* x, void* y,
           int64_t nbr, int width, int R, int C, int64_t k, int route,
           cudaStream_t st) {
  const T* b = static_cast<const T*>(blocks);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  if (route == kTiles) {
    return launch_tiles<T>(bcols, b, xx, yy, nbr, width, R, C, k, st);
  }
  if (route == kVec) {
    const int64_t grid = (nbr + kWarpsV - 1) / kWarpsV;
    bsr_vec_kernel<T><<<static_cast<unsigned>(grid), kWarpsV * 32, 0, st>>>(
        bcols, b, xx, yy, nbr, width, R, C);
  } else if (route == kWarp) {
    const int64_t warps = nbr * k;
    const int64_t grid = (warps + kWarpsA - 1) / kWarpsA;
    bsr_warp_kernel<T><<<static_cast<unsigned>(grid), kWarpsA * 32, 0, st>>>(
        bcols, b, xx, yy, nbr, width, R, C, k);
  } else {
    const int64_t warps = nbr * ((k + 31) / 32);
    const int64_t grid = (warps + kWarpsB - 1) / kWarpsB;
    bsr_lanes_kernel<T><<<static_cast<unsigned>(grid), kWarpsB * 32, 0, st>>>(
        bcols, b, xx, yy, nbr, width, R, C, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (nbr*R, k) = the block-ELL matrix (block_cols (nbr, width) int32,
// blocks (nbr, width, R, C)) times x (nbc*C, k); f64: blocks, x and y are
// double, else float.  All row-major and contiguous.  route: 0 warp, 1
// lanes, 2 vec, 3 tiles (see the source note).  Returns cudaGetLastError()
// after the launch (0 with nothing to launch), or cudaErrorInvalidValue for
// a route that does not take the shape or, on the vec and tiles routes, an
// operand that is not 16-byte aligned.
int bsr_spmm_launch(const void* block_cols, const void* blocks, const void* x,
                    void* y, int f64, long long nbr, int width, int R, int C,
                    long long k, int route, void* stream) {
  if (nbr < 0 || width <= 0 || R <= 0 || C <= 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vl = f64 ? 2 : 4;
  const bool aligned = ((reinterpret_cast<uintptr_t>(blocks) |
                         reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int isz = f64 ? 8 : 4;
  if ((route == kWarp && !warp_route(R, C, k)) ||
      (route == kVec && !(vec_route(R, C, k, vl) && aligned)) ||
      (route == kTiles && !(tiles_route(width, R, C, k, isz) && aligned)) ||
      route < kWarp || route > kTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t ctas = route == kVec     ? nbr / kWarpsV
                       : route == kWarp  ? nbr * k / kWarpsA
                       : route == kTiles ? nbr / kTileRows
                                         : nbr * ((k + 31) / 32) / kWarpsB;
  if (ctas >= (int64_t{1} << 31) - 1 ||
      (route == kTiles && (k + kChunk - 1) / kChunk > 65535)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (nbr == 0 || k == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* bc = static_cast<const int32_t*>(block_cols);
  return f64 ? launch<double>(bc, blocks, x, y, nbr, width, R, C, k, route,
                              st)
             : launch<float>(bc, blocks, x, y, nbr, width, R, C, k, route,
                             st);
}

// The tiles kernel's resources for block rows of `width` (R, C) blocks and
// k columns (f64: double, else float): out[0..4] = registers per thread,
// resident CTAs per SM, dynamic shared memory bytes a CTA, threads a CTA
// and x blocks a window.  Returns a CUDA error code (cudaErrorInvalidValue
// for a shape the route does not take).
int bsr_tiles_info(int f64, int width, int R, int C, long long k, int* out) {
  const int isz = f64 ? 8 : 4;
  if (width <= 0 || R <= 0 || C <= 0 || !tiles_route(width, R, C, k, isz)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TilesShape s =
      tiles_shape(width, R, C, std::min<long long>(k, kChunk), isz);
  const int bytes = static_cast<int>(s.bytes);
  const void* kern = f64 ? reinterpret_cast<const void*>(bsr_tiles_kernel<double>)
                         : reinterpret_cast<const void*>(bsr_tiles_kernel<float>);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  int ctas = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern,
                                                      kTileRows * 32, bytes);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = ctas;
  out[2] = bytes;
  out[3] = kTileRows * 32;
  out[4] = s.nw;
  return 0;
}

}  // extern "C"
