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
// At k = 128 the FP32 FFMAs: 2 * nbr * width * R * C * k flops, 27.7 GFLOP
// there, at least 413 us at 67 TFLOP/s.  Two thread mappings:
//
//   * warp route (k < 32, C a power of two <= 32, R*C <= 256): one warp per
//     (block row, column j).  Lanes run over the R*C products of a block,
//     so each slot's block is read as contiguous, coalesced words; a lane's
//     column c = lane mod C is fixed, so it loads one x value per slot; a
//     shuffle reduction over the C lanes of each row ends the sum.  At
//     k = 1 this packs 8 block rows into a 256-thread CTA instead of
//     launching 8-thread CTAs.
//   * lanes route (everything else, e.g. k = 128): one warp per (block row,
//     32 columns), lanes along j, so x reads coalesce along the row of x;
//     each lane keeps up to 8 rows of the block row in registers, and the
//     block values are warp-uniform (broadcast) loads.
//
// All element offsets are 64-bit: at 256x256x64 the blocks hold ~1.7e9
// elements.  The kernel trusts block_cols < nbc (the rows of x over C).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsA = 8;   // warps per CTA, warp route
constexpr int kMaxT = 8;     // R*C <= 32 * kMaxT on the warp route
constexpr int kWarpsB = 4;   // warps per CTA, lanes route
constexpr int kRB = 8;       // rows per register pass, lanes route

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

bool warp_route(int R, int C, int64_t k) {
  return k < 32 && C > 0 && C <= 32 && (C & (C - 1)) == 0 &&
         R * C <= 32 * kMaxT;
}

template <typename T>
int launch(const int32_t* bcols, const void* blocks, const void* x, void* y,
           int64_t nbr, int width, int R, int C, int64_t k, cudaStream_t st) {
  const T* b = static_cast<const T*>(blocks);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  if (warp_route(R, C, k)) {
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

// 0: the warp route serves (R, C, k); 1: the lanes route.
int bsr_spmm_route(int R, int C, long long k) {
  return warp_route(R, C, k) ? 0 : 1;
}

// y (nbr*R, k) = the block-ELL matrix (block_cols (nbr, width) int32,
// blocks (nbr, width, R, C)) times x (nbc*C, k); f64: blocks, x and y are
// double, else float.  All row-major and contiguous.  Returns
// cudaGetLastError() after the launch (0 with nothing to launch).
int bsr_spmm_launch(const void* block_cols, const void* blocks, const void* x,
                    void* y, int f64, long long nbr, int width, int R, int C,
                    long long k, void* stream) {
  if (nbr < 0 || width <= 0 || R <= 0 || C <= 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t warps = warp_route(R, C, k) ? nbr * k / kWarpsA
                                            : nbr * ((k + 31) / 32) / kWarpsB;
  if (warps >= (int64_t{1} << 31) - 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (nbr == 0 || k == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* bc = static_cast<const int32_t*>(block_cols);
  return f64 ? launch<double>(bc, blocks, x, y, nbr, width, R, C, k, st)
             : launch<float>(bc, blocks, x, y, nbr, width, R, C, k, st);
}

}  // extern "C"
