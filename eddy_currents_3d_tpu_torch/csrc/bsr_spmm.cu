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
// there, at least 413 us at 67 TFLOP/s.  Three thread mappings; the
// wrapper (ops/bsr_cuda.py spmm_route) picks one, the launch refuses a
// route that does not fit the shape:
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
//   * lanes route (everything else, e.g. k = 128): one warp per (block row,
//     32 columns), lanes along j, so x reads coalesce along the row of x;
//     each lane keeps up to 8 rows of the block row in registers, and the
//     block values are warp-uniform (broadcast) loads.
//
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsA = 8;   // warps per CTA, warp route
constexpr int kMaxT = 8;     // R*C <= 32 * kMaxT on the warp route
constexpr int kWarpsB = 4;   // warps per CTA, lanes route
constexpr int kRB = 8;       // rows per register pass, lanes route
constexpr int kWarpsV = 1;   // warps per CTA, vec route
constexpr int kBatch = 9;    // loads a lane issues before its FMAs, vec route
enum Route : int { kWarp = 0, kLanes = 1, kVec = 2 };

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

template <typename T>
int launch(const int32_t* bcols, const void* blocks, const void* x, void* y,
           int64_t nbr, int width, int R, int C, int64_t k, int route,
           cudaStream_t st) {
  const T* b = static_cast<const T*>(blocks);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
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
// lanes, 2 vec (see the source note).  Returns cudaGetLastError() after the
// launch (0 with nothing to launch), or cudaErrorInvalidValue for a route
// that does not take the shape or, on the vec route, an operand that is
// not 16-byte aligned.
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
  if ((route == kWarp && !warp_route(R, C, k)) ||
      (route == kVec && !(vec_route(R, C, k, vl) && aligned)) ||
      route < kWarp || route > kVec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t ctas = route == kVec ? nbr / kWarpsV
                       : route == kWarp ? nbr * k / kWarpsA
                                        : nbr * ((k + 31) / 32) / kWarpsB;
  if (ctas >= (int64_t{1} << 31) - 1) {
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

}  // extern "C"
