// Field-kernel tier of the eddy-current operator, for Hopper (sm_90a): the
// operator applied from streamed coefficient fields, float32 or bfloat16.
//
// Replaces the TPU kernels of eddy_currents_3d_tpu/ops/pallas_stencil.py:
//   * field_a: _a_kernel / _a_kernel_1tile (:136, :148),
//       y[l](cell) = sum_o ka[o](cell) * A[l](cell + offset_o)
//     over the 7 offsets [0, -x, +x, -y, +y, -z, +z], for each of the L
//     leading fields of A (L = 3 for the operator's A components and for
//     the multigrid V-cycle's fields);
//   * field_u: _u_kernel / _u_kernel_1tile (:206, :242), over the conductor
//     box (z0, y0, x0) + (bz, by, bx):
//       gout[c] = sum_k gu[c,k] * U(cell + k e_c),      k = -2..+2,
//       uout    = sum_o ku[o] * U(cell + offset_o)
//               + sum_c sum_k da[c,k] * A[c](cell + k e_c),  k = -1..+1;
//     gout is added into yA inside the box (read-modify-write, so field_u
//     runs after field_a on the same stream) and uout written to the box
//     of yU, which the wrapper zeroes beforehand.
// Both are templated on the coefficient type and on the state type, and
// built for (float, float), (__nv_bfloat16, float) and (__nv_bfloat16,
// __nv_bfloat16): bfloat16 state comes with bfloat16 coefficients, as
// every bfloat16 system, multigrid level and ILU(0) factor of the port
// carries them.  Every coefficient and state value is loaded and
// converted to float, every product accumulated in float, and each output
// rounded once to the state type at the store.  The JAX kernels at
// bfloat16 state round every operation in bfloat16; the plain versions
// (ops/field.py) and these kernels do not.  The kernels' arithmetic type
// is Acc<S>: float at float32 state, where nvcc may contract products and
// sums into FMAs as it always did; Rn at bfloat16 state, a float whose
// every product and sum is rounded apart (__fmul_rn, __fadd_rn, never
// contracted), the plain version's float32 arithmetic in its order, so the
// one rounding to bfloat16 at the store sees the same float sum.
//
// Neighbours: a read beyond the grid (field_a) or beyond the box (field_u)
// is guarded and taken as zero, never clamped: the TPU kernels' clamped
// duplicate block times a zero coefficient is not needed.  Zero is exact
// because of the assembly invariant (assembly/stencil.py): every
// coefficient that reaches across a grid face, or lies within 2 cells of a
// box face, is zero.  So a neighbour outside the box may be read from the
// full grid or taken as zero with the same result; the kernel takes zero,
// as the plain version (ops/field.py) does.
//
// What bounds it on an H100: device-memory bytes.  field_a needs 7 flops
// per field and cell against 7 coefficients (28 B in float32, 14 B in
// bfloat16) + L fields read + L written: 52 B/cell in float32, 38 B/cell
// with bfloat16 coefficients and 26 B/cell with bfloat16 coefficients and
// state at L = 3, about 65, 47 and 33 us at 256x256x64 at the 3.35 TB/s
// peak.  The design moves each operand once: one thread per cell on 32x8
// (x, y) tiles, one z plane per block, so the +-x/+-y neighbour reads of a
// warp hit the same or adjacent cache lines and the +-z planes are reused
// through the 50 MB L2; each thread reads its 7 coefficients once and
// applies them to all L fields.  field_u streams 31 coefficients per box
// cell (124 B float32, 62 B bfloat16) plus U, A and yA's box (168 B per
// box cell in float32, 84 B with bfloat16 state and coefficients).
// On the H100 the bfloat16-state kernels measured slower than the float32
// ones, on half the bytes (PERF.md).  The likely reason: a thread still
// issues one load per operand, each warp load is now 64 B against 128 B,
// and the kernel is not bound by bytes.  Two cells per thread (bf16x2
// loads), z-marching with shared-memory planes and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// float arithmetic with each product and sum rounded apart (see above)
struct Rn {
  float v;
  Rn() = default;
  __device__ __forceinline__ Rn(float x) : v(x) {}
};
__device__ __forceinline__ Rn operator*(Rn a, Rn b) {
  return __fmul_rn(a.v, b.v);
}
__device__ __forceinline__ Rn operator+(Rn a, Rn b) {
  return __fadd_rn(a.v, b.v);
}
__device__ __forceinline__ Rn& operator+=(Rn& a, Rn b) { return a = a + b; }

template <typename S>
using Acc = std::conditional_t<std::is_same_v<S, float>, float, Rn>;

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Rn x) { return x.v; }

// the sum stored at state type S: rounded once to bfloat16
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// a state element as float
template <typename S>
__device__ __forceinline__ float ld(const S* __restrict__ p, size_t i) {
  return to_f32(__ldg(p + i));
}

// a coefficient as the arithmetic type V
template <typename V, typename T>
__device__ __forceinline__ V coef(const T* __restrict__ p, size_t i) {
  return to_f32(p[i]);
}

dim3 tiles(int nx, int ny, int nz) {
  return dim3((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY, nz);
}

template <typename T, typename S>
__global__ void __launch_bounds__(kTX * kTY)
field_a_kernel(const T* __restrict__ ka, const S* __restrict__ A,
               S* __restrict__ y, int L, int nx, int ny, int nz) {
  using V = Acc<S>;
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int yy = blockIdx.y * kTY + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= nx || yy >= ny) return;
  const size_t plane = static_cast<size_t>(nx) * ny;
  const size_t n = plane * nz;
  const size_t i = static_cast<size_t>(z) * plane +
                   static_cast<size_t>(yy) * nx + x;
  V k[7];
#pragma unroll
  for (int o = 0; o < 7; ++o) k[o] = coef<V>(ka, o * n + i);
  const bool xm = x > 0, xp = x + 1 < nx;
  const bool ym = yy > 0, yp = yy + 1 < ny;
  const bool zm = z > 0, zp = z + 1 < nz;
  for (int l = 0; l < L; ++l) {
    const S* __restrict__ a = A + l * n;
    V acc = k[0] * ld(a, i);
    acc += k[1] * (xm ? ld(a, i - 1) : 0.f);
    acc += k[2] * (xp ? ld(a, i + 1) : 0.f);
    acc += k[3] * (ym ? ld(a, i - nx) : 0.f);
    acc += k[4] * (yp ? ld(a, i + nx) : 0.f);
    acc += k[5] * (zm ? ld(a, i - plane) : 0.f);
    acc += k[6] * (zp ? ld(a, i + plane) : 0.f);
    store(y + l * n + i, val(acc));
  }
}

struct Box {
  int z0, y0, x0;  // origin in the grid
  int bz, by, bx;  // extent
};

// f (a full-grid field) at the box cell pos + d e_axis, zero beyond the box
template <typename S>
__device__ __forceinline__ float box_nbr(const S* __restrict__ f, size_t i,
                                         const int pos[3], const int ext[3],
                                         const long long stride[3], int axis,
                                         int d) {
  const int p = pos[axis] + d;
  if (p < 0 || p >= ext[axis]) return 0.f;
  return to_f32(__ldg(f + static_cast<long long>(i) + d * stride[axis]));
}

template <typename T, typename S>
__global__ void __launch_bounds__(kTX * kTY)
field_u_kernel(const T* __restrict__ gu, const T* __restrict__ ku,
               const T* __restrict__ da, const S* __restrict__ A,
               const S* __restrict__ U, S* __restrict__ yA,
               S* __restrict__ yU, int nx, int ny, int nz, Box b) {
  using V = Acc<S>;
  const int xb = blockIdx.x * kTX + threadIdx.x;
  const int yb = blockIdx.y * kTY + threadIdx.y;
  const int zb = blockIdx.z;
  if (xb >= b.bx || yb >= b.by) return;
  const size_t nb = static_cast<size_t>(b.bx) * b.by * b.bz;
  const size_t ib = (static_cast<size_t>(zb) * b.by + yb) * b.bx + xb;
  const size_t n = static_cast<size_t>(nx) * ny * nz;
  const size_t i =
      (static_cast<size_t>(b.z0 + zb) * ny + (b.y0 + yb)) * nx + (b.x0 + xb);
  const int pos[3] = {xb, yb, zb};
  const int ext[3] = {b.bx, b.by, b.bz};
  const long long stride[3] = {1, nx, static_cast<long long>(nx) * ny};

  // grad-U into the A rows: centre, -1, +1, -2, +2, as the plain version
  // sums them; the sum is added to yA and rounded once
  const int gk[5] = {2, 1, 3, 0, 4};
  const int gd[5] = {0, -1, 1, -2, 2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    V g = 0.f;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const V t = coef<V>(gu, (c * 5 + gk[j]) * nb + ib) *
                  box_nbr(U, i, pos, ext, stride, c, gd[j]);
      g = j == 0 ? t : g + t;
    }
    store(yA + c * n + i, val(V(to_f32(yA[c * n + i])) + g));
  }

  // U rows: Laplacian on U, offsets [0, -x, +x, -y, +y, -z, +z] ...
  V u = coef<V>(ku, ib) * ld(U, i);
#pragma unroll
  for (int o = 1; o < 7; ++o) {
    const int axis = (o - 1) / 2;
    const int d = (o % 2) ? -1 : 1;
    u += coef<V>(ku, o * nb + ib) * box_nbr(U, i, pos, ext, stride, axis, d);
  }
  // ... plus the div(dA/dt) coupling, offsets [-1, 0, +1] along c
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const S* __restrict__ a = A + c * n;
    u = u + coef<V>(da, (c * 3 + 1) * nb + ib) * ld(a, i) +
        coef<V>(da, (c * 3 + 0) * nb + ib) *
            box_nbr(a, i, pos, ext, stride, c, -1) +
        coef<V>(da, (c * 3 + 2) * nb + ib) *
            box_nbr(a, i, pos, ext, stride, c, 1);
  }
  store(yU + i, val(u));
}

template <typename T, typename S>
int launch_a(const void* ka, const void* A, void* y, int L, int nx, int ny,
             int nz, cudaStream_t st) {
  field_a_kernel<T, S><<<tiles(nx, ny, nz), dim3(kTX, kTY), 0, st>>>(
      static_cast<const T*>(ka), static_cast<const S*>(A),
      static_cast<S*>(y), L, nx, ny, nz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch_u(const void* gu, const void* ku, const void* da, const void* A,
             const void* U, void* yA, void* yU, int nx, int ny, int nz,
             const Box& b, cudaStream_t st) {
  field_u_kernel<T, S><<<tiles(b.bx, b.by, b.bz), dim3(kTX, kTY), 0, st>>>(
      static_cast<const T*>(gu), static_cast<const T*>(ku),
      static_cast<const T*>(da), static_cast<const S*>(A),
      static_cast<const S*>(U), static_cast<S*>(yA), static_cast<S*>(yU),
      nx, ny, nz, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (L, nz, ny, nx) = the 7-point stencil ka (7, nz, ny, nx) applied to
// each of A's L fields.  coef_bf16: ka is __nv_bfloat16, else float;
// state_bf16: A and y are __nv_bfloat16 (and so is ka), else float.
// Returns cudaGetLastError() after the launch.
int field_a_launch(const void* ka, int coef_bf16, int state_bf16,
                   const void* A, void* y, int L, int nx, int ny, int nz,
                   void* stream) {
  if (L <= 0 || nx <= 0 || ny <= 0 || nz <= 0 || (state_bf16 && !coef_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (state_bf16) return launch_a<bf16, bf16>(ka, A, y, L, nx, ny, nz, st);
  return coef_bf16 ? launch_a<bf16, float>(ka, A, y, L, nx, ny, nz, st)
                   : launch_a<float, float>(ka, A, y, L, nx, ny, nz, st);
}

// The U-coupling over the box (z0, y0, x0) + (bz, by, bx): adds the grad-U
// terms into yA (3, nz, ny, nx) and writes the U rows into the box of yU
// (nz, ny, nx); gu (3, 5, bz, by, bx), ku (7, ...), da (3, 3, ...), in the
// types coef_bf16 and state_bf16 name as for field_a_launch.
int field_u_launch(const void* gu, const void* ku, const void* da,
                   int coef_bf16, int state_bf16, const void* A,
                   const void* U, void* yA, void* yU, int nx, int ny, int nz,
                   int z0, int y0, int x0, int bz, int by, int bx,
                   void* stream) {
  if (bz <= 0 || by <= 0 || bx <= 0 || z0 < 0 || y0 < 0 || x0 < 0 ||
      z0 + bz > nz || y0 + by > ny || x0 + bx > nx ||
      (state_bf16 && !coef_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Box b{z0, y0, x0, bz, by, bx};
  auto st = static_cast<cudaStream_t>(stream);
  if (state_bf16) {
    return launch_u<bf16, bf16>(gu, ku, da, A, U, yA, yU, nx, ny, nz, b, st);
  }
  return coef_bf16
             ? launch_u<bf16, float>(gu, ku, da, A, U, yA, yU, nx, ny, nz, b,
                                     st)
             : launch_u<float, float>(gu, ku, da, A, U, yA, yU, nx, ny, nz, b,
                                      st);
}

}  // extern "C"
