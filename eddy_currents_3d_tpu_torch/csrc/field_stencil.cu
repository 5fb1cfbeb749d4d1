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
// built for (float, float), (__nv_bfloat16, float), (__nv_bfloat16,
// __nv_bfloat16) and (float, __nv_bfloat16): bfloat16 state mostly comes
// with bfloat16 coefficients, as every bfloat16 system, multigrid level
// and ILU(0) factor of the port carries them, and with float32 ones under
// coeff_dtype=float32 (the JAX package's _a_kernel and _u_kernel at f32
// coefficients and bf16 state: each product an f32 coefficient times a
// bf16 value widened to f32, f32 sums, one rounding at the store).  Every
// coefficient and state value is loaded and
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
// At bfloat16 state these one-cell-a-thread kernels measured slower on the
// H100 than the float32 ones, on half the bytes (PERF.md): one 2-byte load
// per operand (64-byte warp loads), a runtime loop over the fields that
// reloads each cell's z neighbours, and 26 of 128 lanes idle at nx = 102.
// So bfloat16 state has a second route, field_a_pairs and field_u_pairs
// below: two cells a thread as 4-byte words, consecutive pairs of a plane
// a CTA, runs of planes marched with the z neighbours in registers, the
// same sums bit for bit.  field_a takes it with float32 coefficients too
// (field_a_pairs_f32: each pair's coefficients one 8-byte float2), which
// moves 40 B a cell at L = 3 (28 of coefficients, 6 read, 6 written).  The
// one-cell kernels stay for odd widths, unaligned tensors and field_u at
// float32 coefficients (ops/field_cuda.py pair_route; 146 B a box cell:
// 124 + 22), where they measured 74% of the bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>
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

// ---- bfloat16 state, two cells a thread: the paired route ----
//
// The same functions at bfloat16 state as field_a_kernel<bf16, bf16> and
// field_u_kernel<bf16, bf16> (and, field_a_pairs_f32, as field_a_kernel<
// float, bf16>), with the same products and sums per cell, in the same
// order, each rounded apart (Rn), and one rounding to bfloat16 per output:
// their outputs equal the scalar kernels' bit for bit.  A thread takes two
// cells along x, (x, x + 1) with x even, as one 4-byte word
// (__nv_bfloat162) of each state field and of each bfloat16 coefficient
// field (an 8-byte float2 of a float32 one); the CTA takes
// consecutive pairs of a plane in row-major order (no lane idles at any
// width); the thread marches a run of planes, carrying the z neighbours
// in registers.  A pair's outer x neighbours are the adjacent lanes' pairs
// (warp shuffles; the warp's first and last lanes load theirs), and the
// guards of the scalar kernels decide which neighbours are zero.
//
// Bound by bytes as the scalar kernels are (26 B a cell for field_a at
// L = 3, 84 B a box cell for field_u).  On an H100 (PERF.md): at team7's
// 102 x 102 x 24, whose few megabytes stay in L2, field_a 3.9 us against
// 7.4 for the one-cell kernel, field_u 3.6-3.7 against 5.6 (50% and 61%
// of their bounds); at 256 x 256 x 64 43.6 against 104 and 24.1 against
// 37.2 (75% and 61%).  team7's grid holds few pairs, so longer runs leave
// too few warps there: field_a marches 2 planes, field_u 1, in CTAs of 128
// threads, the fastest of the covers measured.  A ring of shared-memory
// planes, one field a thread and two 2-byte loads for odd pairs measured
// slower (PERF.md).

using u32 = unsigned int;

// a word's two bfloat16 values as float: the cell at the even index (low
// half) and the one after it (high half)
__device__ __forceinline__ float lo(u32 w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(u32 w) {
  return __uint_as_float(w & 0xffff0000u);
}
template <int H>
__device__ __forceinline__ float half(u32 w) {
  return H ? hi(w) : lo(w);
}
// a pair's float32 coefficients: the even cell's (x), the odd one's (y)
template <int H>
__device__ __forceinline__ float half(float2 v) {
  return H ? v.y : v.x;
}

// two sums, each rounded once to bfloat16 as store() rounds it, as a word
__device__ __forceinline__ u32 pack(float a, float b) {
  const __nv_bfloat162 h =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  return *reinterpret_cast<const u32*>(&h);
}

constexpr u32 kAll = 0xffffffffu;
constexpr int kPairThreads = 128;  // threads a CTA
constexpr int kARun = 2;           // planes a field_a_pairs thread marches
constexpr int kURun = 1;           // box planes a field_u_pairs thread marches

// the 7-point stencil of one cell of a pair: H = 0 the even cell, 1 the
// odd one; K the coefficients' pair (u32: bfloat16 words, float2: float32);
// the neighbours as the scalar kernel reads them (0 beyond the grid), in
// its order [0, -x, +x, -y, +y, -z, +z]
template <int H, typename K>
__device__ __forceinline__ float a_cell(const K (&k)[7], float c, float xm,
                                        float xp, u32 ym, u32 yp, u32 zm,
                                        u32 zp) {
  Rn acc = Rn(half<H>(k[0])) * c;
  acc += Rn(half<H>(k[1])) * xm;
  acc += Rn(half<H>(k[2])) * xp;
  acc += Rn(half<H>(k[3])) * half<H>(ym);
  acc += Rn(half<H>(k[4])) * half<H>(yp);
  acc += Rn(half<H>(k[5])) * half<H>(zm);
  acc += Rn(half<H>(k[6])) * half<H>(zp);
  return acc.v;
}

// field_a over pairs: NL fields marched together (3: the operator's and the
// V-cycle's three fields in one thread; 1: one field a thread).  The grid:
// blockIdx.x the pairs of a plane, blockIdx.y runs of `run` planes,
// blockIdx.z the group of NL fields.  ka as pairs K (a bfloat16 word or a
// float2), A and y as words: nx is even, so a row holds nx / 2 whole pairs.
template <typename K, int NL>
__device__ __forceinline__ void a_pairs(const K* __restrict__ ka,
                                        const u32* __restrict__ A,
                                        u32* __restrict__ y, int nx, int ny,
                                        int nz, int run) {
  const int hx = nx >> 1;          // words a row
  const int hp = hx * ny;          // words a plane
  const int n = hp * nz;           // words a field
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = f < hp;
  const int w = on ? f : hp - 1;   // lanes past the plane shuffle, not store
  const int yy = w / hx;
  const int xw = w - yy * hx;
  const int lane = threadIdx.x & 31;
  // x - 1 of the even cell and x + 2 of the odd one lie in the grid; the
  // pair's own x neighbours always do
  const bool xm = xw > 0, xp = xw + 1 < hx;
  const bool ym = yy > 0, yp = yy + 1 < ny;
  const int z0 = blockIdx.y * run;
  const int z1 = min(z0 + run, nz);
  const u32* __restrict__ a = A + blockIdx.z * NL * n;
  u32* __restrict__ out = y + blockIdx.z * NL * n;
  u32 am[NL], ac[NL], ap[NL];
  auto plane_at = [&](int z, u32 (&r)[NL]) {
    const bool in = z >= 0 && z < nz;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      r[l] = in ? __ldg(a + l * n + z * hp + w) : 0u;
    }
  };
  plane_at(z0 - 1, am);
  plane_at(z0, ac);
  for (int z = z0; z < z1; ++z) {
    plane_at(z + 1, ap);
    const int i = z * hp + w;
    K k[7];
#pragma unroll
    for (int o = 0; o < 7; ++o) k[o] = __ldg(ka + o * n + i);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const u32* __restrict__ al = a + l * n;
      const u32 c = ac[l];
      u32 left = __shfl_up_sync(kAll, c, 1);
      u32 right = __shfl_down_sync(kAll, c, 1);
      if (lane == 0) left = xm ? __ldg(al + i - 1) : 0u;
      if (lane == 31) right = xp ? __ldg(al + i + 1) : 0u;
      const u32 wm = ym ? __ldg(al + i - hx) : 0u;
      const u32 wp = yp ? __ldg(al + i + hx) : 0u;
      const float s0 = a_cell<0>(k, lo(c), xm ? hi(left) : 0.f, hi(c), wm,
                                 wp, am[l], ap[l]);
      const float s1 = a_cell<1>(k, hi(c), lo(c), xp ? lo(right) : 0.f, wm,
                                 wp, am[l], ap[l]);
      if (on) out[l * n + i] = pack(s0, s1);
    }
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      am[l] = ac[l];
      ac[l] = ap[l];
    }
  }
}

template <int NL>
__global__ void __launch_bounds__(kPairThreads)
field_a_pairs(const u32* __restrict__ ka, const u32* __restrict__ A,
              u32* __restrict__ y, int nx, int ny, int nz, int run) {
  a_pairs<u32, NL>(ka, A, y, nx, ny, nz, run);
}

// float32 coefficients at bfloat16 state: the same sums as
// field_a_kernel<float, bf16>, bit for bit
template <int NL>
__global__ void __launch_bounds__(kPairThreads)
field_a_pairs_f32(const float2* __restrict__ ka, const u32* __restrict__ A,
                  u32* __restrict__ y, int nx, int ny, int nz, int run) {
  a_pairs<float2, NL>(ka, A, y, nx, ny, nz, run);
}

// How field_u_pairs reads and writes the grid-indexed state at a box pair
// (grid index i, i + 1).  kEven: i is even, one aligned word.  kOdd, the
// box at an odd x0: the aligned words (i - 1, i) and (i + 1, i + 2), the
// first of them the previous lane's second (a shuffle, loaded where the
// previous lane's pair is not the one to the left), joined by a byte
// permute; a warp's edge lanes read their outer neighbours' pairs as two
// 2-byte loads; odd pairs are stored as two 2-byte halves.
enum PairIo { kEven = 0, kOdd = 1 };

template <int IO>
__device__ __forceinline__ u32 pair_direct(const bf16* __restrict__ p,
                                           int i) {
  if (IO == kEven) return __ldg(reinterpret_cast<const u32*>(p + i));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  return __ldg(q + i) | (static_cast<u32>(__ldg(q + i + 1)) << 16);
}

// every lane of the warp calls this with its i (kOdd shuffles);
// fetch: the previous lane's pair is not (i - 2, i - 1)
template <int IO>
__device__ __forceinline__ u32 pair_at(const bf16* __restrict__ p, int i,
                                       bool fetch) {
  if (IO == kEven) return pair_direct<IO>(p, i);
  const u32 next = __ldg(reinterpret_cast<const u32*>(p + i + 1));
  u32 prev = __shfl_up_sync(kAll, next, 1);
  if (fetch) prev = __ldg(reinterpret_cast<const u32*>(p + i - 1));
  return __byte_perm(prev, next, 0x5432);
}

template <int IO>
__device__ __forceinline__ void put_pair(bf16* __restrict__ p, int i,
                                         u32 v) {
  if (IO == kEven) {
    *reinterpret_cast<u32*>(p + i) = v;
  } else {
    unsigned short* q = reinterpret_cast<unsigned short*>(p);
    q[i] = static_cast<unsigned short>(v & 0xffffu);
    q[i + 1] = static_cast<unsigned short>(v >> 16);
  }
}

// One box cell of field_u, as field_u_kernel sums it: u0 the cell's U;
// un[c] U along axis c at -1, +1, -2, +2; a[c] A[c] along c at -1, 0, +1
// (each 0 beyond the box); ya the cell's yA in, the new yA out; returns
// the U row.  H picks the cell's half of each coefficient word.
template <int H>
__device__ __forceinline__ float u_cell(const u32 (&g)[15],
                                        const u32 (&k)[7],
                                        const u32 (&d)[9], float u0,
                                        const float (&un)[3][4],
                                        const float (&a)[3][3],
                                        float (&ya)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    Rn s = Rn(half<H>(g[c * 5 + 2])) * u0;
    s = s + Rn(half<H>(g[c * 5 + 1])) * un[c][0];
    s = s + Rn(half<H>(g[c * 5 + 3])) * un[c][1];
    s = s + Rn(half<H>(g[c * 5 + 0])) * un[c][2];
    s = s + Rn(half<H>(g[c * 5 + 4])) * un[c][3];
    ya[c] = (Rn(ya[c]) + s).v;
  }
  Rn u = Rn(half<H>(k[0])) * u0;
#pragma unroll
  for (int o = 1; o < 7; ++o) {
    u += Rn(half<H>(k[o])) * un[(o - 1) / 2][(o - 1) % 2];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    u = u + Rn(half<H>(d[c * 3 + 1])) * a[c][1] +
        Rn(half<H>(d[c * 3 + 0])) * a[c][0] +
        Rn(half<H>(d[c * 3 + 2])) * a[c][2];
  }
  return u.v;
}

// field_u over box pairs: blockIdx.x the pairs of a box plane (bx even),
// blockIdx.y runs of `run` box planes.  Coefficients are box-indexed
// words; A, U, yA and yU full-grid bfloat16 (nx even, so every pair of
// the box starts at an index of x0's parity).  The march carries U at
// z - 2 .. z + 2 and A[2] at z - 1 .. z + 1.
template <int IO>
__global__ void __launch_bounds__(kPairThreads)
field_u_pairs(const u32* __restrict__ gu, const u32* __restrict__ ku,
              const u32* __restrict__ da, const bf16* __restrict__ A,
              const bf16* __restrict__ U, bf16* __restrict__ yA,
              bf16* __restrict__ yU, int nx, int ny, int nz, Box b,
              int run) {
  const int hbx = b.bx >> 1;       // words a box row
  const int hbp = hbx * b.by;      // words a box plane
  const int nbw = hbp * b.bz;      // words a coefficient field
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = f < hbp;
  const int w = on ? f : hbp - 1;
  const int yb = w / hbx;
  const int xw = w - yb * hbx;
  const int lane = threadIdx.x & 31;
  // the neighbouring pairs along x lie in the box; rows along y
  const bool xl = xw > 0, xr = xw + 1 < hbx;
  const bool ym1 = yb > 0, ym2 = yb > 1;
  const bool yp1 = yb + 1 < b.by, yp2 = yb + 2 < b.by;
  const bool fetch = lane == 0 || !xl;
  const int plane = nx * ny;
  const int n = plane * nz;
  const int row = (b.y0 + yb) * nx + b.x0 + 2 * xw;
  const int zr0 = blockIdx.y * run;
  const int zr1 = min(zr0 + run, b.bz);
  const bf16* __restrict__ A0 = A;
  const bf16* __restrict__ A1 = A + n;
  const bf16* __restrict__ A2 = A + 2 * n;
  // p's pair on box plane zb, 0 beyond the box (every lane reads: kOdd)
  auto zpair = [&](const bf16* __restrict__ p, int zb) {
    const bool in = zb >= 0 && zb < b.bz;
    const u32 v = pair_at<IO>(p, (b.z0 + (in ? zb : zr0)) * plane + row,
                              fetch);
    return in ? v : 0u;
  };
  // p's pair d rows along y from i, 0 beyond the box
  auto ypair = [&](const bf16* __restrict__ p, int i, int d, bool in) {
    const u32 v = pair_at<IO>(p, in ? i + d * nx : i, fetch);
    return in ? v : 0u;
  };
  u32 um2 = zpair(U, zr0 - 2), um1 = zpair(U, zr0 - 1), uc = zpair(U, zr0);
  u32 up1 = zpair(U, zr0 + 1);
  u32 a2m = zpair(A2, zr0 - 1), a2c = zpair(A2, zr0);
  for (int zb = zr0; zb < zr1; ++zb) {
    const u32 up2 = zpair(U, zb + 2);
    const u32 a2p = zpair(A2, zb + 1);
    const int i = (b.z0 + zb) * plane + row;
    // U and A[0] along x: the adjacent lanes' pairs (x - 2, x - 1) and
    // (x + 2, x + 3)
    u32 ul = __shfl_up_sync(kAll, uc, 1), ur = __shfl_down_sync(kAll, uc, 1);
    const u32 a0 = pair_at<IO>(A0, i, fetch);
    u32 a0l = __shfl_up_sync(kAll, a0, 1), a0r = __shfl_down_sync(kAll, a0, 1);
    if (lane == 0) {
      ul = xl ? pair_direct<IO>(U, i - 2) : 0u;
      a0l = xl ? pair_direct<IO>(A0, i - 2) : 0u;
    }
    if (lane == 31) {
      ur = xr ? pair_direct<IO>(U, i + 2) : 0u;
      a0r = xr ? pair_direct<IO>(A0, i + 2) : 0u;
    }
    const u32 uym1 = ypair(U, i, -1, ym1), uyp1 = ypair(U, i, 1, yp1);
    const u32 uym2 = ypair(U, i, -2, ym2), uyp2 = ypair(U, i, 2, yp2);
    const u32 a1 = pair_at<IO>(A1, i, fetch);
    const u32 a1m = ypair(A1, i, -1, ym1), a1p = ypair(A1, i, 1, yp1);
    u32 yw[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) yw[c] = pair_at<IO>(yA + c * n, i, fetch);
    const int j = zb * hbp + w;
    u32 g[15], k[7], d[9];
#pragma unroll
    for (int q = 0; q < 15; ++q) g[q] = __ldg(gu + q * nbw + j);
#pragma unroll
    for (int q = 0; q < 7; ++q) k[q] = __ldg(ku + q * nbw + j);
#pragma unroll
    for (int q = 0; q < 9; ++q) d[q] = __ldg(da + q * nbw + j);

    const float ul0 = xl ? lo(ul) : 0.f, ul1 = xl ? hi(ul) : 0.f;
    const float ur0 = xr ? lo(ur) : 0.f, ur1 = xr ? hi(ur) : 0.f;
    float y0[3] = {lo(yw[0]), lo(yw[1]), lo(yw[2])};
    float y1[3] = {hi(yw[0]), hi(yw[1]), hi(yw[2])};
    const float un0[3][4] = {
        {ul1, hi(uc), ul0, ur0},
        {lo(uym1), lo(uyp1), lo(uym2), lo(uyp2)},
        {lo(um1), lo(up1), lo(um2), lo(up2)}};
    const float an0[3][3] = {{xl ? hi(a0l) : 0.f, lo(a0), hi(a0)},
                             {lo(a1m), lo(a1), lo(a1p)},
                             {lo(a2m), lo(a2c), lo(a2p)}};
    const float v0 = u_cell<0>(g, k, d, lo(uc), un0, an0, y0);
    const float un1[3][4] = {
        {lo(uc), ur0, ul1, ur1},
        {hi(uym1), hi(uyp1), hi(uym2), hi(uyp2)},
        {hi(um1), hi(up1), hi(um2), hi(up2)}};
    const float an1[3][3] = {{lo(a0), hi(a0), xr ? lo(a0r) : 0.f},
                             {hi(a1m), hi(a1), hi(a1p)},
                             {hi(a2m), hi(a2c), hi(a2p)}};
    const float v1 = u_cell<1>(g, k, d, hi(uc), un1, an1, y1);
    if (on) {
#pragma unroll
      for (int c = 0; c < 3; ++c) put_pair<IO>(yA + c * n, i, pack(y0[c], y1[c]));
      put_pair<IO>(yU, i, pack(v0, v1));
    }
    um2 = um1;
    um1 = uc;
    uc = up1;
    up1 = up2;
    a2m = a2c;
    a2c = a2p;
  }
}

dim3 pair_grid(int pairs, int planes, int run, int groups = 1) {
  return dim3((pairs + kPairThreads - 1) / kPairThreads,
              (planes + run - 1) / run, groups);
}

// three fields a thread where L = 3 (the operator's A, the V-cycle's
// fields), else one field a thread and the CTAs split the L fields;
// coef_bf16: ka as bfloat16 words, else as float2 pairs
int launch_a_pairs(const void* ka, int coef_bf16, const void* A, void* y,
                   int L, int nx, int ny, int nz, cudaStream_t st) {
  const int nl = L == 3 ? 3 : 1;
  const dim3 grid = pair_grid(nx / 2 * ny, nz, kARun, L / nl);
  const auto k = static_cast<const u32*>(ka);
  const auto k2 = static_cast<const float2*>(ka);
  const auto a = static_cast<const u32*>(A);
  const auto o = static_cast<u32*>(y);
  if (coef_bf16 && nl == 3) {
    field_a_pairs<3><<<grid, kPairThreads, 0, st>>>(k, a, o, nx, ny, nz,
                                                    kARun);
  } else if (coef_bf16) {
    field_a_pairs<1><<<grid, kPairThreads, 0, st>>>(k, a, o, nx, ny, nz,
                                                    kARun);
  } else if (nl == 3) {
    field_a_pairs_f32<3><<<grid, kPairThreads, 0, st>>>(k2, a, o, nx, ny,
                                                        nz, kARun);
  } else {
    field_a_pairs_f32<1><<<grid, kPairThreads, 0, st>>>(k2, a, o, nx, ny,
                                                        nz, kARun);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int IO>
int launch_u_pairs(const void* gu, const void* ku, const void* da,
                   const void* A, const void* U, void* yA, void* yU, int nx,
                   int ny, int nz, const Box& b, cudaStream_t st) {
  field_u_pairs<IO><<<pair_grid(b.bx / 2 * b.by, b.bz, kURun), kPairThreads,
                      0, st>>>(
      static_cast<const u32*>(gu), static_cast<const u32*>(ku),
      static_cast<const u32*>(da), static_cast<const bf16*>(A),
      static_cast<const bf16*>(U), static_cast<bf16*>(yA),
      static_cast<bf16*>(yU), nx, ny, nz, b, kURun);
  return static_cast<int>(cudaGetLastError());
}

// out: registers per thread, resident CTAs per SM and local memory per
// thread (bytes) of kernel `kern` at the `threads` threads a CTA it is
// launched with, and `threads`
template <typename K>
int info_of(K kern, int threads, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  int ctas = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, threads,
                                                      0);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = ctas;
  out[2] = static_cast<int>(fa.localSizeBytes);
  out[3] = threads;
  return 0;
}

bool aligned4(std::initializer_list<const void*> ps) {
  for (const void* p : ps) {
    if (reinterpret_cast<uintptr_t>(p) % 4) return false;
  }
  return true;
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
// state_bf16: A and y are __nv_bfloat16, else float (bfloat16 state with
// float coefficients is the (float, bf16) instantiation).
// Returns cudaGetLastError() after the launch.
int field_a_launch(const void* ka, int coef_bf16, int state_bf16,
                   const void* A, void* y, int L, int nx, int ny, int nz,
                   void* stream) {
  if (L <= 0 || nx <= 0 || ny <= 0 || nz <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (state_bf16) {
    return coef_bf16 ? launch_a<bf16, bf16>(ka, A, y, L, nx, ny, nz, st)
                     : launch_a<float, bf16>(ka, A, y, L, nx, ny, nz, st);
  }
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
      z0 + bz > nz || y0 + by > ny || x0 + bx > nx) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Box b{z0, y0, x0, bz, by, bx};
  auto st = static_cast<cudaStream_t>(stream);
  if (state_bf16) {
    return coef_bf16 ? launch_u<bf16, bf16>(gu, ku, da, A, U, yA, yU, nx, ny,
                                            nz, b, st)
                     : launch_u<float, bf16>(gu, ku, da, A, U, yA, yU, nx,
                                             ny, nz, b, st);
  }
  return coef_bf16
             ? launch_u<bf16, float>(gu, ku, da, A, U, yA, yU, nx, ny, nz, b,
                                     st)
             : launch_u<float, float>(gu, ku, da, A, U, yA, yU, nx, ny, nz, b,
                                      st);
}

// The paired route at bfloat16 state (state_bf16 of field_a_launch and
// field_u_launch): the same outputs, bit for bit, two cells a thread.
// field_a_pairs_launch takes bfloat16 (coef_bf16) or float32 coefficients
// and needs nx even, A and y 4-byte aligned and ka aligned to a pair of
// coefficients (4 bytes, 8 at float32); field_u_pairs_launch takes
// bfloat16 coefficients and needs nx and bx even and every pointer 4-byte
// aligned.  Both return cudaErrorInvalidValue for what they do not take,
// else cudaGetLastError() after the launch.
int field_a_pairs_launch(const void* ka, int coef_bf16, const void* A,
                         void* y, int L, int nx, int ny, int nz,
                         void* stream) {
  if (L <= 0 || L > 65535 || nx <= 0 || nx % 2 || ny <= 0 || nz <= 0 ||
      !aligned4({ka, A, y}) ||
      (!coef_bf16 && reinterpret_cast<uintptr_t>(ka) % 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_a_pairs(ka, coef_bf16, A, y, L, nx, ny, nz,
                        static_cast<cudaStream_t>(stream));
}

int field_u_pairs_launch(const void* gu, const void* ku, const void* da,
                         const void* A, const void* U, void* yA, void* yU,
                         int nx, int ny, int nz, int z0, int y0, int x0,
                         int bz, int by, int bx, void* stream) {
  if (bz <= 0 || by <= 0 || bx <= 0 || z0 < 0 || y0 < 0 || x0 < 0 ||
      z0 + bz > nz || y0 + by > ny || x0 + bx > nx || nx % 2 || bx % 2 ||
      !aligned4({gu, ku, da, A, U, yA, yU})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Box b{z0, y0, x0, bz, by, bx};
  auto st = static_cast<cudaStream_t>(stream);
  return x0 % 2 == 0
             ? launch_u_pairs<kEven>(gu, ku, da, A, U, yA, yU, nx, ny, nz, b,
                                     st)
             : launch_u_pairs<kOdd>(gu, ku, da, A, U, yA, yU, nx, ny, nz, b,
                                    st);
}

// Resources of a kernel: out[0..3] = registers per thread, resident CTAs
// per SM and local memory per thread in bytes at the threads a CTA it is
// launched with, and those threads.  which: 0-2 field_a_kernel <float,
// float>, <bf16, float>, <bf16, bf16>; 3-5 field_u_kernel in the same
// order; 6, 7 field_a_pairs<3>, <1>; 8, 9 field_u_pairs<kEven>, <kOdd>;
// 10, 11 field_a_kernel and field_u_kernel <float, bf16>; 12, 13
// field_a_pairs_f32<3>, <1>.  Returns a CUDA error code.
int field_info(int which, int* out) {
  constexpr int kScalar = kTX * kTY;
  switch (which) {
    case 0: return info_of(field_a_kernel<float, float>, kScalar, out);
    case 1: return info_of(field_a_kernel<bf16, float>, kScalar, out);
    case 2: return info_of(field_a_kernel<bf16, bf16>, kScalar, out);
    case 3: return info_of(field_u_kernel<float, float>, kScalar, out);
    case 4: return info_of(field_u_kernel<bf16, float>, kScalar, out);
    case 5: return info_of(field_u_kernel<bf16, bf16>, kScalar, out);
    case 6: return info_of(field_a_pairs<3>, kPairThreads, out);
    case 7: return info_of(field_a_pairs<1>, kPairThreads, out);
    case 8: return info_of(field_u_pairs<kEven>, kPairThreads, out);
    case 9: return info_of(field_u_pairs<kOdd>, kPairThreads, out);
    case 10: return info_of(field_a_kernel<float, bf16>, kScalar, out);
    case 11: return info_of(field_u_kernel<float, bf16>, kScalar, out);
    case 12: return info_of(field_a_pairs_f32<3>, kPairThreads, out);
    case 13: return info_of(field_a_pairs_f32<1>, kPairThreads, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
