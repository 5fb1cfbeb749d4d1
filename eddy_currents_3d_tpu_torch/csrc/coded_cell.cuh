// Device code shared by the case-coded matvec kernels (coded_matvec.cu and
// coded_split.cu), for Hopper (sm_90a): the coefficient constants, the
// constant+face A stencil of one cell, the conductor terms of one cell (the
// in-register decode _u_body of eddy_currents_3d_tpu/ops/pallas_coded.py:
// 1051), guarded neighbour reads and the block reduction of the fused dot
// partials.
//
// The arithmetic takes the neighbour values through accessors, so every
// kernel evaluates each cell with one copy of the expressions, in one
// order, wherever its values come from (guarded global reads in
// coded_matvec.cu, shared-memory planes and registers in coded_split.cu),
// and each value is fetched where the expression uses it, which keeps few
// of them live at once:
//   A accessor: c(comp), m(comp, axis), p(comp, axis): A_comp at the cell,
//     one cell down and one cell up axis (0 = x, 1 = y, 2 = z), zero
//     beyond the grid;
//   U accessor: u0(), n(axis, j): U at the cell and at offset -2, -1, +1,
//     +2 (j = 0..3) along axis, zero beyond the grid and U's planes.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace coded {

// coded_matvec.cu's thread layout: one thread per cell on kTX x kTY (x, y)
// tiles, one z plane per block
constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kWarps = kTX * kTY / 32;

enum Mode : int { kApply = 0, kDots = 1, kDiv = 2 };

// Every coefficient constant is formed in float64 on the host and rounded
// once to float32, as the JAX kernel's c(...) does.
struct Consts {
  float s[3];     // 1 / delta_a^2
  float bndm[3];  // BND(a, minus) * s_a: minus-neighbour coefficient on a plus face
  float bndp[3];  // BND(a, plus) * s_a: plus-neighbour coefficient on a minus face
  float ds[3];    // 0.5 / delta_a
  float inv2dt;   // 2 / dt
  float sdiag;    // 2 (s_x + s_y + s_z)
  float big[3];   // 2 / (dt delta_a)
  float half[3];  // 0.5 / (dt delta_a)
};

struct Grid {
  int nx, ny, nz;
};

// The face coefficients of the constant+face 7-point stencil of a cell: BND
// multipliers from its face membership.
struct AFace {
  float cm[3];  // minus-neighbour coefficient along each axis
  float cp[3];  // plus-neighbour coefficient
  float diag;
};

__device__ __forceinline__ AFace a_face(int x, int y, int z, const Grid& g,
                                        const Consts& k) {
  const bool fm[3] = {x == 0, y == 0, z == 0};
  const bool fp[3] = {x == g.nx - 1, y == g.ny - 1, z == g.nz - 1};
  AFace f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    f.cm[a] = fm[a] ? 0.f : (fp[a] ? k.bndm[a] : -k.s[a]);
    f.cp[a] = fp[a] ? 0.f : (fm[a] ? k.bndp[a] : -k.s[a]);
  }
  f.diag = ((fm[0] || fp[0]) ? k.s[0] : 2.f * k.s[0]) +
           ((fm[1] || fp[1]) ? k.s[1] : 2.f * k.s[1]);
  f.diag = f.diag + ((fm[2] || fp[2]) ? k.s[2] : 2.f * k.s[2]);
  return f;
}

// The constant+face A stencil of one cell for the three components.
template <class AN>
__device__ __forceinline__ void a_rows(const AFace& f, const AN& a,
                                       float ya[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = f.diag * a.c(c);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      v = v + f.cm[ax] * a.m(c, ax);
      v = v + f.cp[ax] * a.p(c, ax);
    }
    ya[c] = v;
  }
}

// The conductor terms of a cell whose code cd is not 0 (bit set = that
// neighbour is not conducting): adds grad-U (central, or one-sided
// -3/+4/-1 on conductor surfaces), the 2C/dt inertia (intc cells, or every
// cond cell with inertia_on_faces) and, with CONV, cv[a] * (A_c(+a) -
// A_c(-a)) for every c and a to ya, and returns the U row: the case-coded
// Laplacian plus div(dA/dt), including the interior13 half terms and the
// (x-, y+, z+) sign quirk of EC3D.f90:803-806, exactly as the JAX ladder
// writes it.  c0 is the cell's C, cv its convection.  DIV: U = 0, so ya is
// left alone and only the div(dA/dt) part of the U row is formed; u, c0 and
// cv are not read.
template <bool DIV, bool CONV, class AN, class UN>
__device__ __forceinline__ float conductor(int cd, const AN& a, const UN& u,
                                           float c0, const float cv[3],
                                           const Consts& k,
                                           int inertia_on_faces, float ya[3]) {
  const bool mm[3] = {((cd >> 0) & 1) != 0, ((cd >> 2) & 1) != 0,
                      ((cd >> 4) & 1) != 0};
  const bool mp[3] = {((cd >> 1) & 1) != 0, ((cd >> 3) & 1) != 0,
                      ((cd >> 5) & 1) != 0};
  const bool cond = ((cd >> 6) & 1) != 0;
  const bool intc = ((cd >> 7) & 1) != 0;

  float yu = 0.f;
  if (!DIV) {
    const float u0 = u.u0();
    // ---- grad-U, inertia and convection into the A rows ----
    const bool inert_sel = inertia_on_faces ? cond : intc;
    const float inert = inert_sel ? k.inv2dt * c0 : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const bool one_m = intc && mp[c];
      const bool one_p = intc && !mp[c] && mm[c];
      const bool central = intc && !mp[c] && !mm[c];
      const float gg = c0 * k.ds[c];
      const float g0 = one_m ? -3.f * gg : (one_p ? 3.f * gg : 0.f);
      const float gm1 = one_m ? 4.f * gg : (central ? gg : 0.f);
      const float gm2 = one_m ? -gg : 0.f;
      const float gp1 = one_p ? -4.f * gg : (central ? -gg : 0.f);
      const float gp2 = one_p ? gg : 0.f;
      float gc = g0 * u0 + gm1 * u.n(c, 1) + gm2 * u.n(c, 0) +
                 gp1 * u.n(c, 2) + gp2 * u.n(c, 3);
      gc = gc + inert * a.c(c);
      if (CONV) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          gc = gc + cv[ax] * (a.p(c, ax) - a.m(c, ax));
        }
      }
      ya[c] = ya[c] + gc;
    }

    // ---- U row: case-coded Laplacian ----
    yu = (cond ? k.sdiag : 0.f) * u0;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float km = mp[ax] ? -2.f * k.s[ax] : (mm[ax] ? 0.f : -k.s[ax]);
      const float kp = mm[ax] ? -2.f * k.s[ax] : (mp[ax] ? 0.f : -k.s[ax]);
      yu = yu + (cond ? km : 0.f) * u.n(ax, 1);
      yu = yu + (cond ? kp : 0.f) * u.n(ax, 2);
    }
  }

  // ---- U row: div(dA/dt) ----
  const bool any_missing = mm[0] || mp[0] || mm[1] || mp[1] || mm[2] || mp[2];
  const bool interior13 = cond && !any_missing;
  const bool quirk = cond && mm[0] && mp[1] && mp[2];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float big = k.big[ax];
    float sign = mp[ax] ? big : (mm[ax] ? -big : 0.f);
    if (ax == 0 && quirk) sign = big;
    if (ax == 1 && quirk) sign = -big;
    yu = yu + ((cond && (mm[ax] || mp[ax])) ? sign : 0.f) * a.c(ax);
    yu = yu + (interior13 ? k.half[ax] : 0.f) * a.m(ax, ax);
    yu = yu + (interior13 ? -k.half[ax] : 0.f) * a.p(ax, ax);
  }
  return yu;
}

// ---- guarded global reads (coded_matvec.cu) ----

// A scalar field held over planes [z0, z0 + nz) of the grid: all of it, or
// the conductor slab of the z-compact U.  It reads as zero beyond them.
struct Planes {
  const float* p;
  int z0;
  int nz;
};

// value of f at (x, y, z), zero beyond the grid and beyond f's planes
__device__ __forceinline__ float at(const Planes& f, int x, int y, int z,
                                   const Grid& g) {
  const int zl = z - f.z0;
  if (x < 0 || x >= g.nx || y < 0 || y >= g.ny || zl < 0 || zl >= f.nz) {
    return 0.f;
  }
  return __ldg(f.p + (static_cast<size_t>(zl) * g.ny + y) * g.nx + x);
}

// neighbour at offset d along physical axis a (0 = x, 1 = y, 2 = z)
__device__ __forceinline__ float nbr(const Planes& f, int x, int y, int z,
                                     int a, int d, const Grid& g) {
  return at(f, x + (a == 0 ? d : 0), y + (a == 1 ? d : 0),
            z + (a == 2 ? d : 0), g);
}

// A around cell (x, y, z) of the whole grid, flat index i; n = nx ny nz is
// the stride between components
struct GlobalA {
  const float* A;
  size_t i, n;
  int x, y, z;
  Grid g;
  __device__ __forceinline__ float c(int comp) const {
    return __ldg(A + comp * n + i);
  }
  __device__ __forceinline__ float m(int comp, int ax) const {
    return nbr(Planes{A + comp * n, 0, g.nz}, x, y, z, ax, -1, g);
  }
  __device__ __forceinline__ float p(int comp, int ax) const {
    return nbr(Planes{A + comp * n, 0, g.nz}, x, y, z, ax, +1, g);
  }
};

// U around cell (x, y, z)
struct GlobalU {
  Planes U;
  int x, y, z;
  Grid g;
  __device__ __forceinline__ float u0() const { return at(U, x, y, z, g); }
  __device__ __forceinline__ float n(int ax, int j) const {
    return nbr(U, x, y, z, ax, j < 2 ? j - 2 : j - 1, g);
  }
};

// Sums the threads' pw and py over the block (warp shuffles, then one value
// per warp in shared memory, added in a fixed order by thread 0: no
// atomics, so a run repeats bit for bit) and writes the two sums to
// partials[2 b] and partials[2 b + 1], b the block's linear index.  Every
// thread of a kTX x kTY block must call it.
__device__ __forceinline__ void block_dots(float pw, float py,
                                           float* __restrict__ partials) {
  __shared__ float sw[kWarps];
  __shared__ float sy[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pw += __shfl_down_sync(0xffffffffu, pw, off);
    py += __shfl_down_sync(0xffffffffu, py, off);
  }
  const int tid = threadIdx.y * kTX + threadIdx.x;
  if ((tid & 31) == 0) {
    sw[tid >> 5] = pw;
    sy[tid >> 5] = py;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f;
    float b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += sw[w];
      b += sy[w];
    }
    const size_t blk =
        (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
            gridDim.x + blockIdx.x;
    partials[2 * blk] = a;
    partials[2 * blk + 1] = b;
  }
}

// blocks of one coded_matvec launch over nplanes z planes
inline dim3 grid_of(int nx, int ny, int nplanes) {
  return dim3((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY, nplanes);
}

}  // namespace coded
