// Device code shared by the case-coded matvec kernels (coded_matvec.cu and
// coded_split.cu), for Hopper (sm_90a): the coefficient constants, the
// constant+face A stencil of one cell, the conductor terms of one cell (the
// in-register decode _u_body of eddy_currents_3d_tpu/ops/pallas_coded.py:
// 1051), and the dot sums finished in the kernel.
//
// The arithmetic takes the neighbour values through accessors, so every
// kernel evaluates each cell with one copy of the expressions, in one
// order, wherever its values come from (registers and read-only global
// loads in coded_matvec.cu, shared-memory planes and registers in
// coded_split.cu), and each value is fetched where the expression uses it,
// which keeps few of them live at once:
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

// ---- the dots, finished in the kernel ----
//
// Each CTA sums its threads' y.w and y.y in a fixed order and writes one
// pair; the last CTA to finish (a device-scope counter after
// __threadfence, which wraps to 0 as the last CTA counts itself) sums all
// pairs in a fixed order, adds the prior totals and writes the two totals.
// The counter decides which CTA sums, never the order, so repeated calls
// give the same bits.

struct DotOut {
  float* partials;     // 2 floats per CTA
  unsigned* counter;   // CTAs done, modulo the grid's CTAs; 0 between launches
  const float* prior;  // 2 floats added to the totals, or null
  float* totals;       // dot(y, w), dot(y, y)
};

// a and b summed over the block into thread 0's a and b: warp shuffles,
// then the warps' values in a fixed order
template <int NT>
__device__ __forceinline__ void block_sum(float& a, float& b, float* sa,
                                          float* sb) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) {
    sa[threadIdx.x >> 5] = a;
    sb[threadIdx.x >> 5] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.f;
    b = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      a += sa[w];
      b += sb[w];
    }
  }
}

// Writes the CTA's pair; the last CTA of the grid to get here sums every
// pair in a fixed order and writes prior + sums to totals.  Every thread
// must call it.
template <int NT>
__device__ __forceinline__ void finish_dots(float pw, float py,
                                            const DotOut& d) {
  __shared__ float sa[NT / 32];
  __shared__ float sb[NT / 32];
  __shared__ bool last;
  block_sum<NT>(pw, py, sa, sb);
  const unsigned nblk = gridDim.x * gridDim.y;
  if (threadIdx.x == 0) {
    const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
    d.partials[2 * b] = pw;
    d.partials[2 * b + 1] = py;
    __threadfence();
    // the last CTA's increment wraps the counter back to 0
    last = atomicInc(d.counter, nblk - 1) == nblk - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float a = 0.f;
  float c = 0.f;
  for (unsigned j = threadIdx.x; j < nblk; j += NT) {
    a += __ldcg(d.partials + 2 * j);
    c += __ldcg(d.partials + 2 * j + 1);
  }
  block_sum<NT>(a, c, sa, sb);
  if (threadIdx.x == 0) {
    if (d.prior != nullptr) {
      a = __ldcg(d.prior) + a;
      c = __ldcg(d.prior + 1) + c;
    }
    d.totals[0] = a;
    d.totals[1] = c;
  }
}

}  // namespace coded
