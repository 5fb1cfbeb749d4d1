// Case-coded matvec of the eddy-current operator over the whole grid, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel _fused_kernel_chunk together with its in-register
// decode _u_body (eddy_currents_3d_tpu/ops/pallas_coded.py:405 and :1051).
// Per cell (z, y, x) of the unpadded grid it computes
//   * yA[c], c = 0..2: the constant+face 7-point A stencil (BND multipliers
//     from the cell's face membership); on conducting cells plus grad-U
//     (central, or one-sided -3/+4/-1 on conductor surfaces), the 2C/dt
//     inertia (intc cells, or every cond cell with inertia_on_faces), and
//     with convection conv[a] * (A_c(+a) - A_c(-a)) for every c and a;
//   * yU: the case-coded U Laplacian plus div(dA/dt), including the
//     interior13 half terms and the (x-, y+, z+) sign quirk of
//     EC3D.f90:803-806, exactly as the JAX ladder writes it.
// The per-cell arithmetic lives in coded_cell.cuh, shared with the split
// kernels of coded_split.cu, so the outputs are theirs bit for bit.
// Three modes: APPLY; DOTS, which also returns dot(y, w) and dot(y, y);
// DIV, where U is 0 and only yU is written (apply_div).
//
// What bounds it on an H100: device-memory bytes.  A cell needs ~30 flops
// in the air and ~100 in a conductor, against 40 B of compulsory traffic
// on the conductor's planes without convection or dots (A 12 + U 4 + code
// 4 + cf 4 read, yA 12 + yU 4 written) and 28 B on the others, where every
// code is 0 (A read, yA and yU written); DOTS adds w.A's 12 B everywhere
// and w.U's 4 B on the conductor's planes, convection 12 B.  That is far
// below the card's flop-per-byte balance.  At the reference's grid (102 x
// 102 x 24, 11 MB with dots, mostly held in the 50 MB L2 between solver
// calls) a call lasts a few microseconds, so latency bounds it in
// practice: how many loads each SM keeps in flight, and how long its
// slowest CTA runs.
// A z-march over shared-memory planes (coded_split.cu's slab kernel over
// the whole grid) measured slower there than one thread per cell: 128
// registers leave 16 warps an SM, and every plane of a run waits for its
// copies and a barrier (PERF.md).
//
// The design: a z-march in registers.  Each thread of a 32 x TY CTA owns
// one column (x, y) of its segment of the plane over a run of planes (a
// segment: 32 TY consecutive columns in row-major order, so no lane idles
// where nx is not a multiple of 32): it carries A at z - 1, z, z + 1 (and,
// on conducting runs, U at z - 2 .. z + 2) in registers, so a cell loads
// one new A centre per component and U value, and takes its x/y
// neighbours by read-only loads, each guarded by a mask worked out once
// per column (zero beyond the grid, nothing read out of bounds).  No
// shared memory, no barrier inside the march, 64 registers, 32-bit
// indices.  The plan (ops/coded_cuda.py whole_plan) cuts the planes at the
// conductor's z-extent: the conducting runs come first, short, so that the
// items that decode start at once; the runs off the conductor hold no cell
// whose code is not 0, so they read no code, U, cf, conv or wU, and in DIV
// mode no A.  The items (segment, run) go to at most 4 CTAs an SM in turn,
// so each CTA finishes its dots once.  The dots are finished in the kernel
// (coded_cell.cuh finish_dots: the last CTA sums every CTA's pair in a
// fixed order, no atomics on the sums), so apply_dots is one launch and
// repeats bit for bit.  The tile, the run lengths and the CTAs an SM are
// the fastest of the variants timed at team7 on an H100 (PERF.md lists
// them).

#include <cstring>

#include "coded_cell.cuh"

using namespace coded;

namespace {

// The kernel's CTA: 32 x TY threads, one column of cells each; MINB CTAs
// per SM bound its registers.  ops/coded_cuda.py holds the same TY for its
// plan, whose CTAs the launch refuses if the items are fewer.
struct WholeTile { static constexpr int TY = 8, MINB = 4; };

// A around a cell: the centre and z neighbours from the column's
// registers, the x/y neighbours loaded where the arithmetic uses them.
struct ColumnA {
  const float* q;   // component 0 at the cell
  int n;            // floats from one component to the next
  int sy;           // floats from one row to the next
  bool xm, xp, ym, yp;   // the x/y neighbour lies in the grid
  float cz[3], mz[3], pz[3];
  __device__ __forceinline__ float c(int comp) const { return cz[comp]; }
  __device__ __forceinline__ float m(int comp, int ax) const {
    return ax == 0   ? (xm ? __ldg(q + comp * n - 1) : 0.f)
           : ax == 1 ? (ym ? __ldg(q + comp * n - sy) : 0.f)
                     : mz[comp];
  }
  __device__ __forceinline__ float p(int comp, int ax) const {
    return ax == 0   ? (xp ? __ldg(q + comp * n + 1) : 0.f)
           : ax == 1 ? (yp ? __ldg(q + comp * n + sy) : 0.f)
                     : pz[comp];
  }
};

// U around a cell: the centre and z neighbours from registers, the x/y
// neighbours at -2, -1, +1, +2 loaded where they lie in the grid.
struct ColumnU {
  const float* q;   // U at the cell
  int sy;
  unsigned in;      // bit 4 ax + j: the neighbour j along ax (0 x, 1 y) is in
  float u;
  float zn[4];      // U at z - 2, z - 1, z + 1, z + 2
  __device__ __forceinline__ float u0() const { return u; }
  __device__ __forceinline__ float n(int ax, int j) const {
    const int d = j < 2 ? j - 2 : j - 1;
    if (ax == 2) return zn[j];
    const bool ok = (in >> (4 * ax + j)) & 1u;
    return ok ? __ldg(q + (ax == 0 ? d : d * sy)) : 0.f;
  }
};

// The march of one column: planes [z0, z1) at (x, y), adding its dots to
// pw and py.  cond: the run may hold cells whose code is not 0.
template <int MODE, bool CONV>
__device__ __forceinline__ void column(
    const float* __restrict__ A, const float* __restrict__ U,
    const int32_t* __restrict__ code, const float* __restrict__ cf,
    const float* __restrict__ conv, const float* __restrict__ wA,
    const float* __restrict__ wU, float* __restrict__ yA,
    float* __restrict__ yU, int x, int y, int z0, int z1, bool cond,
    const Grid& g, const Consts& k, int inertia_on_faces, float& pw,
    float& py) {
  constexpr bool DIV = MODE == kDiv;
  constexpr bool DOTS = MODE == kDots;
  // what the run reads: A unless DIV off the conductor; U on the conductor
  const bool reads_a = !DIV || cond;
  const bool reads_u = !DIV && cond;
  // the grid holds fewer than 2^31 values (the wrapper checks 3 nz ny nx)
  const int plane = g.nx * g.ny;
  const int n = plane * g.nz;
  const int iyx = y * g.nx + x;
  const unsigned uin =
      (x > 1) | (x > 0) << 1 | (x < g.nx - 1) << 2 | (x < g.nx - 2) << 3 |
      (y > 1) << 4 | (y > 0) << 5 | (y < g.ny - 1) << 6 | (y < g.ny - 2) << 7;
  auto a_at = [&](int z, float (&r)[3]) {
    const bool in = reads_a && z >= 0 && z < g.nz;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r[c] = in ? __ldg(A + c * n + z * plane + iyx) : 0.f;
    }
  };
  auto u_at = [&](int z) {
    return (reads_u && z >= 0 && z < g.nz) ? __ldg(U + z * plane + iyx)
                                           : 0.f;
  };
  float am[3], ac[3], ap[3];
  a_at(z0 - 1, am);
  a_at(z0, ac);
  float um2 = u_at(z0 - 2), um1 = u_at(z0 - 1), u0 = u_at(z0);
  float up1 = u_at(z0 + 1);

  for (int z = z0; z < z1; ++z) {
    const int i = z * plane + iyx;
    a_at(z + 1, ap);
    const float up2 = u_at(z + 2);
    const int cd = cond ? __ldg(code + i) : 0;
    const ColumnA a{A + i, n, g.nx, x > 0, x < g.nx - 1, y > 0,
                    y < g.ny - 1, {ac[0], ac[1], ac[2]},
                    {am[0], am[1], am[2]}, {ap[0], ap[1], ap[2]}};
    float ya[3] = {0.f, 0.f, 0.f};
    if (!DIV) a_rows(a_face(x, y, z, g, k), a, ya);
    float yu = 0.f;
    if (cd != 0) {
      const ColumnU u{U + i, g.nx, uin, u0, {um2, um1, up1, up2}};
      float c0 = 0.f;
      float cv[3] = {0.f, 0.f, 0.f};
      if (!DIV) c0 = __ldg(cf + i);
      if (CONV) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) cv[ax] = __ldg(conv + ax * n + i);
      }
      yu = conductor<DIV, CONV>(cd, a, u, c0, cv, k, inertia_on_faces, ya);
    }
    if (!DIV) {
#pragma unroll
      for (int c = 0; c < 3; ++c) yA[c * n + i] = ya[c];
    }
    yU[i] = yu;
    if (DOTS) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        pw += ya[c] * __ldg(wA + c * n + i);
        py += ya[c] * ya[c];
      }
      if (cond) {
        pw += yu * __ldg(wU + i);
        py += yu * yu;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      am[c] = ac[c];
      ac[c] = ap[c];
    }
    um2 = um1;
    um1 = u0;
    u0 = up1;
    up1 = up2;
  }
}

// The work items are (segment, run) pairs, item = run * segments +
// segment, so the conducting runs' items come first; a segment is 32 TY
// consecutive columns of the plane in row-major order (rows wrap inside a
// warp, so no lane idles where nx is not a multiple of 32).  CTA b takes
// items b, b + gridDim.x, ... and finishes its dots once.
template <int MODE, bool CONV>
__global__ void __launch_bounds__(32 * WholeTile::TY, WholeTile::MINB)
whole_march(const float* __restrict__ A, const float* __restrict__ U,
            const int32_t* __restrict__ code, const float* __restrict__ cf,
            const float* __restrict__ conv, const float* __restrict__ wA,
            const float* __restrict__ wU, float* __restrict__ yA,
            float* __restrict__ yU, DotOut d, const int* __restrict__ runs,
            int n_items, Grid g, Consts k, int inertia_on_faces) {
  constexpr int NT = 32 * WholeTile::TY;
  const int plane = g.nx * g.ny;
  const int segs = (plane + NT - 1) / NT;
  float pw = 0.f;
  float py = 0.f;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int j = item / segs;
    const int f = (item - j * segs) * NT + static_cast<int>(threadIdx.x);
    const int y = f / g.nx;
    const int x = f - y * g.nx;
    if (f < plane) {
      column<MODE, CONV>(A, U, code, cf, conv, wA, wU, yA, yU, x, y,
                         runs[3 * j], runs[3 * j + 1], runs[3 * j + 2] != 0,
                         g, k, inertia_on_faces, pw, py);
    }
  }
  if (MODE == kDots) finish_dots<32 * WholeTile::TY>(pw, py, d);
}

struct Args {
  const float* A;
  const float* U;
  const int32_t* code;
  const float* cf;
  const float* conv;
  const float* wA;
  const float* wU;
  float* yA;
  float* yU;
  DotOut d;
  const int* runs;
  int n_items;
  int n_ctas;
  Grid g;
  Consts k;
  int inertia_on_faces;
  cudaStream_t stream;
};

template <int MODE, bool CONV>
int go(const Args& a) {
  whole_march<MODE, CONV><<<a.n_ctas, 32 * WholeTile::TY, 0, a.stream>>>(
      a.A, a.U, a.code, a.cf, a.conv, a.wA, a.wU, a.yA, a.yU, a.d, a.runs,
      a.n_items, a.g, a.k, a.inertia_on_faces);
  return static_cast<int>(cudaGetLastError());
}

// out: registers per thread, static and dynamic shared memory per CTA
// (bytes), resident CTAs per SM, local memory per thread (bytes)
template <int MODE, bool CONV>
int info(int* out) {
  auto kern = whole_march<MODE, CONV>;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  int ctas = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, kern, 32 * WholeTile::TY, 0);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = 0;
  out[3] = ctas;
  out[4] = static_cast<int>(fa.localSizeBytes);
  return 0;
}

}  // namespace

extern "C" {

// number of floats the consts argument of coded_matvec_launch must hold
int coded_matvec_consts_len() {
  return static_cast<int>(sizeof(Consts) / sizeof(float));
}

// The coded matvec over the whole grid.  Its work items are segment t of
// 32 WholeTile::TY columns times run j of planes [runs[3j], runs[3j+1]),
// item j segments + t, where runs[3j+2] = 0 promises that no cell of those
// planes has a code other than 0.  n_ctas (1 .. the items) CTAs take the
// items in turn.  mode: 0 apply, 1 apply with dots, 2 div only.  conv may
// be null (no convection); U and yA are ignored in mode 2; wA, wU,
// partials (2 floats per CTA), counter (0 on entry, left 0) and totals
// (dot(y, w), dot(y, y)) are read only in mode 1.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a bad
// mode or a count of CTAs out of range.
int coded_matvec_launch(const void* A, const void* U, const void* code,
                        const void* cf, const void* conv, const void* wA,
                        const void* wU, void* yA, void* yU, void* partials,
                        int n_ctas, void* counter, void* totals,
                        const void* runs, int n_runs, int nx, int ny, int nz,
                        int mode, int inertia_on_faces, const float* consts,
                        void* stream) {
  const long long nt = 32 * WholeTile::TY;
  const long long items =
      (static_cast<long long>(nx) * ny + nt - 1) / nt * n_runs;
  if (n_runs < 1 || n_ctas < 1 || n_ctas > items) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.A = static_cast<const float*>(A);
  a.U = static_cast<const float*>(U);
  a.code = static_cast<const int32_t*>(code);
  a.cf = static_cast<const float*>(cf);
  a.conv = static_cast<const float*>(conv);
  a.wA = static_cast<const float*>(wA);
  a.wU = static_cast<const float*>(wU);
  a.yA = static_cast<float*>(yA);
  a.yU = static_cast<float*>(yU);
  a.d = DotOut{static_cast<float*>(partials), static_cast<unsigned*>(counter),
               nullptr, static_cast<float*>(totals)};
  a.runs = static_cast<const int*>(runs);
  a.n_items = static_cast<int>(items);
  a.n_ctas = n_ctas;
  a.g = Grid{nx, ny, nz};
  std::memcpy(&a.k, consts, sizeof(Consts));
  a.inertia_on_faces = inertia_on_faces;
  a.stream = static_cast<cudaStream_t>(stream);
  const bool has_conv = a.conv != nullptr;
  switch (mode) {
    case kApply:
      return has_conv ? go<kApply, true>(a) : go<kApply, false>(a);
    case kDots:
      return has_conv ? go<kDots, true>(a) : go<kDots, false>(a);
    case kDiv:
      // U = 0: no grad-U, no Laplacian, and convection only feeds yA
      return go<kDiv, false>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What a launch in mode (conv != 0: with convection) runs: out[0..4] =
// registers per thread, static and dynamic shared memory per CTA in bytes,
// resident CTAs per SM, local memory per thread in bytes.  Returns a CUDA
// error code, 0 on success.
int coded_matvec_info(int mode, int conv, int* out) {
  switch (mode) {
    case kApply:
      return conv ? info<kApply, true>(out) : info<kApply, false>(out);
    case kDots:
      return conv ? info<kDots, true>(out) : info<kDots, false>(out);
    case kDiv:
      return info<kDiv, false>(out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
