// Split case-coded matvec over the z-compact U, for Hopper (sm_90a).
//
// Replaces the TPU kernels _stencil_kernel_yt and _slab_kernel_yt
// (eddy_currents_3d_tpu/ops/pallas_coded.py:602 and :658), the pair the JAX
// package runs on 256x256-class planes.  The solver's U vectors then hold
// only the conductor slab's planes [zb0, zb0 + nzc): U is zero off the
// conductor in every solver vector, so the compact layout loses nothing.
//   * stencil_march: the constant+face A stencil (coded_cell.cuh) on every
//     plane outside the slab.  It reads A and writes yA, nothing else: no
//     code, cf or U.  With dots it also reads wA and forms yA.wA and yA.yA
//     over those planes only; the slab's planes belong to the slab kernel,
//     so nothing is counted twice.
//   * slab_march: the whole coded matvec of coded_matvec.cu on the slab
//     planes.  It reads A (z-neighbours at zb0 - 1 and zb0 + nzc included),
//     the compact U (zero beyond the slab), code, cf and conv, and writes
//     the slab planes of the same yA tensor the stencil kernel fills, so
//     there is no splice copy, and the compact yU.  Modes APPLY, DOTS and
//     DIV (U = 0, only yU: apply_div).
//
// What bounds them on an H100: device-memory bytes.  The stencil kernel
// must move 24 B per owned cell (A in, yA out), 36 B with dots (wA in);
// the slab kernel 40 B per slab cell (A, U, code, cf in; yA, yU out), 56 B
// with dots, 12 B more with convection.  Each cell needs 30 to 100 flops,
// far below the card's flop-per-byte balance.  What the design does:
//   * A 2.5-D march.  A CTA owns an (x, y) tile of 32 VX x TY cells and a
//     run of z planes.  Thread (tx, ty) of 32 x TY owns the VX cells
//     x0 + tx + 32 v of row y0 + ty, so each v is one coalesced warp row
//     and a thread has VX independent cells of loads in flight.  The
//     current plane's A tile with a one-cell x/y halo (and, in the slab,
//     U with a two-cell halo) sits in shared memory; the thread keeps its
//     cells' A at z - 1, z, z + 1 (and U at z - 2 .. z + 2) in registers.
//     So each A value leaves device memory once and L2 about once per run
//     of planes, plus the halo, where a one-plane-per-block kernel reads
//     it from L2 about three times.
//   * The planes arrive by cp.async (16-byte copies when nx % 4 == 0 and
//     the fields are 16-byte aligned, 4-byte copies otherwise; zero-fill
//     beyond the grid, so an nx or ny that is not a multiple of the tile
//     needs no other path) into a ring of S plane slots: at each step a
//     CTA waits for the planes it reads and issues the copies of the plane
//     S - 1 ahead, so S - 2 planes are in flight while it computes (S - 3
//     in the slab, which reads U two planes ahead).  The cells' own fields
//     (wA; code, cf, conv, wU) ride the same ring, so no global read waits
//     inside a step.  TMA would want 16-byte row strides, which an odd nx
//     does not give.
//   * Copy instructions, not bytes, bounded a first version that copied
//     field by field: every field of one window shape is now copied in one
//     pass, each element's place worked out once, and the addresses are
//     formed anew at each plane rather than held in registers over the
//     march.  __launch_bounds__ asks for at most 128 registers a thread.
//   * The grids are (x, y) tiles x runs of planes, from the plan of
//     ops/coded_split_cuda.py, passed as tables of [first, last) pairs.
//     The stencil kernel's runs skip the slab's planes but read planes zb0
//     and zb0 + nzc - 1 as neighbours; at 256x256x64 they are runs of <= 8
//     planes, 1152 CTAs.  The slab kernel's runs cover the compact planes;
//     at 256x256 one run of all 5 planes per tile, 256 CTAs, one wave.
//     Each kernel has one tile (StencilTile, SlabTile), the fastest of
//     those timed at 256x256x64 on an H100 (PERF.md).
//   * The dots are finished in the kernel.  Each CTA keeps its y.w and y.y
//     partials in registers over its march, reduces them in a fixed order
//     and writes one pair; the last CTA to finish (a device-scope counter
//     after __threadfence, which wraps to 0 as the last CTA counts itself)
//     sums all pairs in a fixed order, adds the prior totals (the slab
//     kernel's prior is the stencil kernel's totals, so the result is
//     stencil + slab) and writes the two totals.  The counter decides which
//     CTA sums, never the order, so repeated calls give the same bits.
// Every cell is evaluated with coded_cell.cuh's expressions in their
// order, on the same values coded_matvec.cu reads.

#include <cstring>

#include "coded_cell.cuh"

using namespace coded;

namespace {

// ---- cp.async: global -> shared copies that land asynchronously ----

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the tile ----
//
// In shared memory a plane's window of rows y0 - H .. y0 + TY + H - 1 is
// held with row stride RS = TX + 8, column x at (x - x0) + 4: the tile's
// first column lands on a 16-byte boundary and a halo of up to 4 columns
// fits on each side.

__host__ __device__ constexpr int rs_of(int vx) { return 32 * vx + 8; }

// Issues the copies of the windows of halo H around tile (x0, y0) of plane
// z of the NF fields f (whose planes [0, nzf) exist, each ny x nx; the
// grid holds fewer than 2^31 values) into dst, dst + stride, ...; entries
// beyond the grid or the fields' planes are zero-filled.  Each element's
// place is worked out once for all NF fields.  vec: nx % 4 == 0 and every
// f 16-byte aligned, so the tile's own columns go as 16-byte copies.
template <int VX, int TY, int H, int NF>
__device__ __forceinline__ void load_windows(float* dst, int stride,
                                             const float* const (&f)[NF],
                                             int z, int nzf, int x0, int y0,
                                             const Grid& g, bool vec) {
  constexpr int TX = 32 * VX;
  constexpr int NT = 32 * TY;
  constexpr int RS = rs_of(VX);
  constexpr int ROWS = TY + 2 * H;
  // the fields and the tile's origin are made opaque here, so the compiler
  // forms the copies' addresses anew at each plane instead of holding them
  // across the march in registers
  const float* p[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    p[i] = f[i];
    asm volatile("" : "+l"(p[i]));
  }
  asm volatile("" : "+r"(x0), "+r"(y0));
  const int tid = threadIdx.x;
  const bool zin = z >= 0 && z < nzf;
  const int zoff = zin ? z * g.ny * g.nx : 0;
  auto copy = [&](int r, int dx, int width) {
    const int y = y0 - H + r;
    const int x = x0 + dx;
    const bool ok = zin && y >= 0 && y < g.ny && x >= 0 && x < g.nx;
    const int off = ok ? zoff + y * g.nx + x : 0;
    float* d = dst + r * RS + 4 + dx;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      if (width == 4) {
        cp_async16(d + i * stride, p[i] + off, ok);
      } else {
        cp_async4(d + i * stride, p[i] + off, ok);
      }
    }
  };
  if (vec) {
    constexpr int Q = TX / 4;
    for (int e = tid; e < ROWS * Q; e += NT) {
      const int r = e / Q;
      copy(r, 4 * (e - r * Q), 4);
    }
    if constexpr (H > 0) {
      constexpr int HC = 2 * H;
      for (int e = tid; e < ROWS * HC; e += NT) {
        const int r = e / HC;
        const int j = e - r * HC;
        copy(r, j < H ? j - H : TX + j - H, 1);
      }
    }
  } else {
    constexpr int C = TX + 2 * H;
    for (int e = tid; e < ROWS * C; e += NT) {
      const int r = e / C;
      copy(r, e - r * C - H, 1);
    }
  }
}

// ---- a cell of the march, for coded_cell.cuh's arithmetic ----

// A around a cell: its x/y neighbours in the current plane's windows in
// shared memory, read where the arithmetic uses them; the centre and the
// z neighbours from the thread's registers.
struct MarchA {
  const float* w;   // the cell in component 0's window
  int plane;        // floats from one component's window to the next
  int rs;           // the windows' row stride
  float cz[3], mz[3], pz[3];
  __device__ __forceinline__ float c(int comp) const { return cz[comp]; }
  __device__ __forceinline__ float m(int comp, int ax) const {
    return ax == 0 ? w[comp * plane - 1]
                   : (ax == 1 ? w[comp * plane - rs] : mz[comp]);
  }
  __device__ __forceinline__ float p(int comp, int ax) const {
    return ax == 0 ? w[comp * plane + 1]
                   : (ax == 1 ? w[comp * plane + rs] : pz[comp]);
  }
};

// U around a cell: x/y neighbours in U's window (two-cell halo), the
// centre and the z neighbours from registers.
struct MarchU {
  const float* w;   // the cell in U's window
  int rs;
  float u;          // U at the cell
  float zn[4];      // U at z - 2, z - 1, z + 1, z + 2
  __device__ __forceinline__ float u0() const { return u; }
  __device__ __forceinline__ float n(int ax, int j) const {
    const int d = j < 2 ? j - 2 : j - 1;
    return ax == 0 ? w[d] : (ax == 1 ? w[d * rs] : zn[j]);
  }
};

// ---- the stencil kernel ----

// CTAs of NT threads resident per SM that the kernels ask the compiler to
// allow: at most 128 registers a thread
__host__ __device__ constexpr int min_ctas(int nt) { return 512 / nt; }

// The kernels' tiles: a CTA of 32 x TY threads covers 32 VX x TY cells of a
// plane (VX cells a thread in x) with a ring of S plane slots.
// ops/coded_split_cuda.py holds the same numbers for its plan; the launches
// refuse a plan whose count of CTAs is not their grid's.
struct StencilTile {
  static constexpr int VX = 4, TY = 4, S = 4;
};
struct SlabTile {
  static constexpr int VX = 1, TY = 8, S = 4;
};

// One ring slot of the stencil kernel, in floats: A's three windows (one-
// cell halo), then with dots wA's three (no halo).
__host__ __device__ constexpr int stencil_slot(bool dots, int vx,
                                                 int ty) {
  return (3 * (ty + 2) + (dots ? 3 * ty : 0)) * rs_of(vx);
}

// Plane z of a run [z0, z1) lives in ring slot (z - z0 + 1) % S.  At step z
// the slots of z and z + 1 have landed (z's windows for the x/y neighbours
// and wA, z + 1's A centres into registers) and planes up to z + S - 1 are
// in flight.
template <bool DOTS>
__global__ void __launch_bounds__(32 * StencilTile::TY,
                                  min_ctas(32 * StencilTile::TY))
stencil_march(const float* __restrict__ A, const float* __restrict__ wA,
              float* __restrict__ yA, DotOut d,
              const int* __restrict__ chunks, Grid g, Consts k, int vec) {
  constexpr int VX = StencilTile::VX;
  constexpr int TY = StencilTile::TY;
  constexpr int S = StencilTile::S;
  static_assert(S >= 3, "the march reads planes z and z + 1 while z + 2 lands");
  constexpr int TX = 32 * VX;
  constexpr int RS = rs_of(VX);
  constexpr int APLANE = (TY + 2) * RS;   // one component's A window
  constexpr int CPLANE = TY * RS;         // one component's wA window
  constexpr int OFF_W = 3 * APLANE;
  constexpr int SLOT = stencil_slot(DOTS, VX, TY);
  extern __shared__ __align__(16) float smem[];

  const int tiles_x = (g.nx + TX - 1) / TX;
  const int x0 = static_cast<int>(blockIdx.x % tiles_x) * TX;
  const int y0 = static_cast<int>(blockIdx.x / tiles_x) * TY;
  const int z0 = chunks[2 * blockIdx.y];
  const int z1 = chunks[2 * blockIdx.y + 1];
  const int tx = threadIdx.x & 31;
  const int ty = static_cast<int>(threadIdx.x >> 5);
  const int y = y0 + ty;
  const size_t plane_n = static_cast<size_t>(g.nx) * g.ny;
  const size_t n = plane_n * g.nz;
  const int actr = (ty + 1) * RS + 4 + tx;
  const int cctr = OFF_W + ty * RS + 4 + tx;

  auto slot = [&](int z) { return smem + ((z - z0 + 1) % S) * SLOT; };
  auto issue = [&](int z) {
    if (z <= z1) {
      float* s = slot(z);
      load_windows<VX, TY, 1>(s, APLANE, {A, A + n, A + 2 * n}, z, g.nz, x0,
                              y0, g, vec);
      if (DOTS && z >= z0 && z < z1) {
        load_windows<VX, TY, 0>(s + OFF_W, CPLANE, {wA, wA + n, wA + 2 * n},
                                z, g.nz, x0, y0, g, vec);
      }
    }
    cp_async_commit();
  };
  auto centres = [&](int z, float (&r)[3][VX]) {
    const float* s = slot(z);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int v = 0; v < VX; ++v) r[c][v] = s[c * APLANE + actr + 32 * v];
    }
  };

  for (int j = 0; j < S; ++j) issue(z0 - 1 + j);
  float am[3][VX], ac[3][VX], ap[3][VX];
  cp_async_wait<S - 1>();
  __syncthreads();
  centres(z0 - 1, am);
  cp_async_wait<S - 2>();
  __syncthreads();
  centres(z0, ac);

  float pw = 0.f;
  float py = 0.f;
  for (int z = z0; z < z1; ++z) {
    cp_async_wait<S - 3>();   // plane z + 1 has landed
    __syncthreads();          // ... for every thread; slot of z - 1 is free
    issue(z + S - 1);
    centres(z + 1, ap);
    const float* sc = slot(z);
#pragma unroll
    for (int v = 0; v < VX; ++v) {
      const int x = x0 + tx + 32 * v;
      if (x < g.nx && y < g.ny) {
        const size_t i = z * plane_n + static_cast<size_t>(y) * g.nx + x;
        const MarchA a{sc + actr + 32 * v, APLANE, RS,
                       {ac[0][v], ac[1][v], ac[2][v]},
                       {am[0][v], am[1][v], am[2][v]},
                       {ap[0][v], ap[1][v], ap[2][v]}};
        float ya[3];
        a_rows(a_face(x, y, z, g, k), a, ya);
#pragma unroll
        for (int c = 0; c < 3; ++c) yA[c * n + i] = ya[c];
        if (DOTS) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            pw += ya[c] * sc[cctr + c * CPLANE + 32 * v];
            py += ya[c] * ya[c];
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int v = 0; v < VX; ++v) {
        am[c][v] = ac[c][v];
        ac[c][v] = ap[c][v];
      }
    }
  }
  if (DOTS) finish_dots<32 * TY>(pw, py, d);
}

// ---- the slab kernel ----

// One ring slot of the slab kernel, in floats: A's three windows (one-cell
// halo); unless DIV, U's window (two-cell halo); then the cells' code,
// unless DIV cf, with CONV conv's three, with DOTS wA's three and wU's (no
// halo).
struct SlabSlot {
  int u, code, cf, conv, w, size;
};

__host__ __device__ constexpr SlabSlot slab_slot(int mode, bool conv,
                                                int vx, int ty) {
  const int rs = rs_of(vx);
  const int cp = ty * rs;
  const int u = 3 * (ty + 2) * rs;
  const int code = u + (mode == kDiv ? 0 : (ty + 4) * rs);
  const int cf = code + cp;
  const int cv = cf + (mode == kDiv ? 0 : cp);
  const int w = cv + (conv ? 3 * cp : 0);
  return SlabSlot{u, code, cf, cv, w, w + (mode == kDots ? 4 * cp : 0)};
}

// A CTA marches compact planes [p0, p1) (grid planes zb0 + p) of one
// tile.  Plane p lives in ring slot (p - p0 + 1) % S.  At step p the slots
// of p, p + 1 and p + 2 have landed (p's windows, p + 1's A centres and
// p + 2's U centres into registers); U at p0 - 2 and p0 - 1 is read once,
// directly.
template <int MODE, bool CONV>
__global__ void __launch_bounds__(32 * SlabTile::TY,
                                  min_ctas(32 * SlabTile::TY))
slab_march(const float* __restrict__ A, const float* __restrict__ Uc,
           const int32_t* __restrict__ code, const float* __restrict__ cf,
           const float* __restrict__ conv, const float* __restrict__ wA,
           const float* __restrict__ wUc, float* __restrict__ yA,
           float* __restrict__ yUc, DotOut d,
           const int* __restrict__ runs, Grid g, int zb0, int nzc,
           Consts k, int inertia_on_faces, int vec) {
  constexpr int VX = SlabTile::VX;
  constexpr int TY = SlabTile::TY;
  constexpr int S = SlabTile::S;
  static_assert(S >= 4, "the march reads planes p .. p + 2 while p + 3 lands");
  constexpr bool DIV = MODE == kDiv;
  constexpr bool DOTS = MODE == kDots;
  constexpr int TX = 32 * VX;
  constexpr int RS = rs_of(VX);
  constexpr int APLANE = (TY + 2) * RS;
  constexpr int CPLANE = TY * RS;
  constexpr SlabSlot L = slab_slot(MODE, CONV, VX, TY);
  extern __shared__ __align__(16) float smem[];

  const int tiles_x = (g.nx + TX - 1) / TX;
  const int x0 = static_cast<int>(blockIdx.x % tiles_x) * TX;
  const int y0 = static_cast<int>(blockIdx.x / tiles_x) * TY;
  const int tx = threadIdx.x & 31;
  const int ty = static_cast<int>(threadIdx.x >> 5);
  const int y = y0 + ty;
  const size_t plane_n = static_cast<size_t>(g.nx) * g.ny;
  const size_t n = plane_n * g.nz;
  const int p0 = runs[2 * blockIdx.y];
  const int p1 = runs[2 * blockIdx.y + 1];
  const int actr = (ty + 1) * RS + 4 + tx;
  const int uctr = L.u + (ty + 2) * RS + 4 + tx;
  const int cctr = ty * RS + 4 + tx;   // in a no-halo window

  auto slot = [&](int p) { return smem + ((p - p0 + 1) % S) * L.size; };
  // the windows plane p is needed for: A for p0 - 1 .. p1, U for p0 ..
  // p1 + 1, the cells' own fields for the run's planes
  auto issue = [&](int p) {
    float* s = slot(p);
    const int z = zb0 + p;
    if (p <= p1) {
      load_windows<VX, TY, 1>(s, APLANE, {A, A + n, A + 2 * n}, z, g.nz, x0,
                              y0, g, vec);
    }
    if (!DIV && p >= p0 && p <= p1 + 1 && p < nzc) {
      load_windows<VX, TY, 2>(s + L.u, 0, {Uc}, p, nzc, x0, y0, g, vec);
    }
    if (p >= p0 && p < p1) {
      // the cells' own fields, consecutive windows from L.code
      const float* cd = reinterpret_cast<const float*>(code);
      if (DIV) {
        load_windows<VX, TY, 0>(s + L.code, CPLANE, {cd}, z, g.nz, x0, y0, g,
                                vec);
      } else if (CONV && DOTS) {
        load_windows<VX, TY, 0>(
            s + L.code, CPLANE,
            {cd, cf, conv, conv + n, conv + 2 * n, wA, wA + n, wA + 2 * n}, z,
            g.nz, x0, y0, g, vec);
      } else if (CONV) {
        load_windows<VX, TY, 0>(s + L.code, CPLANE,
                                {cd, cf, conv, conv + n, conv + 2 * n}, z,
                                g.nz, x0, y0, g, vec);
      } else if (DOTS) {
        load_windows<VX, TY, 0>(s + L.code, CPLANE,
                                {cd, cf, wA, wA + n, wA + 2 * n}, z, g.nz,
                                x0, y0, g, vec);
      } else {
        load_windows<VX, TY, 0>(s + L.code, CPLANE, {cd, cf}, z, g.nz, x0,
                                y0, g, vec);
      }
      if (DOTS) {
        load_windows<VX, TY, 0>(s + L.w + 3 * CPLANE, 0, {wUc}, p, nzc, x0,
                                y0, g, vec);
      }
    }
    cp_async_commit();
  };
  auto a_centres = [&](int p, float (&r)[3][VX]) {
    const float* s = slot(p);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int v = 0; v < VX; ++v) r[c][v] = s[c * APLANE + actr + 32 * v];
    }
  };
  // U's centres of plane p, zero beyond the slab
  auto u_centres = [&](int p, float (&r)[VX]) {
    const float* s = slot(p);
#pragma unroll
    for (int v = 0; v < VX; ++v) {
      r[v] = (!DIV && p < nzc) ? s[uctr + 32 * v] : 0.f;
    }
  };

  for (int j = 0; j < S; ++j) issue(p0 - 1 + j);
  float am[3][VX], ac[3][VX], ap[3][VX];
  float um2[VX], um1[VX], u0[VX], up1[VX], up2[VX];
#pragma unroll
  for (int v = 0; v < VX; ++v) {
    const int x = x0 + tx + 32 * v;
    const bool in = !DIV && x < g.nx && y < g.ny;
    const size_t iyx = static_cast<size_t>(y) * g.nx + x;
    um2[v] = (in && p0 >= 2) ? __ldg(Uc + (p0 - 2) * plane_n + iyx) : 0.f;
    um1[v] = (in && p0 >= 1) ? __ldg(Uc + (p0 - 1) * plane_n + iyx) : 0.f;
  }
  cp_async_wait<S - 1>();
  __syncthreads();
  a_centres(p0 - 1, am);
  cp_async_wait<S - 2>();
  __syncthreads();
  a_centres(p0, ac);
  u_centres(p0, u0);
  cp_async_wait<S - 3>();
  __syncthreads();
  u_centres(p0 + 1, up1);

  float pw = 0.f;
  float py = 0.f;
  for (int p = p0; p < p1; ++p) {
    cp_async_wait<S - 4>();   // plane p + 2 has landed
    __syncthreads();          // ... for every thread; slot of p - 1 is free
    issue(p + S - 1);
    a_centres(p + 1, ap);
    u_centres(p + 2, up2);
    const float* sc = slot(p);
    const int z = zb0 + p;
#pragma unroll
    for (int v = 0; v < VX; ++v) {
      const int x = x0 + tx + 32 * v;
      if (x < g.nx && y < g.ny) {
        const size_t iyx = static_cast<size_t>(y) * g.nx + x;
        const size_t i = z * plane_n + iyx;
        const size_t ic = p * plane_n + iyx;
        const float* cell = sc + cctr + 32 * v;   // this cell in a no-halo window
        const int cd = __float_as_int(cell[L.code]);
        const MarchA a{sc + actr + 32 * v, APLANE, RS,
                       {ac[0][v], ac[1][v], ac[2][v]},
                       {am[0][v], am[1][v], am[2][v]},
                       {ap[0][v], ap[1][v], ap[2][v]}};
        float ya[3] = {0.f, 0.f, 0.f};
        if (!DIV) a_rows(a_face(x, y, z, g, k), a, ya);
        float yu = 0.f;
        if (cd != 0) {
          const MarchU u{sc + uctr + 32 * v, RS, u0[v],
                         {um2[v], um1[v], up1[v], up2[v]}};
          float c0 = 0.f;
          float cv[3] = {0.f, 0.f, 0.f};
          if (!DIV) c0 = cell[L.cf];
          if (CONV) {
#pragma unroll
            for (int ax = 0; ax < 3; ++ax) cv[ax] = cell[L.conv + ax * CPLANE];
          }
          yu = conductor<DIV, CONV>(cd, a, u, c0, cv, k, inertia_on_faces,
                                    ya);
        }
        if (!DIV) {
#pragma unroll
          for (int c = 0; c < 3; ++c) yA[c * n + i] = ya[c];
        }
        yUc[ic] = yu;
        if (DOTS) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            pw += ya[c] * cell[L.w + c * CPLANE];
            py += ya[c] * ya[c];
          }
          pw += yu * cell[L.w + 3 * CPLANE];
          py += yu * yu;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < VX; ++v) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        am[c][v] = ac[c][v];
        ac[c][v] = ap[c][v];
      }
      um2[v] = um1[v];
      um1[v] = u0[v];
      u0[v] = up1[v];
      up1[v] = up2[v];
    }
  }
  if (DOTS) finish_dots<32 * TY>(pw, py, d);
}

// ---- launches ----

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// out: registers per thread, static and dynamic shared memory per CTA
// (bytes), resident CTAs per SM, local memory per thread (bytes)
template <typename K>
int kernel_info(K kern, int threads, size_t smem, int* out) {
  cudaError_t e = allow_smem(kern, smem);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  int ctas = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, threads,
                                                      smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = ctas;
  out[4] = static_cast<int>(fa.localSizeBytes);
  return 0;
}

int tiles_of(int nx, int ny, int vx, int ty) {
  return ((nx + 32 * vx - 1) / (32 * vx)) * ((ny + ty - 1) / ty);
}

// dynamic shared memory of a CTA: the ring's S slots
size_t stencil_smem(bool dots) {
  return sizeof(float) * StencilTile::S *
         stencil_slot(dots, StencilTile::VX, StencilTile::TY);
}

size_t slab_smem(int mode, bool conv) {
  return sizeof(float) * SlabTile::S *
         slab_slot(mode, conv, SlabTile::VX, SlabTile::TY).size;
}

struct StencilArgs {
  const float* A;
  const float* wA;
  float* yA;
  DotOut d;
  const int* chunks;
  int n_chunks;
  Grid g;
  Consts k;
  int vec;
  cudaStream_t stream;
};

template <bool DOTS>
int stencil_go(const StencilArgs& a) {
  auto kern = stencil_march<DOTS>;
  const size_t smem = stencil_smem(DOTS);
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(tiles_of(a.g.nx, a.g.ny, StencilTile::VX, StencilTile::TY),
                  a.n_chunks);
  kern<<<grid, 32 * StencilTile::TY, smem, a.stream>>>(
      a.A, a.wA, a.yA, a.d, a.chunks, a.g, a.k, a.vec);
  return static_cast<int>(cudaGetLastError());
}

struct SlabArgs {
  const float* A;
  const float* Uc;
  const int32_t* code;
  const float* cf;
  const float* conv;
  const float* wA;
  const float* wUc;
  float* yA;
  float* yUc;
  DotOut d;
  const int* runs;
  int n_runs;
  Grid g;
  int zb0;
  int nzc;
  Consts k;
  int inertia_on_faces;
  int vec;
  cudaStream_t stream;
};

struct SlabLaunch {
  const SlabArgs& a;
  template <int MODE, bool CONV>
  int run() const {
    auto kern = slab_march<MODE, CONV>;
    const size_t smem = slab_smem(MODE, CONV);
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(tiles_of(a.g.nx, a.g.ny, SlabTile::VX, SlabTile::TY),
                    a.n_runs);
    kern<<<grid, 32 * SlabTile::TY, smem, a.stream>>>(
        a.A, a.Uc, a.code, a.cf, a.conv, a.wA, a.wUc, a.yA, a.yUc, a.d,
        a.runs, a.g, a.zb0, a.nzc, a.k, a.inertia_on_faces, a.vec);
    return static_cast<int>(cudaGetLastError());
  }
};

struct SlabInfo {
  int* out;
  template <int MODE, bool CONV>
  int run() const {
    return kernel_info(slab_march<MODE, CONV>, 32 * SlabTile::TY,
                       slab_smem(MODE, CONV), out);
  }
};

// f.run<MODE, CONV>() for the slab kernel of mode and conv
template <typename F>
int with_slab_mode(int mode, bool conv, const F& f) {
  switch (mode) {
    case kApply:
      return conv ? f.template run<kApply, true>()
                  : f.template run<kApply, false>();
    case kDots:
      return conv ? f.template run<kDots, true>()
                  : f.template run<kDots, false>();
    case kDiv:
      // U = 0: no grad-U, no Laplacian, and convection only feeds yA
      return f.template run<kDiv, false>();
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_slab(int nz, int zb0, int nzc) {
  return nzc < 1 || zb0 < 0 || zb0 + nzc > nz;
}

}  // namespace

extern "C" {

// number of floats the consts argument of the launches must hold
int coded_split_consts_len() {
  return static_cast<int>(sizeof(Consts) / sizeof(float));
}

// The stencil kernel over the planes outside [zb0, zb0 + nzc): CTAs
// (tiles, n_chunks), CTA (t, j) marching planes [chunks[2j], chunks[2j+1])
// of tile t.  n_ctas: the CTAs the caller's plan counts, which must be
// the grid's (so a caller whose tile is not StencilTile is refused).
// dots != 0: also read wA and write dot(yA, wA), dot(yA, yA) to totals,
// using partials (2 floats per CTA) and counter (0 on entry, left 0).
// vec: 16-byte copies (nx % 4 == 0, A and wA 16-byte aligned).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a slab
// that leaves no plane or a count of CTAs that is not the grid's.
int coded_stencil_launch(const void* A, const void* wA, void* yA,
                         void* partials, int n_ctas, void* counter,
                         void* totals, const void* chunks, int n_chunks,
                         int vec, int nx, int ny, int nz, int zb0, int nzc,
                         int dots, const float* consts, void* stream) {
  if (bad_slab(nz, zb0, nzc) || nzc == nz || n_chunks < 1 ||
      static_cast<long long>(
          tiles_of(nx, ny, StencilTile::VX, StencilTile::TY)) *
              n_chunks !=
          n_ctas) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StencilArgs a;
  a.A = static_cast<const float*>(A);
  a.wA = static_cast<const float*>(wA);
  a.yA = static_cast<float*>(yA);
  a.d = DotOut{static_cast<float*>(partials), static_cast<unsigned*>(counter),
               nullptr, static_cast<float*>(totals)};
  a.chunks = static_cast<const int*>(chunks);
  a.n_chunks = n_chunks;
  a.g = Grid{nx, ny, nz};
  std::memcpy(&a.k, consts, sizeof(Consts));
  a.vec = vec;
  a.stream = static_cast<cudaStream_t>(stream);
  return dots ? stencil_go<true>(a) : stencil_go<false>(a);
}

// The slab kernel over planes [zb0, zb0 + nzc): CTAs (tiles, n_runs), CTA
// (t, j) marching compact planes [runs[2j], runs[2j+1]) of tile t; n_ctas
// as in coded_stencil_launch, for SlabTile.  Uc, wUc and yUc hold the
// slab's planes only.  mode: 0 apply, 1 apply with dots, 2 div only.  conv
// may be null (no convection); Uc and yA are ignored in mode 2; wA, wUc,
// partials, counter, prior and totals are read only in mode 1, where
// totals = prior + the slab's dots (prior may be null).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a bad
// mode or slab, or a count of CTAs that is not the grid's.
int coded_slab_launch(const void* A, const void* Uc, const void* code,
                      const void* cf, const void* conv, const void* wA,
                      const void* wUc, void* yA, void* yUc, void* partials,
                      int n_ctas, void* counter, const void* prior,
                      void* totals, const void* runs, int n_runs, int vec,
                      int nx, int ny, int nz, int zb0, int nzc, int mode,
                      int inertia_on_faces, const float* consts,
                      void* stream) {
  if (bad_slab(nz, zb0, nzc) || n_runs < 1 ||
      static_cast<long long>(tiles_of(nx, ny, SlabTile::VX, SlabTile::TY)) *
              n_runs !=
          n_ctas) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SlabArgs a;
  a.A = static_cast<const float*>(A);
  a.Uc = static_cast<const float*>(Uc);
  a.code = static_cast<const int32_t*>(code);
  a.cf = static_cast<const float*>(cf);
  a.conv = static_cast<const float*>(conv);
  a.wA = static_cast<const float*>(wA);
  a.wUc = static_cast<const float*>(wUc);
  a.yA = static_cast<float*>(yA);
  a.yUc = static_cast<float*>(yUc);
  a.d = DotOut{static_cast<float*>(partials), static_cast<unsigned*>(counter),
               static_cast<const float*>(prior), static_cast<float*>(totals)};
  a.runs = static_cast<const int*>(runs);
  a.n_runs = n_runs;
  a.g = Grid{nx, ny, nz};
  a.zb0 = zb0;
  a.nzc = nzc;
  std::memcpy(&a.k, consts, sizeof(Consts));
  a.inertia_on_faces = inertia_on_faces;
  a.vec = vec;
  a.stream = static_cast<cudaStream_t>(stream);
  return with_slab_mode(mode, a.conv != nullptr, SlabLaunch{a});
}

// What a launch runs (kernel 0: the stencil kernel, with dots when mode
// is 1; kernel 1: the slab kernel in mode, conv != 0 with convection):
// out[0..4] = registers per thread, static and dynamic shared memory per
// CTA in bytes, resident CTAs per SM, local memory per thread in bytes.
// Returns a CUDA error code, 0 on success.
int coded_split_info(int kernel, int mode, int conv, int* out) {
  if (kernel == 0) {
    const int threads = 32 * StencilTile::TY;
    return mode == kDots
               ? kernel_info(stencil_march<true>, threads, stencil_smem(true),
                             out)
               : kernel_info(stencil_march<false>, threads,
                             stencil_smem(false), out);
  }
  return with_slab_mode(mode, conv != 0, SlabInfo{out});
}

}  // extern "C"
