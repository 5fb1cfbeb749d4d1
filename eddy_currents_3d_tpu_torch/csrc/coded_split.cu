// Split case-coded matvec over the z-compact U, for Hopper (sm_90a).
//
// Replaces the TPU kernels _stencil_kernel_yt and _slab_kernel_yt
// (eddy_currents_3d_tpu/ops/pallas_coded.py:602 and :658), the pair the JAX
// package runs on 256x256-class planes.  The solver's U vectors then hold
// only the conductor slab's planes [zb0, zb0 + nzc): U is zero off the
// conductor in every solver vector, so the compact layout loses nothing.
//   * stencil_kernel: the constant+face A stencil (coded_cell.cuh) on every
//     plane outside the slab.  It reads A and writes yA, nothing else: no
//     code, cf or U.  DOTS also writes per-block partials of yA.wA and
//     yA.yA over those planes only; the slab's planes belong to the slab
//     kernel, so nothing is counted twice.
//   * slab_kernel: the whole coded matvec of coded_matvec.cu on the slab
//     planes.  It reads A (z-neighbours at zb0 - 1 and zb0 + nzc included),
//     the compact U (zero beyond the slab), code, cf and conv, and writes
//     the slab planes of the same yA tensor the stencil kernel fills, so
//     there is no splice copy, and the compact yU.  Modes APPLY, DOTS and
//     DIV (U = 0, only yU: apply_div).
//
// What bounds them on an H100: device-memory bytes, as for coded_matvec.cu.
// An air cell costs the stencil kernel 24 B (A in, yA out) against 32 B in
// coded_matvec (which also reads the code and writes a zero yU there); the
// slab cells cost 40 B as there.  The larger gain is outside the kernels:
// every solver vector's U shrinks to nzc planes.  The thread layout is
// coded_matvec.cu's (one thread per cell on 32x8 (x, y) tiles, one z plane
// per block, guarded neighbour reads, dot partials reduced in the block
// without atomics), and the blocks cover exactly the planes each kernel
// owns.

#include <cstring>

#include "coded_cell.cuh"

using namespace coded;

namespace {

template <bool DOTS>
__global__ void __launch_bounds__(kTX * kTY)
stencil_kernel(const float* __restrict__ A, const float* __restrict__ wA,
               float* __restrict__ yA, float* __restrict__ partials, Grid g,
               int zb0, int nzc, Consts k) {
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  const int bz = static_cast<int>(blockIdx.z);
  const int z = bz < zb0 ? bz : bz + nzc;   // skip the slab's planes
  float pw = 0.f;
  float py = 0.f;

  if (x < g.nx && y < g.ny) {
    const size_t n = static_cast<size_t>(g.nx) * g.ny * g.nz;
    const size_t i = (static_cast<size_t>(z) * g.ny + y) * g.nx + x;
    float ya[3];
    a_stencil(A, x, y, z, i, n, g, k, ya);
#pragma unroll
    for (int c = 0; c < 3; ++c) yA[c * n + i] = ya[c];
    if (DOTS) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        pw += ya[c] * __ldg(wA + c * n + i);
        py += ya[c] * ya[c];
      }
    }
  }
  if (DOTS) block_dots(pw, py, partials);
}

template <int MODE, bool CONV>
__global__ void __launch_bounds__(kTX * kTY)
slab_kernel(const float* __restrict__ A, const float* __restrict__ Uc,
            const int32_t* __restrict__ code, const float* __restrict__ cf,
            const float* __restrict__ conv, const float* __restrict__ wA,
            const float* __restrict__ wUc, float* __restrict__ yA,
            float* __restrict__ yUc, float* __restrict__ partials, Grid g,
            int zb0, int nzc, Consts k, int inertia_on_faces) {
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  const int zl = static_cast<int>(blockIdx.z);   // plane within the slab
  const int z = zb0 + zl;
  float pw = 0.f;
  float py = 0.f;

  if (x < g.nx && y < g.ny) {
    const size_t n = static_cast<size_t>(g.nx) * g.ny * g.nz;
    const size_t i = (static_cast<size_t>(z) * g.ny + y) * g.nx + x;
    const size_t ic = (static_cast<size_t>(zl) * g.ny + y) * g.nx + x;
    const int cd = code[i];
    float ya[3] = {0.f, 0.f, 0.f};
    if (MODE != kDiv) a_stencil(A, x, y, z, i, n, g, k, ya);
    float yu = 0.f;
    if (cd != 0) {
      yu = conductor<MODE == kDiv, CONV>(cd, A, Planes{Uc, zb0, nzc}, cf,
                                         conv, x, y, z, i, n, g, k,
                                         inertia_on_faces, ya);
    }

    if (MODE != kDiv) {
#pragma unroll
      for (int c = 0; c < 3; ++c) yA[c * n + i] = ya[c];
    }
    yUc[ic] = yu;
    if (MODE == kDots) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        pw += ya[c] * __ldg(wA + c * n + i);
        py += ya[c] * ya[c];
      }
      pw += yu * __ldg(wUc + ic);
      py += yu * yu;
    }
  }
  if (MODE == kDots) block_dots(pw, py, partials);
}

template <int MODE, bool CONV>
void launch_slab(const float* A, const float* Uc, const int32_t* code,
                 const float* cf, const float* conv, const float* wA,
                 const float* wUc, float* yA, float* yUc, float* partials,
                 const Grid& g, int zb0, int nzc, const Consts& k,
                 int inertia_on_faces, cudaStream_t stream) {
  slab_kernel<MODE, CONV>
      <<<grid_of(g.nx, g.ny, nzc), dim3(kTX, kTY), 0, stream>>>(
          A, Uc, code, cf, conv, wA, wUc, yA, yUc, partials, g, zb0, nzc, k,
          inertia_on_faces);
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

// number of thread blocks of a launch over nplanes z planes: the partials
// buffer holds 2 floats per block
long long coded_split_num_blocks(int nx, int ny, int nplanes) {
  const dim3 gr = grid_of(nx, ny, nplanes);
  return static_cast<long long>(gr.x) * gr.y * gr.z;
}

// The stencil kernel over the nz - nzc planes outside [zb0, zb0 + nzc).
// dots != 0: also write partials (wA read).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a slab that leaves no
// plane or does not fit the grid.
int coded_stencil_launch(const void* A, const void* wA, void* yA,
                         void* partials, int nx, int ny, int nz, int zb0,
                         int nzc, int dots, const float* consts,
                         void* stream) {
  if (bad_slab(nz, zb0, nzc) || nzc == nz) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Grid g{nx, ny, nz};
  Consts k;
  std::memcpy(&k, consts, sizeof(Consts));
  const auto* a = static_cast<const float*>(A);
  const auto* wa = static_cast<const float*>(wA);
  auto* ya = static_cast<float*>(yA);
  auto* pt = static_cast<float*>(partials);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 gr = grid_of(nx, ny, nz - nzc);
  if (dots) {
    stencil_kernel<true><<<gr, dim3(kTX, kTY), 0, st>>>(a, wa, ya, pt, g,
                                                        zb0, nzc, k);
  } else {
    stencil_kernel<false><<<gr, dim3(kTX, kTY), 0, st>>>(a, wa, ya, pt, g,
                                                         zb0, nzc, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// The slab kernel over planes [zb0, zb0 + nzc).  Uc, wUc and yUc hold those
// planes only.  mode: 0 apply, 1 apply with dots, 2 div only.  conv may be
// null (no convection); Uc and yA are ignored in mode 2; wA, wUc and
// partials are read only in mode 1.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a bad mode or slab.
int coded_slab_launch(const void* A, const void* Uc, const void* code,
                      const void* cf, const void* conv, const void* wA,
                      const void* wUc, void* yA, void* yUc, void* partials,
                      int nx, int ny, int nz, int zb0, int nzc, int mode,
                      int inertia_on_faces, const float* consts,
                      void* stream) {
  if (bad_slab(nz, zb0, nzc)) return static_cast<int>(cudaErrorInvalidValue);
  Grid g{nx, ny, nz};
  Consts k;
  std::memcpy(&k, consts, sizeof(Consts));
  const auto* a = static_cast<const float*>(A);
  const auto* u = static_cast<const float*>(Uc);
  const auto* cdp = static_cast<const int32_t*>(code);
  const auto* cfp = static_cast<const float*>(cf);
  const auto* cv = static_cast<const float*>(conv);
  const auto* wa = static_cast<const float*>(wA);
  const auto* wu = static_cast<const float*>(wUc);
  auto* ya = static_cast<float*>(yA);
  auto* yu = static_cast<float*>(yUc);
  auto* pt = static_cast<float*>(partials);
  auto st = static_cast<cudaStream_t>(stream);
  const bool has_conv = cv != nullptr;
  switch (mode) {
    case kApply:
      if (has_conv) {
        launch_slab<kApply, true>(a, u, cdp, cfp, cv, wa, wu, ya, yu, pt, g,
                                  zb0, nzc, k, inertia_on_faces, st);
      } else {
        launch_slab<kApply, false>(a, u, cdp, cfp, cv, wa, wu, ya, yu, pt, g,
                                   zb0, nzc, k, inertia_on_faces, st);
      }
      break;
    case kDots:
      if (has_conv) {
        launch_slab<kDots, true>(a, u, cdp, cfp, cv, wa, wu, ya, yu, pt, g,
                                 zb0, nzc, k, inertia_on_faces, st);
      } else {
        launch_slab<kDots, false>(a, u, cdp, cfp, cv, wa, wu, ya, yu, pt, g,
                                  zb0, nzc, k, inertia_on_faces, st);
      }
      break;
    case kDiv:
      launch_slab<kDiv, false>(a, u, cdp, cfp, cv, wa, wu, ya, yu, pt, g,
                               zb0, nzc, k, inertia_on_faces, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
