// Case-coded matvec of the eddy-current operator, for Hopper (sm_90a).
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
// kernels of coded_split.cu: this kernel reads each cell's A (and, on
// conducting cells, U) neighbours for it with guarded global reads.
// Three modes: APPLY; DOTS, which also writes per-block float32 partials
// of y.w and y.y; DIV, where U is 0 and only yU is written (apply_div).
//
// What bounds it on an H100: device-memory bytes.  A cell needs ~30 flops
// in the air and ~100 in a conductor, against 40 B of compulsory traffic
// without convection or dots (A 12 + U 4 + code 4 + cf 4 read, yA 12 +
// yU 4 written); DOTS adds 16 B of w, convection 12 B.  That is far below
// the card's flop-per-byte balance, so the design moves each operand once:
// one thread per cell on 32x8 (x, y) tiles, one z plane per block, so the
// +-1/+-2 neighbour reads of a warp hit the same or adjacent cache lines
// (L1/L2) and each plane's neighbours are reused by the blocks of the next
// planes through the 50 MB L2.  Cells whose code is 0 (not conducting)
// skip the decode and never read U, cf or conv.  Neighbours beyond the
// grid read as zero; the index is guarded, nothing is read out of bounds.
// The dot partials are reduced in the block by warp shuffles and shared
// memory and written to (n_blocks, 2) without atomics, so a run repeats
// bit for bit.  Z-marching with shared-memory planes and TMA is later work.

#include <cstring>

#include "coded_cell.cuh"

using namespace coded;

namespace {

template <int MODE, bool CONV>
__global__ void __launch_bounds__(kTX * kTY)
coded_matvec_kernel(const float* __restrict__ A, const float* __restrict__ U,
                    const int32_t* __restrict__ code,
                    const float* __restrict__ cf,
                    const float* __restrict__ conv,
                    const float* __restrict__ wA,
                    const float* __restrict__ wU, float* __restrict__ yA,
                    float* __restrict__ yU, float* __restrict__ partials,
                    Grid g, Consts k, int inertia_on_faces) {
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  const int z = blockIdx.z;
  float pw = 0.f;
  float py = 0.f;

  if (x < g.nx && y < g.ny) {
    const size_t n = static_cast<size_t>(g.nx) * g.ny * g.nz;
    const size_t i = (static_cast<size_t>(z) * g.ny + y) * g.nx + x;
    const int cd = code[i];
    float ya[3] = {0.f, 0.f, 0.f};
    const GlobalA a{A, i, n, x, y, z, g};
    if (MODE != kDiv) a_rows(a_face(x, y, z, g, k), a, ya);
    float yu = 0.f;
    if (cd != 0) {
      const GlobalU u{Planes{U, 0, g.nz}, x, y, z, g};
      float c0 = 0.f;
      float cv[3] = {0.f, 0.f, 0.f};
      if (MODE != kDiv) c0 = __ldg(cf + i);
      if (CONV) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) cv[ax] = __ldg(conv + ax * n + i);
      }
      yu = conductor<MODE == kDiv, CONV>(cd, a, u, c0, cv, k,
                                         inertia_on_faces, ya);
    }

    if (MODE != kDiv) {
#pragma unroll
      for (int c = 0; c < 3; ++c) yA[c * n + i] = ya[c];
    }
    yU[i] = yu;
    if (MODE == kDots) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        pw += ya[c] * __ldg(wA + c * n + i);
        py += ya[c] * ya[c];
      }
      pw += yu * __ldg(wU + i);
      py += yu * yu;
    }
  }
  if (MODE == kDots) block_dots(pw, py, partials);
}

template <int MODE, bool CONV>
void launch(const float* A, const float* U, const int32_t* code,
            const float* cf, const float* conv, const float* wA,
            const float* wU, float* yA, float* yU, float* partials,
            const Grid& g, const Consts& k, int inertia_on_faces,
            cudaStream_t stream) {
  coded_matvec_kernel<MODE, CONV>
      <<<grid_of(g.nx, g.ny, g.nz), dim3(kTX, kTY), 0, stream>>>(
          A, U, code, cf, conv, wA, wU, yA, yU, partials, g, k,
          inertia_on_faces);
}

}  // namespace

extern "C" {

// number of floats the consts argument of coded_matvec_launch must hold
int coded_matvec_consts_len() {
  return static_cast<int>(sizeof(Consts) / sizeof(float));
}

// number of thread blocks a launch uses: the partials buffer holds
// 2 floats per block
long long coded_matvec_num_blocks(int nx, int ny, int nz) {
  const dim3 gr = grid_of(nx, ny, nz);
  return static_cast<long long>(gr.x) * gr.y * gr.z;
}

// mode: 0 apply, 1 apply with dots, 2 div only.  conv may be null (no
// convection); U is ignored in mode 2; wA, wU and partials are read only
// in mode 1.  Returns cudaGetLastError() after the launch.
int coded_matvec_launch(const void* A, const void* U, const void* code,
                        const void* cf, const void* conv, const void* wA,
                        const void* wU, void* yA, void* yU, void* partials,
                        int nx, int ny, int nz, int mode,
                        int inertia_on_faces, const float* consts,
                        void* stream) {
  Grid g{nx, ny, nz};
  Consts k;
  std::memcpy(&k, consts, sizeof(Consts));
  const auto* a = static_cast<const float*>(A);
  const auto* u = static_cast<const float*>(U);
  const auto* cdp = static_cast<const int32_t*>(code);
  const auto* cfp = static_cast<const float*>(cf);
  const auto* cv = static_cast<const float*>(conv);
  const auto* wa = static_cast<const float*>(wA);
  const auto* wu = static_cast<const float*>(wU);
  auto* ya = static_cast<float*>(yA);
  auto* yu = static_cast<float*>(yU);
  auto* pt = static_cast<float*>(partials);
  auto st = static_cast<cudaStream_t>(stream);
  const bool has_conv = cv != nullptr;
  switch (mode) {
    case kApply:
      if (has_conv) {
        launch<kApply, true>(a, u, cdp, cfp, cv, wa, wu, ya, yu, pt, g, k,
                             inertia_on_faces, st);
      } else {
        launch<kApply, false>(a, u, cdp, cfp, cv, wa, wu, ya, yu, pt, g, k,
                              inertia_on_faces, st);
      }
      break;
    case kDots:
      if (has_conv) {
        launch<kDots, true>(a, u, cdp, cfp, cv, wa, wu, ya, yu, pt, g, k,
                            inertia_on_faces, st);
      } else {
        launch<kDots, false>(a, u, cdp, cfp, cv, wa, wu, ya, yu, pt, g, k,
                             inertia_on_faces, st);
      }
      break;
    case kDiv:
      // U = 0: no grad-U, no Laplacian, and convection only feeds yA
      launch<kDiv, false>(a, u, cdp, cfp, cv, wa, wu, ya, yu, pt, g, k,
                          inertia_on_faces, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
