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

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

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

// value of f at (x, y, z), zero beyond the grid
__device__ __forceinline__ float at(const float* __restrict__ f, int x, int y,
                                   int z, const Grid& g) {
  if (x < 0 || x >= g.nx || y < 0 || y >= g.ny || z < 0 || z >= g.nz) {
    return 0.f;
  }
  return __ldg(f + (static_cast<size_t>(z) * g.ny + y) * g.nx + x);
}

// neighbour at offset d along physical axis a (0 = x, 1 = y, 2 = z)
__device__ __forceinline__ float nbr(const float* __restrict__ f, int x, int y,
                                     int z, int a, int d, const Grid& g) {
  return at(f, x + (a == 0 ? d : 0), y + (a == 1 ? d : 0),
            z + (a == 2 ? d : 0), g);
}

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

    if (MODE != kDiv) {
      // ---- constant + face 7-point A stencil ----
      const bool fm[3] = {x == 0, y == 0, z == 0};
      const bool fp[3] = {x == g.nx - 1, y == g.ny - 1, z == g.nz - 1};
      float cm[3], cp[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        cm[a] = fm[a] ? 0.f : (fp[a] ? k.bndm[a] : -k.s[a]);
        cp[a] = fp[a] ? 0.f : (fm[a] ? k.bndp[a] : -k.s[a]);
      }
      float diag = ((fm[0] || fp[0]) ? k.s[0] : 2.f * k.s[0]) +
                   ((fm[1] || fp[1]) ? k.s[1] : 2.f * k.s[1]);
      diag = diag + ((fm[2] || fp[2]) ? k.s[2] : 2.f * k.s[2]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* Ac = A + c * n;
        float v = diag * __ldg(Ac + i);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          v = v + cm[a] * nbr(Ac, x, y, z, a, -1, g);
          v = v + cp[a] * nbr(Ac, x, y, z, a, +1, g);
        }
        ya[c] = v;
      }
    }

    float yu = 0.f;
    if (cd != 0) {
      // ---- case decode (bit set = that neighbour is not conducting) ----
      const bool mm[3] = {((cd >> 0) & 1) != 0, ((cd >> 2) & 1) != 0,
                          ((cd >> 4) & 1) != 0};
      const bool mp[3] = {((cd >> 1) & 1) != 0, ((cd >> 3) & 1) != 0,
                          ((cd >> 5) & 1) != 0};
      const bool cond = ((cd >> 6) & 1) != 0;
      const bool intc = ((cd >> 7) & 1) != 0;

      if (MODE != kDiv) {
        const float c0 = __ldg(cf + i);
        const float u0 = __ldg(U + i);
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
          float gc = g0 * u0 + gm1 * nbr(U, x, y, z, c, -1, g) +
                     gm2 * nbr(U, x, y, z, c, -2, g) +
                     gp1 * nbr(U, x, y, z, c, +1, g) +
                     gp2 * nbr(U, x, y, z, c, +2, g);
          const float* Ac = A + c * n;
          gc = gc + inert * __ldg(Ac + i);
          if (CONV) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              gc = gc + __ldg(conv + a * n + i) *
                            (nbr(Ac, x, y, z, a, +1, g) -
                             nbr(Ac, x, y, z, a, -1, g));
            }
          }
          ya[c] = ya[c] + gc;
        }

        // ---- U row: case-coded Laplacian ----
        yu = (cond ? k.sdiag : 0.f) * u0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float km = mp[a] ? -2.f * k.s[a] : (mm[a] ? 0.f : -k.s[a]);
          const float kp = mm[a] ? -2.f * k.s[a] : (mp[a] ? 0.f : -k.s[a]);
          yu = yu + (cond ? km : 0.f) * nbr(U, x, y, z, a, -1, g);
          yu = yu + (cond ? kp : 0.f) * nbr(U, x, y, z, a, +1, g);
        }
      }

      // ---- U row: div(dA/dt) ----
      const bool any_missing =
          mm[0] || mp[0] || mm[1] || mp[1] || mm[2] || mp[2];
      const bool interior13 = cond && !any_missing;
      const bool quirk = cond && mm[0] && mp[1] && mp[2];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float big = k.big[a];
        float sign = mp[a] ? big : (mm[a] ? -big : 0.f);
        if (a == 0 && quirk) sign = big;
        if (a == 1 && quirk) sign = -big;
        const float* Aa = A + a * n;
        yu = yu + ((cond && (mm[a] || mp[a])) ? sign : 0.f) * __ldg(Aa + i);
        yu = yu + (interior13 ? k.half[a] : 0.f) * nbr(Aa, x, y, z, a, -1, g);
        yu = yu + (interior13 ? -k.half[a] : 0.f) * nbr(Aa, x, y, z, a, +1, g);
      }
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

  if (MODE == kDots) {
    // block reduction: warp shuffles, then one value per warp in shared
    // memory, summed in a fixed order by thread 0 (no atomics)
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
}

dim3 grid_of(int nx, int ny, int nz) {
  return dim3((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY, nz);
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
