// The vector glue of one BiCGSTABwr iteration, for Hopper (sm_90a): three
// kernels between the iteration's two operator applies.
//
// Replaces nothing of the TPU package's kernels: the JAX package leaves
// this glue (axpys, norms, dots, selects) to XLA.  It is the device part
// of solvers/bicgstab.py DeviceLoop._iterate on the fused route, and
// ops/glue_cuda.py holds its plain torch version (TorchGlue), which is the
// glue every other route runs.  Per iteration, with ap = A p, as = A s
// and the dots ap.r0, as.s, as.as from whatever formed them:
//
//   glue_s:  alpha = rr0 / ap.r0;  s = r + (-alpha) ap;  ss = s.s
//   glue_xr: s_rel = sqrt(ss) / |b|; conv_s = s_rel < tol;
//            omega = as.s / as.as;  omega_g = conv_s ? 0 : omega;
//            x = (x + alpha p) + omega_g s;  r = s + (-omega_g) as;
//            rr = r.r;  rr0_new = r.r0;  then, in the last CTA, the
//            iteration's scalars and the loop's carry: r_rel, conv_r,
//            restart, beta, beta_g, omega_p; rr0, relres, done, it += 1
//   glue_p:  p = r + beta_g (p - omega_p ap);  r0 = r on a restart
//
// Every elementwise result is the torch glue's operation for operation
// (__fmul_rn / __fadd_rn / __fsub_rn: no FMA contraction), and every
// scalar its 0-d op (IEEE divide and sqrt, tol compared at float32), so
// given the same dots the outputs are the torch glue's bit for bit.  Only
// the dots are this file's own: each thread sums its items, each CTA its
// threads in a fixed order (coded_cell.cuh block_sum), and the last CTA
// to finish sums the CTAs' partials in a fixed order (the counter picks
// which CTA sums, never the order; no atomics on values), so a solve
// repeats bit for bit.
//
// A vector is one or two leaves (a State's A and U) taken as one index
// space: items [0, na) in leaf a and [na, n) in leaf u, of float4 where
// every leaf's length is a multiple of 4 and every pointer 16-byte
// aligned, else of float.  What bounds it on an H100: bytes.  At team7 a
// vector is 998,784 floats (4.0 MB); glue_s moves 3 of them, glue_xr 7 and
// glue_p 3 (4 on a restart), and the iteration's working set (x, r, r0,
// p, ap, s, as: 28 MB) sits in the 50 MB L2.  A CTA of 256 threads takes
// items t, t + 256 ctas, ... (ctas given by the wrapper).

#include <cuda_runtime.h>

#include <cstdint>

#include "coded_cell.cuh"

namespace {

constexpr int NT = 256;

// The iteration's scalars, in the order of ops/glue_cuda.py SCALARS and
// FLAGS (one 64-byte buffer of the wrapper's scratch).
struct Scalars {
  float alpha, ss, s_rel, omega, omega_g, rr, rr0_new, r_rel, beta, beta_g,
      omega_p;
  int conv_s, conv_r, restart;
};
static_assert(sizeof(Scalars) == 14 * 4, "ops/glue_cuda.py's 16-int buffer");

// What glue_xr reads and writes besides its vectors: the dots of as, |b|
// and tol (a device float, or the value where null), and the loop's carry
// scalars, written by the last CTA.
struct Carry {
  const float* as_s;
  const float* as_as;
  const float* bnorm;
  const float* tol;
  float tol_value;
  float* rr0;
  float* relres;
  bool* done;
  int* it;
};

template <typename T>
struct In {
  const T* a;
  const T* u;
  __device__ __forceinline__ T operator()(int i, int na) const {
    return i < na ? a[i] : u[i - na];
  }
};

template <typename T>
struct Out {
  T* a;
  T* u;
  __device__ __forceinline__ T operator()(int i, int na) const {
    return i < na ? a[i] : u[i - na];
  }
  __device__ __forceinline__ void put(int i, int na, T v) const {
    if (i < na) {
      a[i] = v;
    } else {
      u[i - na] = v;
    }
  }
};

// y + a x and y - a x, rounded as two torch ops: the product, then the sum
__device__ __forceinline__ float axpy(float y, float a, float x) {
  return __fadd_rn(y, __fmul_rn(a, x));
}
__device__ __forceinline__ float4 axpy(float4 y, float a, float4 x) {
  return make_float4(axpy(y.x, a, x.x), axpy(y.y, a, x.y),
                     axpy(y.z, a, x.z), axpy(y.w, a, x.w));
}
__device__ __forceinline__ float ymax(float y, float a, float x) {
  return __fsub_rn(y, __fmul_rn(a, x));
}
__device__ __forceinline__ float4 ymax(float4 y, float a, float4 x) {
  return make_float4(ymax(y.x, a, x.x), ymax(y.y, a, x.y),
                     ymax(y.z, a, x.z), ymax(y.w, a, x.w));
}
// acc + u.v (the dots' own order)
__device__ __forceinline__ float dot(float u, float v, float acc) {
  return fmaf(u, v, acc);
}
__device__ __forceinline__ float dot(float4 u, float4 v, float acc) {
  return fmaf(u.w, v.w, fmaf(u.z, v.z, fmaf(u.y, v.y, fmaf(u.x, v.x, acc))));
}

// Writes the CTA's sums (a, b) to its partials; the last CTA to get here
// sums every CTA's pair in a fixed order.  True in that CTA's thread 0,
// whose a and b then hold the totals.  The counter is 0 on entry and left
// 0 (the last CTA's increment wraps it).  Every thread must call it.
__device__ __forceinline__ bool last_sum(float& a, float& b, float* partials,
                                         unsigned* counter) {
  __shared__ float sa[NT / 32];
  __shared__ float sb[NT / 32];
  __shared__ bool last;
  coded::block_sum<NT>(a, b, sa, sb);
  const unsigned nblk = gridDim.x;
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = a;
    partials[2 * blockIdx.x + 1] = b;
    __threadfence();
    last = atomicInc(counter, nblk - 1) == nblk - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  a = 0.f;
  b = 0.f;
  for (unsigned j = threadIdx.x; j < nblk; j += NT) {
    a += __ldcg(partials + 2 * j);
    b += __ldcg(partials + 2 * j + 1);
  }
  coded::block_sum<NT>(a, b, sa, sb);
  return threadIdx.x == 0;
}

template <typename T>
__global__ void __launch_bounds__(NT)
glue_s(In<T> r, In<T> ap, Out<T> s, int na, int n,
       const float* __restrict__ rr0, const float* __restrict__ ap_r0,
       Scalars* __restrict__ sc, float* __restrict__ partials,
       unsigned* __restrict__ counter) {
  const float alpha = __fdiv_rn(*rr0, *ap_r0);
  const float nalpha = -alpha;
  float ss = 0.f;
  float none = 0.f;
  for (int i = blockIdx.x * NT + threadIdx.x; i < n; i += gridDim.x * NT) {
    const T v = axpy(r(i, na), nalpha, ap(i, na));
    s.put(i, na, v);
    ss = dot(v, v, ss);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) sc->alpha = alpha;
  if (last_sum(ss, none, partials, counter)) sc->ss = ss;
}

template <typename T>
__global__ void __launch_bounds__(NT)
glue_xr(Out<T> x, In<T> p, In<T> s, In<T> as, In<T> r0, Out<T> r, int na,
        int n, Carry q, Scalars* __restrict__ sc,
        float* __restrict__ partials, unsigned* __restrict__ counter) {
  const float alpha = sc->alpha;
  const float bnorm = *q.bnorm;
  const float tol = q.tol != nullptr ? *q.tol : q.tol_value;
  const float s_rel = __fdiv_rn(__fsqrt_rn(sc->ss), bnorm);
  const bool conv_s = s_rel < tol;
  const float omega = __fdiv_rn(*q.as_s, *q.as_as);
  const float omega_g = conv_s ? 0.f : omega;
  const float nomega_g = -omega_g;
  float rr = 0.f;
  float rr0n = 0.f;
  for (int i = blockIdx.x * NT + threadIdx.x; i < n; i += gridDim.x * NT) {
    const T si = s(i, na);
    x.put(i, na, axpy(axpy(x(i, na), alpha, p(i, na)), omega_g, si));
    const T ri = axpy(si, nomega_g, as(i, na));
    r.put(i, na, ri);
    rr = dot(ri, ri, rr);
    rr0n = dot(ri, r0(i, na), rr0n);
  }
  if (!last_sum(rr, rr0n, partials, counter)) return;
  const float r_rel = __fdiv_rn(__fsqrt_rn(rr), bnorm);
  const bool conv_r = r_rel < tol;
  const bool restart = __fdiv_rn(fabsf(rr0n), bnorm) < tol;
  const float rr0 = *q.rr0;
  const float beta =
      __fdiv_rn(__fmul_rn(__fdiv_rn(alpha, omega), rr0n), rr0);
  const bool stop = restart || conv_s;
  const float beta_g = stop ? 0.f : beta;
  const float omega_p = stop ? 0.f : omega;
  *q.rr0 = restart ? rr : rr0n;
  *q.relres = conv_s ? s_rel : r_rel;
  *q.done = conv_s || conv_r;
  *q.it += 1;
  sc->s_rel = s_rel;
  sc->omega = omega;
  sc->omega_g = omega_g;
  sc->rr = rr;
  sc->rr0_new = rr0n;
  sc->r_rel = r_rel;
  sc->beta = beta;
  sc->beta_g = beta_g;
  sc->omega_p = omega_p;
  sc->conv_s = conv_s;
  sc->conv_r = conv_r;
  sc->restart = restart;
}

template <typename T>
__global__ void __launch_bounds__(NT)
glue_p(Out<T> p, In<T> r, In<T> ap, Out<T> r0, int na, int n,
       const Scalars* __restrict__ sc) {
  const float beta_g = sc->beta_g;
  const float omega_p = sc->omega_p;
  const bool restart = sc->restart != 0;
  for (int i = blockIdx.x * NT + threadIdx.x; i < n; i += gridDim.x * NT) {
    const T ri = r(i, na);
    p.put(i, na, axpy(ri, beta_g, ymax(p(i, na), omega_p, ap(i, na))));
    if (restart) r0.put(i, na, ri);
  }
}

template <typename T>
In<T> in(void* const* v, int j) {
  return In<T>{static_cast<const T*>(v[2 * j]),
               static_cast<const T*>(v[2 * j + 1])};
}

template <typename T>
Out<T> out(void* const* v, int j) {
  return Out<T>{static_cast<T*>(v[2 * j]), static_cast<T*>(v[2 * j + 1])};
}

// na, n: items of leaf a and in all, of T
template <typename T>
int launch(int which, void* const* v, int na, int n, void* const* sp,
           float tol_value, int ctas, cudaStream_t st) {
  Scalars* sc = static_cast<Scalars*>(sp[0]);
  float* partials = static_cast<float*>(sp[1]);
  unsigned* counter = static_cast<unsigned*>(sp[2]);
  switch (which) {
    case 0:
      glue_s<T><<<ctas, NT, 0, st>>>(
          in<T>(v, 0), in<T>(v, 1), out<T>(v, 2), na, n,
          static_cast<const float*>(sp[3]), static_cast<const float*>(sp[4]),
          sc, partials, counter);
      break;
    case 1: {
      const Carry q{static_cast<const float*>(sp[3]),
                    static_cast<const float*>(sp[4]),
                    static_cast<const float*>(sp[5]),
                    static_cast<const float*>(sp[6]),
                    tol_value,
                    static_cast<float*>(sp[7]),
                    static_cast<float*>(sp[8]),
                    static_cast<bool*>(sp[9]),
                    static_cast<int*>(sp[10])};
      glue_xr<T><<<ctas, NT, 0, st>>>(out<T>(v, 0), in<T>(v, 1), in<T>(v, 2),
                                      in<T>(v, 3), in<T>(v, 4), out<T>(v, 5),
                                      na, n, q, sc, partials, counter);
      break;
    }
    case 2:
      glue_p<T><<<ctas, NT, 0, st>>>(out<T>(v, 0), in<T>(v, 1), in<T>(v, 2),
                                     out<T>(v, 3), na, n, sc);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch of kernel `which` (0 glue_s, 1 glue_xr, 2 glue_p) with `ctas`
// CTAs of 256 threads.  vecs: (leaf a, leaf u) pointers of each vector, in
// order: glue_s r, ap, s; glue_xr x, p, s, as, r0, r; glue_p p, r, ap, r0
// (the last of each written; x and p read too).  na, nu: floats of leaf a
// and leaf u (nu may be 0, leaf u's pointer then unused); vec 4: every
// length a multiple of 4 and every pointer 16-byte aligned, else 1.
// scal: the Scalars buffer, the partials (2 floats a CTA), the counter (0
// on entry, left 0), then glue_s rr0, ap.r0; glue_xr as.s, as.as, |b|, tol
// (null: tol_value), rr0, relres, done (bool), it (int32).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue.
int solver_glue_launch(int which, void* const* vecs, long long na,
                       long long nu, int vec, void* const* scal,
                       float tol_value, int ctas, void* stream) {
  const long long n = na + nu;
  if (ctas < 1 || na < 1 || nu < 0 || n >= (1ll << 31) ||
      (vec != 1 && vec != 4) || na % vec != 0 || nu % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    return launch<float4>(which, vecs, static_cast<int>(na / 4),
                          static_cast<int>(n / 4), scal, tol_value, ctas, st);
  }
  return launch<float>(which, vecs, static_cast<int>(na),
                       static_cast<int>(n), scal, tol_value, ctas, st);
}

}  // extern "C"
