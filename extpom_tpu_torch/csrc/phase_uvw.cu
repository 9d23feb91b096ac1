// Internal-mode phase uvw: depth-mean adjustment of u, v and the vertical
// velocity w from continuity (advance.f:364-400).
//
// Replaces phase "uvw" of extpom_tpu/pallas/phases.py:_kernel (via
// windowed_phase and runner.uvw), which runs core/stepper.py:phase_uvw on
// halo-extended i-stripes in TPU VMEM.  Counterpart here of
// kernels/phases.py:phase_uvw_plain (core/stepper.py:236-251,
// ops/continuity.py:vertvl, bc/orlanski.py:orl_w).
//
// Bound on the H100: memory.  Per column it reads u, v, w (3 kb words) and
// ~14 2-D words and writes u, v, w (3 kb words), with ~20 flops per level.
//
// Design: one thread per (i, j) column, a loop over k (coalesced in the
// (kb, im, jm) layout), two launches:
//   k_uv  the adjusted u on [:kbm1, 1:, :] and v on [:kbm1, :, 1:]
//         (u - sum_k u dz + (utb + utf) / (dt + dt_w)), copies elsewhere;
//   k_w   vertvl: it reads the ADJUSTED u at i+1 and v at j+1, so it runs
//         after k_uv instead of recomputing the neighbours' depth sums;
//         w[0] = (vfluxb + vflux)/2 on the interior, then the ascending-k
//         running sum, boundary columns passing through, then orl_w
//         (w[:kbm1] *= fsm, edges included).
// Built with -fmad=false so each operation rounds as the plain PyTorch
// version's does; the depth sum runs in ascending k, as the plain phase's
// does (kernels/phases.py:_depth_sum).
//
// extpom_phase_uvw_mesh_f32/f64 run the same kernels on one ring-extended
// block of the decomposed step (O, column.cuh), replacing the same TPU
// kernel with has_off (via mesh_runner): regions at global (i, j), each
// launch skipping 2 more cells next to the block's split edges (its reads
// reach 1 cell).

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

using extpom::GeomT;

template <typename T, bool O>
struct Uvw {
  const T *u, *v, *w;                                // (kb, im, jm)
  const T *dt, *utb, *vtb, *utf, *vtf, *etb, *etf;  // (im, jm)
  const T *vfluxb, *vflux;                          // (im, jm)
  const T *dx, *dy, *fsm;                           // (im, jm)
  const T* dz;                                      // (kb,)
  T *uo, *vo, *wo;                                  // outputs
  GeomT<O> g;
  int kbm1;
  T rdti2;  // 1/dti2: PyTorch on the card divides by a Python float as a
            // product with its reciprocal
};

template <typename T, bool O>
__global__ void k_uv(Uvw<T, O> s) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= s.g.n) return;
  const int i = p / s.g.jm, j = p % s.g.jm;
  if (s.g.skip(i, j)) return;
  const long n = s.g.n;
  if (s.g.gi(i) >= 1) {
    T tps = T(0);
    for (int k = 0; k < s.kbm1; ++k) tps = tps + s.u[k * n + p] * s.dz[k];
    const T add = (s.utb[p] + s.utf[p]) / (s.dt[p] + s.dt[p - s.g.jm]);
    for (int k = 0; k < s.kbm1; ++k)
      s.uo[k * n + p] = (s.u[k * n + p] - tps) + add;
  } else {
    for (int k = 0; k < s.kbm1; ++k) s.uo[k * n + p] = s.u[k * n + p];
  }
  for (int k = s.kbm1; k < s.g.kb; ++k) s.uo[k * n + p] = s.u[k * n + p];
  if (s.g.gj(j) >= 1) {
    T tps = T(0);
    for (int k = 0; k < s.kbm1; ++k) tps = tps + s.v[k * n + p] * s.dz[k];
    const T add = (s.vtb[p] + s.vtf[p]) / (s.dt[p] + s.dt[p - 1]);
    for (int k = 0; k < s.kbm1; ++k)
      s.vo[k * n + p] = (s.v[k * n + p] - tps) + add;
  } else {
    for (int k = 0; k < s.kbm1; ++k) s.vo[k * n + p] = s.v[k * n + p];
  }
  for (int k = s.kbm1; k < s.g.kb; ++k) s.vo[k * n + p] = s.v[k * n + p];
}

template <typename T, bool O>
__global__ void k_w(Uvw<T, O> s) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= s.g.n) return;
  const int i = p / s.g.jm, j = p % s.g.jm;
  if (s.g.skip(i, j)) return;
  const int gi = s.g.gi(i), gj = s.g.gj(j), im = s.g.GI(), jm = s.g.jm;
  const long n = s.g.n;
  const T fsm = s.fsm[p];
  if (gi < 1 || gi > im - 2 || gj < 1 || gj > s.g.GJ() - 2) {
    for (int k = 0; k < s.g.kb; ++k)
      s.wo[k * n + p] = k < s.kbm1 ? s.w[k * n + p] * fsm : s.w[k * n + p];
    return;
  }
  const long pe = p + jm, pn = p + 1;
  // xflux = put(z3, .25 (dy + dy_w) (dt + dt_w) u, [KM1, 1:, 1:]), the
  // interior's i and i+1 faces both inside the region (yflux likewise)
  const T cx = T(0.25) * (s.dy[p] + s.dy[p - jm]) * (s.dt[p] + s.dt[p - jm]);
  const T cxe = T(0.25) * (s.dy[pe] + s.dy[p]) * (s.dt[pe] + s.dt[p]);
  const T cy = T(0.25) * (s.dx[p] + s.dx[p - 1]) * (s.dt[p] + s.dt[p - 1]);
  const T cyn = T(0.25) * (s.dx[pn] + s.dx[p]) * (s.dt[pn] + s.dt[p]);
  const T dxy = s.dx[p] * s.dy[p];
  const T ddt = (s.etf[p] - s.etb[p]) * s.rdti2;
  T wk = T(0.5) * (s.vfluxb[p] + s.vflux[p]);
  s.wo[p] = wk * fsm;  // level 0 < kbm1
  for (int k = 0; k < s.kbm1; ++k) {
    const long q = k * n;
    const T div = cxe * s.uo[q + pe] - cx * s.uo[q + p] +
                  cyn * s.vo[q + pn] - cy * s.vo[q + p];
    wk = wk + s.dz[k] * (div / dxy + ddt);
    s.wo[q + n + p] = k + 1 < s.kbm1 ? wk * fsm : wk;
  }
}

constexpr int kThreads = 256;
constexpr int kPointers = 19;

// ptr: the operands and outputs; the domain is (im, jm), the arrays the
// domain or (O) the (R, L) block at global (oi, oj)
template <typename T, bool O>
int run(void* const* ptr, const double* prm, int kb, int im, int jm, int R,
        int L, int oi, int oj, void* stream) {
  Uvw<T, O> s;
  int k = 0;
#define NEXT(f) s.f = (decltype(s.f))ptr[k++]
  NEXT(u); NEXT(v); NEXT(w);
  NEXT(dt); NEXT(utb); NEXT(vtb); NEXT(utf); NEXT(vtf); NEXT(etb); NEXT(etf);
  NEXT(vfluxb); NEXT(vflux);
  NEXT(dx); NEXT(dy); NEXT(fsm); NEXT(dz);
  NEXT(uo); NEXT(vo); NEXT(wo);
#undef NEXT
  if (k != kPointers) return (int)cudaErrorInvalidValue;
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 2);
  s.kbm1 = kb - 1;
  // prm: dti2
  s.rdti2 = T(1) / T(prm[0]);
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (int)((s.g.n + kThreads - 1) / kThreads);
  k_uv<T, O><<<blocks, kThreads, 0, st>>>(s);
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 4);
  k_w<T, O><<<blocks, kThreads, 0, st>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int extpom_phase_uvw_f32(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int, int,
                                    void* stream) {
  return run<float, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, stream);
}

extern "C" int extpom_phase_uvw_f64(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int, int,
                                    void* stream) {
  return run<double, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, stream);
}

extern "C" int extpom_phase_uvw_mesh_f32(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int, int,
                                         void* stream) {
  return run<float, true>(ptr, prm, kb, im, jm, R, L, oi, oj, stream);
}

extern "C" int extpom_phase_uvw_mesh_f64(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int, int,
                                         void* stream) {
  return run<double, true>(ptr, prm, kb, im, jm, R, L, oi, oj, stream);
}
