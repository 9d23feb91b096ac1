// Internal-mode phase mom: u/v advection and leapfrog step, implicit
// vertical diffusion with bottom friction, Orlanski open boundaries and the
// Asselin filter with depth-mean correction (advance.f:459-521).
//
// Replaces phase "mom" of extpom_tpu/pallas/phases.py:_kernel (via
// windowed_phase and runner.mom), which runs core/stepper.py:phase_mom on
// halo-extended i-stripes in TPU VMEM.  Counterpart here of
// kernels/phases.py:phase_mom_plain (core/stepper.py:292-314,
// ops/momentum.py:advu/advv, ops/vertical.py:profu/profv,
// bc/orlanski.py:orl_vel3d).
//
// Bound on the H100: memory.  Per column it reads 10 kb-level fields (u, ub,
// v, vb, w, advx, advy, drhox, drhoy, km) and writes 4 (uf, u, vf, v) and
// two 2-D fields (wubot, wvbot), with ~120 flops per level and component.
//
// Design: one thread per (i, j) column, two launches, because orl_vel3d
// reads the neighbour's SOLVED uf/vf one and two rows in and the Asselin
// filter needs the column's final uf:
//   k_solve  advu/advv level by level inside the forward sweep of the
//            profu/profv Thomas solves (extpom::thomas_column), into a
//            scratch uf/vf; edge columns keep the raw vertical advection
//            (momentum.py:95-97, 125-127; vertical.py:117-118); wubot/wvbot
//            on the interior;
//   k_final  the Orlanski edge values (east, west, south, north in the
//            reference's order), the dum/dvm mask on k < kbm1, and the
//            Asselin filter with the depth-mean correction.
// Built with -fmad=false so each operation rounds as the plain PyTorch
// version's does; the depth sums run in ascending k, as the plain phase's
// do (kernels/phases.py:_depth_sum).
//
// extpom_phase_mom_mesh_f32/f64 run the same kernels on one ring-extended
// block of the decomposed step (O, column.cuh), replacing the same TPU
// kernel with has_off (via mesh_runner): regions and the Orlanski rows at
// global (i, j), k_solve skipping 2 cells next to the block's split edges
// and k_final 4 (their unguarded reads reach 1 and 2 cells).

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

using extpom::GeomT;

template <typename T, bool O>
struct Mom {
  const T *u, *ub, *v, *vb, *w, *advx, *advy, *drhox, *drhoy, *km;  // 3-D
  const T *dt, *egf, *egb, *etb, *etf;                              // 2-D
  const T *e_atmos, *wusurf, *wvsurf;                               // 2-D
  const T *h, *dx, *dy, *aru, *arv, *cor, *cbc, *dum, *dvm;         // 2-D
  const T *dz, *dzz;                                                // (kb,)
  T *uo, *ubo, *vo, *vbo, *wubot, *wvbot;                           // outputs
  T *ufs, *vfs, *ees, *ggs;                                         // scratch
  GeomT<O> g;
  int kbm1, kbm2;
  // constants, each formed in double as the Python expression forms it and
  // rounded to T as PyTorch rounds a Python float operand
  T dti2, mdti2, dti2x2, g0125, umol, hsmoth;
};

// ---- k_solve ----------------------------------------------------------------

template <typename T, bool O>
__global__ void k_solve(Mom<T, O> s) {
  const auto& g = s.g;
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.n) return;
  const int i = p / g.jm, j = p % g.jm;
  if (g.skip(i, j)) return;
  const int gi = g.gi(i), gj = g.gj(j);
  const int jm = g.jm, kbm1 = s.kbm1, kbm2 = s.kbm2;
  const long n = g.n;
  // vertical advection, on [1:kbm1, 1:, :] (u) and [1:kbm1, :, 1:] (v)
  auto vadv_u = [&](int k) -> T {
    if (k < 1 || k >= kbm1 || gi < 1) return T(0);
    const long q = k * n + p;
    return T(0.25) * (s.w[q] + s.w[q - jm]) * (s.u[q] + s.u[q - n]);
  };
  auto vadv_v = [&](int k) -> T {
    if (k < 1 || k >= kbm1 || gj < 1) return T(0);
    const long q = k * n + p;
    return T(0.25) * (s.w[q] + s.w[q - 1]) * (s.v[q] + s.v[q - n]);
  };
  if (gi < 1 || gi > g.GI() - 2 || gj < 1 || gj > g.GJ() - 2) {
    // outside the combine region uf/vf hold the raw vertical advection,
    // which profu/profv leave as it is
    for (int k = 0; k < g.kb; ++k) {
      s.ufs[k * n + p] = vadv_u(k);
      s.vfs[k * n + p] = vadv_v(k);
    }
    s.wubot[p] = T(0);
    s.wvbot[p] = T(0);
    return;
  }
  const long pw = p - jm, ps = p - 1;
  const T h = s.h[p], etb = s.etb[p], etf = s.etf[p], dt = s.dt[p];

  // ---- u: advu (momentum.py:72-102), then profu ----
  {
    const T aru = s.aru[p], dtw = s.dt[pw];
    const T eg = s.egf[p] - s.egf[pw] + s.egb[p] - s.egb[pw] +
                 (s.e_atmos[p] - s.e_atmos[pw]) * T(2);
    const T pgrad = s.g0125 * (dt + dtw) * eg * (s.dy[p] + s.dy[pw]);
    const T num = (h + etb + s.h[pw] + s.etb[pw]) * aru;
    const T den = (h + etf + s.h[pw] + s.etf[pw]) * aru;
    auto adv = [&](int k) -> T {  // uf on the interior, level k < kbm1
      const long q = k * n + p;
      const T cori = aru * T(0.25) *
                     (s.cor[p] * dt * (s.v[q + 1] + s.v[q]) +
                      s.cor[pw] * dtw * (s.v[q - jm + 1] + s.v[q - jm]));
      const T f = s.advx[q] + (vadv_u(k) - vadv_u(k + 1)) * aru / s.dz[k] -
                  cori + pgrad + s.drhox[q];
      return (num * s.ub[q] - s.dti2x2 * f) / den;
    };
    const T dh = T(0.5) * (h + etf + s.h[pw] + s.etf[pw]);
    auto kdif = [&](int k) -> T {
      return T(0.5) * (s.km[k * n + p] + s.km[k * n + pw]) + s.umol;
    };
    auto coef_a = [&](int k) -> T {
      return k < kbm2 ? s.mdti2 * kdif(k + 1) / (s.dz[k] * s.dzz[k] * dh * dh)
                      : T(0);
    };
    auto coef_c = [&](int k) -> T {
      return k >= 1 && k < kbm1
                 ? s.mdti2 * kdif(k) / (s.dz[k] * s.dzz[k - 1] * dh * dh)
                 : T(0);
    };
    const long qb = (long)(kbm1 - 1) * n + p;
    const T ubb = s.ub[qb];
    const T vbb = T(0.25) * (s.vb[qb] + s.vb[qb + 1] + s.vb[qb - jm] +
                             s.vb[qb - jm + 1]);
    const T tps = T(0.5) * (s.cbc[p] + s.cbc[pw]) * sqrt(ubb * ubb + vbb * vbb);
    const T a0 = coef_a(0);
    const T ee0 = a0 / (a0 - T(1));
    const T gg0 = (s.mdti2 * s.wusurf[p] / (-s.dz[0] * dh) - adv(0)) /
                  (a0 - T(1));
    const T db = tps * s.dti2 / (-s.dz[kbm2] * dh) - T(1);
    T bottom = T(0);
    extpom::thomas_column<T>(
        [&](int k, T& a, T& c, T& dn, T& rhs) {
          a = coef_a(k);
          c = coef_c(k);
          dn = T(1);
          rhs = -adv(k);
        },
        [&](int k, T f) {
          s.ufs[k * n + p] = f;
          if (k == kbm2) bottom = f;
        },
        ee0, gg0, coef_c(kbm2), -adv(kbm2), db, s.dum[p], s.ees, s.ggs, n, p,
        1, kbm2);
    for (int k = kbm1; k < g.kb; ++k) s.ufs[k * n + p] = T(0);
    s.wubot[p] = -tps * bottom;
  }

  // ---- v: advv (momentum.py:105-132), then profv ----
  {
    const T arv = s.arv[p], dts = s.dt[ps];
    const T eg = s.egf[p] - s.egf[ps] + s.egb[p] - s.egb[ps] +
                 (s.e_atmos[p] - s.e_atmos[ps]) * T(2);
    const T pgrad = s.g0125 * (dt + dts) * eg * (s.dx[p] + s.dx[ps]);
    const T num = (h + etb + s.h[ps] + s.etb[ps]) * arv;
    const T den = (h + etf + s.h[ps] + s.etf[ps]) * arv;
    auto adv = [&](int k) -> T {
      const long q = k * n + p;
      const T cori = arv * T(0.25) *
                     (s.cor[p] * dt * (s.u[q + jm] + s.u[q]) +
                      s.cor[ps] * dts * (s.u[q + jm - 1] + s.u[q - 1]));
      const T f = s.advy[q] + (vadv_v(k) - vadv_v(k + 1)) * arv / s.dz[k] +
                  cori + pgrad + s.drhoy[q];
      return (num * s.vb[q] - s.dti2x2 * f) / den;
    };
    const T dh = T(0.5) * (h + etf + s.h[ps] + s.etf[ps]);
    auto kdif = [&](int k) -> T {
      return T(0.5) * (s.km[k * n + p] + s.km[k * n + ps]) + s.umol;
    };
    auto coef_a = [&](int k) -> T {
      return k < kbm2 ? s.mdti2 * kdif(k + 1) / (s.dz[k] * s.dzz[k] * dh * dh)
                      : T(0);
    };
    auto coef_c = [&](int k) -> T {
      return k >= 1 && k < kbm1
                 ? s.mdti2 * kdif(k) / (s.dz[k] * s.dzz[k - 1] * dh * dh)
                 : T(0);
    };
    const long qb = (long)(kbm1 - 1) * n + p;
    const T ubb = T(0.25) * (s.ub[qb] + s.ub[qb + jm] + s.ub[qb - 1] +
                             s.ub[qb + jm - 1]);
    const T vbb = s.vb[qb];
    const T tps = T(0.5) * (s.cbc[p] + s.cbc[ps]) * sqrt(ubb * ubb + vbb * vbb);
    const T a0 = coef_a(0);
    const T ee0 = a0 / (a0 - T(1));
    const T gg0 = (s.mdti2 * s.wvsurf[p] / (-s.dz[0] * dh) - adv(0)) /
                  (a0 - T(1));
    const T db = tps * s.dti2 / (-s.dz[kbm2] * dh) - T(1);
    T bottom = T(0);
    extpom::thomas_column<T>(
        [&](int k, T& a, T& c, T& dn, T& rhs) {
          a = coef_a(k);
          c = coef_c(k);
          dn = T(1);
          rhs = -adv(k);
        },
        [&](int k, T f) {
          s.vfs[k * n + p] = f;
          if (k == kbm2) bottom = f;
        },
        ee0, gg0, coef_c(kbm2), -adv(kbm2), db, s.dvm[p], s.ees, s.ggs, n, p,
        1, kbm2);
    for (int k = kbm1; k < g.kb; ++k) s.vfs[k * n + p] = T(0);
    s.wvbot[p] = -tps * bottom;
  }
}

// ---- k_final ----------------------------------------------------------------

// Orlanski phase speed, clamped to [0, 1] (a NaN passes through, as
// torch.clamp lets it)
template <typename T>
__device__ __forceinline__ T phase_speed(T ff_b, T fb_b, T f_i) {
  T denom = ff_b + fb_b - T(2) * f_i;
  denom = denom == T(0) ? T(0.01) : denom;
  const T x = (fb_b - ff_b) / denom;
  return x != x ? x : (x < T(0) ? T(0) : (x > T(1) ? T(1) : x));
}

// radiated value (fb (1 - cl) + 2 cl f_in) / (1 + cl)
template <typename T>
__device__ __forceinline__ T radiate(T cl, T fb, T f_in) {
  return (fb * (T(1) - cl) + T(2) * cl * f_in) / (T(1) + cl);
}

// uf after orl_vel3d at level k < kbm1, before the dum mask; at(a, ii)
// reads global row ii of the cell's column
template <typename T, bool O>
__device__ T uf_final(const Mom<T, O>& s, int k, int i, int j) {
  const auto& g = s.g;
  const int im = g.GI(), jm = g.jm, gi = g.gi(i), gj = g.gj(j);
  const long row = k * g.n;
  auto at = [&](const T* a, int ii) {
    return a[row + (long)g.li(ii) * jm + j];
  };
  if (gj >= 1 && gj <= g.GJ() - 2) {
    if (gi == im - 1) {  // east: uf/ub one row in, u two rows in
      const T cl = phase_speed(at(s.ufs, im - 2), at(s.ub, im - 2),
                               at(s.u, im - 3));
      return radiate(cl, at(s.ub, im - 1), at(s.u, im - 2));
    }
    if (gi <= 1) {  // west: the u-face at 1, then row 0 copies it
      const T cl = phase_speed(at(s.ufs, 2), at(s.ub, 2), at(s.u, 3));
      return radiate(cl, at(s.ub, 1), at(s.u, 2));
    }
  } else if (gi >= 1 && gi <= im - 2) {  // south and north rows
    return T(0);
  }
  return s.ufs[row + (long)i * jm + j];
}

// vf after orl_vel3d at level k < kbm1, before the dvm mask; at(a, jj)
// reads global column jj of the cell's row
template <typename T, bool O>
__device__ T vf_final(const Mom<T, O>& s, int k, int i, int j) {
  const auto& g = s.g;
  const int im = g.GI(), jm = g.GJ(), gi = g.gi(i), gj = g.gj(j);
  const long row = k * g.n + (long)i * g.jm;
  auto at = [&](const T* a, int jj) { return a[row + g.lj(jj)]; };
  if (gi >= 1 && gi <= im - 2) {
    if (gj == jm - 1) {  // north
      const T cl = phase_speed(at(s.vfs, jm - 2), at(s.vb, jm - 2),
                               at(s.v, jm - 3));
      return radiate(cl, at(s.vb, jm - 1), at(s.v, jm - 2));
    }
    if (gj <= 1) {  // south: the v-face at 1, then column 0 copies it
      const T cl = phase_speed(at(s.vfs, 2), at(s.vb, 2), at(s.v, 3));
      return radiate(cl, at(s.vb, 1), at(s.v, 2));
    }
  } else if (gj >= 1 && gj <= jm - 2) {  // east and west rows
    return T(0);
  }
  return s.vfs[row + j];
}

template <typename T, bool O>
__global__ void k_final(Mom<T, O> s) {
  const auto& g = s.g;
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.n) return;
  const int i = p / g.jm, j = p % g.jm;
  if (g.skip(i, j)) return;
  const long n = g.n;
  const T dum = s.dum[p], dvm = s.dvm[p];
  T tpu = T(0), tpv = T(0);
  for (int k = 0; k < g.kb; ++k) {
    const long q = k * n + p;
    const T uf = k < s.kbm1 ? uf_final(s, k, i, j) * dum : s.ufs[q];
    const T vf = k < s.kbm1 ? vf_final(s, k, i, j) * dvm : s.vfs[q];
    s.uo[q] = uf;
    s.vo[q] = vf;
    if (k < s.kbm1) {
      tpu = tpu + (uf + s.ub[q] - T(2) * s.u[q]) * s.dz[k];
      tpv = tpv + (vf + s.vb[q] - T(2) * s.v[q]) * s.dz[k];
    }
  }
  for (int k = 0; k < g.kb; ++k) {
    const long q = k * n + p;
    s.ubo[q] = s.u[q] + s.hsmoth * (s.uo[q] + s.ub[q] - T(2) * s.u[q] - tpu);
    s.vbo[q] = s.v[q] + s.hsmoth * (s.vo[q] + s.vb[q] - T(2) * s.v[q] - tpv);
  }
}

constexpr int kThreads = 128;
constexpr int kPointers = 39;

// ptr: the operands, outputs and scratch; the domain is (im, jm), the
// arrays the domain or (O) the (R, L) block at global (oi, oj)
template <typename T, bool O>
int run(void* const* ptr, const double* prm, int kb, int im, int jm, int R,
        int L, int oi, int oj, void* stream) {
  Mom<T, O> s;
  int k = 0;
#define NEXT(f) s.f = (decltype(s.f))ptr[k++]
  NEXT(u); NEXT(ub); NEXT(v); NEXT(vb); NEXT(w); NEXT(advx); NEXT(advy);
  NEXT(drhox); NEXT(drhoy); NEXT(km);
  NEXT(dt); NEXT(egf); NEXT(egb); NEXT(etb); NEXT(etf);
  NEXT(e_atmos); NEXT(wusurf); NEXT(wvsurf);
  NEXT(h); NEXT(dx); NEXT(dy); NEXT(aru); NEXT(arv); NEXT(cor); NEXT(cbc);
  NEXT(dum); NEXT(dvm);
  NEXT(dz); NEXT(dzz);
  NEXT(uo); NEXT(ubo); NEXT(vo); NEXT(vbo); NEXT(wubot); NEXT(wvbot);
  NEXT(ufs); NEXT(vfs); NEXT(ees); NEXT(ggs);
#undef NEXT
  if (k != kPointers) return (int)cudaErrorInvalidValue;
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 2);
  s.kbm1 = kb - 1;
  s.kbm2 = kb - 2;
  // prm: dti2, grav, umol, smoth
  s.dti2 = T(prm[0]);
  s.mdti2 = T(-prm[0]);
  s.dti2x2 = T(2.0 * prm[0]);
  s.g0125 = T(prm[1] * 0.125);
  s.umol = T(prm[2]);
  s.hsmoth = T(0.5 * prm[3]);
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (int)((s.g.n + kThreads - 1) / kThreads);
  k_solve<T, O><<<blocks, kThreads, 0, st>>>(s);
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 4);
  k_final<T, O><<<blocks, kThreads, 0, st>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int extpom_phase_mom_f32(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int, int,
                                    void* stream) {
  return run<float, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, stream);
}

extern "C" int extpom_phase_mom_f64(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int, int,
                                    void* stream) {
  return run<double, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, stream);
}

extern "C" int extpom_phase_mom_mesh_f32(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int, int,
                                         void* stream) {
  return run<float, true>(ptr, prm, kb, im, jm, R, L, oi, oj, stream);
}

extern "C" int extpom_phase_mom_mesh_f64(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int, int,
                                         void* stream) {
  return run<double, true>(ptr, prm, kb, im, jm, R, L, oi, oj, stream);
}
