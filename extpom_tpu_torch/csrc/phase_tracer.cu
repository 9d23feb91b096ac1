// Internal-mode phase tracer: T/S advection, implicit vertical diffusion,
// open-boundary values, Asselin filter and the equation of state
// (advance.f:424-456).
//
// Replaces phase "tracer" of extpom_tpu/pallas/phases.py:_kernel (via
// windowed_phase and runner.tracer), which runs core/stepper.py:
// phase_tracer on halo-extended i-stripes in TPU VMEM.  Counterpart here of
// kernels/phases.py:phase_tracer_plain (core/stepper.py:269-289,
// ops/tracers.py:advt1, ops/vertical.py:proft, bc/bcond.py:bc_ts,
// ops/density.py:dens).
//
// Bound on the H100: memory.  Per column it reads 11 kb-level fields (t,
// tb, s, sb, tclim, sclim, u, v, w, aam, kh) and writes 5 (t, tb, s, sb,
// rho), with ~150 flops per level and tracer plus two exp per level where
// the surface condition has shortwave radiation (nbc 2, 4).
//
// Design: one thread per (i, j) column and one launch.  An interior column
// computes advt1's tendency level by level inside the forward sweep of its
// Thomas solve (extpom::thomas_column, column.cuh), T first and then S
// through the same (2, kb, n) ee/gg scratch, and applies fsm and the
// Asselin filter as the back substitution hands out each level.  An edge
// column takes bc_ts's value instead: bc_ts reads only the OLD t/s/u/v/w/dt,
// so no column needs a neighbour's new value.  The equation of state then
// runs down the column on the new t/s.  Neighbour fluxes are recomputed,
// not stored.  Built with -fmad=false so each operation rounds as the plain
// PyTorch version's does; exp and pow come from CUDA's math library, which
// may differ from PyTorch's in the last bit.
//
// Where an off-by-one would hide:
//   * advt1's ghost bottom layer (tracers.py:65-66) is never read by the
//     levels k < kbm1 it commits; the k=0 zflux is f[0] w[0] art
//     (tracers.py:75);
//   * proft keeps f[kbm1:] of its input, which advt1 left 0 (vertical.py:75);
//   * bc_ts writes east, west, south, north in that order, so a corner takes
//     the south or north value; it writes levels k < kbm1 only, and its
//     vertical-advection correction applies for 0 < k < kbm1-1 with
//     dzz2 == 0 read as 1 (bcond.py:93-100).
//
// extpom_phase_tracer_mesh_f32/f64 run the same kernel on one ring-extended
// block of the decomposed step (O, column.cuh), replacing the same TPU
// kernel with has_off (via mesh_runner): regions and edges at global
// (i, j), the launch skipping 2 cells next to the block's split edges (its
// unguarded reads reach 1 cell).

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

using extpom::GeomT;
using extpom::ld1;
using extpom::ld2;
using extpom::ld3;

template <typename T, bool O>
struct Trc {
  const T *t, *tb, *s, *sb, *tclim, *sclim, *u, *v, *w, *aam, *kh;  // 3-D
  const T *dt, *etb, *etf;                                           // 2-D
  const T *wtsurf, *tsurf, *wssurf, *ssurf, *swrad;                  // 2-D
  const T *tbw, *tbe, *sbw, *sbe;  // (kb, jm)
  const T *tbs, *tbn, *sbs, *sbn;  // (kb, im)
  const T *h, *dx, *dy, *art, *dum, *dvm, *fsm;  // (im, jm)
  const T *z, *zz, *dz, *dzz;                    // (kb,)
  T *to, *tbo, *so, *sbo, *rho;                  // outputs
  T *ees, *ggs;                                  // (kb, n) scratch
  GeomT<O> g;
  int kbm1, kbm2, nbct, nbcs;
  // constants, each formed in double as the Python expression forms it and
  // rounded to T as PyTorch rounds a Python float operand
  T dti2, mdti2, dti, tprni, umol, hsmoth, tbias, sbias, grho, rrhoref, r,
      omr, rad1, rad2;
};

// One tracer's operands: f (time n), fb (n-1), fclim, the surface flux and
// value, the surface condition nbc, the four boundary series and the
// outputs (new f, new fb).
template <typename T>
struct View {
  const T *f, *fb, *fclim, *wfsurf, *fsurf;
  const T *bw, *be, *bs, *bn;
  T *fo, *fbo;
  int nbc;
};

// advt1's x face flux at column q (i >= 1, j >= 1): advection plus the
// climatology-deviation diffusion, times the face width
template <typename T, bool O>
__device__ __forceinline__ T xflux(const Trc<T, O>& s, const View<T>& tv, int k,
                                   long q) {
  const long n = s.g.n, kq = k * n + q, qw = q - s.g.jm, kw = kq - s.g.jm;
  const T x1 = T(0.25) * (s.dt[q] + s.dt[qw]) * (tv.f[kq] + tv.f[kw]) * s.u[kq];
  const T xd = T(-0.5) * (s.aam[kq] + s.aam[kw]) * (s.h[q] + s.h[qw]) *
               s.tprni *
               ((tv.fb[kq] - tv.fclim[kq]) - (tv.fb[kw] - tv.fclim[kw])) *
               s.dum[q] / (s.dx[q] + s.dx[qw]);
  return T(0.5) * (s.dy[q] + s.dy[qw]) * (x1 + xd);
}

template <typename T, bool O>
__device__ __forceinline__ T yflux(const Trc<T, O>& s, const View<T>& tv, int k,
                                   long q) {
  const long n = s.g.n, kq = k * n + q, qs = q - 1, ks = kq - 1;
  const T y1 = T(0.25) * (s.dt[q] + s.dt[qs]) * (tv.f[kq] + tv.f[ks]) * s.v[kq];
  const T yd = T(-0.5) * (s.aam[kq] + s.aam[ks]) * (s.h[q] + s.h[qs]) *
               s.tprni *
               ((tv.fb[kq] - tv.fclim[kq]) - (tv.fb[ks] - tv.fclim[ks])) *
               s.dvm[q] / (s.dy[q] + s.dy[qs]);
  return T(0.5) * (s.dx[q] + s.dx[qs]) * (y1 + yd);
}

// advt1 + proft + fsm + Asselin for one tracer of an interior column
template <typename T, bool O>
__device__ void interior(const Trc<T, O>& s, const View<T>& tv, long p) {
  const long n = s.g.n;
  const int jm = s.g.jm, kbm1 = s.kbm1, kbm2 = s.kbm2;
  const T h = s.h[p], art = s.art[p], fsm = s.fsm[p];
  const T dh = h + s.etf[p];
  const bool with_rad = tv.nbc == 2 || tv.nbc == 4;
  auto rad = [&](int k) -> T {
    if (!with_rad || k >= kbm1) return T(0);
    const T zd = s.z[k] * dh;
    return s.swrad[p] * (s.r * exp(zd * s.rad1) + s.omr * exp(zd * s.rad2));
  };
  auto zflux = [&](int k) -> T {
    if (k == 0) return tv.f[p] * s.w[p] * art;
    if (k < kbm1)
      return T(0.5) * (tv.f[(k - 1) * n + p] + tv.f[k * n + p]) *
             s.w[k * n + p] * art;
    return T(0);
  };
  // advt1's new value at level k < kbm1
  auto adv = [&](int k) -> T {
    const T ff = xflux(s, tv, k, p + jm) - xflux(s, tv, k, p) +
                 yflux(s, tv, k, p + 1) - yflux(s, tv, k, p) +
                 (zflux(k) - zflux(k + 1)) / s.dz[k];
    return (tv.fb[k * n + p] * (h + s.etb[p]) * art - s.dti2 * ff) /
           ((h + s.etf[p]) * art);
  };
  auto coef_a = [&](int k) -> T {
    return k < kbm2 ? s.mdti2 * (s.kh[(k + 1) * n + p] + s.umol) /
                          (s.dz[k] * s.dzz[k] * dh * dh)
                    : T(0);
  };
  auto coef_c = [&](int k) -> T {
    return k >= 1 && k < kbm1 ? s.mdti2 * (s.kh[k * n + p] + s.umol) /
                                    (s.dz[k] * s.dzz[k - 1] * dh * dh)
                              : T(0);
  };
  const T a0 = coef_a(0);
  T ee0, gg0;
  if (tv.nbc == 1) {
    ee0 = a0 / (a0 - T(1));
    gg0 = (s.dti2 * tv.wfsurf[p] / (s.dz[0] * dh) - adv(0)) / (a0 - T(1));
  } else if (tv.nbc == 2) {
    ee0 = a0 / (a0 - T(1));
    gg0 = (s.dti2 * (tv.wfsurf[p] + rad(0) - rad(1)) / (s.dz[0] * dh) -
           adv(0)) /
          (a0 - T(1));
  } else {
    ee0 = T(0);
    gg0 = tv.fsurf[p];
  }
  const T rb = -adv(kbm2) + s.dti2 * (rad(kbm2) - rad(kbm1)) /
                                (dh * s.dz[kbm2]);
  extpom::thomas_column<T>(
      [&](int k, T& a, T& c, T& den, T& rhs) {
        a = coef_a(k);
        c = coef_c(k);
        den = T(1);
        rhs = -adv(k) + s.dti2 * (rad(k) - rad(k + 1)) / (dh * s.dz[k]);
      },
      [&](int k, T f) {
        const long q = k * n + p;
        const T fn = f * fsm;
        tv.fo[q] = fn;
        tv.fbo[q] = tv.f[q] + s.hsmoth * (fn + tv.fb[q] - T(2) * tv.f[q]);
      },
      ee0, gg0, coef_c(kbm2), rb, T(-1), T(1), s.ees, s.ggs, n, p, 1, kbm2);
  for (int k = kbm1; k < s.g.kb; ++k) {  // proft keeps advt1's 0 there
    const long q = k * n + p;
    tv.fo[q] = T(0);
    tv.fbo[q] = tv.f[q] + s.hsmoth * (T(0) + tv.fb[q] - T(2) * tv.f[q]);
  }
}

// bc_ts's value at edge column (i, j), level k < kbm1, before fsm; the
// inner point (ii, jj) is the neighbour towards the interior
template <typename T, bool O>
__device__ T edge_value(const Trc<T, O>& s, const View<T>& tv, int k, int i,
                        int j) {
  const auto& g = s.g;
  const int im = g.im, jm = g.jm;
  const long e = (long)i * jm + j;
  int ii, jj;
  bool le;
  T u1, ext;
  // written east, west, south, north: the last side written wins
  if (g.gj(j) == g.GJ() - 1) {
    ii = i; jj = j - 1; le = true;
    u1 = T(2) * ld3(s.v, g, k, i, j) * s.dti / (s.dy[e] + s.dy[e - 1]);
    ext = tv.bn[k * im + i];
  } else if (g.gj(j) == 0) {
    ii = i; jj = j + 1; le = false;
    u1 = T(2) * ld3(s.v, g, k, i, j + 1) * s.dti / (s.dy[e] + s.dy[e + 1]);
    ext = tv.bs[k * im + i];
  } else if (g.gi(i) == 0) {
    ii = i + 1; jj = j; le = false;
    u1 = T(2) * ld3(s.u, g, k, i + 1, j) * s.dti / (s.dx[e] + s.dx[e + jm]);
    ext = tv.bw[k * jm + j];
  } else {
    ii = i - 1; jj = j; le = true;
    u1 = T(2) * ld3(s.u, g, k, i, j) * s.dti / (s.dx[e] + s.dx[e - jm]);
    ext = tv.be[k * jm + j];
  }
  const T fe = ld3(tv.f, g, k, i, j), fi = ld3(tv.f, g, k, ii, jj);
  // vertical-advection correction of the outflow value
  T dzz2 = ld1(s.zz, g.kb, k - 1) - ld1(s.zz, g.kb, k + 1);
  dzz2 = dzz2 == T(0) ? T(1) : dzz2;
  const T wm = T(0.5) * (ld3(s.w, g, k, ii, jj) + ld3(s.w, g, k + 1, ii, jj)) *
               s.dti / (dzz2 * ld2(s.dt, g, ii, jj));
  const T kmask = (k > 0 && k < s.kbm1 - 1) ? T(1) : T(0);
  const T corr =
      kmask * wm * (ld3(tv.f, g, k - 1, ii, jj) - ld3(tv.f, g, k + 1, ii, jj));
  if (le) {
    const T f_inf = fe - u1 * (ext - fe);
    const T f_out = fe - u1 * (fe - fi) - corr;
    return u1 <= T(0) ? f_inf : f_out;
  }
  const T f_inf = fe - u1 * (fe - ext);
  const T f_out = fe - u1 * (fi - fe) - corr;
  return u1 >= T(0) ? f_inf : f_out;
}

template <typename T, bool O>
__device__ void edge(const Trc<T, O>& s, const View<T>& tv, long p, int i,
                     int j) {
  const long n = s.g.n;
  const T fsm = s.fsm[p];
  for (int k = 0; k < s.g.kb; ++k) {
    const long q = k * n + p;
    const T fn = k < s.kbm1 ? edge_value(s, tv, k, i, j) * fsm : T(0);
    tv.fo[q] = fn;
    tv.fbo[q] = tv.f[q] + s.hsmoth * (fn + tv.fb[q] - T(2) * tv.f[q]);
  }
}

template <typename T, bool O>
__global__ void k_tracer(Trc<T, O> s) {
  const auto& g = s.g;
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.n) return;
  const int i = p / g.jm, j = p % g.jm;
  if (g.skip(i, j)) return;
  const int gi = g.gi(i), gj = g.gj(j);
  const View<T> tt{s.t, s.tb, s.tclim, s.wtsurf, s.tsurf, s.tbw, s.tbe,
                   s.tbs, s.tbn, s.to, s.tbo, s.nbct};
  const View<T> ss{s.s, s.sb, s.sclim, s.wssurf, s.ssurf, s.sbw, s.sbe,
                   s.sbs, s.sbn, s.so, s.sbo, s.nbcs};
  if (gi >= 1 && gi <= g.GI() - 2 && gj >= 1 && gj <= g.GJ() - 2) {
    interior(s, tt, p);
    interior(s, ss, p);
  } else {
    edge(s, tt, p, i, j);
    edge(s, ss, p, i, j);
  }
  // dens on the new t/s (density.py:12-36); layer kb-1 is 0
  const T h = s.h[p], fsm = s.fsm[p];
  for (int k = 0; k < g.kb; ++k) {
    const long q = k * g.n + p;
    if (k == g.kb - 1) {
      s.rho[q] = T(0);
      continue;
    }
    const T tr = s.to[q] + s.tbias, sr = s.so[q] + s.sbias;
    const T tr2 = tr * tr, tr3 = tr2 * tr, tr4 = tr3 * tr;
    const T pr = s.grho * (-s.zz[k] * h) * T(1.0e-5);
    T rhor = T(-0.157406) + T(6.793952e-2) * tr - T(9.095290e-3) * tr2 +
             T(1.001685e-4) * tr3 - T(1.120083e-6) * tr4 +
             T(6.536332e-9) * tr4 * tr;
    rhor = rhor + ((T(0.824493) - T(4.0899e-3) * tr + T(7.6438e-5) * tr2 -
                    T(8.2467e-7) * tr3 + T(5.3875e-9) * tr4) *
                       sr +
                   (T(-5.72466e-3) + T(1.0227e-4) * tr - T(1.6546e-6) * tr2) *
                       pow(fabs(sr), T(1.5)) +
                   T(4.8314e-4) * sr * sr);
    const T cr = T(1449.1) + T(0.0821) * pr + T(4.55) * tr - T(0.045) * tr2 +
                 T(1.34) * (sr - T(35.0));
    rhor = rhor +
           T(1.0e5) * pr / (cr * cr) * (T(1) - T(2) * pr / (cr * cr));
    s.rho[q] = rhor * s.rrhoref * fsm;
  }
}

constexpr int kThreads = 128;
constexpr int kPointers = 45;

// ptr: the operands, outputs and scratch; the domain is (im, jm), the
// arrays the domain or (O) the (R, L) block at global (oi, oj)
template <typename T, bool O>
int run(void* const* ptr, const double* prm, int kb, int im, int jm, int R,
        int L, int oi, int oj, int nbct, int nbcs, void* stream) {
  Trc<T, O> s;
  int k = 0;
#define NEXT(f) s.f = (decltype(s.f))ptr[k++]
  NEXT(t); NEXT(tb); NEXT(s); NEXT(sb); NEXT(tclim); NEXT(sclim); NEXT(u);
  NEXT(v); NEXT(w); NEXT(aam); NEXT(kh);
  NEXT(dt); NEXT(etb); NEXT(etf);
  NEXT(wtsurf); NEXT(tsurf); NEXT(wssurf); NEXT(ssurf); NEXT(swrad);
  NEXT(tbw); NEXT(tbe); NEXT(sbw); NEXT(sbe);
  NEXT(tbs); NEXT(tbn); NEXT(sbs); NEXT(sbn);
  NEXT(h); NEXT(dx); NEXT(dy); NEXT(art); NEXT(dum); NEXT(dvm); NEXT(fsm);
  NEXT(z); NEXT(zz); NEXT(dz); NEXT(dzz);
  NEXT(to); NEXT(tbo); NEXT(so); NEXT(sbo); NEXT(rho);
  NEXT(ees); NEXT(ggs);
#undef NEXT
  if (k != kPointers) return (int)cudaErrorInvalidValue;
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 2);
  s.kbm1 = kb - 1;
  s.kbm2 = kb - 2;
  s.nbct = nbct;
  s.nbcs = nbcs;
  // prm: dti2, dti, tprni, umol, smoth, tbias, sbias, grav, rhoref,
  //      r, ad1, ad2 (the Jerlov parameters of ntp)
  s.dti2 = T(prm[0]);
  s.mdti2 = T(-prm[0]);
  s.dti = T(prm[1]);
  s.tprni = T(prm[2]);
  s.umol = T(prm[3]);
  s.hsmoth = T(0.5 * prm[4]);
  s.tbias = T(prm[5]);
  s.sbias = T(prm[6]);
  s.grho = T(prm[7] * prm[8]);
  // PyTorch on the card divides by a Python float as a product with its
  // reciprocal, taken in T
  s.rrhoref = T(1) / T(prm[8]);
  s.r = T(prm[9]);
  s.omr = T(1.0 - prm[9]);
  s.rad1 = T(1) / T(prm[10]);
  s.rad2 = T(1) / T(prm[11]);
  const int blocks = (int)((s.g.n + kThreads - 1) / kThreads);
  k_tracer<T, O><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int extpom_phase_tracer_f32(void* const* ptr, const double* prm,
                                       int kb, int im, int jm, int nbct,
                                       int nbcs, void* stream) {
  return run<float, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, nbct, nbcs,
                           stream);
}

extern "C" int extpom_phase_tracer_f64(void* const* ptr, const double* prm,
                                       int kb, int im, int jm, int nbct,
                                       int nbcs, void* stream) {
  return run<double, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, nbct, nbcs,
                            stream);
}

extern "C" int extpom_phase_tracer_mesh_f32(void* const* ptr,
                                            const double* prm, int kb, int im,
                                            int jm, int R, int L, int oi,
                                            int oj, int nbct, int nbcs,
                                            void* stream) {
  return run<float, true>(ptr, prm, kb, im, jm, R, L, oi, oj, nbct, nbcs,
                          stream);
}

extern "C" int extpom_phase_tracer_mesh_f64(void* const* ptr,
                                            const double* prm, int kb, int im,
                                            int jm, int R, int L, int oi,
                                            int oj, int nbct, int nbcs,
                                            void* stream) {
  return run<double, true>(ptr, prm, kb, im, jm, R, L, oi, oj, nbct, nbcs,
                           stream);
}
