// Internal-mode phase tke: q2/q2l advection, the Mellor-Yamada 2.5
// closure with its two implicit vertical solves, open-boundary values and
// the Asselin filter (advance.f:406-421).
//
// Replaces phase "tke" of extpom_tpu/pallas/phases.py:_kernel (via
// windowed_phase and runner.tke), which runs core/stepper.py:phase_tke on
// halo-extended i-stripes in TPU VMEM.  Counterpart here of
// kernels/phases.py:phase_tke_plain (ops/tracers.py:advq,
// ops/vertical.py:profq, bc/bcond.py:bc_turb).
//
// Bound on the H100: memory.  Per column it reads 14 kb-level fields (q2,
// q2b, q2l, q2lb, u, v, w, aam, t, s, rho, km, kh, kq) and writes 8 (q2,
// q2b, q2l, q2lb, km, kh, kq, l), with a few hundred flops per level.
//
// Design: one thread per (i, j) column, two launches:
//   k_column  an interior column computes advq's new q2 level by level
//             inside the forward sweep of profq's q2 solve and advq's new
//             q2l inside that of the q2l solve (extpom::thomas_column,
//             column.cuh; both through the same (kb, n) ee/gg scratch), and
//             applies the rectification, fsm, bc_turb's +1e-10 and the
//             Asselin filter as each back substitution hands out a level;
//             then the length scale l and the stability functions, whose
//             new km/kh/kq go to scratch.  An edge column takes bc_turb's
//             value instead: bc_turb reads only the OLD q2/q2l/u/v, so no
//             column needs a neighbour's new q2.  Neighbour fluxes are
//             recomputed, not stored.
//   k_edges   km/kh/kq times fsm, with profq's boundary copy: written
//             north, south, east, west, so an edge column takes the value
//             of the nearest interior column and a corner the diagonal one.
//             It reads the neighbour's NEW value, hence the second launch.
// Built with -fmad=false so each operation rounds as the plain PyTorch
// version's does.
//
// Where an off-by-one would hide:
//   * advq commits levels 1..kbm1-1 on the interior only; profq's q2 solve
//     runs from level 1 to kb-1 with the bottom value from wubot/wvbot
//     (vertical.py:178-181), its q2l solve from level 2 with level kb-2
//     overwritten by the wall value before the right-hand side is formed
//     (vertical.py:234-235) and levels 0 and kb-1 zero;
//   * the old l is never read: every level is recomputed;
//   * bc_turb writes all kb levels of the edge columns, west, east, south,
//     north, so a corner takes the south or north value.
//
// extpom_phase_tke_mesh_f32/f64 run the same kernels on one ring-extended
// block of the decomposed step (O, column.cuh), replacing the same TPU
// kernel with has_off (via mesh_runner): regions and edges at global
// (i, j), k_column skipping 2 cells next to the block's split edges and
// k_edges 4 (their unguarded reads reach 1 cell).

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

using extpom::GeomT;

template <typename T, bool O>
struct Tke {
  const T *q2, *q2b, *q2l, *q2lb, *u, *v, *w, *aam, *t, *s, *rho;  // 3-D
  const T *km, *kh, *kq;                                           // 3-D
  const T *dt, *etb, *etf, *wubot, *wvbot;                         // 2-D
  const T *wusurf, *wvsurf;                                        // 2-D
  const T *h, *dx, *dy, *art, *dum, *dvm, *fsm;                    // 2-D
  const T *z, *zz, *dz, *dzz;                                      // (kb,)
  T *q2o, *q2bo, *q2lo, *q2lbo, *kmo, *kho, *kqo, *lo;             // outputs
  T *ees, *ggs, *kmr, *khr, *kqr;                                  // scratch
  GeomT<O> g;
  int kbm1;
  // constants, each formed in double as the Python expression forms it and
  // rounded to T as PyTorch rounds a Python float operand
  T dti2, mdti2, umol2, dti2x2, mdti2x2, dti, hsmoth, grav, g2x2, grho,
      rgrav, tbias, sbias, kappa, mkappa, small, const1, ggc, surfl, sef,
      shiw, b1, e1, e2;
  // the stability functions' coefficients, formed in T as the tensors
  // coef1..coef3 of profq are (stf = 1)
  T coef1, coef2, coef3, coef4, coef5;
};

// torch.maximum: NaN when either operand is NaN
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

// advq's x face flux at column q (i >= 1, j >= 1), level 1 <= k < kbm1
template <typename T, bool O>
__device__ __forceinline__ T xflux(const Tke<T, O>& s, const T* f, const T* fb,
                                   int k, long q) {
  const long n = s.g.n, kq = k * n + q, qw = q - s.g.jm, kw = kq - s.g.jm;
  const T x1 = T(0.125) * (f[kq] + f[kw]) * (s.dt[q] + s.dt[qw]) *
               (s.u[kq] + s.u[kq - n]);
  const T xd = T(0.25) *
               (s.aam[kq] + s.aam[kw] + s.aam[kq - n] + s.aam[kw - n]) *
               (s.h[q] + s.h[qw]) * (fb[kq] - fb[kw]) * s.dum[q] /
               (s.dx[q] + s.dx[qw]);
  return T(0.5) * (s.dy[q] + s.dy[qw]) * (x1 - xd);
}

template <typename T, bool O>
__device__ __forceinline__ T yflux(const Tke<T, O>& s, const T* f, const T* fb,
                                   int k, long q) {
  const long n = s.g.n, kq = k * n + q, qs = q - 1, ks = kq - 1;
  const T y1 = T(0.125) * (f[kq] + f[ks]) * (s.dt[q] + s.dt[qs]) *
               (s.v[kq] + s.v[kq - n]);
  const T yd = T(0.25) *
               (s.aam[kq] + s.aam[ks] + s.aam[kq - n] + s.aam[ks - n]) *
               (s.h[q] + s.h[qs]) * (fb[kq] - fb[ks]) * s.dvm[q] /
               (s.dy[q] + s.dy[qs]);
  return T(0.5) * (s.dx[q] + s.dx[qs]) * (y1 - yd);
}

// advq's new value of f at interior column p, level 1 <= k < kbm1
template <typename T, bool O>
__device__ T advq(const Tke<T, O>& s, const T* f, const T* fb, int k, long p) {
  const long n = s.g.n, jm = s.g.jm, q = k * n + p;
  const T h = s.h[p], art = s.art[p];
  const T qf = (s.w[q - n] * f[q - n] - s.w[q + n] * f[q + n]) * art /
                   (s.dz[k] + s.dz[k - 1]) +
               xflux(s, f, fb, k, p + jm) - xflux(s, f, fb, k, p) +
               yflux(s, f, fb, k, p + 1) - yflux(s, f, fb, k, p);
  return ((h + s.etb[p]) * art * fb[q] - s.dti2 * qf) /
         ((h + s.etf[p]) * art);
}

// profq's speed of sound at level k < kbm1 of column p
template <typename T, bool O>
__device__ __forceinline__ T sound(const Tke<T, O>& s, int k, long p) {
  const long q = k * s.g.n + p;
  const T tp = s.t[q] + s.tbias, sp = s.s[q] + s.sbias;
  const T pr = s.grho * (-s.zz[k] * s.h[p]) * T(1.0e-4);
  const T cc = T(1449.1) + T(0.00821) * pr + T(4.55) * tp -
               T(0.045) * (tp * tp) + T(1.34) * (sp - T(35.0));
  return cc /
         sqrt((T(1) - T(0.01642) * pr / cc) * (T(1) - T(0.40) * pr / (cc * cc)));
}

// buoyancy gradient at level 1 <= k < kbm1 of column p
template <typename T, bool O>
__device__ __forceinline__ T boygr(const Tke<T, O>& s, int k, long p) {
  const long q = k * s.g.n + p;
  const T cm = sound(s, k - 1, p), c0 = sound(s, k, p);
  return s.grav * (s.rho[q - s.g.n] - s.rho[q]) / (s.dzz[k - 1] * s.h[p]) +
         T(1) / (cm * cm + c0 * c0) * s.g2x2;
}

// bc_turb's value of f at edge column (i, j), level k, before fsm
template <typename T, bool O>
__device__ T turb_edge(const Tke<T, O>& s, const T* f, int k, int i, int j) {
  const int jm = s.g.jm, gi = s.g.gi(i), gj = s.g.gj(j);
  const long row = k * s.g.n;
  long e, in;  // the edge point and the one inside it
  bool le;
  T u1;
  // written west, east, south, north: the last side written wins
  if (gj == s.g.GJ() - 1) {
    e = (long)i * jm + j; in = e - 1; le = true;
    u1 = T(2) * s.v[row + e] * s.dti / (s.dy[e] + s.dy[in]);
  } else if (gj == 0) {
    e = (long)i * jm + j; in = e + 1; le = false;
    u1 = T(2) * s.v[row + in] * s.dti / (s.dy[e] + s.dy[in]);
  } else if (gi == s.g.GI() - 1) {
    e = (long)i * jm + j; in = e - jm; le = true;
    u1 = T(2) * s.u[row + e] * s.dti / (s.dx[e] + s.dx[in]);
  } else {
    e = (long)i * jm + j; in = e + jm; le = false;
    u1 = T(2) * s.u[row + in] * s.dti / (s.dx[e] + s.dx[in]);
  }
  const T fe = f[row + e], fi = f[row + in];
  if (le) return u1 <= T(0) ? fe - u1 * (s.small - fe) : fe - u1 * (fe - fi);
  return u1 >= T(0) ? fe - u1 * (fe - s.small) : fe - u1 * (fi - fe);
}

template <typename T, bool O>
__global__ void k_column(Tke<T, O> s) {
  const auto& g = s.g;
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.n) return;
  const int i = p / g.jm, j = p % g.jm;
  if (g.skip(i, j)) return;
  const int gi = g.gi(i), gj = g.gj(j);
  const int kb = g.kb, kbm1 = s.kbm1, jm = g.jm;
  const long n = g.n;
  const T h = s.h[p], fsm = s.fsm[p];
  const T dh = h + s.etf[p];
  // surface friction velocity squared, 0 on the last row and column
  T utau2 = T(0);
  if (gi < g.GI() - 1 && gj < g.GJ() - 1) {
    const T su = T(0.5) * (s.wusurf[p] + s.wusurf[p + jm]);
    const T sv = T(0.5) * (s.wvsurf[p] + s.wvsurf[p + 1]);
    utau2 = sqrt(su * su + sv * sv);
  }
  const T kl0 = s.kappa * (s.surfl * utau2 * s.rgrav);
  auto mid = [&](int k) { return k >= 1 && k < kbm1; };
  // q2b/q2lb, rectified on the middle levels
  auto rect = [&](const T* a, int k) {
    const T x = a[k * n + p];
    return mid(k) ? fabs(x) : x;
  };
  auto ell = [&](int k) -> T {  // the new length scale
    if (k == 0) return kl0;
    if (k == kb - 1) return T(0);
    const T qb = fabs(s.q2b[k * n + p]);
    const T lm = fabs(fabs(s.q2lb[k * n + p]) / (qb == T(0) ? T(1) : qb));
    return s.z[k] > T(-0.5) ? nan_max(lm, kl0) : lm;
  };
  // Asselin filter of q2 or q2l at level k with its final new value fn
  auto commit = [&](const T* f, const T* fb, T* fo, T* fbo, int k, T fn) {
    const long q = k * n + p;
    fo[q] = fn;
    fbo[q] = f[q] + s.hsmoth * (fn + rect(fb, k) - T(2) * f[q]);
  };

  if (gi < 1 || gi > g.GI() - 2 || gj < 1 || gj > g.GJ() - 2) {
    for (int k = 0; k < kb; ++k) {
      commit(s.q2, s.q2b, s.q2o, s.q2bo, k,
             turb_edge(s, s.q2, k, i, j) * fsm + T(1.0e-10));
      commit(s.q2l, s.q2lb, s.q2lo, s.q2lbo, k,
             turb_edge(s, s.q2l, k, i, j) * fsm + T(1.0e-10));
      s.lo[k * n + p] = ell(k);
    }
    return;
  }

  auto coef_a = [&](int k) -> T {
    const long q = k * n + p;
    return s.mdti2 * (s.kq[q + n] + s.kq[q] + s.umol2) * T(0.5) /
           (s.dzz[k - 1] * s.dz[k] * dh * dh);
  };
  auto coef_c = [&](int k) -> T {
    const long q = k * n + p;
    return s.mdti2 * (s.kq[q - n] + s.kq[q] + s.umol2) * T(0.5) /
           (s.dzz[k - 1] * s.dz[k - 1] * dh * dh);
  };
  // shear and buoyancy production at level 1 <= k < kbm1
  auto prod = [&](int k, T by) -> T {
    const long q = k * n + p, e = q + jm, nn = q + 1;
    const T du = s.u[q] - s.u[q - n] + s.u[e] - s.u[e - n];
    const T dv = s.v[q] - s.v[q - n] + s.v[nn] - s.v[nn - n];
    const T dd = s.dzz[k - 1] * dh;
    return s.km[q] * T(0.25) * s.sef * (du * du + dv * dv) / (dd * dd) -
           s.shiw * s.km[q] * by + s.kh[q] * by;
  };
  auto dtef = [&](int k) -> T {  // (times stf = 1)
    return sqrt(fabs(s.q2b[k * n + p])) / (s.b1 * ell(k) + s.small);
  };

  // ---- q2 solve (solver.f:1394-1413), levels 1..kb-1 ----
  T bot;
  {
    const T bu = T(0.5) * (s.wubot[p] + s.wubot[p + jm]);
    const T bv = T(0.5) * (s.wvbot[p] + s.wvbot[p + 1]);
    bot = sqrt(bu * bu + bv * bv) * s.const1;
  }
  extpom::thomas_column<T>(
      [&](int k, T& a, T& c, T& den, T& rhs) {
        a = coef_a(k);
        c = coef_c(k);
        den = s.dti2x2 * dtef(k) + T(1);
        rhs = s.mdti2x2 * prod(k, boygr(s, k, p)) - advq(s, s.q2, s.q2b, k, p);
      },
      [&](int k, T f) {
        commit(s.q2, s.q2b, s.q2o, s.q2bo, k,
               (mid(k) ? fabs(f) : f) * fsm + T(1.0e-10));
      },
      T(0), s.ggc * utau2, T(0), bot, T(1), T(1), s.ees, s.ggs, n, p, 1,
      kb - 1);

  // ---- q2l solve (solver.f:1415-1455), levels 2..kb-1 ----
  const T z0 = s.z[0], zb = s.z[kb - 1];
  auto wallfac = [&](int k) -> T {
    const T d0 = fabs(s.z[k] - z0), d1 = fabs(s.z[k] - zb);
    if (!(d0 > T(0) && d1 > T(0))) return T(1);
    const T x = (T(1) / d0 + T(1) / d1) * ell(k) / (dh * s.kappa);
    return T(1) + s.e2 * (x * x);
  };
  const T wall = s.kappa * (T(1) + s.z[kb - 2]) * dh * s.q2[(kb - 2) * n + p];
  extpom::thomas_column<T>(
      [&](int k, T& a, T& c, T& den, T& rhs) {
        a = coef_a(k);
        c = coef_c(k);
        den = s.dti2 * (dtef(k) * wallfac(k)) + T(1);
        const T fin = k == kb - 2 ? wall : advq(s, s.q2l, s.q2lb, k, p);
        rhs = s.dti2 * (-prod(k, boygr(s, k, p)) * ell(k) * s.e1) - fin;
      },
      [&](int k, T f) {
        commit(s.q2l, s.q2lb, s.q2lo, s.q2lbo, k,
               (mid(k) ? fabs(f) : T(0)) * fsm + T(1.0e-10));
      },
      T(0), s.mkappa * s.z[1] * dh * s.q2[n + p], T(0), T(0), T(1), T(1),
      s.ees, s.ggs, n, p, 2, kb - 1);

  // ---- stability functions and mixing coefficients ----
  for (int k = 0; k < kb; ++k) {
    const long q = k * n + p;
    const T lk = ell(k);
    s.lo[q] = lk;
    T gh = T(0);
    if (mid(k)) {
      const T qb = fabs(s.q2b[q]);
      const T x = lk * lk * boygr(s, k, p) / (qb == T(0) ? T(1) : qb);
      gh = x > T(0.028) ? T(0.028) : x;  // a NaN passes, as torch.clamp's
    }
    const T sh = s.coef1 / (T(1) - s.coef2 * gh);
    const T sm = (s.coef3 + sh * s.coef4 * gh) / (T(1) - s.coef5 * gh);
    const T kn = lk * sqrt(fabs(s.q2[q]));
    s.kqr[q] = (kn * T(0.41) * sh + s.kq[q]) * T(0.5);
    s.kmr[q] = (kn * sm + s.km[q]) * T(0.5);
    s.khr[q] = (kn * sh + s.kh[q]) * T(0.5);
  }
}

template <typename T, bool O>
__global__ void k_edges(Tke<T, O> s) {
  const auto& g = s.g;
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.n) return;
  const int i = p / g.jm, j = p % g.jm;
  if (g.skip(i, j)) return;
  const int gi = g.gi(i), gj = g.gj(j), im = g.GI(), jm = g.GJ();
  const int ci = gi == 0 ? 1 : (gi == im - 1 ? im - 2 : gi);
  const int cj = gj == 0 ? 1 : (gj == jm - 1 ? jm - 2 : gj);
  const long src = (long)g.li(ci) * g.jm + g.lj(cj);
  const T fsm = s.fsm[p];
  for (int k = 0; k < g.kb; ++k) {
    const long q = k * g.n;
    s.kmo[q + p] = s.kmr[q + src] * fsm;
    s.kho[q + p] = s.khr[q + src] * fsm;
    s.kqo[q + p] = s.kqr[q + src] * fsm;
  }
}

constexpr int kThreads = 128;
constexpr int kPointers = 45;

// ptr: the operands, outputs and scratch; the domain is (im, jm), the
// arrays the domain or (O) the (R, L) block at global (oi, oj)
template <typename T, bool O>
int run(void* const* ptr, const double* prm, int kb, int im, int jm, int R,
        int L, int oi, int oj, void* stream) {
  Tke<T, O> s;
  int k = 0;
#define NEXT(f) s.f = (decltype(s.f))ptr[k++]
  NEXT(q2); NEXT(q2b); NEXT(q2l); NEXT(q2lb); NEXT(u); NEXT(v); NEXT(w);
  NEXT(aam); NEXT(t); NEXT(s); NEXT(rho); NEXT(km); NEXT(kh); NEXT(kq);
  NEXT(dt); NEXT(etb); NEXT(etf); NEXT(wubot); NEXT(wvbot);
  NEXT(wusurf); NEXT(wvsurf);
  NEXT(h); NEXT(dx); NEXT(dy); NEXT(art); NEXT(dum); NEXT(dvm); NEXT(fsm);
  NEXT(z); NEXT(zz); NEXT(dz); NEXT(dzz);
  NEXT(q2o); NEXT(q2bo); NEXT(q2lo); NEXT(q2lbo); NEXT(kmo); NEXT(kho);
  NEXT(kqo); NEXT(lo);
  NEXT(ees); NEXT(ggs); NEXT(kmr); NEXT(khr); NEXT(kqr);
#undef NEXT
  if (k != kPointers) return (int)cudaErrorInvalidValue;
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 2);
  s.kbm1 = kb - 1;
  // prm (kernels/phases.py:phase_tke): dti2, -dti2, 2 umol, 2 dti2,
  // -2 dti2, dti, smoth/2, grav, 2 grav^2, grav rhoref, tbias, sbias,
  // kappa, -kappa, small, const1, (15.8 cbcnst)^(2/3), surfl, sef, shiw,
  // b1, e1, e2, a1, a2, 6 a1/b1, 1 - 3 c1, 3 a2 b2, 18 a1 a2, coef4, coef5
  s.dti2 = T(prm[0]);
  s.mdti2 = T(prm[1]);
  s.umol2 = T(prm[2]);
  s.dti2x2 = T(prm[3]);
  s.mdti2x2 = T(prm[4]);
  s.dti = T(prm[5]);
  s.hsmoth = T(prm[6]);
  s.grav = T(prm[7]);
  s.g2x2 = T(prm[8]);
  s.grho = T(prm[9]);
  // PyTorch on the card divides by a Python float as a product with its
  // reciprocal, taken in T
  s.rgrav = T(1) / T(prm[7]);
  s.tbias = T(prm[10]);
  s.sbias = T(prm[11]);
  s.kappa = T(prm[12]);
  s.mkappa = T(prm[13]);
  s.small = T(prm[14]);
  s.const1 = T(prm[15]);
  s.ggc = T(prm[16]);
  s.surfl = T(prm[17]);
  s.sef = T(prm[18]);
  s.shiw = T(prm[19]);
  s.b1 = T(prm[20]);
  s.e1 = T(prm[21]);
  s.e2 = T(prm[22]);
  const T a1 = T(prm[23]), a2 = T(prm[24]), c6 = T(prm[25]);
  s.coef1 = a2 * (T(1) - c6);
  s.coef2 = T(prm[27]) + T(prm[28]);
  s.coef3 = a1 * (T(prm[26]) - c6);
  s.coef4 = T(prm[29]);
  s.coef5 = T(prm[30]);
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (int)((s.g.n + kThreads - 1) / kThreads);
  k_column<T, O><<<blocks, kThreads, 0, st>>>(s);
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 4);
  k_edges<T, O><<<blocks, kThreads, 0, st>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int extpom_phase_tke_f32(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int, int,
                                    void* stream) {
  return run<float, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, stream);
}

extern "C" int extpom_phase_tke_f64(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int, int,
                                    void* stream) {
  return run<double, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, stream);
}

extern "C" int extpom_phase_tke_mesh_f32(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int, int,
                                         void* stream) {
  return run<float, true>(ptr, prm, kb, im, jm, R, L, oi, oj, stream);
}

extern "C" int extpom_phase_tke_mesh_f64(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int, int,
                                         void* stream) {
  return run<double, true>(ptr, prm, kb, im, jm, R, L, oi, oj, stream);
}
