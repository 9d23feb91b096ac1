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
// Design: one launch, column tiles (column.cuh Tiles).  A block owns a
// TI x TJ tile of columns, one thread each, and sweeps k once upward:
//   * each level's planes of t, tb, tclim, s, sb, sclim, u, v, aam (read
//     at a neighbour by the fluxes) are staged into shared memory as the
//     tile's window with a one-cell halo, those of w and kh (own column
//     only) as the tile, by cp.async two levels ahead (a ring of three: k,
//     k+1 resident, k+2 in flight); the 2-D grid fields of the fluxes once
//     per tile;
//   * each face flux of advt1 is computed once per level into shared
//     memory (every thread its west and south face, the tile's last row
//     and column the faces beyond), and advt1 takes differences of the
//     stored faces; the vertical flux and the shortwave term of level k+1
//     are carried to level k+1;
//   * T's and S's forward eliminations run in the same sweep and share
//     proft's coef_a/coef_c; one descending pass then does both back
//     substitutions, the Asselin commits and the equation of state of each
//     level as soon as its new t and s exist;
//   * ee/gg of the two solves live in device scratch, kb x 4 rows of the
//     tile's columns per block; the grid is the resident blocks, so the
//     scratch is sized by them, not by the grid of columns.
// An edge column takes bc_ts's value, read from device memory with the
// zero-fill guards (bc_ts reads only the OLD t/s/u/v/w/dt), and its
// equation of state in the same sweep.  Under the orlanski scheme
// (template flag B, orl_ts) an edge value reads the NEW tracer one cell in:
// the tile launch skips the edge columns and also writes the solved values
// of the columns one in (before fsm) to a strip, and a perimeter launch
// (k_tracer_edge, one thread per edge column) then forms orl_ts's values
// from the strip and the old t/tb/s/sb/ub, which no launch overwrites (the
// outputs are separate arrays), and commits the Asselin filter and dens of
// those columns.  Every per-point expression is the
// one of the plain version, operand for operand, and the sources build
// with -fmad=false, so each operation rounds as the plain PyTorch
// version's does; exp and pow come from CUDA's math library, which may
// differ from PyTorch's in the last bit.
//
// The options (template flag X, selected by non-null operands):
//   * MPDATA (nadv=2, ops/tracers.py:advt2) does not fit the tile's single
//     upward sweep: each of its nitera upstream steps couples level k with
//     k-1 and k+1 and widens the horizontal reach by a cell.  Its steps run
//     first in launches of their own over the whole grid (or block),
//     phase_mpdata.cu's k_mpdata_tile, all nitera steps in one launch where
//     they fit.  The tile then takes the field of
//     the last step (mt, ms) in place of advt1's and forms only the closing
//     climatology-deviation diffusion from its staged planes (fb - fclim,
//     aam and the 2-D window); the ghost level kb-1 and the edge columns
//     below kbm1 keep MPDATA's field, which proft passes through.
//   * Interior restoring (do_restore, core/stepper.py:328-336) commits after
//     the Asselin filter, on levels k < kbm1 of every column, edges
//     included (and k_tracer_edge's), before the equation of state reads
//     the restored t and s; taurstr may be one broadcast value.
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
// (i, j), the launch skipping 2 cells next to the block's split edges;
// every staged read is guarded, 0 outside the block.

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

using extpom::GeomT;
using extpom::ld1;
using extpom::ld2;
using extpom::ld3;
using extpom::Tiles;

constexpr int kMaxThreads = 256;
constexpr int kStages = 3;  // levels k, k+1 resident, k+2 in flight
// fields staged per level as the window
constexpr int kHalo = 9;
enum { HT, HTB, HTC, HS, HSB, HSC, HU, HV, HAAM };
// ... and at the own column: w, kh
constexpr int kOwn = 2;
enum { OW, OKH };
// 2-D fields of the fluxes, staged once per tile: dt, h, dx, dy, dum, dvm
constexpr int k2D = 6;
enum { DDT, DH, DDX, DDY, DDUM, DDVM };
// no wide window; face pairs per level: the x and y faces of two fields
constexpr int kWide = 0;
constexpr int kFaces = 2;
// ee/gg rows per level in device scratch; no levels kept per column
constexpr int kScratch = 4;
constexpr int kKeep = 0;
// face pairs staged per level, and a ring that holds every level when
// the tile keeps them (phase_uvw.cu's layout): none
constexpr int kStageFaces = 0;
constexpr int kKeepRing = 0;

// Shared memory of a tile, in elements: kStages stages, the 2-D window,
// the x and y faces of T and S.  kernels/phases.py:column_tile counts the
// same from the constants above, which it reads from this file.
struct Layout {
  int HC, TC, stage, faces, total;
};

__host__ __device__ inline Layout layout(int TI, int TJ) {
  Layout L;
  L.HC = (TI + 2) * (TJ + 2);
  L.TC = TI * TJ;
  L.stage = kHalo * L.HC + kOwn * L.TC;
  L.faces = kFaces * ((TI + 1) * TJ + TI * (TJ + 1));
  L.total = kStages * L.stage + k2D * L.HC + L.faces;
  return L;
}

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
  // ee/gg rows of the two solves, kb x 4 x TI*TJ per block
  T* egs;
  // the orlanski scheme (orl_ts; null otherwise): the old u (kb, im, jm),
  // and the strip of the solved T and S one cell inside each edge, before
  // the fsm mask: [tracer][side][k][j] of rows 1 and im-2 (side 0, 1),
  // then [tracer][side][k][i] of columns 1 and jm-2
  const T* ub;
  T* strip;
  // the options (X): the restoring series (null without do_restore;
  // taurstr one value where tau_one), MPDATA's field of T and S (null:
  // advt1)
  const T *trstr, *srstr, *taurstr;
  const T *mt, *ms;
  GeomT<O> g;
  Tiles tl;
  int kbm1, kbm2, nbct, nbcs;
  bool tau_one;
  // constants, each formed in double as the Python expression forms it and
  // rounded to T as PyTorch rounds a Python float operand
  T dti2, mdti2, dti, tprni, umol, hsmoth, tbias, sbias, grho, rrhoref, r,
      omr, rad1, rad2, rfac;
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

// advt1's x face flux between window cells c - HJ and c: advection plus
// the climatology-deviation diffusion, times the face width; f, fb, fclim,
// u and aam at the level, the 2-D window d
template <typename T>
__device__ __forceinline__ T xface(const T* f, const T* fb, const T* fc,
                                   const T* u, const T* a, const T* d,
                                   T tprni, int HC, int c, int HJ) {
  const int w = c - HJ;
  const T* dt = d + DDT * HC;
  const T* h = d + DH * HC;
  const T* dx = d + DDX * HC;
  const T* dy = d + DDY * HC;
  const T x1 = T(0.25) * (dt[c] + dt[w]) * (f[c] + f[w]) * u[c];
  const T xd = T(-0.5) * (a[c] + a[w]) * (h[c] + h[w]) * tprni *
               ((fb[c] - fc[c]) - (fb[w] - fc[w])) * d[DDUM * HC + c] /
               (dx[c] + dx[w]);
  return T(0.5) * (dy[c] + dy[w]) * (x1 + xd);
}

// advt1's y face flux between window cells c - 1 and c
template <typename T>
__device__ __forceinline__ T yface(const T* f, const T* fb, const T* fc,
                                   const T* v, const T* a, const T* d,
                                   T tprni, int HC, int c) {
  const int s = c - 1;
  const T* dt = d + DDT * HC;
  const T* h = d + DH * HC;
  const T* dx = d + DDX * HC;
  const T* dy = d + DDY * HC;
  const T y1 = T(0.25) * (dt[c] + dt[s]) * (f[c] + f[s]) * v[c];
  const T yd = T(-0.5) * (a[c] + a[s]) * (h[c] + h[s]) * tprni *
               ((fb[c] - fc[c]) - (fb[s] - fc[s])) * d[DDVM * HC + c] /
               (dy[c] + dy[s]);
  return T(0.5) * (dx[c] + dx[s]) * (y1 + yd);
}

// MPDATA's closing diffusion flux across the x face between window cells
// c - HJ and c (tracers.py:advt2, solver.f:691-726): fb, fclim and aam at
// the level, the 2-D window d
template <typename T>
__device__ __forceinline__ T xdiff(const T* fb, const T* fc, const T* a,
                                   const T* d, T tprni, int HC, int c,
                                   int HJ) {
  const int w = c - HJ;
  const T* h = d + DH * HC;
  const T* dx = d + DDX * HC;
  const T* dy = d + DDY * HC;
  const T aamx = T(0.5) * (a[c] + a[w]);
  return -aamx * (h[c] + h[w]) * tprni * ((fb[c] - fc[c]) - (fb[w] - fc[w])) *
         d[DDUM * HC + c] * (dy[c] + dy[w]) * T(0.5) / (dx[c] + dx[w]);
}

// ... across the y face between window cells c - 1 and c
template <typename T>
__device__ __forceinline__ T ydiff(const T* fb, const T* fc, const T* a,
                                   const T* d, T tprni, int HC, int c) {
  const int s = c - 1;
  const T* h = d + DH * HC;
  const T* dx = d + DDX * HC;
  const T* dy = d + DDY * HC;
  const T aamy = T(0.5) * (a[c] + a[s]);
  return -aamy * (h[c] + h[s]) * tprni * ((fb[c] - fc[c]) - (fb[s] - fc[s])) *
         d[DDVM * HC + c] * (dx[c] + dx[s]) * T(0.5) / (dy[c] + dy[s]);
}

// Interior restoring of tracer c's new value f and new fb at point q
// (k < kbm1), times fsm
template <typename T, bool O>
__device__ __forceinline__ void restore(const Trc<T, O>& s, int c, long q,
                                        T fsm, T& f, T& fb) {
  const T fac = s.rfac * s.taurstr[s.tau_one ? 0 : q];
  const T r = (c ? s.srstr : s.trstr)[q];
  f = (f + fac * (r - f)) * fsm;
  fb = (fb + fac * (r - fb)) * fsm;
}

// The value of tracer c below the solved levels (k >= kbm1): proft passes
// its input through, advt1's 0 or MPDATA's field
template <typename T, bool O, bool X>
__device__ __forceinline__ T ghost(const Trc<T, O>& s, int c, long q) {
  if constexpr (X) {
    const T* m = c ? s.ms : s.mt;
    if (m != nullptr) return m[q];
  }
  return T(0);
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

// dens on the new t/s of level k < kb-1 (density.py:12-36), times fsm
template <typename T, bool O>
__device__ __forceinline__ T dens(const Trc<T, O>& s, int k, T tn, T sn, T h,
                                  T fsm) {
  const T tr = tn + s.tbias, sr = sn + s.sbias;
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
  rhor = rhor + T(1.0e5) * pr / (cr * cr) * (T(1) - T(2) * pr / (cr * cr));
  return rhor * s.rrhoref * fsm;
}

// One tracer's forward elimination state in the ascending sweep
template <typename T>
struct Fwd {
  T ee, gg;  // the last row
  T zf;      // advt1's vertical flux at the level's top face
  T last;    // the solution at level kbm2
};

// ---- orl_ts (bc/orlanski.py) ----

// the strip's element of tracer c, level k, side `side` (0: the low row or
// column, 1: the high one) at array column j (EW) or array row i (NS)
template <typename T, bool O>
__device__ __forceinline__ T& strip_ew(const Trc<T, O>& s, int c, int side,
                                       int k, int j) {
  const auto& g = s.g;
  return s.strip[((long)(c * 2 + side) * g.kb + k) * g.jm + j];
}

template <typename T, bool O>
__device__ __forceinline__ T& strip_ns(const Trc<T, O>& s, int c, int side,
                                       int k, int i) {
  const auto& g = s.g;
  return s.strip[4L * g.kb * g.jm + ((long)(c * 2 + side) * g.kb + k) * g.im +
                 i];
}

// the solved (unmasked) value f of tracer c at level k of inner column
// (i, j), global (gi, gj), into the strip where orl_ts reads it
template <typename T, bool O>
__device__ __forceinline__ void strip_put(const Trc<T, O>& s, int c, int k,
                                          int gi, int gj, int i, int j, T f) {
  const auto& g = s.g;
  if (gi == 1) strip_ew(s, c, 0, k, j) = f;
  if (gi == g.GI() - 2) strip_ew(s, c, 1, k, j) = f;
  if (gj == 1) strip_ns(s, c, 0, k, i) = f;
  if (gj == g.GJ() - 2) strip_ns(s, c, 1, k, i) = f;
}

// orl_ts's east (side 1) or west (side 0) value of tracer c at level k,
// array column j, before fsm: the radiated value from the solved value one
// row in (the strip) and the old values one and two rows in, clamped to
// the boundary series where the phase speed is 0 and the flow enters
template <typename T, bool O>
__device__ T orl_ew(const Trc<T, O>& s, const View<T>& v, int c, int side,
                    int k, int j) {
  const auto& g = s.g;
  const int e = side ? g.li(g.GI() - 1) : g.li(0);  // the edge row
  const int d = side ? -1 : 1;                      // towards the interior
  const long b = (long)k * g.n + j;
  auto at = [&](const T* a, int i) { return a[b + (long)i * g.jm]; };
  const T cl = extpom::phase_speed(strip_ew(s, c, side, k, j),
                                   at(v.fb, e + d), at(v.f, e + 2 * d));
  const T val = extpom::radiate(cl, at(v.fb, e), at(v.f, e + d));
  // inflow: ub of the edge row (east) or of row 1 (west)
  const T ubc = at(s.ub, side ? e : e + d);
  const bool clamp = cl == T(0) && (side ? ubc <= T(0) : ubc >= T(0));
  return clamp ? (side ? v.be : v.bw)[k * g.jm + j] : val;
}

// orl_ts at array column (i, j) of the perimeter, level k < kbm1, before
// fsm: east and west over every column, then the north and south rows
// copy the column one in, where an east/west value has been written
template <typename T, bool O>
__device__ T orl_value(const Trc<T, O>& s, const View<T>& v, int c, int k,
                       int i, int j) {
  const auto& g = s.g;
  const int gi = g.gi(i), gj = g.gj(j), GI = g.GI(), GJ = g.GJ();
  if (gj == 0 || gj == GJ - 1) {
    const int side = gj == 0 ? 0 : 1;
    const int jj = g.lj(side ? GJ - 2 : 1);
    if (gi == 0) return orl_ew(s, v, c, 0, k, jj);
    if (gi == GI - 1) return orl_ew(s, v, c, 1, k, jj);
    return strip_ns(s, c, side, k, i);
  }
  return orl_ew(s, v, c, gi == 0 ? 0 : 1, k, j);
}

// One thread per column of the domain's perimeter in the block: rows 0 and
// im-1 across its columns, then columns 0 and jm-1 across its rows between
// them.  orl_ts, the fsm mask, the Asselin commit and dens of the column,
// after k_tracer_tile (which solved the columns one in and skipped these).
template <typename T, bool O, bool X>
__global__ void k_tracer_edge(Trc<T, O> s) {
  const auto& g = s.g;
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int GI = g.GI(), GJ = g.GJ();
  int i, j;
  if (e < 2L * g.jm) {
    i = g.li(e < g.jm ? 0 : GI - 1);
    j = (int)(e % g.jm);
    if (i < 0 || i >= g.im) return;
  } else {
    const long f = e - 2L * g.jm;
    if (f >= 2L * g.im) return;
    i = (int)(f % g.im);
    j = g.lj(f < g.im ? 0 : GJ - 1);
    const int gi = g.gi(i);
    if (j < 0 || j >= g.jm || gi <= 0 || gi >= GI - 1) return;
  }
  if (g.skip(i, j)) return;
  const long n = g.n, p = (long)i * g.jm + j;
  const T fsm = s.fsm[p], h = s.h[p];
  const View<T> tv[2] = {{s.t, s.tb, s.tclim, s.wtsurf, s.tsurf, s.tbw,
                          s.tbe, s.tbs, s.tbn, s.to, s.tbo, s.nbct},
                         {s.s, s.sb, s.sclim, s.wssurf, s.ssurf, s.sbw,
                          s.sbe, s.sbs, s.sbn, s.so, s.sbo, s.nbcs}};
  for (int k = 0; k < g.kb; ++k) {
    const long q = k * n + p;
    T fnew[2];
    for (int c = 0; c < 2; ++c) {
      const View<T>& v = tv[c];
      T fv = k < s.kbm1 ? orl_value(s, v, c, k, i, j) * fsm
                        : ghost<T, O, X>(s, c, q);
      const T f = v.f[q], fb = v.fb[q];
      T fbn = f + s.hsmoth * (fv + fb - T(2) * f);
      if (X && s.trstr != nullptr && k < s.kbm1) restore(s, c, q, fsm, fv, fbn);
      v.fo[q] = fv;
      v.fbo[q] = fbn;
      fnew[c] = fv;
    }
    s.rho[q] = k == g.kb - 1 ? T(0) : dens(s, k, fnew[0], fnew[1], h, fsm);
  }
}

template <typename T, bool O, bool B, bool X>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 4 ? 2 : 1)
    k_tracer_tile(Trc<T, O> s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const auto& g = s.g;
  const Tiles tl = s.tl;
  const int TI = tl.TI, TJ = tl.TJ, HJ = TJ + 2, nt = TI * TJ;
  const int t = threadIdx.x, ti = t / TJ, tj = t % TJ;
  const int kb = g.kb, kbm1 = s.kbm1, kbm2 = s.kbm2, jm = g.jm;
  const long n = g.n;
  const Layout L = layout(TI, TJ);
  const int HC = L.HC, wc = (ti + 1) * HJ + tj + 1;  // own window cell
  T* const d2 = sm + kStages * L.stage;
  T* const fxy = d2 + k2D * HC;  // per tracer: x (TI+1) x TJ, y TI x (TJ+1)
  const int nface = (TI + 1) * TJ + TI * (TJ + 1);
  T* const eg = s.egs + (long)blockIdx.x * kb * 4 * nt;
  const int fw = ti * TJ + tj, fe = fw + TJ;      // x faces west, east
  const int fs = ti * (TJ + 1) + tj, fn = fs + 1;  // y faces south, north
  auto win = [&](int k, int f) {
    return sm + (k % kStages) * L.stage + f * HC;
  };
  auto own = [&](int k, int f) {
    return sm + (k % kStages) * L.stage + kHalo * HC + f * L.TC + t;
  };
  auto row = [&](int k, int c) -> T& { return eg[(k * 4 + c) * nt + t]; };
  const View<T> tv[2] = {{s.t, s.tb, s.tclim, s.wtsurf, s.tsurf, s.tbw,
                          s.tbe, s.tbs, s.tbn, s.to, s.tbo, s.nbct},
                         {s.s, s.sb, s.sclim, s.wssurf, s.ssurf, s.sbw,
                          s.sbe, s.sbs, s.sbn, s.so, s.sbo, s.nbcs}};
  const bool any_rad = s.nbct == 2 || s.nbct == 4 || s.nbcs == 2 ||
                       s.nbcs == 4;
  const bool mp = X && s.mt != nullptr;        // MPDATA's field, not advt1
  const bool rst = X && s.trstr != nullptr;    // interior restoring

  for (int tile = blockIdx.x; tile < tl.count; tile += gridDim.x) {
    const int i0 = (tile / tl.nj) * TI, j0 = (tile % tl.nj) * TJ;
    const int i = i0 + ti, j = j0 + tj;
    const bool in = i < g.im && j < jm;
    const long p = in ? (long)i * jm + j : 0;
    const bool act = in && !g.skip(i, j);
    const int gi = g.gi(i), gj = g.gj(j);
    const bool inner =
        act && gi >= 1 && gi <= g.GI() - 2 && gj >= 1 && gj <= g.GJ() - 2;
    int off[extpom::kWindowCells];
    extpom::window_cells(off, t, nt, i0, j0, TI, TJ, g.im, jm);
    auto stage = [&](int k) {
      if (k < kb) {
        const long b = (long)k * n;
        extpom::stage_window(win(k, HT), s.t + b, off, t, nt);
        extpom::stage_window(win(k, HTB), s.tb + b, off, t, nt);
        extpom::stage_window(win(k, HTC), s.tclim + b, off, t, nt);
        extpom::stage_window(win(k, HS), s.s + b, off, t, nt);
        extpom::stage_window(win(k, HSB), s.sb + b, off, t, nt);
        extpom::stage_window(win(k, HSC), s.sclim + b, off, t, nt);
        extpom::stage_window(win(k, HU), s.u + b, off, t, nt);
        extpom::stage_window(win(k, HV), s.v + b, off, t, nt);
        extpom::stage_window(win(k, HAAM), s.aam + b, off, t, nt);
        extpom::stage_own(own(k, OW), s.w + b, p, in);
        extpom::stage_own(own(k, OKH), s.kh + b, p, in);
      }
      extpom::cp_async_commit();
    };
    __syncthreads();  // the previous tile is done with shared memory
    extpom::stage_window(d2 + DDT * HC, s.dt, off, t, nt);
    extpom::stage_window(d2 + DH * HC, s.h, off, t, nt);
    extpom::stage_window(d2 + DDX * HC, s.dx, off, t, nt);
    extpom::stage_window(d2 + DDY * HC, s.dy, off, t, nt);
    extpom::stage_window(d2 + DDUM * HC, s.dum, off, t, nt);
    extpom::stage_window(d2 + DDVM * HC, s.dvm, off, t, nt);
    stage(0);
    stage(1);

    // the column's 2-D values
    T h = T(0), fsm = T(0), dh = T(0), art = T(0), etb = T(0), etf = T(0),
      swrad = T(0);
    if (act) {
      h = s.h[p];
      fsm = s.fsm[p];
    }
    if (inner) {
      art = s.art[p];
      etb = s.etb[p];
      etf = s.etf[p];
      dh = h + etf;
      if (any_rad) swrad = s.swrad[p];
    }
    // proft's shortwave term at level k (0 from kbm1 on)
    auto rad = [&](int k) -> T {
      if (k >= kbm1) return T(0);
      const T zd = s.z[k] * dh;
      return swrad * (s.r * exp(zd * s.rad1) + s.omr * exp(zd * s.rad2));
    };
    auto with_rad = [&](int c) { return tv[c].nbc == 2 || tv[c].nbc == 4; };
    Fwd<T> fw_[2] = {{T(0), T(0), T(0), T(0)}, {T(0), T(0), T(0), T(0)}};
    T rk = T(0);  // rad(k) where a tracer needs it

    // ---- the ascending sweep ----
    for (int k = 0; k < kb; ++k) {
      extpom::cp_async_wait_all();
      __syncthreads();
      stage(k + 2);
      if (k <= kbm2) {
        const T *u = win(k, HU), *v = win(k, HV), *a = win(k, HAAM);
        for (int c = 0; c < 2; ++c) {
          const T* f = win(k, c ? HS : HT);
          const T* fb = win(k, c ? HSB : HTB);
          const T* fc = win(k, c ? HSC : HTC);
          T* x = fxy + c * nface;
          T* y = x + (TI + 1) * TJ;
          if (mp) {  // MPDATA's closing diffusion
            x[fw] = xdiff(fb, fc, a, d2, s.tprni, HC, wc, HJ);
            y[fs] = ydiff(fb, fc, a, d2, s.tprni, HC, wc);
            if (ti == TI - 1)
              x[fe] = xdiff(fb, fc, a, d2, s.tprni, HC, wc + HJ, HJ);
            if (tj == TJ - 1)
              y[fn] = ydiff(fb, fc, a, d2, s.tprni, HC, wc + 1);
            continue;
          }
          x[fw] = xface(f, fb, fc, u, a, d2, s.tprni, HC, wc, HJ);
          y[fs] = yface(f, fb, fc, v, a, d2, s.tprni, HC, wc);
          if (ti == TI - 1)
            x[fe] = xface(f, fb, fc, u, a, d2, s.tprni, HC, wc + HJ, HJ);
          if (tj == TJ - 1)
            y[fn] = yface(f, fb, fc, v, a, d2, s.tprni, HC, wc + 1);
        }
        __syncthreads();
      }
      if (!act) continue;
      const long q = k * n + p;
      if (!inner) {  // bc_ts, Asselin and dens at this edge column
        if constexpr (B) continue;  // k_tracer_edge finishes it
        T fnew[2];
        for (int c = 0; c < 2; ++c) {
          const T f = win(k, c ? HS : HT)[wc], fb = win(k, c ? HSB : HTB)[wc];
          T fv = k < kbm1 ? edge_value(s, tv[c], k, i, j) * fsm
                          : ghost<T, O, X>(s, c, q);
          T fbn = f + s.hsmoth * (fv + fb - T(2) * f);
          if (rst && k < kbm1) restore(s, c, q, fsm, fv, fbn);
          tv[c].fo[q] = fv;
          tv[c].fbo[q] = fbn;
          fnew[c] = fv;
        }
        s.rho[q] = k == kb - 1 ? T(0) : dens(s, k, fnew[0], fnew[1], h, fsm);
        continue;
      }
      if (k > kbm2) continue;
      // proft's coefficients at level k, shared by T and S
      const T ca = k < kbm2 ? s.mdti2 * (*own(k + 1, OKH) + s.umol) /
                                  (s.dz[k] * s.dzz[k] * dh * dh)
                            : T(0);
      const T cc = k >= 1 && k < kbm1 ? s.mdti2 * (*own(k, OKH) + s.umol) /
                                            (s.dz[k] * s.dzz[k - 1] * dh * dh)
                                      : T(0);
      if (k == 0 && any_rad) rk = rad(0);
      const T rk1 = any_rad ? rad(k + 1) : T(0);
      const T wp = *own(k + 1, OW);
      for (int c = 0; c < 2; ++c) {
        Fwd<T>& st = fw_[c];
        const T* wf = win(k, c ? HS : HT);
        const T fk = wf[wc], fbk = win(k, c ? HSB : HTB)[wc];
        const T fp = win(k + 1, c ? HS : HT)[wc];
        if (k == 0) st.zf = fk * *own(0, OW) * art;
        const T zf1 =
            k + 1 < kbm1 ? T(0.5) * (fk + fp) * wp * art : T(0);
        const T* x = fxy + c * nface;
        const T* y = x + (TI + 1) * TJ;
        T adv;
        if (mp) {
          adv = (c ? s.ms : s.mt)[k * n + p] -
                s.dti2 * (x[fe] - x[fw] + y[fn] - y[fs]) / ((h + etf) * art);
        } else {
          const T ff =
              x[fe] - x[fw] + y[fn] - y[fs] + (st.zf - zf1) / s.dz[k];
          adv = (fbk * (h + etb) * art - s.dti2 * ff) / ((h + etf) * art);
        }
        st.zf = zf1;
        const bool wr = with_rad(c);
        const T r0 = wr ? rk : T(0), r1 = wr ? rk1 : T(0);
        if (k == 0) {
          const View<T>& v = tv[c];
          if (v.nbc == 1) {
            st.ee = ca / (ca - T(1));
            st.gg =
                (s.dti2 * v.wfsurf[p] / (s.dz[0] * dh) - adv) / (ca - T(1));
          } else if (v.nbc == 2) {
            st.ee = ca / (ca - T(1));
            st.gg = (s.dti2 * (v.wfsurf[p] + r0 - r1) / (s.dz[0] * dh) - adv) /
                    (ca - T(1));
          } else {
            st.ee = T(0);
            st.gg = v.fsurf[p];
          }
        } else if (k < kbm2) {
          const T rhs = -adv + s.dti2 * (r0 - r1) / (dh * s.dz[k]);
          const T gk = T(1) / (ca + cc * (T(1) - st.ee) - T(1));
          st.ee = ca * gk;
          st.gg = (rhs + cc * st.gg) * gk;
        } else {  // the closed-form bottom row
          const T rb = -adv + s.dti2 * (r0 - r1) / (dh * s.dz[kbm2]);
          st.last = (cc * st.gg + rb) / (cc * (T(1) - st.ee) + T(-1)) * T(1);
        }
        if (k < kbm2) {
          row(k, 2 * c) = st.ee;
          row(k, 2 * c + 1) = st.gg;
        }
      }
      rk = rk1;
    }

    // ---- the descending pass: back substitutions, commits, dens ----
    if (inner) {
      T f[2] = {fw_[0].last, fw_[1].last};
      for (int k = kb - 1; k >= 0; --k) {
        const long q = k * n + p;
        T fnew[2];
        for (int c = 0; c < 2; ++c) {
          const View<T>& v = tv[c];
          const T fo = v.f[q], fbo = v.fb[q];
          if (k > kbm2) {  // proft keeps its input there: advt1's 0
            const T gv = ghost<T, O, X>(s, c, q);
            v.fo[q] = gv;
            v.fbo[q] = fo + s.hsmoth * (gv + fbo - T(2) * fo);
            continue;
          }
          if (k < kbm2)
            f[c] = (row(k, 2 * c) * f[c] + row(k, 2 * c + 1)) * T(1);
          if constexpr (B) strip_put(s, c, k, gi, gj, i, j, f[c]);
          fnew[c] = f[c] * fsm;
          T fbn = fo + s.hsmoth * (fnew[c] + fbo - T(2) * fo);
          if (rst) restore(s, c, q, fsm, fnew[c], fbn);
          v.fo[q] = fnew[c];
          v.fbo[q] = fbn;
        }
        s.rho[q] = k == kb - 1 ? T(0) : dens(s, k, fnew[0], fnew[1], h, fsm);
      }
    }
  }
}

constexpr int kPointers = 51;
constexpr int kEdgeThreads = 128;

// ptr: the operands, outputs and scratch, then ub and the strip (both
// null outside the orlanski scheme, whose orl_ts they select), then the
// options: trstr, srstr, taurstr (null without restoring) and MPDATA's
// field of T and S (null: advt1); the domain is (im, jm), the arrays the
// domain or (O) the (R, L) block at global (oi, oj); the tiles TI x TJ,
// walked by `grid` blocks
template <typename T, bool O>
int run(void* const* ptr, const double* prm, int kb, int im, int jm, int R,
        int L, int oi, int oj, int nbct, int nbcs, int TI, int TJ, int grid,
        void* stream) {
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
  NEXT(egs);
  NEXT(ub); NEXT(strip);
  NEXT(trstr); NEXT(srstr); NEXT(taurstr);
  NEXT(mt); NEXT(ms);
#undef NEXT
  if (k != kPointers) return (int)cudaErrorInvalidValue;
  const int threads = TI * TJ;
  const bool orl = s.ub != nullptr;
  const bool rst = s.trstr != nullptr, mp = s.mt != nullptr;
  if (TI < 1 || TJ < 32 || TJ % 32 || threads > kMaxThreads || grid < 1 ||
      s.egs == nullptr || (s.strip == nullptr) == orl ||
      (rst && (s.srstr == nullptr || s.taurstr == nullptr)) ||
      (mp && s.ms == nullptr))
    return (int)cudaErrorInvalidValue;
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 2);
  s.tl.TI = TI;
  s.tl.TJ = TJ;
  s.tl.nj = (s.g.jm + TJ - 1) / TJ;
  s.tl.count = ((s.g.im + TI - 1) / TI) * s.tl.nj;
  s.kbm1 = kb - 1;
  s.kbm2 = kb - 2;
  s.nbct = nbct;
  s.nbcs = nbcs;
  // prm: dti2, dti, tprni, umol, smoth, tbias, sbias, grav, rhoref,
  //      r, ad1, ad2 (the Jerlov parameters of ntp), 2 dti / 86400 (the
  //      restoring factor of taurstr) and whether taurstr is one value
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
  s.rfac = T(prm[12]);
  s.tau_one = prm[13] != 0.0;
  const int smem = layout(TI, TJ).total * (int)sizeof(T);
  cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto tile, auto edge) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    tile<<<grid, threads, smem, st>>>(s);
    if (orl) {
      const long cols = 2L * (s.g.im + s.g.jm);
      edge<<<(int)((cols + kEdgeThreads - 1) / kEdgeThreads), kEdgeThreads,
             0, st>>>(s);
    }
    return (int)cudaGetLastError();
  };
  if (rst || mp)
    return orl ? go(k_tracer_tile<T, O, true, true>,
                    k_tracer_edge<T, O, true>)
               : go(k_tracer_tile<T, O, false, true>,
                    k_tracer_edge<T, O, true>);
  return orl ? go(k_tracer_tile<T, O, true, false>,
                  k_tracer_edge<T, O, false>)
             : go(k_tracer_tile<T, O, false, false>,
                  k_tracer_edge<T, O, false>);
}

template <typename T, bool O>
int info(int TI, int TJ, int opt, int* out) {
  const int smem = layout(TI, TJ).total * (int)sizeof(T);
  const int n = TI * TJ;
  switch (opt & 3) {
    case 1: return extpom::tile_info(k_tracer_tile<T, O, true, false>, n,
                                     smem, out);
    case 2: return extpom::tile_info(k_tracer_tile<T, O, false, true>, n,
                                     smem, out);
    case 3: return extpom::tile_info(k_tracer_tile<T, O, true, true>, n,
                                     smem, out);
    default: return extpom::tile_info(k_tracer_tile<T, O, false, false>, n,
                                      smem, out);
  }
}

}  // namespace

extern "C" int extpom_phase_tracer_f32(void* const* ptr, const double* prm,
                                       int kb, int im, int jm, int nbct,
                                       int nbcs, int TI, int TJ, int grid,
                                       void* stream) {
  return run<float, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, nbct, nbcs,
                           TI, TJ, grid, stream);
}

extern "C" int extpom_phase_tracer_f64(void* const* ptr, const double* prm,
                                       int kb, int im, int jm, int nbct,
                                       int nbcs, int TI, int TJ, int grid,
                                       void* stream) {
  return run<double, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, nbct, nbcs,
                            TI, TJ, grid, stream);
}

extern "C" int extpom_phase_tracer_mesh_f32(void* const* ptr,
                                            const double* prm, int kb, int im,
                                            int jm, int R, int L, int oi,
                                            int oj, int nbct, int nbcs,
                                            int TI, int TJ, int grid,
                                            void* stream) {
  return run<float, true>(ptr, prm, kb, im, jm, R, L, oi, oj, nbct, nbcs, TI,
                          TJ, grid, stream);
}

extern "C" int extpom_phase_tracer_mesh_f64(void* const* ptr,
                                            const double* prm, int kb, int im,
                                            int jm, int R, int L, int oi,
                                            int oj, int nbct, int nbcs,
                                            int TI, int TJ, int grid,
                                            void* stream) {
  return run<double, true>(ptr, prm, kb, im, jm, R, L, oi, oj, nbct, nbcs, TI,
                           TJ, grid, stream);
}

// registers, static and dynamic shared bytes, resident blocks per SM,
// spill bytes and SMs of the tile kernel (column.cuh tile_info); f64, mesh
// and opt (bit 0 the orlanski variant, in the slot of phase_mom.cu's keep;
// bit 1 the options' variant) pick the instantiation (its shared memory
// does not depend on the depth)
extern "C" int extpom_phase_tracer_info(int f64, int mesh, int TI, int TJ,
                                        int, int opt, int* out) {
  if (f64)
    return mesh ? info<double, true>(TI, TJ, opt, out)
                : info<double, false>(TI, TJ, opt, out);
  return mesh ? info<float, true>(TI, TJ, opt, out)
              : info<float, false>(TI, TJ, opt, out);
}
