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
// Design: one launch, column tiles (column.cuh Tiles).  A block owns a
// TI x TJ tile of columns, one thread each, and sweeps k once upward:
//   * each level's planes of the fields read at a neighbour (q2, q2b, q2l,
//     q2lb, u, v, aam) are staged into shared memory as the tile's window
//     with a one-cell halo, those read only at the own column (w, t, s,
//     rho, km, kh, kq) as the tile, by cp.async two levels ahead (a ring
//     of four: k-1, k, k+1 resident, k+2 in flight); the 2-D grid fields
//     of the fluxes once per tile;
//   * each face flux of advq is computed once per level into shared memory
//     (every thread its west and south face, the tile's last row and
//     column the faces beyond), and advq takes differences of the stored
//     faces;
//   * the forward eliminations of profq's q2 and q2l solves run in the same
//     sweep (the q2l solve reads only the OLD q2), sharing the sound speed,
//     buoyancy gradient, length scale, production and dissipation of the
//     level, each evaluated once; the stability functions read only old
//     fields, so km/kh/kq are written in that sweep too; one descending
//     pass then does both back substitutions and the Asselin commits;
//   * ee/gg of the two solves live in device scratch, kb x 4 rows of the
//     tile's columns per block; the grid is the resident blocks, so the
//     scratch is sized by them, not by the grid of columns;
//   * profq's boundary copy of km/kh/kq is pushed: the interior column
//     nearest an edge column (for a corner, the diagonal one) writes its
//     value times the edge column's fsm there.  Every value comes from old
//     fields, so no block waits for another.
// An edge column takes bc_turb's value from the staged halo (bc_turb reads
// only the OLD q2/q2l/u/v).  Under the orlanski scheme (template flag B,
// orl_turb) the west and east edge columns take 1e-10 times fsm at every
// level, the south and north ones run profq's solve as the interior does,
// with advq's and the production's 0 there, and no value gains bc_turb's
// 1e-10.  Every per-point expression is the one of the
// plain version, operand for operand, and the sources build with
// -fmad=false, so each operation rounds as the plain PyTorch version's.
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
// extpom_phase_tke_mesh_f32/f64 run the same kernel on one ring-extended
// block of the decomposed step (O, column.cuh), replacing the same TPU
// kernel with has_off (via mesh_runner): regions and edges at global
// (i, j), the launch skipping 2 cells next to the block's split edges;
// every staged read is guarded, 0 outside the block.

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

using extpom::GeomT;
using extpom::Tiles;

constexpr int kMaxThreads = 256;
constexpr int kStages = 4;  // levels k-1, k, k+1 resident, k+2 in flight
// fields staged per level as the window: q2, q2b, q2l, q2lb, u, v, aam
constexpr int kHalo = 7;
enum { HQ2, HQ2B, HQ2L, HQ2LB, HU, HV, HAAM };
// ... and at the own column: w, t, s, rho, km, kh, kq
constexpr int kOwn = 7;
enum { OW, OT, OS, ORHO, OKM, OKH, OKQ };
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
// the x and y faces of q2 and q2l.  kernels/phases.py:column_tile counts
// the same from the constants above, which it reads from this file.
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
struct Tke {
  const T *q2, *q2b, *q2l, *q2lb, *u, *v, *w, *aam, *t, *s, *rho;  // 3-D
  const T *km, *kh, *kq;                                           // 3-D
  const T *dt, *etb, *etf, *wubot, *wvbot;                         // 2-D
  const T *wusurf, *wvsurf;                                        // 2-D
  const T *h, *dx, *dy, *art, *dum, *dvm, *fsm;                    // 2-D
  const T *z, *zz, *dz, *dzz;                                      // (kb,)
  T *q2o, *q2bo, *q2lo, *q2lbo, *kmo, *kho, *kqo, *lo;             // outputs
  // ee/gg rows of the two solves, kb x 4 x TI*TJ per block
  T* egs;
  GeomT<O> g;
  Tiles tl;
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

// advq's x face flux between window cells c - HJ and c at level k: f, fb,
// u and aam at k (0) and k-1 (1), the 2-D window d
template <typename T>
__device__ __forceinline__ T xface(const T* f, const T* fb, const T* u0,
                                   const T* u1, const T* a0, const T* a1,
                                   const T* d, int HC, int c, int HJ) {
  const int w = c - HJ;
  const T* dt = d + DDT * HC;
  const T* h = d + DH * HC;
  const T* dx = d + DDX * HC;
  const T* dy = d + DDY * HC;
  const T x1 = T(0.125) * (f[c] + f[w]) * (dt[c] + dt[w]) * (u0[c] + u1[c]);
  const T xd = T(0.25) * (a0[c] + a0[w] + a1[c] + a1[w]) * (h[c] + h[w]) *
               (fb[c] - fb[w]) * d[DDUM * HC + c] / (dx[c] + dx[w]);
  return T(0.5) * (dy[c] + dy[w]) * (x1 - xd);
}

// advq's y face flux between window cells c - 1 and c
template <typename T>
__device__ __forceinline__ T yface(const T* f, const T* fb, const T* v0,
                                   const T* v1, const T* a0, const T* a1,
                                   const T* d, int HC, int c) {
  const int s = c - 1;
  const T* dt = d + DDT * HC;
  const T* h = d + DH * HC;
  const T* dx = d + DDX * HC;
  const T* dy = d + DDY * HC;
  const T y1 = T(0.125) * (f[c] + f[s]) * (dt[c] + dt[s]) * (v0[c] + v1[c]);
  const T yd = T(0.25) * (a0[c] + a0[s] + a1[c] + a1[s]) * (h[c] + h[s]) *
               (fb[c] - fb[s]) * d[DDVM * HC + c] / (dy[c] + dy[s]);
  return T(0.5) * (dx[c] + dx[s]) * (y1 - yd);
}

// profq's speed of sound at level k < kbm1 from the column's t, s
template <typename T, bool O>
__device__ __forceinline__ T sound(const Tke<T, O>& s, int k, T t, T sal,
                                   T h) {
  const T tp = t + s.tbias, sp = sal + s.sbias;
  const T pr = s.grho * (-s.zz[k] * h) * T(1.0e-4);
  const T cc = T(1449.1) + T(0.00821) * pr + T(4.55) * tp -
               T(0.045) * (tp * tp) + T(1.34) * (sp - T(35.0));
  return cc /
         sqrt((T(1) - T(0.01642) * pr / cc) * (T(1) - T(0.40) * pr / (cc * cc)));
}

template <typename T, bool O, bool B>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 4 ? 2 : 1)
    k_tke_tile(Tke<T, O> s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const auto& g = s.g;
  const Tiles tl = s.tl;
  const int TI = tl.TI, TJ = tl.TJ, HJ = TJ + 2, nt = TI * TJ;
  const int t = threadIdx.x, ti = t / TJ, tj = t % TJ;
  const int kb = g.kb, kbm1 = s.kbm1, jm = g.jm;
  const long n = g.n;
  const Layout L = layout(TI, TJ);
  const int HC = L.HC, wc = (ti + 1) * HJ + tj + 1;  // own window cell
  T* const d2 = sm + kStages * L.stage;
  T* const xq2 = d2 + k2D * HC;           // (TI+1) x TJ
  T* const yq2 = xq2 + (TI + 1) * TJ;     // TI x (TJ+1)
  T* const xq2l = yq2 + TI * (TJ + 1);
  T* const yq2l = xq2l + (TI + 1) * TJ;
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

  for (int tile = blockIdx.x; tile < tl.count; tile += gridDim.x) {
    const int i0 = (tile / tl.nj) * TI, j0 = (tile % tl.nj) * TJ;
    const int i = i0 + ti, j = j0 + tj;
    const bool in = i < g.im && j < jm;
    const long p = in ? (long)i * jm + j : 0;
    const bool act = in && !g.skip(i, j);
    const int gi = g.gi(i), gj = g.gj(j);
    const bool inner =
        act && gi >= 1 && gi <= g.GI() - 2 && gj >= 1 && gj <= g.GJ() - 2;
    // B (orl_turb): the south and north edge columns keep profq's solve,
    // whose advection and production are 0 there
    const bool ns = B && act && !inner && gi >= 1 && gi <= g.GI() - 2;
    int off[extpom::kWindowCells];
    extpom::window_cells(off, t, nt, i0, j0, TI, TJ, g.im, jm);
    auto stage = [&](int k) {
      if (k < kb) {
        const long b = (long)k * n;
        extpom::stage_window(win(k, HQ2), s.q2 + b, off, t, nt);
        extpom::stage_window(win(k, HQ2B), s.q2b + b, off, t, nt);
        extpom::stage_window(win(k, HQ2L), s.q2l + b, off, t, nt);
        extpom::stage_window(win(k, HQ2LB), s.q2lb + b, off, t, nt);
        extpom::stage_window(win(k, HU), s.u + b, off, t, nt);
        extpom::stage_window(win(k, HV), s.v + b, off, t, nt);
        extpom::stage_window(win(k, HAAM), s.aam + b, off, t, nt);
        extpom::stage_own(own(k, OW), s.w + b, p, in);
        extpom::stage_own(own(k, OT), s.t + b, p, in);
        extpom::stage_own(own(k, OS), s.s + b, p, in);
        extpom::stage_own(own(k, ORHO), s.rho + b, p, in);
        extpom::stage_own(own(k, OKM), s.km + b, p, in);
        extpom::stage_own(own(k, OKH), s.kh + b, p, in);
        extpom::stage_own(own(k, OKQ), s.kq + b, p, in);
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
    T h = T(0), fsm = T(0), dh = T(0), art = T(0), etb = T(0), etf = T(0);
    T utau2 = T(0), bot = T(0);
    if (act) {
      h = s.h[p];
      fsm = s.fsm[p];
      etf = s.etf[p];
      dh = h + etf;
      // surface friction velocity squared, 0 on the last row and column
      if (gi < g.GI() - 1 && gj < g.GJ() - 1) {
        const T su = T(0.5) * (s.wusurf[p] + s.wusurf[p + jm]);
        const T sv = T(0.5) * (s.wvsurf[p] + s.wvsurf[p + 1]);
        utau2 = sqrt(su * su + sv * sv);
      }
    }
    if (inner) {
      art = s.art[p];
      etb = s.etb[p];
    }
    // the bottom value on the bottom stress's region :-1, :-1
    if (inner || (ns && gj == 0)) {
      const T bu = T(0.5) * (s.wubot[p] + s.wubot[p + jm]);
      const T bv = T(0.5) * (s.wvbot[p] + s.wvbot[p + 1]);
      bot = sqrt(bu * bu + bv * bv) * s.const1;
    }
    const T kl0 = s.kappa * (s.surfl * utau2 * s.rgrav);
    const T z0 = s.z[0], zb = s.z[kb - 1];
    // edge columns this column's km/kh/kq go to (profq's boundary copy):
    // bit 0/1 the first/last row, bit 2/3 the first/last column
    int push = 0;
    if (inner) {
      push = (gi == 1 ? 1 : 0) | (gi == g.GI() - 2 ? 2 : 0) |
             (gj == 1 ? 4 : 0) | (gj == g.GJ() - 2 ? 8 : 0);
    }
    auto mid = [&](int k) { return k >= 1 && k < kbm1; };
    // Asselin filter of q2 or q2l at level k with its final new value fn
    auto commit = [&](T f, T fb, T* fo, T* fbo, int k, T fn) {
      const long q = k * n + p;
      fo[q] = fn;
      fbo[q] = f + s.hsmoth * (fn + (mid(k) ? fabs(fb) : fb) - T(2) * f);
    };
    // bc_turb's value of f (window wf) at this edge column, level k, before
    // fsm; written west, east, south, north: the last side written wins
    auto turb_edge = [&](const T* wf, int k) -> T {
      const T* u = win(k, HU);
      const T* v = win(k, HV);
      const T* dx = d2 + DDX * HC;
      const T* dy = d2 + DDY * HC;
      int in_c;
      bool le;
      T u1;
      if (gj == g.GJ() - 1) {
        in_c = wc - 1; le = true;
        u1 = T(2) * v[wc] * s.dti / (dy[wc] + dy[in_c]);
      } else if (gj == 0) {
        in_c = wc + 1; le = false;
        u1 = T(2) * v[in_c] * s.dti / (dy[wc] + dy[in_c]);
      } else if (gi == g.GI() - 1) {
        in_c = wc - HJ; le = true;
        u1 = T(2) * u[wc] * s.dti / (dx[wc] + dx[in_c]);
      } else {
        in_c = wc + HJ; le = false;
        u1 = T(2) * u[in_c] * s.dti / (dx[wc] + dx[in_c]);
      }
      const T fv = wf[wc], fi = wf[in_c];
      if (le)
        return u1 <= T(0) ? fv - u1 * (s.small - fv) : fv - u1 * (fv - fi);
      return u1 >= T(0) ? fv - u1 * (fv - s.small) : fv - u1 * (fi - fv);
    };

    // ---- the ascending sweep ----
    T ee1 = T(0), gg1 = T(0), ee2 = T(0), gg2 = T(0);  // q2, q2l rows
    T cm = T(0);                                      // sound at k-1
    for (int k = 0; k < kb; ++k) {
      extpom::cp_async_wait_all();
      __syncthreads();
      stage(k + 2);
      const bool fq2 = k >= 1 && k <= kb - 2, fq2l = k >= 2 && k <= kb - 3;
      if (fq2 || fq2l) {
        const T *u0 = win(k, HU), *u1 = win(k - 1, HU);
        const T *v0 = win(k, HV), *v1 = win(k - 1, HV);
        const T *a0 = win(k, HAAM), *a1 = win(k - 1, HAAM);
        if (fq2) {
          const T *f = win(k, HQ2), *fb = win(k, HQ2B);
          xq2[fw] = xface(f, fb, u0, u1, a0, a1, d2, HC, wc, HJ);
          yq2[fs] = yface(f, fb, v0, v1, a0, a1, d2, HC, wc);
          if (ti == TI - 1)
            xq2[fe] = xface(f, fb, u0, u1, a0, a1, d2, HC, wc + HJ, HJ);
          if (tj == TJ - 1)
            yq2[fn] = yface(f, fb, v0, v1, a0, a1, d2, HC, wc + 1);
        }
        if (fq2l) {
          const T *f = win(k, HQ2L), *fb = win(k, HQ2LB);
          xq2l[fw] = xface(f, fb, u0, u1, a0, a1, d2, HC, wc, HJ);
          yq2l[fs] = yface(f, fb, v0, v1, a0, a1, d2, HC, wc);
          if (ti == TI - 1)
            xq2l[fe] = xface(f, fb, u0, u1, a0, a1, d2, HC, wc + HJ, HJ);
          if (tj == TJ - 1)
            yq2l[fn] = yface(f, fb, v0, v1, a0, a1, d2, HC, wc + 1);
        }
        __syncthreads();
      }
      if (!act) continue;
      const long q = k * n + p;
      const T q2k = win(k, HQ2)[wc], q2bk = win(k, HQ2B)[wc];
      const T q2lk = win(k, HQ2L)[wc], q2lbk = win(k, HQ2LB)[wc];
      // the new length scale
      T lk;
      if (k == 0) {
        lk = kl0;
      } else if (k == kb - 1) {
        lk = T(0);
      } else {
        const T qb = fabs(q2bk);
        const T lm = fabs(fabs(q2lbk) / (qb == T(0) ? T(1) : qb));
        lk = s.z[k] > T(-0.5) ? nan_max(lm, kl0) : lm;
      }
      s.lo[q] = lk;
      if (!inner && !ns) {
        if constexpr (B) {  // orl_turb: the west and east edges
          commit(q2k, q2bk, s.q2o, s.q2bo, k, T(1.0e-10) * fsm);
          commit(q2lk, q2lbk, s.q2lo, s.q2lbo, k, T(1.0e-10) * fsm);
        } else {
          commit(q2k, q2bk, s.q2o, s.q2bo, k,
                 turb_edge(win(k, HQ2), k) * fsm + T(1.0e-10));
          commit(q2lk, q2lbk, s.q2lo, s.q2lbo, k,
                 turb_edge(win(k, HQ2L), k) * fsm + T(1.0e-10));
        }
        continue;
      }
      const T kmk = *own(k, OKM), khk = *own(k, OKH), kqk = *own(k, OKQ);
      // buoyancy gradient and production at the middle levels
      const T c0 = k < kbm1 ? sound(s, k, *own(k, OT), *own(k, OS), h) : T(0);
      T by = T(0), pk = T(0);
      if (mid(k)) {
        by = s.grav * (*own(k - 1, ORHO) - *own(k, ORHO)) /
                 (s.dzz[k - 1] * h) +
             T(1) / (cm * cm + c0 * c0) * s.g2x2;
      }
      if (mid(k) && (!B || inner)) {  // prod's region is 1:-1, 1:-1
        const T *u0 = win(k, HU), *u1 = win(k - 1, HU);
        const T *v0 = win(k, HV), *v1 = win(k - 1, HV);
        const T du = u0[wc] - u1[wc] + u0[wc + HJ] - u1[wc + HJ];
        const T dv = v0[wc] - v1[wc] + v0[wc + 1] - v1[wc + 1];
        const T dd = s.dzz[k - 1] * dh;
        pk = kmk * T(0.25) * s.sef * (du * du + dv * dv) / (dd * dd) -
             s.shiw * kmk * by + khk * by;
      }
      cm = c0;
      if (k == 0) {  // the seed rows: q2's surface value, q2l's zeros
        ee1 = T(0);
        gg1 = s.ggc * utau2;
        row(0, 0) = ee1;
        row(0, 1) = gg1;
        row(0, 2) = T(0);
        row(0, 3) = T(0);
      } else if (k == 1) {  // q2l's surface value
        ee2 = T(0);
        gg2 = s.mkappa * s.z[1] * dh * q2k;
        row(1, 2) = ee2;
        row(1, 3) = gg2;
      }
      if (k >= 1 && k <= kb - 2) {
        const T a = s.mdti2 * (*own(k + 1, OKQ) + kqk + s.umol2) * T(0.5) /
                    (s.dzz[k - 1] * s.dz[k] * dh * dh);
        const T c = s.mdti2 * (*own(k - 1, OKQ) + kqk + s.umol2) * T(0.5) /
                    (s.dzz[k - 1] * s.dz[k - 1] * dh * dh);
        const T dtef = sqrt(fabs(q2bk)) / (s.b1 * lk + s.small);
        const T wm = *own(k - 1, OW), wp = *own(k + 1, OW);
        {  // q2, levels 1..kb-2, with advq's new q2
          const T fm = win(k - 1, HQ2)[wc], fp = win(k + 1, HQ2)[wc];
          const T qf = (wm * fm - wp * fp) * art / (s.dz[k] + s.dz[k - 1]) +
                       xq2[fe] - xq2[fw] + yq2[fn] - yq2[fs];
          // advq leaves the edge columns 0
          const T adv = ns ? T(0)
                           : ((h + etb) * art * q2bk - s.dti2 * qf) /
                                 ((h + etf) * art);
          const T den = s.dti2x2 * dtef + T(1);
          const T rhs = s.mdti2x2 * pk - adv;
          const T gk = T(1) / (a + c * (T(1) - ee1) - den);
          ee1 = a * gk;
          gg1 = (rhs + c * gg1) * gk;
          row(k, 0) = ee1;
          row(k, 1) = gg1;
        }
        if (k >= 2) {  // q2l, levels 2..kb-2
          T wallfac = T(1);
          {
            const T d0 = fabs(s.z[k] - z0), d1 = fabs(s.z[k] - zb);
            if (d0 > T(0) && d1 > T(0)) {
              const T x = (T(1) / d0 + T(1) / d1) * lk / (dh * s.kappa);
              wallfac = T(1) + s.e2 * (x * x);
            }
          }
          T fin;
          if (k == kb - 2) {
            fin = s.kappa * (T(1) + s.z[kb - 2]) * dh * q2k;
          } else {
            const T fm = win(k - 1, HQ2L)[wc], fp = win(k + 1, HQ2L)[wc];
            const T qf = (wm * fm - wp * fp) * art / (s.dz[k] + s.dz[k - 1]) +
                         xq2l[fe] - xq2l[fw] + yq2l[fn] - yq2l[fs];
            fin = ns ? T(0)
                     : ((h + etb) * art * q2lbk - s.dti2 * qf) /
                           ((h + etf) * art);
          }
          const T den = s.dti2 * (dtef * wallfac) + T(1);
          const T rhs = s.dti2 * (-pk * lk * s.e1) - fin;
          const T gk = T(1) / (a + c * (T(1) - ee2) - den);
          ee2 = a * gk;
          gg2 = (rhs + c * gg2) * gk;
          row(k, 2) = ee2;
          row(k, 3) = gg2;
        }
      }
      // ---- stability functions and mixing coefficients ----
      T gh = T(0);
      if (mid(k)) {
        const T qb = fabs(q2bk);
        const T x = lk * lk * by / (qb == T(0) ? T(1) : qb);
        gh = x > T(0.028) ? T(0.028) : x;  // a NaN passes, as torch.clamp's
      }
      const T sh = s.coef1 / (T(1) - s.coef2 * gh);
      const T sm_ = (s.coef3 + sh * s.coef4 * gh) / (T(1) - s.coef5 * gh);
      const T kn = lk * sqrt(fabs(q2k));
      const T kqv = (kn * T(0.41) * sh + kqk) * T(0.5);
      const T kmv = (kn * sm_ + kmk) * T(0.5);
      const T khv = (kn * sh + khk) * T(0.5);
      if (!B || inner) {  // an edge column takes its neighbour's (push)
        s.kqo[q] = kqv * fsm;
        s.kmo[q] = kmv * fsm;
        s.kho[q] = khv * fsm;
      }
      // not unrolled: unrolled, the compiler keeps the addresses of all
      // eight candidate edge cells live across the sweep, and at 128
      // registers that spills (40 bytes against 16 per thread, 12 % slower
      // at 2048x2048x41 f32 on the H100)
      if (push) {
#pragma unroll 1
        for (int a = 0; a < 3; ++a) {
          const int ei = a == 0 ? gi : (a == 1 ? 0 : g.GI() - 1);
          if (a == 1 && !(push & 1)) continue;
          if (a == 2 && !(push & 2)) continue;
#pragma unroll 1
          for (int b = 0; b < 3; ++b) {
            const int ej = b == 0 ? gj : (b == 1 ? 0 : g.GJ() - 1);
            if (b == 1 && !(push & 4)) continue;
            if (b == 2 && !(push & 8)) continue;
            if (a == 0 && b == 0) continue;
            const long e = (long)g.li(ei) * jm + g.lj(ej);
            const T fsm_e = s.fsm[e];
            s.kqo[k * n + e] = kqv * fsm_e;
            s.kmo[k * n + e] = kmv * fsm_e;
            s.kho[k * n + e] = khv * fsm_e;
          }
        }
      }
    }

    // ---- the descending pass: both back substitutions, the commits ----
    if (inner || ns) {
      T f1 = (T(0) * gg1 + bot) / (T(0) * (T(1) - ee1) + T(1)) * T(1);
      T f2 = (T(0) * gg2 + T(0)) / (T(0) * (T(1) - ee2) + T(1)) * T(1);
      for (int k = kb - 1; k >= 0; --k) {
        if (k < kb - 1) {
          f1 = (row(k, 0) * f1 + row(k, 1)) * T(1);
          f2 = (row(k, 2) * f2 + row(k, 3)) * T(1);
        }
        const long q = k * n + p;
        // bc_turb adds 1e-10 after the fsm mask; orl_turb does not
        T f1n = (mid(k) ? fabs(f1) : f1) * fsm;
        T f2n = (mid(k) ? fabs(f2) : T(0)) * fsm;
        if constexpr (!B) {
          f1n = f1n + T(1.0e-10);
          f2n = f2n + T(1.0e-10);
        }
        commit(s.q2[q], s.q2b[q], s.q2o, s.q2bo, k, f1n);
        commit(s.q2l[q], s.q2lb[q], s.q2lo, s.q2lbo, k, f2n);
      }
    }
  }
}

constexpr int kPointers = 41;

// ptr: the operands, outputs and scratch; the domain is (im, jm), the
// arrays the domain or (O) the (R, L) block at global (oi, oj); the tiles
// TI x TJ, walked by `grid` blocks
template <typename T, bool O, bool B>
int run(void* const* ptr, const double* prm, int kb, int im, int jm, int R,
        int L, int oi, int oj, int TI, int TJ, int grid, void* stream) {
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
  NEXT(egs);
#undef NEXT
  if (k != kPointers) return (int)cudaErrorInvalidValue;
  const int threads = TI * TJ;
  if (TI < 1 || TJ < 32 || TJ % 32 || threads > kMaxThreads || grid < 1 ||
      s.egs == nullptr)
    return (int)cudaErrorInvalidValue;
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 2);
  s.tl.TI = TI;
  s.tl.TJ = TJ;
  s.tl.nj = (s.g.jm + TJ - 1) / TJ;
  s.tl.count = ((s.g.im + TI - 1) / TI) * s.tl.nj;
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
  const int smem = layout(TI, TJ).total * (int)sizeof(T);
  const cudaError_t e = cudaFuncSetAttribute(
      k_tke_tile<T, O, B>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k_tke_tile<T, O, B><<<grid, threads, smem, (cudaStream_t)stream>>>(s);
  return (int)cudaGetLastError();
}

template <typename T, bool O>
int info(int TI, int TJ, int orl, int* out) {
  const int smem = layout(TI, TJ).total * (int)sizeof(T);
  return orl ? extpom::tile_info(k_tke_tile<T, O, true>, TI * TJ, smem, out)
             : extpom::tile_info(k_tke_tile<T, O, false>, TI * TJ, smem, out);
}

// the entry of the options: orl, the orlanski scheme's orl_turb
template <typename T, bool O>
int run_opt(int orl, void* const* ptr, const double* prm, int kb, int im,
            int jm, int R, int L, int oi, int oj, int TI, int TJ, int grid,
            void* stream) {
  return orl ? run<T, O, true>(ptr, prm, kb, im, jm, R, L, oi, oj, TI, TJ,
                               grid, stream)
             : run<T, O, false>(ptr, prm, kb, im, jm, R, L, oi, oj, TI, TJ,
                                grid, stream);
}

}  // namespace

// the two phase options: orl (the orlanski scheme), unused
extern "C" int extpom_phase_tke_f32(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int orl, int,
                                    int TI, int TJ, int grid, void* stream) {
  return run_opt<float, false>(orl, ptr, prm, kb, im, jm, im, jm, 0, 0, TI,
                               TJ, grid, stream);
}

extern "C" int extpom_phase_tke_f64(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int orl, int,
                                    int TI, int TJ, int grid, void* stream) {
  return run_opt<double, false>(orl, ptr, prm, kb, im, jm, im, jm, 0, 0, TI,
                                TJ, grid, stream);
}

extern "C" int extpom_phase_tke_mesh_f32(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int orl, int, int TI,
                                         int TJ, int grid, void* stream) {
  return run_opt<float, true>(orl, ptr, prm, kb, im, jm, R, L, oi, oj, TI,
                              TJ, grid, stream);
}

extern "C" int extpom_phase_tke_mesh_f64(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int orl, int, int TI,
                                         int TJ, int grid, void* stream) {
  return run_opt<double, true>(orl, ptr, prm, kb, im, jm, R, L, oi, oj, TI,
                               TJ, grid, stream);
}

// registers, static and dynamic shared bytes, resident blocks per SM,
// spill bytes and SMs of the tile kernel (column.cuh tile_info); f64, mesh
// and orl (the orlanski variant, in the slot of phase_mom.cu's keep) pick
// the instantiation (its shared memory does not depend on the depth)
extern "C" int extpom_phase_tke_info(int f64, int mesh, int TI, int TJ,
                                     int, int orl, int* out) {
  if (f64)
    return mesh ? info<double, true>(TI, TJ, orl, out)
                : info<double, false>(TI, TJ, orl, out);
  return mesh ? info<float, true>(TI, TJ, orl, out)
              : info<float, false>(TI, TJ, orl, out);
}
