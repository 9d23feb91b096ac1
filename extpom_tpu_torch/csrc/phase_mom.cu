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
// Design: column tiles (column.cuh Tiles) and two launches.
//   k_mom_tile  a block owns a TI x TJ tile of columns, one thread each,
//     and sweeps k once upward: each level's planes of u, v, w and km (read
//     at a neighbour) are staged into shared memory as the tile's window
//     with a one-cell halo, those of advx, advy, drhox, drhoy, ub and vb
//     as the tile, by cp.async two levels ahead (a ring of three: adv(k)
//     needs the vertical advection at k+1, the solve's coef_a(k) km at
//     k+1).  advu/advv of each level feed the forward eliminations of
//     profu and profv in the same sweep; the vertical advection of level
//     k+1 is carried to the next level.  ee/gg of the two solves live in
//     device scratch, kb x 4 rows of the tile's columns per block (the grid
//     is the resident blocks).  One descending pass back-substitutes both,
//     writes uf and vf, and a column no Orlanski edge touches (2 <= i <=
//     im-2 and 2 <= j <= jm-2) commits the Asselin filter with the depth
//     mean in the same launch: its levels of uf + ub - 2u are kept in
//     shared memory where the planner says so (`keep`: where the blocks
//     the card then holds at once still cover every tile,
//     kernels/phases.py:plan_tile), else in the ub output column, and
//     summed in ascending k as kernels/phases.py:_depth_sum does.  Edge
//     columns keep the raw vertical advection (momentum.py:95-97, 125-127;
//     vertical.py:117-118); wubot/wvbot on the interior.  The solved uf
//     of rows 2 and im-2 and vf of columns 2 and jm-2, which orl_vel3d
//     reads, also go to a strip scratch (2 x kb x jm, then 2 x kb x im).
//   k_mom_edge  one thread per column of the perimeter strips (rows 0, 1,
//     im-1 and columns 0, 1, jm-1): the Orlanski edge values (east, west,
//     south, north in the reference's order) from the strips, the dum/dvm
//     mask on k < kbm1, and the Asselin filter of those columns.  Under
//     the file scheme (template flag F) it takes bc_vel3d's values
//     instead (bc/bcond.py): a blend, weighted by sqrt(d / hmax), of the
//     old u (v) one cell in and the boundary profile (ubw, ube, vbw, vbe
//     (kb, jm); ubs, ubn, vbs, vbn (kb, im)), each smoothed 1-2-1 along
//     the edge, for the normal component (the u-face at row 1 and its
//     copy on row 0, the v-face at column 1 and its copy on column 0), the
//     profile itself for the tangential one, written east, west, south,
//     north, and the dum/dvm mask on every level.
// Every per-point expression is the one of the plain version, operand for
// operand, and the sources build with -fmad=false, so each operation
// rounds as the plain PyTorch version's does.
//
// extpom_phase_mom_mesh_f32/f64 run the same kernels on one ring-extended
// block of the decomposed step (O, column.cuh), replacing the same TPU
// kernel with has_off (via mesh_runner): regions, the Orlanski rows and
// the strips at global (i, j), every staged read 0 outside the block,
// k_mom_tile skipping 2 cells next to the block's split edges and
// k_mom_edge 4 (their unguarded reads reach 1 and 2 cells); a ring cell
// outside the domain is left without its Asselin commit, for the caller
// trims it.

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

using extpom::GeomT;
using extpom::phase_speed;
using extpom::radiate;
using extpom::Tiles;

constexpr int kMaxThreads = 256;
// The kernel is bound by the latency of its per-level arithmetic, so it
// trades registers for resident warps: at most 64 registers in f32 (four
// 256-thread blocks per SM) and 128 in f64 (four 4x32 blocks).
constexpr int kStages = 3;  // levels k, k+1 resident, k+2 in flight
// fields staged per level as the window
constexpr int kHalo = 4;
enum { HU, HV, HW, HKM };
// ... and at the own column
constexpr int kOwn = 6;
enum { OADVX, OADVY, ODRX, ODRY, OUB, OVB };
// no 2-D arrays, wide window or faces in shared memory
constexpr int k2D = 0;
constexpr int kWide = 0;
constexpr int kFaces = 0;
// ee/gg rows per level in device scratch: ee and gg of u, of v
constexpr int kScratch = 4;
// levels kept per column in shared memory (keep): uf + ub - 2u, vf + vb - 2v
constexpr int kKeep = 2;
// face pairs staged per level, and a ring that holds every level when
// the tile keeps them (phase_uvw.cu's layout): none
constexpr int kStageFaces = 0;
constexpr int kKeepRing = 0;

// Shared memory of a tile, in elements: kStages stages, then (keep) kb
// levels of kKeep values per column.  kernels/phases.py:column_tile counts
// the same from the constants above, which it reads from this file.
struct Layout {
  int HC, TC, stage, total;
};

__host__ __device__ inline Layout layout(int TI, int TJ, int kb, bool keep) {
  Layout L;
  L.HC = (TI + 2) * (TJ + 2);
  L.TC = TI * TJ;
  L.stage = kHalo * L.HC + kOwn * L.TC;
  L.total = kStages * L.stage + (keep ? kKeep * kb * L.TC : 0);
  return L;
}

template <typename T, bool O>
struct Mom {
  const T *u, *ub, *v, *vb, *w, *advx, *advy, *drhox, *drhoy, *km;  // 3-D
  const T *dt, *egf, *egb, *etb, *etf, *d;                          // 2-D
  const T *e_atmos, *wusurf, *wvsurf;                               // 2-D
  const T *h, *dx, *dy, *aru, *arv, *cor, *cbc, *dum, *dvm;         // 2-D
  const T *dz, *dzz;                                                // (kb,)
  T *uo, *ubo, *vo, *vbo, *wubot, *wvbot;                           // outputs
  // ee/gg rows of the two solves, kb x 4 x TI*TJ per block
  T* egs;
  // the solved uf at global rows 2 and im-2, (2, kb, jm), then vf at global
  // columns 2 and jm-2, (2, kb, im), in the arrays' (block's) extents
  T* strip;
  // the file scheme's bc_vel3d (null otherwise; it also reads d = h + el):
  // the velocity profiles of the east/west edges (kb, jm) and of the
  // south/north edges (kb, im), hmax (0-d)
  const T *ubw, *ube, *vbw, *vbe, *ubs, *ubn, *vbs, *vbn, *hmax;
  GeomT<O> g;
  Tiles tl;
  int kbm1, kbm2;
  bool keep;
  // constants, each formed in double as the Python expression forms it and
  // rounded to T as PyTorch rounds a Python float operand
  T dti2, mdti2, dti2x2, g0125, umol, hsmoth;
};

// One component's column terms of advu/advv and profu/profv, formed once
// per column; the neighbour cell is the west (u) or south (v) one
template <typename T>
struct Comp {
  T ar4;      // aru (arv) * 0.25
  T ar;       // aru (arv)
  T cdt, cdtn;  // cor dt at the column and at the neighbour
  T pgrad, num, den, dh, tps, db, mask;
  T ee, gg, last;  // the forward sweep's last row, the solution at kbm2
  T va;            // the vertical advection at the level
  T kd;            // the vertical diffusivity at the level
};

// the solve's coefficients at level k (vertical.py:_profuv_solve): a
// from the diffusivity at k+1, c from the one at k
template <typename T, bool O>
__device__ __forceinline__ T coef_a(const Mom<T, O>& s, const Comp<T>& c,
                                    int k, T kd1) {
  return k < s.kbm2 ? s.mdti2 * kd1 / (s.dz[k] * s.dzz[k] * c.dh * c.dh)
                    : T(0);
}

template <typename T, bool O>
__device__ __forceinline__ T coef_c(const Mom<T, O>& s, const Comp<T>& c,
                                    int k) {
  return k >= 1 && k < s.kbm1
             ? s.mdti2 * c.kd / (s.dz[k] * s.dzz[k - 1] * c.dh * c.dh)
             : T(0);
}

// One forward step of a component's solve at level k <= kbm2 with -adv as
// the right-hand side; stores the row of level k < kbm2
template <typename T, bool O>
__device__ __forceinline__ void forward(const Mom<T, O>& s, Comp<T>& c, int k,
                                        T adv, T kd1, T wsurf, T& ee_row,
                                        T& gg_row) {
  const T a = coef_a(s, c, k, kd1);
  if (k == 0) {
    c.ee = a / (a - T(1));
    c.gg = (s.mdti2 * wsurf / (-s.dz[0] * c.dh) - adv) / (a - T(1));
  } else if (k < s.kbm2) {
    const T cc = coef_c(s, c, k);
    const T gk = T(1) / (a + cc * (T(1) - c.ee) - T(1));
    c.ee = a * gk;
    c.gg = (-adv + cc * c.gg) * gk;
  } else {  // the closed-form bottom row
    const T cl = coef_c(s, c, k);
    c.last = (cl * c.gg + -adv) / (cl * (T(1) - c.ee) + c.db) * c.mask;
    return;
  }
  ee_row = c.ee;
  gg_row = c.gg;
}

template <typename T, bool O>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 4 ? 4 : 2)
    k_mom_tile(Mom<T, O> s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const auto& g = s.g;
  const Tiles tl = s.tl;
  const int TI = tl.TI, TJ = tl.TJ, HJ = TJ + 2, nt = TI * TJ;
  const int t = threadIdx.x, ti = t / TJ, tj = t % TJ;
  const int kb = g.kb, kbm1 = s.kbm1, kbm2 = s.kbm2, jm = g.jm;
  const int GI = g.GI(), GJ = g.GJ();
  const long n = g.n;
  const Layout L = layout(TI, TJ, kb, s.keep);
  const int HC = L.HC, oc = (ti + 1) * HJ + tj + 1;  // own window cell
  T* const kept = sm + kStages * L.stage;
  T* const eg = s.egs + (long)blockIdx.x * kb * 4 * nt;
  auto win = [&](int k, int f) {
    return sm + (k % kStages) * L.stage + f * HC;
  };
  auto own = [&](int k, int f) {
    return sm + (k % kStages) * L.stage + kHalo * HC + f * L.TC + t;
  };
  auto row = [&](int k, int c) -> T& { return eg[(k * 4 + c) * nt + t]; };
  T* const su = s.strip;                      // (2, kb, jm)
  T* const sv = s.strip + 2L * kb * jm;       // (2, kb, im)

  for (int tile = blockIdx.x; tile < tl.count; tile += gridDim.x) {
    const int i0 = (tile / tl.nj) * TI, j0 = (tile % tl.nj) * TJ;
    const int i = i0 + ti, j = j0 + tj;
    const bool in = i < g.im && j < jm;
    const long p = in ? (long)i * jm + j : 0;
    const bool act = in && !g.skip(i, j);
    const int gi = g.gi(i), gj = g.gj(j);
    const bool inner =
        act && gi >= 1 && gi <= GI - 2 && gj >= 1 && gj <= GJ - 2;
    // no Orlanski edge value reads or replaces this column's uf/vf
    const bool free_ = inner && gi >= 2 && gi <= GI - 2 && gj >= 2 &&
                       gj <= GJ - 2;
    int off[extpom::kWindowCells];
    extpom::window_cells(off, t, nt, i0, j0, TI, TJ, g.im, jm);
    auto stage = [&](int k) {
      if (k <= kbm2) {
        const long b = (long)k * n;
        extpom::stage_window(win(k, HU), s.u + b, off, t, nt);
        extpom::stage_window(win(k, HV), s.v + b, off, t, nt);
        extpom::stage_window(win(k, HW), s.w + b, off, t, nt);
        extpom::stage_window(win(k, HKM), s.km + b, off, t, nt);
        extpom::stage_own(own(k, OADVX), s.advx + b, p, in);
        extpom::stage_own(own(k, OADVY), s.advy + b, p, in);
        extpom::stage_own(own(k, ODRX), s.drhox + b, p, in);
        extpom::stage_own(own(k, ODRY), s.drhoy + b, p, in);
        extpom::stage_own(own(k, OUB), s.ub + b, p, in);
        extpom::stage_own(own(k, OVB), s.vb + b, p, in);
      }
      extpom::cp_async_commit();
    };
    __syncthreads();  // the previous tile is done with shared memory
    stage(0);
    stage(1);

    // the column's 2-D terms of each component (u: west neighbour pw, v:
    // south neighbour ps)
    Comp<T> cu{}, cv{};
    if (inner) {
      const long pw = p - jm, ps = p - 1;
      const T h = s.h[p], etb = s.etb[p], etf = s.etf[p], dt = s.dt[p];
      const T cdt = s.cor[p] * dt;
      const long qb = (long)kbm2 * n + p;
      {  // u: advu (momentum.py:72-102), profu (vertical.py:98-118)
        const T dtw = s.dt[pw], aru = s.aru[p];
        const T eg2 = s.egf[p] - s.egf[pw] + s.egb[p] - s.egb[pw] +
                      (s.e_atmos[p] - s.e_atmos[pw]) * T(2);
        cu.ar = aru;
        cu.ar4 = aru * T(0.25);
        cu.cdt = cdt;
        cu.cdtn = s.cor[pw] * dtw;
        cu.pgrad = s.g0125 * (dt + dtw) * eg2 * (s.dy[p] + s.dy[pw]);
        cu.num = (h + etb + s.h[pw] + s.etb[pw]) * aru;
        cu.den = (h + etf + s.h[pw] + s.etf[pw]) * aru;
        cu.dh = T(0.5) * (h + etf + s.h[pw] + s.etf[pw]);
        const T ubb = s.ub[qb];
        const T vbb = T(0.25) * (s.vb[qb] + s.vb[qb + 1] + s.vb[qb - jm] +
                                 s.vb[qb - jm + 1]);
        cu.tps = T(0.5) * (s.cbc[p] + s.cbc[pw]) * sqrt(ubb * ubb + vbb * vbb);
        cu.db = cu.tps * s.dti2 / (-s.dz[kbm2] * cu.dh) - T(1);
        cu.mask = s.dum[p];
      }
      {  // v: advv (momentum.py:105-132), profv (vertical.py:121-140)
        const T dts = s.dt[ps], arv = s.arv[p];
        const T eg2 = s.egf[p] - s.egf[ps] + s.egb[p] - s.egb[ps] +
                      (s.e_atmos[p] - s.e_atmos[ps]) * T(2);
        cv.ar = arv;
        cv.ar4 = arv * T(0.25);
        cv.cdt = cdt;
        cv.cdtn = s.cor[ps] * dts;
        cv.pgrad = s.g0125 * (dt + dts) * eg2 * (s.dx[p] + s.dx[ps]);
        cv.num = (h + etb + s.h[ps] + s.etb[ps]) * arv;
        cv.den = (h + etf + s.h[ps] + s.etf[ps]) * arv;
        cv.dh = T(0.5) * (h + etf + s.h[ps] + s.etf[ps]);
        const T ubb = T(0.25) * (s.ub[qb] + s.ub[qb + jm] + s.ub[qb - 1] +
                                 s.ub[qb + jm - 1]);
        const T vbb = s.vb[qb];
        cv.tps = T(0.5) * (s.cbc[p] + s.cbc[ps]) * sqrt(ubb * ubb + vbb * vbb);
        cv.db = cv.tps * s.dti2 / (-s.dz[kbm2] * cv.dh) - T(1);
        cv.mask = s.dvm[p];
      }
    }
    T wsu = T(0), wsv = T(0);
    if (inner) {
      wsu = s.wusurf[p];
      wsv = s.wvsurf[p];
    }

    // ---- the ascending sweep: advu/advv and the forward eliminations ----
    for (int k = 0; k <= kbm2; ++k) {
      extpom::cp_async_wait_all();
      __syncthreads();
      stage(k + 2);
      if (!act) continue;
      const T* const U = win(k, HU);
      const T* const V = win(k, HV);
      const T* const KM = win(k, HKM);
      // vertical advection of level k+1, on [1:kbm1, 1:, :] (u) and
      // [1:kbm1, :, 1:] (v)
      T vu1 = T(0), vv1 = T(0);
      if (k + 1 < kbm1) {
        const T* const U1 = win(k + 1, HU);
        const T* const V1 = win(k + 1, HV);
        const T* const W1 = win(k + 1, HW);
        if (gi >= 1) vu1 = T(0.25) * (W1[oc] + W1[oc - HJ]) * (U1[oc] + U[oc]);
        if (gj >= 1) vv1 = T(0.25) * (W1[oc] + W1[oc - 1]) * (V1[oc] + V[oc]);
      }
      if (!inner) {  // edge columns keep the raw vertical advection
        const long q = k * n + p;
        s.uo[q] = cu.va;
        s.vo[q] = cv.va;
        if (gi == 2) su[(long)k * jm + j] = cu.va;
        if (gi == GI - 2) su[(long)(kb + k) * jm + j] = cu.va;
        if (gj == 2) sv[(long)k * g.im + i] = cv.va;
        if (gj == GJ - 2) sv[(long)(kb + k) * g.im + i] = cv.va;
        cu.va = vu1;
        cv.va = vv1;
        continue;
      }
      if (k == 0) {
        cu.kd = T(0.5) * (KM[oc] + KM[oc - HJ]) + s.umol;
        cv.kd = T(0.5) * (KM[oc] + KM[oc - 1]) + s.umol;
      }
      T ku1 = T(0), kv1 = T(0);  // the diffusivities at k+1
      if (k < kbm2) {
        const T* const KM1 = win(k + 1, HKM);
        ku1 = T(0.5) * (KM1[oc] + KM1[oc - HJ]) + s.umol;
        kv1 = T(0.5) * (KM1[oc] + KM1[oc - 1]) + s.umol;
      }
      // uf and vf of advu/advv on the interior, level k < kbm1
      const T coru = cu.ar4 * (cu.cdt * (V[oc + 1] + V[oc]) +
                               cu.cdtn * (V[oc - HJ + 1] + V[oc - HJ]));
      const T fu = *own(k, OADVX) + (cu.va - vu1) * cu.ar / s.dz[k] - coru +
                   cu.pgrad + *own(k, ODRX);
      const T advu = (cu.num * *own(k, OUB) - s.dti2x2 * fu) / cu.den;
      const T corv = cv.ar4 * (cv.cdt * (U[oc + HJ] + U[oc]) +
                               cv.cdtn * (U[oc + HJ - 1] + U[oc - 1]));
      const T fv = *own(k, OADVY) + (cv.va - vv1) * cv.ar / s.dz[k] + corv +
                   cv.pgrad + *own(k, ODRY);
      const T advv = (cv.num * *own(k, OVB) - s.dti2x2 * fv) / cv.den;
      forward(s, cu, k, advu, ku1, wsu, row(k, 0), row(k, 1));
      forward(s, cv, k, advv, kv1, wsv, row(k, 2), row(k, 3));
      cu.va = vu1;
      cv.va = vv1;
      cu.kd = ku1;
      cv.kd = kv1;
    }
    if (!act) continue;
    if (!inner) {
      for (int k = kbm1; k < kb; ++k) {
        const long q = k * n + p;
        s.uo[q] = T(0);
        s.vo[q] = T(0);
        if (gi == 2) su[(long)k * jm + j] = T(0);
        if (gi == GI - 2) su[(long)(kb + k) * jm + j] = T(0);
        if (gj == 2) sv[(long)k * g.im + i] = T(0);
        if (gj == GJ - 2) sv[(long)(kb + k) * g.im + i] = T(0);
      }
      s.wubot[p] = T(0);
      s.wvbot[p] = T(0);
      continue;
    }
    s.wubot[p] = -cu.tps * cu.last;
    s.wvbot[p] = -cv.tps * cv.last;

    // ---- the descending pass: back substitutions, uf/vf, the strips ----
    T fu = cu.last, fv = cv.last;
    auto xu = [&](int k) -> T& {
      return s.keep ? kept[(k * 2) * nt + t] : s.ubo[k * n + p];
    };
    auto xv = [&](int k) -> T& {
      return s.keep ? kept[(k * 2 + 1) * nt + t] : s.vbo[k * n + p];
    };
    for (int k = kb - 1; k >= 0; --k) {
      const long q = k * n + p;
      T uf = T(0), vf = T(0);  // profu keeps the 0 of advu from kbm1 on
      if (k < kbm2) {
        fu = (row(k, 0) * fu + row(k, 1)) * cu.mask;
        fv = (row(k, 2) * fv + row(k, 3)) * cv.mask;
      }
      if (k <= kbm2) {
        uf = fu;
        vf = fv;
      }
      if (gi == 2) su[(long)k * jm + j] = uf;
      if (gi == GI - 2) su[(long)(kb + k) * jm + j] = uf;
      if (gj == 2) sv[(long)k * g.im + i] = vf;
      if (gj == GJ - 2) sv[(long)(kb + k) * g.im + i] = vf;
      if (!free_) {  // k_mom_edge finishes this column
        s.uo[q] = uf;
        s.vo[q] = vf;
        continue;
      }
      // orl_vel3d's mask on k < kbm1
      if (k < kbm1) {
        uf = uf * cu.mask;
        vf = vf * cv.mask;
      }
      s.uo[q] = uf;
      s.vo[q] = vf;
      xu(k) = uf + s.ub[q] - T(2) * s.u[q];
      xv(k) = vf + s.vb[q] - T(2) * s.v[q];
    }
    if (!free_) continue;
    // ---- the Asselin filter with the depth mean, summed in ascending k ----
    T tpu = xu(0) * s.dz[0], tpv = xv(0) * s.dz[0];
    for (int k = 1; k < kbm1; ++k) {
      tpu = tpu + xu(k) * s.dz[k];
      tpv = tpv + xv(k) * s.dz[k];
    }
    for (int k = 0; k < kb; ++k) {
      const long q = k * n + p;
      const T x = xu(k), y = xv(k);
      s.ubo[q] = s.u[q] + s.hsmoth * (x - tpu);
      s.vbo[q] = s.v[q] + s.hsmoth * (y - tpv);
    }
  }
}

// ---- k_mom_edge ---------------------------------------------------------

// uf after orl_vel3d at level k < kbm1, before the dum mask; at(a, ii)
// reads global row ii of the cell's column, the strip the solved uf one
// row in
template <typename T, bool O>
__device__ T uf_final(const Mom<T, O>& s, int k, int i, int j) {
  const auto& g = s.g;
  const int im = g.GI(), jm = g.jm, gi = g.gi(i), gj = g.gj(j);
  const long row = k * g.n;
  auto at = [&](const T* a, int ii) {
    return a[row + (long)g.li(ii) * jm + j];
  };
  const T* const su = s.strip + (long)k * jm + j;
  if (gj >= 1 && gj <= g.GJ() - 2) {
    if (gi == im - 1) {  // east: uf/ub one row in, u two rows in
      const T cl = phase_speed(su[(long)g.kb * jm], at(s.ub, im - 2),
                               at(s.u, im - 3));
      return radiate(cl, at(s.ub, im - 1), at(s.u, im - 2));
    }
    if (gi <= 1) {  // west: the u-face at 1, then row 0 copies it
      const T cl = phase_speed(su[0], at(s.ub, 2), at(s.u, 3));
      return radiate(cl, at(s.ub, 1), at(s.u, 2));
    }
  } else if (gi >= 1 && gi <= im - 2) {  // south and north rows
    return T(0);
  }
  return s.uo[row + (long)i * jm + j];
}

// vf after orl_vel3d at level k < kbm1, before the dvm mask; at(a, jj)
// reads global column jj of the cell's row, the strip the solved vf one
// column in
template <typename T, bool O>
__device__ T vf_final(const Mom<T, O>& s, int k, int i, int j) {
  const auto& g = s.g;
  const int im = g.GI(), jm = g.GJ(), gi = g.gi(i), gj = g.gj(j);
  const long row = k * g.n + (long)i * g.jm;
  auto at = [&](const T* a, int jj) { return a[row + g.lj(jj)]; };
  const T* const sv =
      s.strip + 2L * g.kb * g.jm + (long)k * g.im + i;
  if (gi >= 1 && gi <= im - 2) {
    if (gj == jm - 1) {  // north
      const T cl = phase_speed(sv[(long)g.kb * g.im], at(s.vb, jm - 2),
                               at(s.v, jm - 3));
      return radiate(cl, at(s.vb, jm - 1), at(s.v, jm - 2));
    }
    if (gj <= 1) {  // south: the v-face at 1, then column 0 copies it
      const T cl = phase_speed(sv[0], at(s.vb, 2), at(s.v, 3));
      return radiate(cl, at(s.vb, 1), at(s.v, 2));
    }
  } else if (gj >= 1 && gj <= jm - 2) {  // east and west rows
    return T(0);
  }
  return s.vo[row + j];
}

// ---- bc_vel3d (the file scheme) ----

// element n of level k of an edge profile of n cells, 0 outside
template <typename T>
__device__ __forceinline__ T prof(const T* a, int n, int k, int idx) {
  return idx >= 0 && idx < n ? a[(long)k * n + idx] : T(0);
}

// sqrt(d / hmax) * (the 1-2-1 average of v0, v1, v2) + (1 - that weight)
// * (the 1-2-1 average of b0, b1, b2)
template <typename T>
__device__ __forceinline__ T blend(T d, T hmax, T v0, T v1, T v2, T b0, T b1,
                                   T b2) {
  const T ga = sqrt(d / hmax);
  return ga * (T(0.25) * v0 + T(0.5) * v1 + T(0.25) * v2) +
         (T(1) - ga) * (T(0.25) * b0 + T(0.5) * b1 + T(0.25) * b2);
}

// uf after bc_vel3d at level k < kbm1, before the dum mask
template <typename T, bool O>
__device__ T uf_file(const Mom<T, O>& s, int k, int i, int j) {
  const auto& g = s.g;
  const int GI = g.GI(), GJ = g.GJ(), gi = g.gi(i), gj = g.gj(j);
  if (gj >= 1 && gj <= GJ - 2) {
    // east: d at the edge, u one row in; west: the u-face at 1 reads d at
    // 0 and u at 2, and row 0 copies it
    const bool east = gi == GI - 1;
    if (east || gi <= 1) {
      const int r = g.li(east ? GI - 2 : 2);
      const T* b = east ? s.ube : s.ubw;
      auto u = [&](int jj) { return extpom::ld3(s.u, g, k, r, jj); };
      return blend(extpom::ld2(s.d, g, g.li(east ? GI - 1 : 0), j),
                   s.hmax[0], u(j - 1), u(j), u(j + 1),
                   prof(b, g.jm, k, j - 1), prof(b, g.jm, k, j),
                   prof(b, g.jm, k, j + 1));
    }
  } else if (gi >= 1 && gi <= GI - 2) {  // south and north: the profile
    return (gj == 0 ? s.ubs : s.ubn)[(long)k * g.im + i];
  }
  return s.uo[k * g.n + (long)i * g.jm + j];
}

// vf after bc_vel3d at level k < kbm1, before the dvm mask
template <typename T, bool O>
__device__ T vf_file(const Mom<T, O>& s, int k, int i, int j) {
  const auto& g = s.g;
  const int GI = g.GI(), GJ = g.GJ(), gi = g.gi(i), gj = g.gj(j);
  if (gi >= 1 && gi <= GI - 2) {
    // north: d at the edge, v one column in; south: the v-face at 1 reads
    // d at 0 and v at 2, and column 0 copies it
    const bool north = gj == GJ - 1;
    if (north || gj <= 1) {
      const int c = g.lj(north ? GJ - 2 : 2);
      const T* b = north ? s.vbn : s.vbs;
      auto v = [&](int ii) { return extpom::ld3(s.v, g, k, ii, c); };
      return blend(extpom::ld2(s.d, g, i, g.lj(north ? GJ - 1 : 0)),
                   s.hmax[0], v(i - 1), v(i), v(i + 1),
                   prof(b, g.im, k, i - 1), prof(b, g.im, k, i),
                   prof(b, g.im, k, i + 1));
    }
  } else if (gj >= 1 && gj <= GJ - 2) {  // west and east: the profile
    return (gi == 0 ? s.vbw : s.vbe)[(long)k * g.jm + j];
  }
  return s.vo[k * g.n + (long)i * g.jm + j];
}

// the perimeter columns of the block: rows 0, 1, im-1 across its columns,
// then columns 0, 1, jm-1 across its rows outside those rows
template <typename T, bool O, bool F>
__global__ void k_mom_edge(Mom<T, O> s) {
  const auto& g = s.g;
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int GI = g.GI(), GJ = g.GJ();
  int i, j;
  if (e < 3L * g.jm) {
    const int m = (int)(e / g.jm);
    const int r = m == 2 ? GI - 1 : m;
    if (m == 2 && r <= 1) return;
    i = g.li(r);
    j = (int)(e % g.jm);
    if (i < 0 || i >= g.im) return;
  } else {
    const long f = e - 3L * g.jm;
    if (f >= 3L * g.im) return;
    const int m = (int)(f / g.im);
    const int c = m == 2 ? GJ - 1 : m;
    if (m == 2 && c <= 1) return;
    i = (int)(f % g.im);
    j = g.lj(c);
    const int gi = g.gi(i);
    if (j < 0 || j >= g.jm || gi <= 1 || gi == GI - 1) return;
  }
  if (g.skip(i, j)) return;
  const long n = g.n, p = (long)i * g.jm + j;
  const T dum = s.dum[p], dvm = s.dvm[p];
  T tpu = T(0), tpv = T(0);
  for (int k = 0; k < g.kb; ++k) {
    const long q = k * n + p;
    T uf, vf;
    if constexpr (F) {  // bc_vel3d masks every level
      uf = (k < s.kbm1 ? uf_file(s, k, i, j) : s.uo[q]) * dum;
      vf = (k < s.kbm1 ? vf_file(s, k, i, j) : s.vo[q]) * dvm;
    } else {
      uf = k < s.kbm1 ? uf_final(s, k, i, j) * dum : s.uo[q];
      vf = k < s.kbm1 ? vf_final(s, k, i, j) * dvm : s.vo[q];
    }
    s.uo[q] = uf;
    s.vo[q] = vf;
    if (k < s.kbm1) {
      const T xu = (uf + s.ub[q] - T(2) * s.u[q]) * s.dz[k];
      const T xv = (vf + s.vb[q] - T(2) * s.v[q]) * s.dz[k];
      tpu = k == 0 ? xu : tpu + xu;
      tpv = k == 0 ? xv : tpv + xv;
    }
  }
  for (int k = 0; k < g.kb; ++k) {
    const long q = k * n + p;
    s.ubo[q] = s.u[q] + s.hsmoth * (s.uo[q] + s.ub[q] - T(2) * s.u[q] - tpu);
    s.vbo[q] = s.v[q] + s.hsmoth * (s.vo[q] + s.vb[q] - T(2) * s.v[q] - tpv);
  }
}

constexpr int kPointers = 47;
constexpr int kEdgeThreads = 128;

// ptr: the operands, outputs and scratch, then (file scheme; null
// otherwise) the eight velocity profiles and hmax; the domain is (im, jm),
// the arrays the domain or (O) the (R, L) block at global (oi, oj); the
// tiles TI x TJ, walked by `grid` blocks, with the levels kept in shared
// memory when keep; file: the file scheme's bc_vel3d
template <typename T, bool O>
int run(void* const* ptr, const double* prm, int kb, int im, int jm, int R,
        int L, int oi, int oj, int keep, int file, int TI, int TJ, int grid,
        void* stream) {
  Mom<T, O> s;
  int k = 0;
#define NEXT(f) s.f = (decltype(s.f))ptr[k++]
  NEXT(u); NEXT(ub); NEXT(v); NEXT(vb); NEXT(w); NEXT(advx); NEXT(advy);
  NEXT(drhox); NEXT(drhoy); NEXT(km);
  NEXT(dt); NEXT(egf); NEXT(egb); NEXT(etb); NEXT(etf); NEXT(d);
  NEXT(e_atmos); NEXT(wusurf); NEXT(wvsurf);
  NEXT(h); NEXT(dx); NEXT(dy); NEXT(aru); NEXT(arv); NEXT(cor); NEXT(cbc);
  NEXT(dum); NEXT(dvm);
  NEXT(dz); NEXT(dzz);
  NEXT(uo); NEXT(ubo); NEXT(vo); NEXT(vbo); NEXT(wubot); NEXT(wvbot);
  NEXT(egs); NEXT(strip);
  NEXT(ubw); NEXT(ube); NEXT(vbw); NEXT(vbe); NEXT(ubs); NEXT(ubn);
  NEXT(vbs); NEXT(vbn); NEXT(hmax);
#undef NEXT
  if (k != kPointers) return (int)cudaErrorInvalidValue;
  const int threads = TI * TJ;
  if (TI < 1 || TJ < 32 || TJ % 32 || threads > kMaxThreads || grid < 1 ||
      kb < 4 || s.egs == nullptr || s.strip == nullptr ||
      (file && (s.d == nullptr || s.hmax == nullptr || s.ubw == nullptr ||
                s.ube == nullptr || s.vbw == nullptr || s.vbe == nullptr ||
                s.ubs == nullptr || s.ubn == nullptr || s.vbs == nullptr ||
                s.vbn == nullptr)))
    return (int)cudaErrorInvalidValue;
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 2);
  s.tl.TI = TI;
  s.tl.TJ = TJ;
  s.tl.nj = (s.g.jm + TJ - 1) / TJ;
  s.tl.count = ((s.g.im + TI - 1) / TI) * s.tl.nj;
  s.kbm1 = kb - 1;
  s.kbm2 = kb - 2;
  s.keep = keep != 0;
  // prm: dti2, grav, umol, smoth
  s.dti2 = T(prm[0]);
  s.mdti2 = T(-prm[0]);
  s.dti2x2 = T(2.0 * prm[0]);
  s.g0125 = T(prm[1] * 0.125);
  s.umol = T(prm[2]);
  s.hsmoth = T(0.5 * prm[3]);
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = layout(TI, TJ, kb, s.keep).total * (int)sizeof(T);
  const cudaError_t e = cudaFuncSetAttribute(
      k_mom_tile<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k_mom_tile<T, O><<<grid, threads, smem, st>>>(s);
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 4);
  const long cols = 3L * (s.g.im + s.g.jm);
  const int eblocks = (int)((cols + kEdgeThreads - 1) / kEdgeThreads);
  if (file)
    k_mom_edge<T, O, true><<<eblocks, kEdgeThreads, 0, st>>>(s);
  else
    k_mom_edge<T, O, false><<<eblocks, kEdgeThreads, 0, st>>>(s);
  return (int)cudaGetLastError();
}

template <typename T, bool O>
int info(int TI, int TJ, int kb, int keep, int* out) {
  return extpom::tile_info(k_mom_tile<T, O>, TI * TJ,
                           layout(TI, TJ, kb, keep != 0).total *
                               (int)sizeof(T),
                           out);
}

}  // namespace

extern "C" int extpom_phase_mom_f32(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int keep,
                                    int file, int TI, int TJ, int grid,
                                    void* stream) {
  return run<float, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, keep, file,
                           TI, TJ, grid, stream);
}

extern "C" int extpom_phase_mom_f64(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int keep,
                                    int file, int TI, int TJ, int grid,
                                    void* stream) {
  return run<double, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, keep, file,
                            TI, TJ, grid, stream);
}

extern "C" int extpom_phase_mom_mesh_f32(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int keep, int file,
                                         int TI, int TJ, int grid,
                                         void* stream) {
  return run<float, true>(ptr, prm, kb, im, jm, R, L, oi, oj, keep, file, TI,
                          TJ, grid, stream);
}

extern "C" int extpom_phase_mom_mesh_f64(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int keep, int file,
                                         int TI, int TJ, int grid,
                                         void* stream) {
  return run<double, true>(ptr, prm, kb, im, jm, R, L, oi, oj, keep, file,
                           TI, TJ, grid, stream);
}

// registers, static and dynamic shared bytes, resident blocks per SM,
// spill bytes and SMs of the tile kernel (column.cuh tile_info) at kb
// levels, keep saying whether it keeps them in shared memory; f64 and
// mesh pick the instantiation
extern "C" int extpom_phase_mom_info(int f64, int mesh, int TI, int TJ,
                                     int kb, int keep, int* out) {
  if (f64)
    return mesh ? info<double, true>(TI, TJ, kb, keep, out)
                : info<double, false>(TI, TJ, kb, keep, out);
  return mesh ? info<float, true>(TI, TJ, kb, keep, out)
              : info<float, false>(TI, TJ, kb, keep, out);
}
