// Internal-mode phase lat: lateral viscosity aam and the 3-D advection and
// baroclinic pressure terms advx, advy, drhox, drhoy (advance.f:96-141).
//
// Replaces phase "lat" of extpom_tpu/pallas/phases.py:_kernel (via
// windowed_phase and runner.lat), which runs core/stepper.py:phase_lat on
// halo-extended i-stripes in TPU VMEM.  Counterpart here of
// kernels/phases.py:phase_lat_plain (core/stepper.py:213-233,
// ops/momentum.py:advct, ops/pressure.py:baropg and _cumk).
//
// Bound on the H100: memory.  Per column it reads 7 kb-level fields (u, v,
// ub, vb, aam, rho, rmean) and writes 5 (aam, advx, advy, drhox, drhoy),
// with ~250 flops per level.
//
// Design: one launch, column tiles (column.cuh Tiles).  A block owns a
// TI x TJ tile of columns, one thread each, and sweeps k once upward:
//   * each level's planes of u, v, ub, vb, aam, rho and rmean are staged
//     into shared memory as the tile's window with a one-cell halo
//     (diagonals included: curv reads v at (i-1, j+1), xflux at (i+1, j-1)
//     reads u), by cp.async one level ahead (a ring of two);
//   * dt, dx and dy are staged once per tile with a two-cell halo (xflux at
//     i-1 reads dt at i-2, curv at i-1 dy at i-2), and the k-independent
//     terms the plain version forms whole are formed from them once per
//     tile: dt + dt_w, dt + dt_s, the dx4/dy4/dt4 sums, 0.25 dx4, 0.25 dy4,
//     0.25 dt4, the curvature metrics dy_e - dy_w, dx_n - dx_s and dx dy;
//   * each level the four face fluxes of advct (xflux and yflux of each
//     component, with their viscous terms and dtaam formed once per cell)
//     and curv are computed once into shared memory, and advx and advy are
//     differences of stored faces;
//   * baropg's running sum stays in registers in ascending k, the order of
//     pressure.py:_cumk, with rho - rmean at (i, j), (i-1, j) and (i, j-1)
//     carried from level k-1.
// Every per-point expression is the one of the plain version, operand for
// operand, and the sources build with -fmad=false, so each operation
// rounds as the plain PyTorch version's does.
//
// McCalpin's 4th-order pressure gradient (npg=2, ops/pressure.py:
// baropg_mcc; template flag M) replaces baropg: rho - rmean is read at i-1,
// i+1 and i-2 (j-1, j+1, j-2) of each level, from the window, and for the tile's first row (column) i-2 (j-2) from device
// memory; d = h + el is staged once per tile into the wide window
// (kWideOpt), and dum (dvm) one cell either way is read once per column;
// the k-independent ddx and d4 of each component are formed once per
// column, drho and rhou of level k-1 are carried in registers, and the
// 4th-order corrections commit on i 2..im-2 (x) and j 2..jm-2 (y).
//
// Where an off-by-one would hide (ops/momentum.py:16-69):
//   * the flux regions differ per term: xflux of advx lives on [1:-1, :]
//     and is 0 at i=0 (read by the interior's i-1 face), yflux of advy on
//     [:, 1:-1] and is 0 at j=0; the others cover the interior's faces;
//   * the curvature correction commits on i 2:-1 (advx) and j 2:-1 (advy);
//   * the ramp multiplies drhox/drhoy on [:, 1:-1, 1:-1], so level kbm1 of
//     the interior is 0 * ramp;
//   * aam keeps aam0 outside [:kbm1, 1:-1, 1:-1].
//
// extpom_phase_lat_mesh_f32/f64 run the same kernel on one ring-extended
// block of the decomposed step (O, column.cuh), replacing the same TPU
// kernel with has_off (via mesh_runner): regions at global (i, j), every
// staged read 0 outside the block, the launch skipping 2 cells next to the
// block's split edges.

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

using extpom::GeomT;
using extpom::Tiles;

constexpr int kMaxThreads = 256;
// The kernel is bound by the latency of its per-level arithmetic, so it
// trades registers for resident warps: at most 64 registers in f32 (four
// 256-thread blocks per SM) and 128 in f64 (four 4x32 blocks).
constexpr int kStages = 2;  // level k resident, k+1 in flight
// fields staged per level as the window
constexpr int kHalo = 7;
enum { HU, HV, HUB, HVB, HAAM, HRHO, HRM };
// ... and at the own column: none
constexpr int kOwn = 0;
// arrays on the one-cell window: the k-independent terms, formed once per
// tile, and curv, formed per level
constexpr int k2D = 11;
enum { DSX, DSY, DQT4, DX4, DY4, DQX4, DQY4, DCY, DCX, DXY, DCURV };
// 2-D fields staged once per tile with a two-cell halo: dt, dx, dy, and d
// in the McCalpin variant (MC)
constexpr int kWide = 3;
constexpr int kWideOpt = 1;
enum { WDT, WDX, WDY, WD };
// face pairs per level: xflux and yflux of advx, of advy
constexpr int kFaces = 2;
// ee/gg rows per level in device scratch, levels kept per column: none
constexpr int kScratch = 0;
constexpr int kKeep = 0;
// face pairs staged per level, and a ring that holds every level when
// the tile keeps them (phase_uvw.cu's layout): none
constexpr int kStageFaces = 0;
constexpr int kKeepRing = 0;

// Shared memory of a tile, in elements: kStages stages, the 2-D arrays,
// the wide window, the faces.  kernels/phases.py:column_tile counts the
// same from the constants above, which it reads from this file.
struct Layout {
  int HC, W2, TC, stage, total;
};

__host__ __device__ inline Layout layout(int TI, int TJ, bool mcc) {
  Layout L;
  L.HC = (TI + 2) * (TJ + 2);
  L.W2 = (TI + 4) * (TJ + 4);
  L.TC = TI * TJ;
  L.stage = kHalo * L.HC + kOwn * L.TC;
  L.total = kStages * L.stage + k2D * L.HC +
            (kWide + (mcc ? kWideOpt : 0)) * L.W2 +
            kFaces * ((TI + 1) * TJ + TI * (TJ + 1));
  return L;
}

template <typename T, bool O>
struct Lat {
  const T *u, *v, *ub, *vb, *aam0, *rho, *rmean;  // (kb, im, jm)
  const T *dt, *d, *ramp;                         // (im, jm), 0-d
  const T *dx, *dy, *aru, *arv, *dum, *dvm;       // (im, jm)
  const T *zz, *dzz;                              // (kb,)
  T *aam, *advx, *advy, *drhox, *drhoy;           // outputs
  GeomT<O> g;
  Tiles tl;
  int kbm1;
  T horcon, g025, g05;  // horcon, grav*0.25, 0.5*grav
  T grav, c24, c16;     // grav, 1/24, 1/16 (McCalpin)
};

// McCalpin's terms of one component at a column, k-independent: the mask
// and its neighbours downstream (mp) and upstream (mm), ddx and d4
template <typename T>
struct Mcc {
  T mp, mm, ddx, d4;
  T drho, rhou;  // drho and rhou of level k-1
};

// ddx and d4 of a component at a column from d at the column (d0), one
// and two cells upstream (d1, d2) and one downstream (dp); the corrections
// where corr (pressure.py:baropg_mcc)
template <typename T>
__device__ __forceinline__ void mcc_column(Mcc<T>& c, T mask, T d0, T d1,
                                           T d2, T dp, bool corr, T c24,
                                           T c16) {
  c.ddx = (d0 - d1) * mask;
  c.d4 = T(0.5) * (d0 + d1) * mask;
  if (corr) {
    c.ddx = c.ddx - c24 * (c.mp * (dp - d0) - T(2) * (d0 - d1) +
                           c.mm * (d1 - d2));
    c.d4 = c.d4 + c16 * (c.mp * (d0 - dp) + c.mm * (d1 - d2));
  }
}

// The McCalpin running sum of one component at level k from rr at the
// column (r0), one and two cells upstream (r1, r2) and one downstream
// (rp)
template <typename T>
__device__ __forceinline__ void mcc_level(Mcc<T>& c, T& dr, int k, T mask,
                                          T r0, T r1, T r2, T rp, bool corr,
                                          const T* zz, const T* dzz, T grav,
                                          T g05, T c24, T c16) {
  T drho = (r0 - r1) * mask;
  T rhou = T(0.5) * (r0 + r1) * mask;
  if (corr) {
    drho = drho - c24 * (c.mp * (rp - r0) - T(2) * (r0 - r1) +
                         c.mm * (r1 - r2));
    rhou = rhou + c16 * (c.mp * (r0 - rp) + c.mm * (r1 - r2));
  }
  if (k == 0)
    dr = grav * (-zz[0]) * c.d4 * drho;
  else
    dr = dr + (g05 * dzz[k - 1] * c.d4 * (c.drho + drho) +
               g05 * (zz[k - 1] + zz[k]) * c.ddx * (rhou - c.rhou));
  c.drho = drho;
  c.rhou = rhou;
}

template <typename T, bool O, bool MC>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 4 ? 4 : 2)
    k_lat_tile(Lat<T, O> s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const auto& g = s.g;
  const Tiles tl = s.tl;
  const int TI = tl.TI, TJ = tl.TJ, HJ = TJ + 2, WJ = TJ + 4, nt = TI * TJ;
  const int t = threadIdx.x, ti = t / TJ, tj = t % TJ;
  const int kbm1 = s.kbm1, jm = g.jm;
  const long n = g.n;
  const Layout L = layout(TI, TJ, MC);
  const int HC = L.HC;
  const int oc = (ti + 1) * HJ + tj + 1;  // own window cell
  // the window cells a thread computes, c = t + m nt at row a, column b:
  // the first one's (a0, b0), and the step from one to the next
  const int a0 = t / HJ, b0 = t % HJ, da = nt / HJ, db = nt % HJ;
  T* const d2 = sm + kStages * L.stage;
  T* const wd = d2 + k2D * HC;
  // faces: xflux of advx (TI+1) x TJ from row i0-1, yflux of advx
  // TI x (TJ+1) from column j0, xflux of advy (TI+1) x TJ from row i0,
  // yflux of advy TI x (TJ+1) from column j0-1
  T* const fxx = wd + kWide * L.W2;
  T* const fyx = fxx + (TI + 1) * TJ;
  T* const fxy = fyx + TI * (TJ + 1);
  T* const fyy = fxy + (TI + 1) * TJ;
  const T* const dtw = wd + WDT * L.W2;
  const T* const dxw = wd + WDX * L.W2;
  const T* const dyw = wd + WDY * L.W2;
  const T* const dw = wd + WD * L.W2;  // MC only
  T* const sx = d2 + DSX * HC;
  T* const sy = d2 + DSY * HC;
  T* const qdt4 = d2 + DQT4 * HC;
  T* const dx4 = d2 + DX4 * HC;
  T* const dy4 = d2 + DY4 * HC;
  T* const qdx4 = d2 + DQX4 * HC;
  T* const qdy4 = d2 + DQY4 * HC;
  T* const cdy = d2 + DCY * HC;
  T* const cdx = d2 + DCX * HC;
  T* const dxy = d2 + DXY * HC;
  T* const curv = d2 + DCURV * HC;
  auto win = [&](int k, int f) {
    return sm + (k % kStages) * L.stage + f * HC;
  };
  const T ramp = s.ramp[0];
  const T zz0 = s.zz[0];

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
      if (k < kbm1) {
        const long b = (long)k * n;
        extpom::stage_window(win(k, HU), s.u + b, off, t, nt);
        extpom::stage_window(win(k, HV), s.v + b, off, t, nt);
        extpom::stage_window(win(k, HUB), s.ub + b, off, t, nt);
        extpom::stage_window(win(k, HVB), s.vb + b, off, t, nt);
        extpom::stage_window(win(k, HAAM), s.aam0 + b, off, t, nt);
        extpom::stage_window(win(k, HRHO), s.rho + b, off, t, nt);
        extpom::stage_window(win(k, HRM), s.rmean + b, off, t, nt);
      }
      extpom::cp_async_commit();
    };
    __syncthreads();  // the previous tile is done with shared memory
    extpom::stage_halo(wd + WDT * L.W2, s.dt, t, nt, i0, j0, TI, TJ, 2,
                       g.im, jm);
    extpom::stage_halo(wd + WDX * L.W2, s.dx, t, nt, i0, j0, TI, TJ, 2,
                       g.im, jm);
    extpom::stage_halo(wd + WDY * L.W2, s.dy, t, nt, i0, j0, TI, TJ, 2,
                       g.im, jm);
    if constexpr (MC)
      extpom::stage_halo(wd + WD * L.W2, s.d, t, nt, i0, j0, TI, TJ, 2, g.im,
                         jm);
    stage(0);
    extpom::cp_async_wait_all();
    __syncthreads();
    // the k-independent terms on the one-cell window (cell c; w is the
    // same cell of the wide window)
    for (int c = t, a = a0, b = b0; c < HC; c += nt, a += da, b += db) {
      if (b >= HJ) {
        b -= HJ;
        ++a;
      }
      const int w = (a + 1) * WJ + b + 1;
      sx[c] = dtw[w] + dtw[w - WJ];
      sy[c] = dtw[w] + dtw[w - 1];
      qdt4[c] = T(0.25) *
                (dtw[w] + dtw[w - WJ] + dtw[w - 1] + dtw[w - WJ - 1]);
      const T ax = dxw[w] + dxw[w - WJ] + dxw[w - 1] + dxw[w - WJ - 1];
      const T ay = dyw[w] + dyw[w - WJ] + dyw[w - 1] + dyw[w - WJ - 1];
      dx4[c] = ax;
      dy4[c] = ay;
      qdx4[c] = T(0.25) * ax;
      qdy4[c] = T(0.25) * ay;
      cdy[c] = dyw[w + WJ] - dyw[w - WJ];
      cdx[c] = dxw[w + 1] - dxw[w - 1];
      dxy[c] = dxw[w] * dyw[w];
    }

    // the column's 2-D values
    const int ow = (ti + 2) * WJ + tj + 2;  // own cell of the wide window
    T dt = T(0), dx = T(0), dy = T(0), aru4 = T(0), arv4 = T(0);
    T dtsx = T(0), dtdx = T(0), dtsy = T(0), dtdy = T(0), dum = T(0),
      dvm = T(0), dyy = T(0), dxx = T(0), hdd = T(0);
    if (inner) {
      dt = dtw[ow];
      dx = dxw[ow];
      dy = dyw[ow];
      aru4 = s.aru[p] * T(0.25);
      arv4 = s.arv[p] * T(0.25);
      dtsx = dt + dtw[ow - WJ];
      dtdx = dt - dtw[ow - WJ];
      dtsy = dt + dtw[ow - 1];
      dtdy = dt - dtw[ow - 1];
      // baropg's mask and perpendicular metric of each component
      dum = s.dum[p];
      dvm = s.dvm[p];
      dyy = dy + dyw[ow - WJ];
      dxx = dx + dxw[ow - 1];
      hdd = s.horcon * dx * dy;
    }
    T drx = T(0), dry = T(0), rrm = T(0), rrwm = T(0), rrsm = T(0);
    // McCalpin's column terms of x and y
    Mcc<T> mx{}, my{};
    if (MC && inner) {
      mx.mp = extpom::ld2(s.dum, g, i + 1, j);
      mx.mm = extpom::ld2(s.dum, g, i - 1, j);
      my.mp = extpom::ld2(s.dvm, g, i, j + 1);
      my.mm = extpom::ld2(s.dvm, g, i, j - 1);
      mcc_column(mx, dum, dw[ow], dw[ow - WJ], dw[ow - 2 * WJ], dw[ow + WJ],
                 gi >= 2, s.c24, s.c16);
      mcc_column(my, dvm, dw[ow], dw[ow - 1], dw[ow - 2], dw[ow + 1],
                 gj >= 2, s.c24, s.c16);
    }

    // ---- the ascending sweep ----
    for (int k = 0; k < kbm1; ++k) {
      extpom::cp_async_wait_all();
      __syncthreads();
      stage(k + 1);
      const T* const U = win(k, HU);
      const T* const V = win(k, HV);
      const T* const UB = win(k, HUB);
      const T* const VB = win(k, HVB);
      const T* const A = win(k, HAAM);
      // the faces and curv of every window cell that needs them
      for (int c = t, a = a0, b = b0; c < HC;
           c += nt, a += da, b += db) {
        if (b >= HJ) {
          b -= HJ;
          ++a;
        }
        const int w = (a + 1) * WJ + b + 1;
        // xflux of advx on rows i0-1 .. i0+TI-1; 0 at i = 0 and im-1
        if (a <= TI && b >= 1 && b <= TJ) {
          const int gii = g.gi(i0 - 1 + a);
          T f = T(0);
          if (gii >= 1 && gii <= g.GI() - 2) {
            const T uu = U[c], ue = U[c + HJ];
            const T x = T(0.125) * (sx[c + HJ] * ue + sx[c] * uu) * (ue + uu);
            f = dyw[w] * (x - dtw[w] * A[c] * T(2) * (UB[c + HJ] - UB[c]) /
                                  dxw[w]);
          }
          fxx[a * TJ + b - 1] = f;
        }
        // yflux of advy on columns j0-1 .. j0+TJ-1; 0 at j = 0 and jm-1
        if (a >= 1 && a <= TI && b <= TJ) {
          const int gjj = g.gj(j0 - 1 + b);
          T f = T(0);
          if (gjj >= 1 && gjj <= g.GJ() - 2) {
            const T vv = V[c], vn = V[c + 1];
            const T y = T(0.125) * (sy[c + 1] * vn + sy[c] * vv) * (vn + vv);
            f = dxw[w] * (y - dtw[w] * A[c] * T(2) * (VB[c + 1] - VB[c]) /
                                  dyw[w]);
          }
          fyy[(a - 1) * (TJ + 1) + b] = f;
        }
        // yflux of advx (columns j0 .. j0+TJ) and xflux of advy (rows
        // i0 .. i0+TI) share the cell's viscous cross term, dtaam times
        // the same sum in both components of advct
        const bool yx = a >= 1 && a <= TI && b >= 1;
        const bool xy = a >= 1 && b >= 1 && b <= TJ;
        if (yx || xy) {
          const T dta =
              qdt4[c] * (A[c] + A[c - HJ] + A[c - 1] + A[c - HJ - 1]);
          const T visc = dta * ((UB[c] - UB[c - 1]) / dy4[c] +
                                (VB[c] - VB[c - HJ]) / dx4[c]);
          if (yx) {
            const T y = T(0.125) * (sy[c] * V[c] + sy[c - HJ] * V[c - HJ]) *
                        (U[c] + U[c - 1]);
            fyx[(a - 1) * (TJ + 1) + b - 1] = qdx4[c] * (y - visc);
          }
          if (xy) {
            const T x = T(0.125) * (sx[c] * U[c] + sx[c - 1] * U[c - 1]) *
                        (V[c] + V[c - HJ]);
            fxy[(a - 1) * TJ + b - 1] = qdy4[c] * (x - visc);
          }
        }
        // curv on the tile, row i0-1 and column j0-1
        if (a <= TI && b <= TJ)
          curv[c] = T(0.25) *
                    ((V[c + 1] + V[c]) * cdy[c] -
                     (U[c + HJ] + U[c]) * cdx[c]) /
                    dxy[c];
      }
      __syncthreads();
      if (!act) continue;
      const long q = k * n + p;
      if (!inner) {
        s.aam[q] = A[oc];
        s.advx[q] = T(0);
        s.advy[q] = T(0);
        s.drhox[q] = T(0);
        s.drhoy[q] = T(0);
        continue;
      }
      // ---- advct x-component ----
      const int xe = (ti + 1) * TJ + tj, yo = ti * (TJ + 1) + tj;
      T ax = fxx[xe] - fxx[xe - TJ] + fyx[yo + 1] - fyx[yo];
      if (gi >= 2)
        ax = ax - aru4 * (curv[oc] * dt * (V[oc + 1] + V[oc]) +
                          curv[oc - HJ] * dtw[ow - WJ] *
                              (V[oc - HJ + 1] + V[oc - HJ]));
      s.advx[q] = ax;
      // ---- advct y-component ----
      T ay = fxy[xe] - fxy[xe - TJ] + fyy[yo + 1] - fyy[yo];
      if (gj >= 2)
        ay = ay + arv4 * (curv[oc] * dt * (U[oc + HJ] + U[oc]) +
                          curv[oc - 1] * dtw[ow - 1] *
                              (U[oc + HJ - 1] + U[oc - 1]));
      s.advy[q] = ay;
      // ---- baropg, the running sum in ascending k ----
      const T* const R = win(k, HRHO);
      const T* const M = win(k, HRM);
      const T rr = R[oc] - M[oc];
      const T rrw = R[oc - HJ] - M[oc - HJ];
      const T rrs = R[oc - 1] - M[oc - 1];
      if constexpr (MC) {
        // rr two cells upstream: the window's, or device memory's for the
        // tile's first row (column)
        auto far = [&](long o, bool ok) {
          return ok ? s.rho[q - o] - s.rmean[q - o] : T(0);
        };
        const T rrww = ti >= 1 ? R[oc - 2 * HJ] - M[oc - 2 * HJ]
                               : far(2L * jm, i >= 2);
        const T rrss = tj >= 1 ? R[oc - 2] - M[oc - 2] : far(2, j >= 2);
        mcc_level(mx, drx, k, dum, rr, rrw, rrww,
                  R[oc + HJ] - M[oc + HJ], gi >= 2, s.zz, s.dzz, s.grav,
                  s.g05, s.c24, s.c16);
        mcc_level(my, dry, k, dvm, rr, rrs, rrss, R[oc + 1] - M[oc + 1],
                  gj >= 2, s.zz, s.dzz, s.grav, s.g05, s.c24, s.c16);
      } else if (k == 0) {
        drx = s.g05 * (-zz0) * dtsx * (rr - rrw);
        dry = s.g05 * (-zz0) * dtsy * (rr - rrs);
      } else {
        const T zdif = s.g025 * (s.zz[k - 1] - s.zz[k]);
        const T zsum = s.g025 * (s.zz[k - 1] + s.zz[k]);
        drx = drx + (zdif * dtsx * ((rr - rrw) + (rrm - rrwm)) +
                     zsum * dtdx * ((rr + rrw) - (rrm + rrwm)));
        dry = dry + (zdif * dtsy * ((rr - rrs) + (rrm - rrsm)) +
                     zsum * dtdy * ((rr + rrs) - (rrm + rrsm)));
      }
      rrm = rr;
      rrwm = rrw;
      rrsm = rrs;
      s.drhox[q] = T(0.25) * dtsx * drx * dum * dyy * ramp;
      s.drhoy[q] = T(0.25) * dtsy * dry * dvm * dxx * ramp;
      // ---- lateral viscosity ----
      const T va = (U[oc + HJ] - U[oc]) / dx;
      const T vb = (V[oc + 1] - V[oc]) / dy;
      const T vc = T(0.25) *
                       (U[oc + 1] + U[oc + HJ + 1] - U[oc - 1] -
                        U[oc + HJ - 1]) /
                       dy +
                   T(0.25) *
                       (V[oc + HJ] + V[oc + HJ + 1] - V[oc - HJ] -
                        V[oc - HJ + 1]) /
                       dx;
      s.aam[q] = hdd * sqrt(va * va + vb * vb + T(0.5) * (vc * vc));
    }
    if (!act) continue;
    // level kbm1: aam0, no advection, the ramp on the interior
    const long q = (long)kbm1 * n + p;
    s.aam[q] = s.aam0[q];
    s.advx[q] = T(0);
    s.advy[q] = T(0);
    s.drhox[q] = inner ? T(0) * ramp : T(0);
    s.drhoy[q] = inner ? T(0) * ramp : T(0);
  }
}

constexpr int kPointers = 23;

// ptr: the operands and outputs; the domain is (im, jm), the arrays the
// domain or (O) the (R, L) block at global (oi, oj); the tiles TI x TJ,
// walked by `grid` blocks; mcc the McCalpin variant
template <typename T, bool O>
int run(void* const* ptr, const double* prm, int kb, int im, int jm, int R,
        int L, int oi, int oj, int mcc, int TI, int TJ, int grid,
        void* stream) {
  Lat<T, O> s;
  int k = 0;
#define NEXT(f) s.f = (decltype(s.f))ptr[k++]
  NEXT(u); NEXT(v); NEXT(ub); NEXT(vb); NEXT(aam0); NEXT(rho); NEXT(rmean);
  NEXT(dt); NEXT(d); NEXT(ramp);
  NEXT(dx); NEXT(dy); NEXT(aru); NEXT(arv); NEXT(dum); NEXT(dvm); NEXT(zz);
  NEXT(dzz);
  NEXT(aam); NEXT(advx); NEXT(advy); NEXT(drhox); NEXT(drhoy);
#undef NEXT
  if (k != kPointers) return (int)cudaErrorInvalidValue;
  const int threads = TI * TJ;
  if (TI < 1 || TJ < 32 || TJ % 32 || threads > kMaxThreads || grid < 1 ||
      kb < 2 || (mcc && (s.d == nullptr || s.dzz == nullptr)))
    return (int)cudaErrorInvalidValue;
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 2);
  s.tl.TI = TI;
  s.tl.TJ = TJ;
  s.tl.nj = (s.g.jm + TJ - 1) / TJ;
  s.tl.count = ((s.g.im + TI - 1) / TI) * s.tl.nj;
  s.kbm1 = kb - 1;
  // prm: horcon, grav; each constant formed in double as the Python
  // expression forms it, then rounded to T
  s.horcon = T(prm[0]);
  s.g025 = T(prm[1] * 0.25);
  s.g05 = T(0.5 * prm[1]);
  s.grav = T(prm[1]);
  s.c24 = T(1.0 / 24.0);
  s.c16 = T(1.0 / 16.0);
  const int smem = layout(TI, TJ, mcc != 0).total * (int)sizeof(T);
  auto go = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(s);
    return (int)cudaGetLastError();
  };
  return mcc ? go(k_lat_tile<T, O, true>) : go(k_lat_tile<T, O, false>);
}

template <typename T, bool O>
int info(int TI, int TJ, bool mcc, int* out) {
  const int smem = layout(TI, TJ, mcc).total * (int)sizeof(T);
  return mcc ? extpom::tile_info(k_lat_tile<T, O, true>, TI * TJ, smem, out)
             : extpom::tile_info(k_lat_tile<T, O, false>, TI * TJ, smem,
                                 out);
}

}  // namespace

extern "C" int extpom_phase_lat_f32(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int mcc, int,
                                    int TI, int TJ, int grid, void* stream) {
  return run<float, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, mcc, TI, TJ,
                           grid, stream);
}

extern "C" int extpom_phase_lat_f64(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int mcc, int,
                                    int TI, int TJ, int grid, void* stream) {
  return run<double, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, mcc, TI, TJ,
                            grid, stream);
}

extern "C" int extpom_phase_lat_mesh_f32(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int mcc, int,
                                         int TI, int TJ, int grid,
                                         void* stream) {
  return run<float, true>(ptr, prm, kb, im, jm, R, L, oi, oj, mcc, TI, TJ,
                          grid, stream);
}

extern "C" int extpom_phase_lat_mesh_f64(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int mcc, int,
                                         int TI, int TJ, int grid,
                                         void* stream) {
  return run<double, true>(ptr, prm, kb, im, jm, R, L, oi, oj, mcc, TI, TJ,
                           grid, stream);
}

// registers, static and dynamic shared bytes, resident blocks per SM,
// spill bytes and SMs of the tile kernel (column.cuh tile_info); f64, mesh
// and bit 1 of opt (the McCalpin variant; bit 0 is phase_mom.cu's keep)
// pick the instantiation, whose shared memory does not depend on the depth
extern "C" int extpom_phase_lat_info(int f64, int mesh, int TI, int TJ, int,
                                     int opt, int* out) {
  const bool mcc = (opt & 2) != 0;
  if (f64)
    return mesh ? info<double, true>(TI, TJ, mcc, out)
                : info<double, false>(TI, TJ, mcc, out);
  return mesh ? info<float, true>(TI, TJ, mcc, out)
              : info<float, false>(TI, TJ, mcc, out);
}
