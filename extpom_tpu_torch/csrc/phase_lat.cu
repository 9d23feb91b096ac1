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
// Design: one thread per (i, j) column and one launch; the loop over k is
// coalesced in the (kb, im, jm) layout.  Every flux a column needs at a
// neighbour (xflux at i-1, yflux at j+1, curv at i-1/j-1, ...) is
// recomputed there instead of being stored, as csrc/extloop.cu does.  The
// baropg integral runs down the column in ascending k, the order of
// pressure.py:_cumk.  Built with -fmad=false so each operation rounds as
// the plain PyTorch version's does.
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
// kernel with has_off (via mesh_runner): regions at global (i, j), the
// launch skipping 2 cells next to the block's split edges (its unguarded
// reads reach 1 cell).

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

using extpom::GeomT;
using extpom::ld2;
using extpom::ld3;

template <typename T, bool O>
struct Lat {
  const T *u, *v, *ub, *vb, *aam0, *rho, *rmean;  // (kb, im, jm)
  const T *dt, *ramp;                             // (im, jm), 0-d
  const T *dx, *dy, *aru, *arv, *dum, *dvm;       // (im, jm)
  const T* zz;                                    // (kb,)
  T *aam, *advx, *advy, *drhox, *drhoy;           // outputs
  GeomT<O> g;
  int kbm1;
  T horcon, g025, g05;  // horcon, grav*0.25, 0.5*grav
};

// dx4-style 4-point sum a + a_w + a_s + a_ws (zero-filled)
template <typename T, bool O>
__device__ __forceinline__ T sum4(const T* a, const GeomT<O>& g, int i,
                                  int j) {
  return a[(long)i * g.jm + j] + ld2(a, g, i - 1, j) + ld2(a, g, i, j - 1) +
         ld2(a, g, i - 1, j - 1);
}

// curv on [KM1, 1:-1, 1:-1]; the callers read it on the interior only
template <typename T, bool O>
__device__ T curv(const Lat<T, O>& s, int k, int i, int j) {
  const auto& g = s.g;
  const long p = (long)i * g.jm + j;
  return T(0.25) *
         ((ld3(s.v, g, k, i, j + 1) + ld3(s.v, g, k, i, j)) *
              (ld2(s.dy, g, i + 1, j) - ld2(s.dy, g, i - 1, j)) -
          (ld3(s.u, g, k, i + 1, j) + ld3(s.u, g, k, i, j)) *
              (ld2(s.dx, g, i, j + 1) - ld2(s.dx, g, i, j - 1))) /
         (s.dx[p] * s.dy[p]);
}

// dtaam = .25 dt4 aam4 at (k, i, j)
template <typename T, bool O>
__device__ __forceinline__ T dtaam(const Lat<T, O>& s, int k, int i, int j) {
  const auto& g = s.g;
  return T(0.25) * sum4(s.dt, g, i, j) * sum4(s.aam0 + k * g.n, g, i, j);
}

// advx's xflux after the viscous term, on [KM1, 1:-1, 1:] (j >= 1 here);
// 0 at i = 0 and i = im-1
template <typename T, bool O>
__device__ T xflux_x(const Lat<T, O>& s, int k, int i, int j) {
  const auto& g = s.g;
  if (g.gi(i) < 1 || g.gi(i) > g.GI() - 2) return T(0);
  const long p = (long)i * g.jm + j;
  const T u = ld3(s.u, g, k, i, j), ue = ld3(s.u, g, k, i + 1, j);
  const T dt = s.dt[p], dte = ld2(s.dt, g, i + 1, j);
  const T f = T(0.125) * ((dte + dt) * ue + (dt + ld2(s.dt, g, i - 1, j)) * u) *
              (ue + u);
  return s.dy[p] * (f - dt * ld3(s.aam0, g, k, i, j) * T(2) *
                            (ld3(s.ub, g, k, i + 1, j) - ld3(s.ub, g, k, i, j)) /
                            s.dx[p]);
}

// advx's yflux after the cross term, on [KM1, 1:-1, 1:] (i interior here)
template <typename T, bool O>
__device__ T yflux_x(const Lat<T, O>& s, int k, int i, int j) {
  const auto& g = s.g;
  const long p = (long)i * g.jm + j;
  const T f = T(0.125) *
              ((s.dt[p] + ld2(s.dt, g, i, j - 1)) * ld3(s.v, g, k, i, j) +
               (ld2(s.dt, g, i - 1, j) + ld2(s.dt, g, i - 1, j - 1)) *
                   ld3(s.v, g, k, i - 1, j)) *
              (ld3(s.u, g, k, i, j) + ld3(s.u, g, k, i, j - 1));
  const T dx4 = sum4(s.dx, g, i, j), dy4 = sum4(s.dy, g, i, j);
  return T(0.25) * dx4 *
         (f - dtaam(s, k, i, j) *
                  ((ld3(s.ub, g, k, i, j) - ld3(s.ub, g, k, i, j - 1)) / dy4 +
                   (ld3(s.vb, g, k, i, j) - ld3(s.vb, g, k, i - 1, j)) / dx4));
}

// advy's xflux after the cross term, on [KM1, 1:, 1:-1] (i >= 1 here)
template <typename T, bool O>
__device__ T xflux_y(const Lat<T, O>& s, int k, int i, int j) {
  const auto& g = s.g;
  const long p = (long)i * g.jm + j;
  const T f = T(0.125) *
              ((s.dt[p] + ld2(s.dt, g, i - 1, j)) * ld3(s.u, g, k, i, j) +
               (ld2(s.dt, g, i, j - 1) + ld2(s.dt, g, i - 1, j - 1)) *
                   ld3(s.u, g, k, i, j - 1)) *
              (ld3(s.v, g, k, i, j) + ld3(s.v, g, k, i - 1, j));
  const T dx4 = sum4(s.dx, g, i, j), dy4 = sum4(s.dy, g, i, j);
  return T(0.25) * dy4 *
         (f - dtaam(s, k, i, j) *
                  ((ld3(s.ub, g, k, i, j) - ld3(s.ub, g, k, i, j - 1)) / dy4 +
                   (ld3(s.vb, g, k, i, j) - ld3(s.vb, g, k, i - 1, j)) / dx4));
}

// advy's yflux after the viscous term, on [KM1, 1:, 1:-1] (i interior
// here); 0 at j = 0 and j = jm-1
template <typename T, bool O>
__device__ T yflux_y(const Lat<T, O>& s, int k, int i, int j) {
  const auto& g = s.g;
  if (g.gj(j) < 1 || g.gj(j) > g.GJ() - 2) return T(0);
  const long p = (long)i * g.jm + j;
  const T v = ld3(s.v, g, k, i, j), vn = ld3(s.v, g, k, i, j + 1);
  const T dt = s.dt[p], dtn = ld2(s.dt, g, i, j + 1);
  const T f = T(0.125) * ((dtn + dt) * vn + (dt + ld2(s.dt, g, i, j - 1)) * v) *
              (vn + v);
  return s.dx[p] * (f - dt * ld3(s.aam0, g, k, i, j) * T(2) *
                            (ld3(s.vb, g, k, i, j + 1) - ld3(s.vb, g, k, i, j)) /
                            s.dy[p]);
}

template <typename T, bool O>
__global__ void k_lat(Lat<T, O> s) {
  const auto& g = s.g;
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.n) return;
  const int i = p / g.jm, j = p % g.jm;
  if (g.skip(i, j)) return;
  const int gi = g.gi(i), gj = g.gj(j);
  const long n = g.n;
  if (gi < 1 || gi > g.GI() - 2 || gj < 1 || gj > g.GJ() - 2) {
    for (int k = 0; k < g.kb; ++k) {
      const long q = k * n + p;
      s.aam[q] = s.aam0[q];
      s.advx[q] = T(0);
      s.advy[q] = T(0);
      s.drhox[q] = T(0);
      s.drhoy[q] = T(0);
    }
    return;
  }
  const long pw = p - g.jm, ps = p - 1;
  const T ramp = s.ramp[0];
  const T dt = s.dt[p], dtw = s.dt[pw], dts = s.dt[ps];
  const T dx = s.dx[p], dy = s.dy[p];
  // baropg: dts/dtd and the perpendicular metric of each component
  const T dtsx = dt + dtw, dtdx = dt - dtw, dtsy = dt + dts, dtdy = dt - dts;
  const T zz0 = s.zz[0];
  T drx = T(0), dry = T(0);
  for (int k = 0; k < s.kbm1; ++k) {
    const long q = k * n + p;
    // ---- advct x-component ----
    T ax = xflux_x(s, k, i, j) - xflux_x(s, k, i - 1, j) +
           yflux_x(s, k, i, j + 1) - yflux_x(s, k, i, j);
    if (gi >= 2)
      ax = ax - s.aru[p] * T(0.25) *
                    (curv(s, k, i, j) * dt * (s.v[q + 1] + s.v[q]) +
                     curv(s, k, i - 1, j) * dtw * (s.v[q - g.jm + 1] + s.v[q - g.jm]));
    s.advx[q] = ax;
    // ---- advct y-component ----
    T ay = xflux_y(s, k, i + 1, j) - xflux_y(s, k, i, j) +
           yflux_y(s, k, i, j) - yflux_y(s, k, i, j - 1);
    if (gj >= 2)
      ay = ay + s.arv[p] * T(0.25) *
                    (curv(s, k, i, j) * dt * (s.u[q + g.jm] + s.u[q]) +
                     curv(s, k, i, j - 1) * dts * (s.u[q + g.jm - 1] + s.u[q - 1]));
    s.advy[q] = ay;
    // ---- baropg, the running sum in ascending k ----
    const T rr = s.rho[q] - s.rmean[q];
    const T rrw = s.rho[q - g.jm] - s.rmean[q - g.jm];
    const T rrs = s.rho[q - 1] - s.rmean[q - 1];
    if (k == 0) {
      drx = s.g05 * (-zz0) * dtsx * (rr - rrw);
      dry = s.g05 * (-zz0) * dtsy * (rr - rrs);
    } else {
      const long m = q - n;
      const T rrm = s.rho[m] - s.rmean[m];
      const T rrwm = s.rho[m - g.jm] - s.rmean[m - g.jm];
      const T rrsm = s.rho[m - 1] - s.rmean[m - 1];
      const T zdif = s.g025 * (s.zz[k - 1] - s.zz[k]);
      const T zsum = s.g025 * (s.zz[k - 1] + s.zz[k]);
      drx = drx + (zdif * dtsx * ((rr - rrw) + (rrm - rrwm)) +
                   zsum * dtdx * ((rr + rrw) - (rrm + rrwm)));
      dry = dry + (zdif * dtsy * ((rr - rrs) + (rrm - rrsm)) +
                   zsum * dtdy * ((rr + rrs) - (rrm + rrsm)));
    }
    s.drhox[q] = T(0.25) * dtsx * drx * s.dum[p] * (dy + s.dy[pw]) * ramp;
    s.drhoy[q] = T(0.25) * dtsy * dry * s.dvm[p] * (dx + s.dx[ps]) * ramp;
    // ---- lateral viscosity ----
    const T a = (s.u[q + g.jm] - s.u[q]) / dx;
    const T b = (s.v[q + 1] - s.v[q]) / dy;
    const T c = T(0.25) *
                    (s.u[q + 1] + s.u[q + g.jm + 1] - s.u[q - 1] -
                     s.u[q + g.jm - 1]) /
                    dy +
                T(0.25) *
                    (s.v[q + g.jm] + s.v[q + g.jm + 1] - s.v[q - g.jm] -
                     s.v[q - g.jm + 1]) /
                    dx;
    s.aam[q] = s.horcon * dx * dy * sqrt(a * a + b * b + T(0.5) * (c * c));
  }
  for (int k = s.kbm1; k < g.kb; ++k) {
    const long q = k * n + p;
    s.aam[q] = s.aam0[q];
    s.advx[q] = T(0);
    s.advy[q] = T(0);
    s.drhox[q] = T(0) * ramp;
    s.drhoy[q] = T(0) * ramp;
  }
}

constexpr int kThreads = 256;
constexpr int kPointers = 21;

// ptr: the operands and outputs; the domain is (im, jm), the arrays the
// domain or (O) the (R, L) block at global (oi, oj)
template <typename T, bool O>
int run(void* const* ptr, const double* prm, int kb, int im, int jm, int R,
        int L, int oi, int oj, void* stream) {
  Lat<T, O> s;
  int k = 0;
#define NEXT(f) s.f = (decltype(s.f))ptr[k++]
  NEXT(u); NEXT(v); NEXT(ub); NEXT(vb); NEXT(aam0); NEXT(rho); NEXT(rmean);
  NEXT(dt); NEXT(ramp);
  NEXT(dx); NEXT(dy); NEXT(aru); NEXT(arv); NEXT(dum); NEXT(dvm); NEXT(zz);
  NEXT(aam); NEXT(advx); NEXT(advy); NEXT(drhox); NEXT(drhoy);
#undef NEXT
  if (k != kPointers) return (int)cudaErrorInvalidValue;
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 2);
  s.kbm1 = kb - 1;
  // prm: horcon, grav; each constant formed in double as the Python
  // expression forms it, then rounded to T
  s.horcon = T(prm[0]);
  s.g025 = T(prm[1] * 0.25);
  s.g05 = T(0.5 * prm[1]);
  const int blocks = (int)((s.g.n + kThreads - 1) / kThreads);
  k_lat<T, O><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int extpom_phase_lat_f32(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int, int,
                                    void* stream) {
  return run<float, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, stream);
}

extern "C" int extpom_phase_lat_f64(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int, int,
                                    void* stream) {
  return run<double, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, stream);
}

extern "C" int extpom_phase_lat_mesh_f32(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int, int,
                                         void* stream) {
  return run<float, true>(ptr, prm, kb, im, jm, R, L, oi, oj, stream);
}

extern "C" int extpom_phase_lat_mesh_f64(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int, int,
                                         void* stream) {
  return run<double, true>(ptr, prm, kb, im, jm, R, L, oi, oj, stream);
}
