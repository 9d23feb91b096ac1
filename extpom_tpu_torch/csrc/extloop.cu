// External-mode (2-D barotropic) loop: all isplit substeps of one internal
// step.
//
// Replaces extpom_tpu/pallas/extloop.py:_kernel (via run_external_loop),
// which holds the whole 2-D working set in TPU VMEM and runs the isplit
// substeps of stepper.mode_external_substep there.  Counterpart here of
// extpom_tpu_torch/core/stepper.py:mode_external_substep.
//
// Bound on the H100: per substep a point does ~200 flops over ~40 words of
// 2-D fields.  At 256x256 f32 the whole working set (~48 fields, ~12.6 MB)
// is far beyond a block's 227 KB of shared memory but fits the 50 MB L2, so
// after the first substep the stencil reads are L2 hits; the least HBM
// traffic is one read of the inputs and one write of the carry.  What bounds
// this design in practice is the grid-wide dependence between the stages
// of a substep (elf feeds uaf at i-1/j-1; uaf/vaf feed the carry update).
//
// Design (the simplest correct one): extpom_extloop_run loops over
// iext = 1..isplit on the host side of the library and launches a chain of
// three pointwise kernels per substep; the kernel boundaries are the
// grid-wide sync points:
//   k_surface  flux divergence -> elf (+ bc_el, fused) and advave
//              (advua/advva, only when iext % ispadv == 0);
//   k_velocity uaf/vaf interior + bc_vel2d (fused), times dum/dvm;
//   k_update   etf tail average, Asselin filter, time-level rotation and
//              the egf/utf/vtf accumulators, in place on the carry.
// The loop-invariant metrics of ext_precompute are computed once per call
// by k_metrics.  Every flux that a stage needs at a neighbour is recomputed
// there instead of being stored.  Built with -fmad=false so each operation
// rounds as the plain PyTorch version's does.
//
// Where an off-by-one would hide:
//   * sft reads 0 outside the array: ld() returns 0 there, it never clamps.
//   * put regions: every flux/face value is defined only on the region of
//     its Fortran loop (put(z2, expr, 1:, 1:-1) etc.) and is 0 elsewhere.
//   * bc_el writes west, east, south, north, so a corner takes the value of
//     the side written last; with zero-gradient copies that makes
//     elf(i, j) = elf_interior(clamp(i), clamp(j)) * fsm(i, j).
//   * bc_vel2d writes row 1 (column 1) before row 0 (column 0) copies it;
//     corners keep 0.
//   * the etf tail uses iext == isplit-2 / isplit-1 / isplit and the
//     accumulators skip the last substep.
//   * the carry order is CARRY_FIELDS of the TPU kernel (extloop.py:48).

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

template <typename T>
struct Ext {
  // carry, updated in place (CARRY_FIELDS order)
  T *el, *elb, *ua, *uab, *va, *vab, *etf, *egf, *utf, *vtf, *advua, *advva,
      *wubot, *wvbot;
  // grid
  const T *h, *dx, *dy, *art, *aru, *arv, *cor, *fsm, *dum, *dvm, *cbc;
  // step-constant 2-D terms
  const T *adx2d, *ady2d, *drx2d, *dry2d, *aam2d;
  // 2-D forcing
  const T *wusurf, *wvsurf, *vflux, *e_atmos;
  // 1-D boundary series, j-sides (jm) then i-sides (im)
  const T *elw, *ele, *uabw, *uabe, *vabw, *vabe;
  const T *els, *eln, *vabs, *vabn, *uabs, *uabn;
  const T* ramp;  // 0-d
  // scratch: loop-invariant metrics, then elf/uaf/vaf of the substep
  T *dyu, *dxv, *hu, *hv, *corw, *cors, *rart, *rdx, *rdy, *dx4, *dy4, *rdx4,
      *rdy4;
  T *elf, *uaf, *vaf;
  int im, jm;
  // constants, rounded to T as PyTorch rounds a Python float operand
  T dte2, c4dte, c025g, grav, ralpha, alpha, ispi, isp2i, hsmoth, qsmoth,
      tsmoth, rfe, rfw, rfn, rfs;
};

// zero-filled read: sft semantics, 0 outside the array (column.cuh)
template <typename T>
__device__ __forceinline__ T ld(const T* a, const Ext<T>& s, int i, int j) {
  return extpom::ld2(a, s.im, s.jm, i, j);
}

// d = h + el (zero outside the array, as sft(d, ...) reads)
template <typename T>
__device__ __forceinline__ T dd(const Ext<T>& s, int i, int j) {
  return (i >= 0 && i < s.im && j >= 0 && j < s.jm)
             ? s.h[i * s.jm + j] + s.el[i * s.jm + j]
             : T(0);
}

template <typename T>
__global__ void k_metrics(Ext<T> s) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= s.im * s.jm) return;
  const int i = p / s.jm, j = p % s.jm;
  const T one = T(1);
  const T dx4 = s.dx[p] + ld(s.dx, s, i - 1, j) + ld(s.dx, s, i, j - 1) +
                ld(s.dx, s, i - 1, j - 1);
  const T dy4 = s.dy[p] + ld(s.dy, s, i - 1, j) + ld(s.dy, s, i, j - 1) +
                ld(s.dy, s, i - 1, j - 1);
  s.dyu[p] = s.dy[p] + ld(s.dy, s, i - 1, j);
  s.dxv[p] = s.dx[p] + ld(s.dx, s, i, j - 1);
  s.hu[p] = s.h[p] + ld(s.h, s, i - 1, j);
  s.hv[p] = s.h[p] + ld(s.h, s, i, j - 1);
  s.corw[p] = ld(s.cor, s, i - 1, j);
  s.cors[p] = ld(s.cor, s, i, j - 1);
  s.rart[p] = one / s.art[p];
  s.rdx[p] = one / s.dx[p];
  s.rdy[p] = one / s.dy[p];
  s.dx4[p] = dx4;
  s.dy4[p] = dy4;
  s.rdx4[p] = one / (dx4 == T(0) ? one : dx4);
  s.rdy4[p] = one / (dy4 == T(0) ? one : dy4);
}

// ---- free surface (advance.f:211-229) ----

// fluxua = put(z2, .25 (d + d_w) dyu ua, 1:, 1:)
template <typename T>
__device__ T flux_u(const Ext<T>& s, int i, int j) {
  if (i < 1 || i >= s.im || j < 1 || j >= s.jm) return T(0);
  const int p = i * s.jm + j;
  return T(0.25) * (dd(s, i, j) + dd(s, i - 1, j)) * s.dyu[p] * s.ua[p];
}

// fluxva = put(z2, .25 (d + d_s) dxv va, 1:, 1:)
template <typename T>
__device__ T flux_v(const Ext<T>& s, int i, int j) {
  if (i < 1 || i >= s.im || j < 1 || j >= s.jm) return T(0);
  const int p = i * s.jm + j;
  return T(0.25) * (dd(s, i, j) + dd(s, i, j - 1)) * s.dxv[p] * s.va[p];
}

// elf before bc_el, on its put region 1:-1, 1:-1
template <typename T>
__device__ T elf_interior(const Ext<T>& s, int i, int j) {
  const int p = i * s.jm + j;
  const T div = flux_u(s, i + 1, j) - flux_u(s, i, j) + flux_v(s, i, j + 1) -
                flux_v(s, i, j);
  return s.elb[p] + s.dte2 * (-div * s.rart[p] - s.vflux[p]);
}

// ---- advave, mode != 2 (solver.f:16-121) ----

template <typename T>
__device__ T adv_tps(const Ext<T>& s, int i, int j) {  // put(z, ..., 1:, 1:)
  if (i < 1 || i >= s.im || j < 1 || j >= s.jm) return T(0);
  const int p = i * s.jm + j;
  const T dsum = dd(s, i, j) + dd(s, i - 1, j) + dd(s, i, j - 1) +
                 dd(s, i - 1, j - 1);
  const T asum = s.aam2d[p] + ld(s.aam2d, s, i, j - 1) +
                 ld(s.aam2d, s, i - 1, j) + ld(s.aam2d, s, i - 1, j - 1);
  return T(0.25) * dsum * asum *
         ((s.uab[p] - ld(s.uab, s, i, j - 1)) * s.rdy4[p] +
          (s.vab[p] - ld(s.vab, s, i - 1, j)) * s.rdx4[p]);
}

// u-part fluxua after viscous term and * dy; region 1:-1, 1:
template <typename T>
__device__ T adv_fua3(const Ext<T>& s, int i, int j) {
  if (i < 1 || i > s.im - 2 || j < 1 || j >= s.jm) return T(0);
  const int p = i * s.jm + j;
  const T d = dd(s, i, j);
  const T ue = ld(s.ua, s, i + 1, j);
  T f = T(0.125) * ((dd(s, i + 1, j) + d) * ue + (d + dd(s, i - 1, j)) * s.ua[p]) *
        (ue + s.ua[p]);
  f = f - d * T(2) * s.aam2d[p] * (ld(s.uab, s, i + 1, j) - s.uab[p]) * s.rdx[p];
  return f * s.dy[p];
}

// u-part fluxva after the cross term and * dx4/4; region 1:, 1:
template <typename T>
__device__ T adv_fva3(const Ext<T>& s, int i, int j) {
  if (i < 1 || i >= s.im || j < 1 || j >= s.jm) return T(0);
  const int p = i * s.jm + j;
  const T f = T(0.125) *
              ((dd(s, i, j) + dd(s, i, j - 1)) * s.va[p] +
               (dd(s, i - 1, j) + dd(s, i - 1, j - 1)) * ld(s.va, s, i - 1, j)) *
              (s.ua[p] + ld(s.ua, s, i, j - 1));
  return (f - adv_tps(s, i, j)) * T(0.25) * s.dx4[p];
}

// v-part fluxua after the cross term and * dy4/4; region 1:, 1:
template <typename T>
__device__ T adv_fua6(const Ext<T>& s, int i, int j) {
  if (i < 1 || i >= s.im || j < 1 || j >= s.jm) return T(0);
  const int p = i * s.jm + j;
  const T f = T(0.125) *
              ((dd(s, i, j) + dd(s, i - 1, j)) * s.ua[p] +
               (dd(s, i, j - 1) + dd(s, i - 1, j - 1)) * ld(s.ua, s, i, j - 1)) *
              (ld(s.va, s, i - 1, j) + s.va[p]);
  return (f - adv_tps(s, i, j)) * T(0.25) * s.dy4[p];
}

// v-part fluxva after viscous term and * dx; region 1:, 1:-1
template <typename T>
__device__ T adv_fva6(const Ext<T>& s, int i, int j) {
  if (i < 1 || i >= s.im || j < 1 || j > s.jm - 2) return T(0);
  const int p = i * s.jm + j;
  const T d = dd(s, i, j);
  const T vn = ld(s.va, s, i, j + 1);
  T f = T(0.125) * ((dd(s, i, j + 1) + d) * vn + (d + dd(s, i, j - 1)) * s.va[p]) *
        (vn + s.va[p]);
  f = f - d * T(2) * s.aam2d[p] * (ld(s.vab, s, i, j + 1) - s.vab[p]) * s.rdy[p];
  return f * s.dx[p];
}

template <typename T>
__global__ void k_surface(Ext<T> s, int do_adv) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= s.im * s.jm) return;
  const int i = p / s.jm, j = p % s.jm;
  // elf + bc_el: edges copy the clamped interior value (see header)
  const int ci = min(max(i, 1), s.im - 2), cj = min(max(j, 1), s.jm - 2);
  s.elf[p] = elf_interior(s, ci, cj) * s.fsm[p];
  if (!do_adv) return;
  const bool in = i >= 1 && i <= s.im - 2 && j >= 1 && j <= s.jm - 2;
  // reads d/ua/va/uab/vab only; advua/advva are read by nobody else here
  s.advua[p] = in ? adv_fua3(s, i, j) - adv_fua3(s, i - 1, j) +
                        adv_fva3(s, i, j + 1) - adv_fva3(s, i, j)
                  : T(0);
  s.advva[p] = in ? adv_fua6(s, i + 1, j) - adv_fua6(s, i, j) +
                        adv_fva6(s, i, j) - adv_fva6(s, i, j - 1)
                  : T(0);
}

// ---- depth-mean momentum (advance.f:237-288) ----

// uaf on its put region 1:, 1:-1
template <typename T>
__device__ T uaf_interior(const Ext<T>& s, int i, int j) {
  const int p = i * s.jm + j, w = p - s.jm;
  const T d = dd(s, i, j), dw = dd(s, i - 1, j);
  const T cori = s.aru[p] * T(0.25) *
                 (s.cor[p] * d * (s.va[p + 1] + s.va[p]) +
                  s.corw[p] * dw * (s.va[w + 1] + s.va[w]));
  const T slope = s.ralpha * (s.el[p] - s.el[w]) +
                  s.alpha * (s.elb[p] - s.elb[w] + s.elf[p] - s.elf[w]) +
                  s.e_atmos[p] - s.e_atmos[w];
  const T u1 = s.adx2d[p] + s.advua[p] - cori +
               s.c025g * s.dyu[p] * (d + dw) * slope + s.drx2d[p] +
               s.aru[p] * (s.wusurf[p] - s.wubot[p]);
  return ((s.hu[p] + s.elb[p] + s.elb[w]) * s.aru[p] * s.uab[p] -
          s.c4dte * u1) /
         ((s.hu[p] + s.elf[p] + s.elf[w]) * s.aru[p]);
}

// vaf on its put region 1:-1, 1:
template <typename T>
__device__ T vaf_interior(const Ext<T>& s, int i, int j) {
  const int p = i * s.jm + j, q = p - 1, e = p + s.jm;
  const T d = dd(s, i, j), ds = dd(s, i, j - 1);
  const T cori = s.arv[p] * T(0.25) *
                 (s.cor[p] * d * (s.ua[e] + s.ua[p]) +
                  s.cors[p] * ds * (s.ua[e - 1] + s.ua[q]));
  const T slope = s.ralpha * (s.el[p] - s.el[q]) +
                  s.alpha * (s.elb[p] - s.elb[q] + s.elf[p] - s.elf[q]) +
                  s.e_atmos[p] - s.e_atmos[q];
  const T v1 = s.ady2d[p] + s.advva[p] + cori +
               s.c025g * s.dxv[p] * (d + ds) * slope + s.dry2d[p] +
               s.arv[p] * (s.wvsurf[p] - s.wvbot[p]);
  return ((s.hv[p] + s.elb[p] + s.elb[q]) * s.arv[p] * s.vab[p] -
          s.c4dte * v1) /
         ((s.hv[p] + s.elf[p] + s.elf[q]) * s.arv[p]);
}

// Flather radiation value with d/el read at (i, j): sqrt(g/d) is taken as
// sqrt((1/d)*g), PyTorch's form of a Python float over a tensor
template <typename T>
__device__ __forceinline__ T flather(const Ext<T>& s, int i, int j, T rf,
                                     T sign, T vb, T eb) {
  const int p = i * s.jm + j;
  const T r = rf * sqrt((T(1) / dd(s, i, j)) * s.grav);
  return s.ramp[0] * (vb + sign * (r * (s.el[p] - eb)));
}

template <typename T>
__global__ void k_velocity(Ext<T> s) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= s.im * s.jm) return;
  const int i = p / s.jm, j = p % s.jm;
  const int im = s.im, jm = s.jm;
  const bool jin = j >= 1 && j <= jm - 2, iin = i >= 1 && i <= im - 2;
  // uaf: west rows 0/1 and east row im-1 on j in 1..jm-2, then the south
  // and north columns on i in 1..im-2; the corners keep 0
  T u = T(0);
  if (jin) {
    if (i <= 1)
      u = flather(s, 1, j, s.rfw, T(-1), s.uabw[j], s.elw[j]);
    else if (i == im - 1)
      u = flather(s, im - 2, j, s.rfe, T(1), s.uabe[j], s.ele[j]);
    else
      u = uaf_interior(s, i, j);
  } else if (iin) {
    u = j == 0 ? s.uabs[i] : s.uabn[i];
  }
  // vaf: west/east rows on j in 1..jm-2, then columns 0/1 and jm-1 on
  // i in 1..im-2
  T v = T(0);
  if (iin) {
    if (j <= 1)
      v = flather(s, i, 1, s.rfs, T(-1), s.vabs[i], s.els[i]);
    else if (j == jm - 1)
      v = flather(s, i, jm - 2, s.rfn, T(1), s.vabn[i], s.eln[i]);
    else
      v = vaf_interior(s, i, j);
  } else if (jin) {
    v = i == 0 ? s.vabw[j] : s.vabe[j];
  }
  s.uaf[p] = u * s.dum[p];
  s.vaf[p] = v * s.dvm[p];
}

// ---- etf tail, Asselin filter, rotation, accumulators (advance.f:295-350)
template <typename T>
__global__ void k_update(Ext<T> s, int iext, int isplit) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= s.im * s.jm) return;
  const int i = p / s.jm, j = p % s.jm;
  const T elf = s.elf[p], uaf = s.uaf[p], vaf = s.vaf[p];
  if (iext == isplit - 2)
    s.etf[p] = s.qsmoth * elf;
  else if (iext == isplit - 1)
    s.etf[p] = s.etf[p] + s.tsmoth * elf;
  else if (iext == isplit)
    s.etf[p] = (s.etf[p] + T(0.5) * elf) * s.fsm[p];

  const T ua = s.ua[p], va = s.va[p], el = s.el[p];
  s.uab[p] = ua + s.hsmoth * (s.uab[p] - T(2) * ua + uaf);
  s.vab[p] = va + s.hsmoth * (s.vab[p] - T(2) * va + vaf);
  s.elb[p] = el + s.hsmoth * (s.elb[p] - T(2) * el + elf);
  s.ua[p] = uaf;
  s.va[p] = vaf;
  s.el[p] = elf;

  const T nl = iext != isplit ? T(1) : T(0);
  s.egf[p] = s.egf[p] + nl * elf * s.ispi;
  // d = h + el with the new el, read from elf (the carry el of a
  // neighbour may already be rotated by its own thread)
  const T d = s.h[p] + elf;
  if (i >= 1)
    s.utf[p] = s.utf[p] +
               nl * uaf * (d + (s.h[p - s.jm] + s.elf[p - s.jm])) * s.isp2i;
  if (j >= 1)
    s.vtf[p] = s.vtf[p] + nl * vaf * (d + (s.h[p - 1] + s.elf[p - 1])) * s.isp2i;
}

constexpr int kThreads = 256;
constexpr int kPointers = 63;

template <typename T>
int run(void* const* ptr, const double* prm, int im, int jm, int isplit,
        int ispadv, void* stream) {
  Ext<T> s;
  int k = 0;
#define NEXT(f) s.f = (decltype(s.f))ptr[k++]
  NEXT(el); NEXT(elb); NEXT(ua); NEXT(uab); NEXT(va); NEXT(vab); NEXT(etf);
  NEXT(egf); NEXT(utf); NEXT(vtf); NEXT(advua); NEXT(advva); NEXT(wubot);
  NEXT(wvbot);
  NEXT(h); NEXT(dx); NEXT(dy); NEXT(art); NEXT(aru); NEXT(arv); NEXT(cor);
  NEXT(fsm); NEXT(dum); NEXT(dvm); NEXT(cbc);
  NEXT(adx2d); NEXT(ady2d); NEXT(drx2d); NEXT(dry2d); NEXT(aam2d);
  NEXT(wusurf); NEXT(wvsurf); NEXT(vflux); NEXT(e_atmos);
  NEXT(elw); NEXT(ele); NEXT(uabw); NEXT(uabe); NEXT(vabw); NEXT(vabe);
  NEXT(els); NEXT(eln); NEXT(vabs); NEXT(vabn); NEXT(uabs); NEXT(uabn);
  NEXT(ramp);
  NEXT(dyu); NEXT(dxv); NEXT(hu); NEXT(hv); NEXT(corw); NEXT(cors);
  NEXT(rart); NEXT(rdx); NEXT(rdy); NEXT(dx4); NEXT(dy4); NEXT(rdx4);
  NEXT(rdy4);
  NEXT(elf); NEXT(uaf); NEXT(vaf);
#undef NEXT
  if (k != kPointers) return (int)cudaErrorInvalidValue;
  s.im = im;
  s.jm = jm;
  // prm: dte, grav, smoth, alpha, isplit, rfe, rfw, rfn, rfs (doubles);
  // each constant is formed in double as the Python expression forms it
  const double dte = prm[0], grav = prm[1], smoth = prm[2], alpha = prm[3],
               nsp = prm[4];
  s.dte2 = T(dte * 2.0);
  s.c4dte = T(4.0 * dte);
  s.c025g = T(0.25 * grav);
  s.grav = T(grav);
  s.ralpha = T(1.0 - 2.0 * alpha);
  s.alpha = T(alpha);
  s.ispi = T(1.0 / nsp);
  s.isp2i = T(1.0 / (2.0 * nsp));
  s.hsmoth = T(0.5 * smoth);
  s.qsmoth = T(0.25 * smoth);
  s.tsmoth = T(0.5 * (1.0 - 0.5 * smoth));
  s.rfe = T(prm[5]);
  s.rfw = T(prm[6]);
  s.rfn = T(prm[7]);
  s.rfs = T(prm[8]);

  cudaStream_t st = (cudaStream_t)stream;
  const int n = im * jm;
  const int blocks = (n + kThreads - 1) / kThreads;
  k_metrics<T><<<blocks, kThreads, 0, st>>>(s);
  cudaError_t err = cudaGetLastError();
  for (int iext = 1; iext <= isplit && err == cudaSuccess; ++iext) {
    k_surface<T><<<blocks, kThreads, 0, st>>>(s, iext % ispadv == 0);
    k_velocity<T><<<blocks, kThreads, 0, st>>>(s);
    k_update<T><<<blocks, kThreads, 0, st>>>(s, iext, isplit);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

extern "C" int extpom_extloop_f32(void* const* ptr, const double* prm, int im,
                                  int jm, int isplit, int ispadv,
                                  void* stream) {
  return run<float>(ptr, prm, im, jm, isplit, ispadv, stream);
}

extern "C" int extpom_extloop_f64(void* const* ptr, const double* prm, int im,
                                  int jm, int isplit, int ispadv,
                                  void* stream) {
  return run<double>(ptr, prm, im, jm, isplit, ispadv, stream);
}
