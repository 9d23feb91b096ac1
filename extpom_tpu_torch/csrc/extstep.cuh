// Per-point arithmetic of one external (2-D barotropic) substep,
// core/stepper.py:mode_external_substep, shared by the whole-grid kernel
// chain (extloop.cu) and the halo-window kernel (extwin.cu).  Both call the
// same device functions (the window through its own reader of the
// operands, below), so a value rounds the same way in the same order in
// both, and both match the plain loop bit for bit (built with -fmad=false).
//
// Operands fall in two groups:
//   ExtArgs  the read-only fields (grid, step-constant 2-D terms, forcing,
//            boundary series, the loop-invariant metrics), always whole
//            (im, jm) arrays in device memory, read at p = i*jm + j;
//   Carry    the fields a substep reads at neighbours and rewrites (el,
//            elb, ua, uab, va, vab, advua, advva) and the substep's elf,
//            uaf, vaf.  The chain points them at whole arrays in device
//            memory; extwin at a window of shared memory.  Either way a
//            point is named by its global (i, j).
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
//
// Stencil radius: a substep's new carry at (i, j) reads the old carry at
// most 2 cells away in i and in j (elf reads d/ua/va at +-1 and feeds
// uaf and utf at i-1; advave reads d at i-2 and j-2).  extwin's halo is 2
// cells per substep for that reason (tests/test_torch_extwin.py checks it
// on the plain loop).
//
// Template flags O of ExtArgs, the readers and the kernels: kBlock, a
// ring-extended block (below); kOrl, the orlanski scheme's edges (orl_el,
// which is bc_el's clamp-and-copy, and orl_vel2d); kMode2, mode 2, whose
// advave adds the bottom stress of the depth-mean flow (then a carry
// field, rewritten every advave substep and read at its own cell by the
// velocity pass) and the curvature terms.  Each is a compile-time flag, so
// the kernels of the main path (O = 0 or kBlock) compile to the code they
// had without the options.
//
// orl_vel2d's edge value reads the same substep's interior uaf (vaf) one
// row (column) in: the edge cell forms that value itself with
// uaf_interior (vaf_interior), from the elf and advua/advva that the
// surface pass finished, so the velocity pass needs no further barrier;
// its stencil reaches 3 cells in from a domain edge, normal to it.
//
// Blocks (the flag kBlock, "offset"): the decomposed step runs the same
// substep on a ring-extended (R, L) block of the domain whose cell (0, 0) is
// global (oi, oj) (extchunk in extloop.cu, extwin_chunk in extwin.cu).
// Cells keep their global (i, j), so every region test and boundary
// condition is the domain's; arrays are the block's, indexed (i - oi) * L +
// (j - oj), and every read is zero-filled outside the block, as sft reads
// on the block.  Cells outside the domain (the ring beyond a domain edge)
// hold 0 in every carry field, as the plain version leaves them.  The
// flag is a template parameter so that the whole-domain kernels compile to
// the code they had without it: there the reads that a region keeps inside
// the domain stay unguarded (rn, cn below).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "column.cuh"

namespace extpom {

// template flags of the external kernels (see the header)
constexpr int kBlock = 1;
constexpr int kOrl = 2;
constexpr int kMode2 = 4;

// The instantiation of the options in `flags` (kOrl | kMode2) on top of B
// (0 or kBlock): f is called with an integral_constant of the template
// flags
template <int B, class F>
int with_flags(int flags, F f) {
  switch (flags & (kOrl | kMode2)) {
    case 0:
      return f(std::integral_constant<int, B>{});
    case kOrl:
      return f(std::integral_constant<int, B | kOrl>{});
    case kMode2:
      return f(std::integral_constant<int, B | kMode2>{});
    default:
      return f(std::integral_constant<int, B | kOrl | kMode2>{});
  }
}

// operand order of the read-only block of a pointer table: grid, aux, 2-D
// forcing, 1-D series (j-sides, then i-sides), ramp, metrics
constexpr int kExtOperands = 11 + 5 + 4 + 12 + 1 + 13;

template <typename T, int O = 0>
struct ExtArgs {
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
  // loop-invariant metrics (ext_precompute), written by k_metrics
  T *dyu, *dxv, *hu, *hv, *corw, *cors, *rart, *rdx, *rdy, *dx4, *dy4, *rdx4,
      *rdy4;
  // bottom stress of the carry: advave passes it through outside mode 2
  const T *wubot, *wvbot;
  int im, jm;          // the domain's extents
  int R, L, oi, oj;    // O: the block's extents and global (i, j) of (0, 0)
  // constants, rounded to T as PyTorch rounds a Python float operand
  T dte2, c4dte, c025g, grav, ralpha, alpha, ispi, isp2i, hsmoth, qsmoth,
      tsmoth, rfe, rfw, rfn, rfs;
};

// Fills the read-only block from ptr[0 .. kExtOperands) and the constants
// from prm = (dte, grav, smoth, alpha, isplit, rfe, rfw, rfn, rfs); each
// constant is formed in double as the Python expression forms it.
template <typename T, int O>
void set_ext_args(ExtArgs<T, O>& s, void* const* ptr, const double* prm,
                  int im, int jm) {
  int k = 0;
#define NEXT(f) s.f = (decltype(s.f))ptr[k++]
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
#undef NEXT
  s.wubot = s.wvbot = nullptr;
  s.im = im;
  s.jm = jm;
  s.R = im;
  s.L = jm;
  s.oi = s.oj = 0;
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
}

// The substep's rewritten fields.  The chain (kWindow false) keeps them as
// whole (im, jm) arrays indexed like the read-only fields.  extwin (kWindow
// true) keeps a window of them: array cell (0, 0) is global (oi, oj), rows
// are `stride` apart, and global rows [i0, i1) x columns [j0, j1), the
// window within the domain, may be read.  Either way a cell is named by its
// global (i, j) and read through at(), in() and ldc() below.
template <typename T, bool kWindow>
struct Carry {
  T *el, *elb, *ua, *uab, *va, *vab, *advua, *advva, *elf, *uaf, *vaf;
  T *wubot, *wvbot;  // kMode2: the bottom stress, a carry field
  int oi, oj, stride;
  int i0, i1, j0, j1;
};

// index of cell (i, j) in the read-only arrays
template <typename T, int O>
__device__ __forceinline__ int pix(const ExtArgs<T, O>& s, int i, int j) {
  if constexpr (O & kBlock) return (i - s.oi) * s.L + (j - s.oj);
  return i * s.jm + j;
}

// distance between rows of the read-only arrays
template <typename T, int O>
__device__ __forceinline__ int prow(const ExtArgs<T, O>& s) {
  if constexpr (O & kBlock) return s.L;
  return s.jm;
}

// whether cell (i, j) lies in the read-only arrays (the domain or the block)
template <typename T, int O>
__device__ __forceinline__ bool inb(const ExtArgs<T, O>& s, int i, int j) {
  if constexpr (O & kBlock)
    return i >= s.oi && i < s.oi + s.R && j >= s.oj && j < s.oj + s.L;
  return i >= 0 && i < s.im && j >= 0 && j < s.jm;
}

// whether cell (i, j) lies in the domain
template <typename T, int O>
__device__ __forceinline__ bool in_domain(const ExtArgs<T, O>& s, int i,
                                          int j) {
  return i >= 0 && i < s.im && j >= 0 && j < s.jm;
}

// cells of the read-only arrays, and the (i, j) of cell p of them
template <typename T, int O>
__device__ __forceinline__ int cells(const ExtArgs<T, O>& s) {
  return (O & kBlock) ? s.R * s.L : s.im * s.jm;
}

template <typename T, int O>
__device__ __forceinline__ void cell(const ExtArgs<T, O>& s, int p, int& i,
                                     int& j) {
  if constexpr (O & kBlock) {
    i = p / s.L + s.oi;
    j = p % s.L + s.oj;
  } else {
    i = p / s.jm;
    j = p % s.jm;
  }
}

// boundary series at column j (j-sides) or row i (i-sides)
template <typename T, int O>
__device__ __forceinline__ T at_j(const ExtArgs<T, O>& s, const T* a, int j) {
  return a[(O & kBlock) ? j - s.oj : j];
}

template <typename T, int O>
__device__ __forceinline__ T at_i(const ExtArgs<T, O>& s, const T* a, int i) {
  return a[(O & kBlock) ? i - s.oi : i];
}

// index of cell (i, j) in the arrays of c
template <typename T, int O, bool W>
__device__ __forceinline__ int at(const ExtArgs<T, O>& s,
                                  const Carry<T, W>& c, int i, int j) {
  if constexpr (W) return (i - c.oi) * c.stride + (j - c.oj);
  return pix(s, i, j);
}

// distance between rows of the arrays of c
template <typename T, int O, bool W>
__device__ __forceinline__ int rows(const ExtArgs<T, O>& s,
                                    const Carry<T, W>& c) {
  if constexpr (W) return c.stride;
  return prow(s);
}

// whether cell (i, j) of c may be read
template <typename T, int O, bool W>
__device__ __forceinline__ bool in(const ExtArgs<T, O>& s,
                                   const Carry<T, W>& c, int i, int j) {
  if constexpr (W) return i >= c.i0 && i < c.i1 && j >= c.j0 && j < c.j1;
  return inb(s, i, j);
}

// zero-filled read of a field of c: 0 outside the domain (the block), as
// sft reads
template <typename T, int O, bool W>
__device__ __forceinline__ T ldc(const ExtArgs<T, O>& s,
                                 const Carry<T, W>& c, const T* a, int i,
                                 int j) {
  return in(s, c, i, j) ? a[at(s, c, i, j)] : T(0);
}

// zero-filled read of a read-only field
template <typename T, int O>
__device__ __forceinline__ T ld(const T* a, const ExtArgs<T, O>& s, int i,
                                int j) {
  if constexpr (O & kBlock) return inb(s, i, j) ? a[pix(s, i, j)] : T(0);
  return ld2(a, s.im, s.jm, i, j);
}

// read-only field at (i + di, j + dj), p the index of (i, j): unguarded on
// the domain, whose region tests keep such reads inside it; zero-filled on
// a block
template <typename T, int O>
__device__ __forceinline__ T rn(const ExtArgs<T, O>& s, const T* a, int p,
                                int i, int j, int di = 0, int dj = 0) {
  if constexpr (O & kBlock) return ld(a, s, i + di, j + dj);
  return a[p + di * s.jm + dj];
}

// the same for a field of c, q the index of (i, j) in its arrays
template <typename T, int O, bool W>
__device__ __forceinline__ T cn(const ExtArgs<T, O>& s, const Carry<T, W>& c,
                                const T* a, int q, int i, int j, int di = 0,
                                int dj = 0) {
  if constexpr (O & kBlock) return ldc(s, c, a, i + di, j + dj);
  return a[q + di * rows(s, c) + dj];
}

// d = h + el (zero outside the array, as sft(d, ...) reads)
template <typename T, int O, bool W>
__device__ __forceinline__ T dd(const ExtArgs<T, O>& s, const Carry<T, W>& c,
                                int i, int j) {
  return in(s, c, i, j) ? s.h[pix(s, i, j)] + c.el[at(s, c, i, j)] : T(0);
}

// ext_precompute at cell p of the read-only arrays
template <typename T, int O>
__device__ __forceinline__ void metrics_point(const ExtArgs<T, O>& s, int p) {
  int i, j;
  cell(s, p, i, j);
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

// ext_precompute, one point per thread
template <typename T, int O>
__global__ void k_metrics(ExtArgs<T, O> s) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < cells(s)) metrics_point(s, p);
}

// ---- reading a point's operands ----
//
// The per-point functions below read the operands of cell (x.i, x.j)
// through a reader x (x.s the read-only fields, x.c the carry):
//   x.r(a, di, dj)  read-only field a at (i + di, j + dj)
//   x.w(a, di, dj)  field a of the carry there
//   x.d(di, dj)     d = h + el there
//   x.asum()        aam2d summed over (i, j), (i, j-1), (i-1, j), (i-1, j-1)
//   x.fu(di, dj), x.fv, x.fua3, x.fva3, x.fua6, x.fva6
//                   the face flux_u, flux_v, adv_fua3, ... there
// At (below) reads every operand where it lies and forms a face where it is
// asked for: the chain.  extwin.cu's reader takes d, the aam2d sums and the
// faces from a window staged in shared memory, formed once per substep by
// these same functions, so a value rounds alike in both.
//
// A face is its function's value on the face's put region and 0 off it.
// The functions below form the value; the caller tests the region (At's
// face readers, extwin.cu's faces), so that faces of one region share one
// test and the reads under it:
//   on_face  1:, 1:    flux_u, flux_v, adv_tps, adv_fva3, adv_fua6
//   on_fua3  1:-1, 1:  adv_fua3
//   on_fva6  1:, 1:-1  adv_fva6

template <class X>
__device__ __forceinline__ bool on_face(const X& x) {
  return x.i >= 1 && x.i < x.s.im && x.j >= 1 && x.j < x.s.jm;
}

template <class X>
__device__ __forceinline__ bool on_fua3(const X& x) {
  return on_face(x) && x.i <= x.s.im - 2;
}

template <class X>
__device__ __forceinline__ bool on_fva6(const X& x) {
  return on_face(x) && x.j <= x.s.jm - 2;
}

// ---- free surface (advance.f:211-229) ----

// fluxua = put(z2, .25 (d + d_w) dyu ua, 1:, 1:), on on_face
template <class X>
__device__ __forceinline__ typename X::type flux_u(const X& x) {
  using T = typename X::type;
  const auto& s = x.s;
  return T(0.25) * (x.d() + x.d(-1, 0)) * x.r(s.dyu) * x.w(x.c.ua);
}

// fluxva = put(z2, .25 (d + d_s) dxv va, 1:, 1:), on on_face
template <class X>
__device__ __forceinline__ typename X::type flux_v(const X& x) {
  using T = typename X::type;
  const auto& s = x.s;
  return T(0.25) * (x.d() + x.d(0, -1)) * x.r(s.dxv) * x.w(x.c.va);
}

// elf before bc_el, on its put region 1:-1, 1:-1
template <class X>
__device__ __forceinline__ typename X::type elf_interior(const X& x) {
  using T = typename X::type;
  const auto& s = x.s;
  const T div = x.fu(1, 0) - x.fu() + x.fv(0, 1) - x.fv();
  return x.w(x.c.elb) + s.dte2 * (-div * x.r(s.rart) - x.r(s.vflux));
}

// ---- advave, mode != 2 (solver.f:16-121) ----

// the viscous cross term of advave, put(z, ..., 1:, 1:), on on_face
template <class X>
__device__ __forceinline__ typename X::type adv_tps(const X& x) {
  using T = typename X::type;
  const auto& s = x.s;
  const auto& c = x.c;
  const T dsum = x.d() + x.d(-1, 0) + x.d(0, -1) + x.d(-1, -1);
  return T(0.25) * dsum * x.asum() *
         ((x.w(c.uab) - x.w(c.uab, 0, -1)) * x.r(s.rdy4) +
          (x.w(c.vab) - x.w(c.vab, -1, 0)) * x.r(s.rdx4));
}

// u-part fluxua after viscous term and * dy, on on_fua3
template <class X>
__device__ __forceinline__ typename X::type adv_fua3(const X& x) {
  using T = typename X::type;
  const auto& s = x.s;
  const auto& c = x.c;
  const T d = x.d();
  const T ue = x.w(c.ua, 1, 0), ua = x.w(c.ua);
  T f = T(0.125) * ((x.d(1, 0) + d) * ue + (d + x.d(-1, 0)) * ua) * (ue + ua);
  f = f - d * T(2) * x.r(s.aam2d) * (x.w(c.uab, 1, 0) - x.w(c.uab)) *
              x.r(s.rdx);
  return f * x.r(s.dy);
}

// u-part fluxva after the cross term and * dx4/4, tps = adv_tps(x), on
// on_face
template <class X>
__device__ __forceinline__ typename X::type adv_fva3(const X& x,
                                                     typename X::type tps) {
  using T = typename X::type;
  const auto& s = x.s;
  const auto& c = x.c;
  const T f = T(0.125) *
              ((x.d() + x.d(0, -1)) * x.w(c.va) +
               (x.d(-1, 0) + x.d(-1, -1)) * x.w(c.va, -1, 0)) *
              (x.w(c.ua) + x.w(c.ua, 0, -1));
  return (f - tps) * T(0.25) * x.r(s.dx4);
}

// v-part fluxua after the cross term and * dy4/4, tps = adv_tps(x), on
// on_face
template <class X>
__device__ __forceinline__ typename X::type adv_fua6(const X& x,
                                                     typename X::type tps) {
  using T = typename X::type;
  const auto& s = x.s;
  const auto& c = x.c;
  const T f = T(0.125) *
              ((x.d() + x.d(-1, 0)) * x.w(c.ua) +
               (x.d(0, -1) + x.d(-1, -1)) * x.w(c.ua, 0, -1)) *
              (x.w(c.va, -1, 0) + x.w(c.va));
  return (f - tps) * T(0.25) * x.r(s.dy4);
}

// v-part fluxva after viscous term and * dx, on on_fva6
template <class X>
__device__ __forceinline__ typename X::type adv_fva6(const X& x) {
  using T = typename X::type;
  const auto& s = x.s;
  const auto& c = x.c;
  const T d = x.d();
  const T vn = x.w(c.va, 0, 1), va = x.w(c.va);
  T f = T(0.125) * ((x.d(0, 1) + d) * vn + (d + x.d(0, -1)) * va) * (vn + va);
  f = f - d * T(2) * x.r(s.aam2d) * (x.w(c.vab, 0, 1) - x.w(c.vab)) *
              x.r(s.rdy);
  return f * x.r(s.dx);
}

// advua and advva at one point (0 off their put region 1:-1, 1:-1); they
// read d/ua/va/uab/vab only
template <class X>
__device__ __forceinline__ void adv_point(const X& x, typename X::type& advua,
                                          typename X::type& advva) {
  using T = typename X::type;
  const auto& s = x.s;
  const bool inside =
      x.i >= 1 && x.i <= s.im - 2 && x.j >= 1 && x.j <= s.jm - 2;
  advua = inside ? x.fua3() - x.fua3(-1, 0) + x.fva3(0, 1) - x.fva3() : T(0);
  advva = inside ? x.fua6(1, 0) - x.fua6() + x.fva6() - x.fva6(0, -1) : T(0);
}

// ---- advave, mode 2 (solver.f:123-193) ----

// curv2d at (i + di, j + dj), on its put region 1:-1, 1:-1; every read a
// caller makes lies in the array where the region holds
template <class X>
__device__ __forceinline__ typename X::type curv(const X& x, int di, int dj) {
  using T = typename X::type;
  const auto& s = x.s;
  const auto& c = x.c;
  const int i = x.i + di, j = x.j + dj;
  if (i < 1 || i > s.im - 2 || j < 1 || j > s.jm - 2) return T(0);
  return T(0.25) *
         ((x.w(c.va, di, dj + 1) + x.w(c.va, di, dj)) *
              (x.r(s.dy, di + 1, dj) - x.r(s.dy, di - 1, dj)) -
          (x.w(c.ua, di + 1, dj) + x.w(c.ua, di, dj)) *
              (x.r(s.dx, di, dj + 1) - x.r(s.dx, di, dj - 1))) *
         x.r(s.rart, di, dj);
}

// advave's mode-2 branch at one point, after adv_point: the bottom stress
// of the depth-mean flow into wubot/wvbot on 1:-1, 1:-1 (left as they are
// elsewhere), and the curvature terms into advua on global i >= 2 and
// advva on global j >= 2
template <class X>
__device__ __forceinline__ void mode2_point(const X& x,
                                            typename X::type& advua,
                                            typename X::type& advva,
                                            typename X::type& wubot,
                                            typename X::type& wvbot) {
  using T = typename X::type;
  const auto& s = x.s;
  const auto& c = x.c;
  const int i = x.i, j = x.j, im = s.im, jm = s.jm;
  if (i < 1 || i > im - 2 || j < 1 || j > jm - 2) return;
  const T uab = x.w(c.uab), vab = x.w(c.vab);
  const T vq = T(0.25) * (vab + x.w(c.vab, 0, 1) + x.w(c.vab, -1, 0) +
                          x.w(c.vab, -1, 1));
  wubot = T(-0.5) * (x.r(s.cbc) + x.r(s.cbc, -1, 0)) *
          sqrt(uab * uab + vq * vq) * uab;
  const T uq = T(0.25) * (uab + x.w(c.uab, 1, 0) + x.w(c.uab, 0, -1) +
                          x.w(c.uab, 1, -1));
  wvbot = T(-0.5) * (x.r(s.cbc) + x.r(s.cbc, 0, -1)) *
          sqrt(vab * vab + uq * uq) * vab;
  const T cv = curv(x, 0, 0), d = x.d();
  if (i >= 2)
    advua = advua - x.r(s.aru) * T(0.25) *
                        (cv * d * (x.w(c.va, 0, 1) + x.w(c.va)) +
                         curv(x, -1, 0) * x.d(-1, 0) *
                             (x.w(c.va, -1, 1) + x.w(c.va, -1, 0)));
  if (j >= 2)
    advva = advva + x.r(s.arv) * T(0.25) *
                        (cv * d * (x.w(c.ua, 1, 0) + x.w(c.ua)) +
                         curv(x, 0, -1) * x.d(0, -1) *
                             (x.w(c.ua, 1, -1) + x.w(c.ua, 0, -1)));
}

// ---- depth-mean momentum (advance.f:237-288) ----

// the bottom stress uaf/vaf read at their own cell: the carry's in mode 2,
// the step's constant one otherwise
template <class X>
__device__ __forceinline__ typename X::type bottom_u(const X& x) {
  if constexpr (X::kFlags & kMode2) return x.w(x.c.wubot);
  return x.r(x.s.wubot);
}

template <class X>
__device__ __forceinline__ typename X::type bottom_v(const X& x) {
  if constexpr (X::kFlags & kMode2) return x.w(x.c.wvbot);
  return x.r(x.s.wvbot);
}

// uaf on its put region 1:, 1:-1
template <class X>
__device__ __forceinline__ typename X::type uaf_interior(const X& x) {
  using T = typename X::type;
  const auto& s = x.s;
  const auto& c = x.c;
  const T d = x.d(), dw = x.d(-1, 0);
  const T aru = x.r(s.aru), hu = x.r(s.hu);
  const T elb = x.w(c.elb), elbw = x.w(c.elb, -1, 0);
  const T elf = x.w(c.elf), elfw = x.w(c.elf, -1, 0);
  const T cori = aru * T(0.25) *
                 (x.r(s.cor) * d * (x.w(c.va, 0, 1) + x.w(c.va)) +
                  x.r(s.corw) * dw * (x.w(c.va, -1, 1) + x.w(c.va, -1, 0)));
  const T slope = s.ralpha * (x.w(c.el) - x.w(c.el, -1, 0)) +
                  s.alpha * (elb - elbw + elf - elfw) + x.r(s.e_atmos) -
                  x.r(s.e_atmos, -1, 0);
  const T u1 = x.r(s.adx2d) + x.w(c.advua) - cori +
               s.c025g * x.r(s.dyu) * (d + dw) * slope + x.r(s.drx2d) +
               aru * (x.r(s.wusurf) - bottom_u(x));
  return ((hu + elb + elbw) * aru * x.w(c.uab) - s.c4dte * u1) /
         ((hu + elf + elfw) * aru);
}

// vaf on its put region 1:-1, 1:
template <class X>
__device__ __forceinline__ typename X::type vaf_interior(const X& x) {
  using T = typename X::type;
  const auto& s = x.s;
  const auto& c = x.c;
  const T d = x.d(), ds = x.d(0, -1);
  const T arv = x.r(s.arv), hv = x.r(s.hv);
  const T elb = x.w(c.elb), elbs = x.w(c.elb, 0, -1);
  const T elf = x.w(c.elf), elfs = x.w(c.elf, 0, -1);
  const T cori = arv * T(0.25) *
                 (x.r(s.cor) * d * (x.w(c.ua, 1, 0) + x.w(c.ua)) +
                  x.r(s.cors) * ds * (x.w(c.ua, 1, -1) + x.w(c.ua, 0, -1)));
  const T slope = s.ralpha * (x.w(c.el) - x.w(c.el, 0, -1)) +
                  s.alpha * (elb - elbs + elf - elfs) + x.r(s.e_atmos) -
                  x.r(s.e_atmos, 0, -1);
  const T v1 = x.r(s.ady2d) + x.w(c.advva) + cori +
               s.c025g * x.r(s.dxv) * (d + ds) * slope + x.r(s.dry2d) +
               arv * (x.r(s.wvsurf) - bottom_v(x));
  return ((hv + elb + elbs) * arv * x.w(c.vab) - s.c4dte * v1) /
         ((hv + elf + elfs) * arv);
}

// The chain's reader of cell (i, j), whose index is p in the read-only
// arrays and q in the carry's: reads are unguarded on the domain, whose
// region tests keep them inside it, and zero-filled on a block (rn, cn);
// d is zero outside the carry's arrays (dd)
template <typename T, int O, bool W>
struct At {
  using type = T;
  static constexpr int kFlags = O;
  const ExtArgs<T, O>& s;
  const Carry<T, W>& c;
  int i, j, p, q;

  __device__ __forceinline__ At(const ExtArgs<T, O>& s_, const Carry<T, W>& c_,
                                int i_, int j_)
      : s(s_), c(c_), i(i_), j(j_), p(pix(s_, i_, j_)), q(at(s_, c_, i_, j_)) {}
  __device__ __forceinline__ T r(const T* a, int di = 0, int dj = 0) const {
    return rn(s, a, p, i, j, di, dj);
  }
  __device__ __forceinline__ T w(const T* a, int di = 0, int dj = 0) const {
    return cn(s, c, a, q, i, j, di, dj);
  }
  __device__ __forceinline__ T d(int di = 0, int dj = 0) const {
    return dd(s, c, i + di, j + dj);
  }
  __device__ __forceinline__ T asum() const {
    return r(s.aam2d) + r(s.aam2d, 0, -1) + r(s.aam2d, -1, 0) +
           r(s.aam2d, -1, -1);
  }
  __device__ __forceinline__ At to(int di, int dj) const {
    return At(s, c, i + di, j + dj);
  }
  __device__ __forceinline__ T fu(int di = 0, int dj = 0) const {
    const At y = to(di, dj);
    return on_face(y) ? flux_u(y) : T(0);
  }
  __device__ __forceinline__ T fv(int di = 0, int dj = 0) const {
    const At y = to(di, dj);
    return on_face(y) ? flux_v(y) : T(0);
  }
  __device__ __forceinline__ T fua3(int di = 0, int dj = 0) const {
    const At y = to(di, dj);
    return on_fua3(y) ? adv_fua3(y) : T(0);
  }
  __device__ __forceinline__ T fva3(int di = 0, int dj = 0) const {
    const At y = to(di, dj);
    return on_face(y) ? adv_fva3(y, adv_tps(y)) : T(0);
  }
  __device__ __forceinline__ T fua6(int di = 0, int dj = 0) const {
    const At y = to(di, dj);
    return on_face(y) ? adv_fua6(y, adv_tps(y)) : T(0);
  }
  __device__ __forceinline__ T fva6(int di = 0, int dj = 0) const {
    const At y = to(di, dj);
    return on_fva6(y) ? adv_fva6(y) : T(0);
  }
};

// elf + bc_el: edges copy the clamped interior value (see header); 0
// outside the domain
template <typename T, int O, bool W>
__device__ T elf_point(const ExtArgs<T, O>& s, const Carry<T, W>& c, int i,
                       int j) {
  if constexpr (O & kBlock)
    if (!in_domain(s, i, j)) return T(0);
  const int ci = min(max(i, 1), s.im - 2), cj = min(max(j, 1), s.jm - 2);
  return elf_interior(At<T, O, W>(s, c, ci, cj)) *
         rn(s, s.fsm, pix(s, i, j), i, j);
}

// advave at one point: advua and advva, and in mode 2 the bottom stress
// into the carry's wubot/wvbot at the point
template <typename T, int O, bool W>
__device__ void adv_point(const ExtArgs<T, O>& s, const Carry<T, W>& c, int i,
                          int j, T& advua, T& advva) {
  const At<T, O, W> x(s, c, i, j);
  adv_point(x, advua, advva);
  if constexpr (O & kMode2)
    mode2_point(x, advua, advva, c.wubot[x.q], c.wvbot[x.q]);
}

// Flather radiation value with d/el read at (i, j): sqrt(g/d) is taken as
// sqrt((1/d)*g), PyTorch's form of a Python float over a tensor
template <typename T, int O, bool W>
__device__ __forceinline__ T flather(const ExtArgs<T, O>& s,
                                     const Carry<T, W>& c, int i, int j, T rf,
                                     T sign, T vb, T eb) {
  const T r = rf * sqrt((T(1) / dd(s, c, i, j)) * s.grav);
  return s.ramp[0] *
         (vb + sign * (r * (cn(s, c, c.el, at(s, c, i, j), i, j) - eb)));
}

// uaf and vaf at one point, bc_vel2d included, times dum/dvm; 0 outside
// the domain
template <typename T, int O, bool W>
__device__ void velocity_point(const ExtArgs<T, O>& s, const Carry<T, W>& c,
                               int i, int j, T& uaf, T& vaf) {
  if constexpr (O & kBlock) {
    if (!in_domain(s, i, j)) {
      uaf = vaf = T(0);
      return;
    }
  }
  const int im = s.im, jm = s.jm;
  const bool jin = j >= 1 && j <= jm - 2, iin = i >= 1 && i <= im - 2;
  T u = T(0), v = T(0);
  if constexpr (O & kOrl) {
    // orl_vel2d, written east, west (row 0 copies row 1), south (column 0
    // copies column 1), north: each edge value from the interior value one
    // row (column) in, which this cell forms; the tangential component at
    // an edge and the corners keep 0
    using A = At<T, O, W>;
    if (jin) {
      if (i == im - 1) {
        const A e(s, c, im - 2, j);
        u = radiate(phase_speed(uaf_interior(e), e.w(c.uab), e.w(c.ua, -1, 0)),
                    e.w(c.uab, 1, 0), e.w(c.ua));
      } else if (i <= 1) {
        const A w(s, c, 2, j);
        u = radiate(phase_speed(uaf_interior(w), w.w(c.uab), w.w(c.ua, 1, 0)),
                    w.w(c.uab, -1, 0), w.w(c.ua));
      } else {
        u = uaf_interior(A(s, c, i, j));
      }
    }
    if (iin) {
      if (j == jm - 1) {
        const A n(s, c, i, jm - 2);
        v = radiate(phase_speed(vaf_interior(n), n.w(c.vab), n.w(c.va, 0, -1)),
                    n.w(c.vab, 0, 1), n.w(c.va));
      } else if (j <= 1) {
        const A so(s, c, i, 2);
        v = radiate(
            phase_speed(vaf_interior(so), so.w(c.vab), so.w(c.va, 0, 1)),
            so.w(c.vab, 0, -1), so.w(c.va));
      } else {
        v = vaf_interior(A(s, c, i, j));
      }
    }
  } else {
    // uaf: west rows 0/1 and east row im-1 on j in 1..jm-2, then the
    // south and north columns on i in 1..im-2; the corners keep 0
    if (jin) {
      if (i <= 1)
        u = flather(s, c, 1, j, s.rfw, T(-1), at_j(s, s.uabw, j),
                    at_j(s, s.elw, j));
      else if (i == im - 1)
        u = flather(s, c, im - 2, j, s.rfe, T(1), at_j(s, s.uabe, j),
                    at_j(s, s.ele, j));
      else
        u = uaf_interior(At<T, O, W>(s, c, i, j));
    } else if (iin) {
      u = j == 0 ? at_i(s, s.uabs, i) : at_i(s, s.uabn, i);
    }
    // vaf: west/east rows on j in 1..jm-2, then columns 0/1 and jm-1 on
    // i in 1..im-2
    if (iin) {
      if (j <= 1)
        v = flather(s, c, i, 1, s.rfs, T(-1), at_i(s, s.vabs, i),
                    at_i(s, s.els, i));
      else if (j == jm - 1)
        v = flather(s, c, i, jm - 2, s.rfn, T(1), at_i(s, s.vabn, i),
                    at_i(s, s.eln, i));
      else
        v = vaf_interior(At<T, O, W>(s, c, i, j));
    } else if (jin) {
      v = i == 0 ? at_j(s, s.vabw, j) : at_j(s, s.vabe, j);
    }
  }
  const int p = pix(s, i, j);
  uaf = u * s.dum[p];
  vaf = v * s.dvm[p];
}

// ---- etf tail, Asselin filter, rotation, accumulators (advance.f:295-350)

// etf tail and the egf/utf/vtf accumulators at (i, j); the four fields are
// whole arrays indexed like the read-only fields.  Reads elf/uaf/vaf only,
// so it may run before or after rotate() at the same point.
template <typename T, int O, bool W>
__device__ void accumulate(const ExtArgs<T, O>& s, const Carry<T, W>& c,
                           int i, int j, int iext, int isplit, T* etf, T* egf,
                           T* utf, T* vtf) {
  const int p = pix(s, i, j), q = at(s, c, i, j);
  const T elf = c.elf[q], uaf = c.uaf[q], vaf = c.vaf[q];
  if (iext == isplit - 2)
    etf[p] = s.qsmoth * elf;
  else if (iext == isplit - 1)
    etf[p] = etf[p] + s.tsmoth * elf;
  else if (iext == isplit)
    etf[p] = (etf[p] + T(0.5) * elf) * s.fsm[p];

  const T nl = iext != isplit ? T(1) : T(0);
  egf[p] = egf[p] + nl * elf * s.ispi;
  // d = h + el with the new el, read from elf (the carry el of a
  // neighbour may already be rotated)
  const T d = s.h[p] + elf;
  if (i >= 1)
    utf[p] = utf[p] + nl * uaf *
                          (d + (rn(s, s.h, p, i, j, -1, 0) +
                                cn(s, c, c.elf, q, i, j, -1, 0))) *
                          s.isp2i;
  if (j >= 1)
    vtf[p] = vtf[p] + nl * vaf *
                          (d + (rn(s, s.h, p, i, j, 0, -1) +
                                cn(s, c, c.elf, q, i, j, 0, -1))) *
                          s.isp2i;
}

// Asselin filter at array cell q: the new b levels of el, ua and va into
// elb[q], uab[q] and vab[q] (c's own b levels, or another slot)
template <typename T, int O, bool W>
__device__ __forceinline__ void asselin(const ExtArgs<T, O>& s,
                                        const Carry<T, W>& c, int q, T* elb,
                                        T* uab, T* vab) {
  const T elf = c.elf[q], uaf = c.uaf[q], vaf = c.vaf[q];
  const T ua = c.ua[q], va = c.va[q], el = c.el[q];
  uab[q] = ua + s.hsmoth * (c.uab[q] - T(2) * ua + uaf);
  vab[q] = va + s.hsmoth * (c.vab[q] - T(2) * va + vaf);
  elb[q] = el + s.hsmoth * (c.elb[q] - T(2) * el + elf);
}

// Asselin filter and time-level rotation at array cell q, in place
template <typename T, int O, bool W>
__device__ void rotate(const ExtArgs<T, O>& s, const Carry<T, W>& c, int q) {
  const T elf = c.elf[q], uaf = c.uaf[q], vaf = c.vaf[q];
  asselin(s, c, q, c.elb, c.uab, c.vab);
  c.ua[q] = uaf;
  c.va[q] = vaf;
  c.el[q] = elf;
}

}  // namespace extpom
