// Halo-window external loop: the isplit external substeps of one internal
// step as isplit/C launches, each running C consecutive substeps over 2-D
// tiles held in shared memory.
//
// Replaces extpom_tpu/pallas/extwin.py:_kernel (via
// run_external_loop_windowed), which stripes the i axis into full-jm
// windows, DMAs every field's window into VMEM and runs C substeps there,
// for grids whose 2-D working set does not fit VMEM.  Counterpart here of C
// calls of extpom_tpu_torch/core/stepper.py:mode_external_substep.
//
// Bound on the H100: per substep a point does ~200 flops over ~50 words of
// 2-D fields.  Once the working set (50 fields of (im, jm), 840 MB at
// 2048x2048 f32) no longer fits the 50 MB L2, the whole-grid chain of
// extloop.cu streams it from device memory three times per substep.  This
// kernel reads the carry from device memory once per C substeps instead;
// the read-only operands are still read at every substep, through L1/L2.
// What bounded the first design (one thread per cell calling the chain's
// per-point functions) was arithmetic done several times over: every flux
// face was formed by both cells that share it, advave's tps four times per
// cell, and d = h + el re-read at every use (PERF.md §6).
//
// Design:
//   * a block owns a ti x tj tile of the output and keeps the window of the
//     tile grown by a halo of H = 2C cells on each side in shared memory:
//     the eight carry fields that a substep reads at neighbours (el, elb,
//     ua, uab, va, vab, advua, advva), the substep's elf, d = h + el, the
//     aam2d sums of advave's tps (constant over the launch), and a pool of
//     six face fields;
//   * per substep, one pass forms every face once per window cell into the
//     pool: the free-surface fluxes (flux_u, flux_v) and, on substeps where
//     iext % ispadv == 0, tps and advave's four fluxes; the next pass
//     differences them into elf and advua/advva; the velocity pass writes
//     uaf/vaf over the two free-surface faces (dead by then); the last pass
//     accumulates, rotates and restages d = h + el from the new el;
//   * a thread owns one column of the window (and every rstep-th row of
//     it), fixed for the launch, so no pass divides per cell;
//   * a substep's stencil radius is 2 (extstep.cuh), so after substep s of
//     C only the margin 2(C-1-s) around the tile is still needed: each
//     substep computes faces on that margin + 1, elf on the margin + 1 below
//     and left (uaf/utf read it at i-1, vaf/vtf at j-1), everything else on
//     the margin, and reads no cell outside the window;
//   * the accumulators etf/egf/utf/vtf are read and written only on the
//     tile, in the output buffer, which no other block touches;
//   * blocks read their neighbours' halo from the input carry while others
//     write their tiles, so input and output are separate buffers that
//     swap between launches (ping-pong), where the chain updates in place.
// Every value is formed by extstep.cuh's per-point functions themselves,
// called with a reader (Cell) that takes d, the aam2d sums and the faces
// from the window (a face formed once rounds as the same face formed twice),
// and the domain's edge cells call elf_point and velocity_point on the
// window's carry, so the results equal the chain's and the plain loop's bit
// for bit.
//
// Where an off-by-one would hide, beyond extstep.cuh's list:
//   * a window cell outside the domain (the block) is never loaded or
//     computed; its d is 0 and reads there give 0 as sft does; edge tiles
//     apply bc_el/bc_vel2d at the global (i, j) exactly as the chain does;
//   * iext of the chunk's first substep is ic*C + 1, so the ispadv branch,
//     the etf tail on substeps isplit-2..isplit (which may span two chunks)
//     and the last-substep skip of the accumulators follow the global
//     substep count.
//
// The options of extstep.cuh are template flags, chosen per call (`flags`
// of the entries): mode 2 keeps the bottom stress in the window as two
// more carry fields (19 fields); under the orlanski scheme an edge cell
// forms the interior velocity one cell in from the window, so a substep
// reaches 3 cells (H = 3C) and forms faces, elf and advave one cell
// further out on every side (kernels/extwin.py:geometry counts both).
//
// extpom_extwin_chunk_f32/f64, the same kernel on one ring-extended block of
// the decomposed step (the O variant of extstep.cuh), replace
// extpom_tpu/pallas/extwin.py:_kernel with has_off (via
// run_external_chunk_windowed), which stripes a ring-extended local block
// into windows.  The tiles cover the (R, L) block whose cell (0, 0) is
// global (oi, oj) instead of the domain; a window is bounded by the block,
// cells keep their global (i, j) for masks and boundary conditions, and a
// chunk of nsub substeps (one ring exchange) runs as nsub/C launches, the
// metrics computed once.  Every read there is zero-filled outside the
// block.

#include <cuda_runtime.h>

#include "extstep.cuh"

namespace {

using extpom::Carry;
using extpom::ExtArgs;

constexpr int kMaxThreads = 512;  // a block's threads, at most
// window fields in shared memory: el, elb, ua, uab, va, vab, advua, advva,
// (mode 2: wubot, wvbot,) elf, d, the tps aam2d sums, six faces
template <int O>
constexpr int kLoaded = (O & extpom::kMode2) ? 10 : 8;  // carry fields
template <int O>
constexpr int kShared = kLoaded<O> + 9;
// cells of halo a substep consumes: its stencil radius, 3 under the
// orlanski scheme (extstep.cuh)
template <int O>
constexpr int kRadius = (O & extpom::kOrl) ? 3 : 2;

// carry field indices (CARRY_FIELDS order)
enum {
  EL, ELB, UA, UAB, VA, VAB, ETF, EGF, UTF, VTF, ADVUA, ADVVA, WUBOT, WVBOT
};

// carry field of the k-th shared-memory field, k < kLoaded
__device__ __forceinline__ int loaded(int k) { return k < 6 ? k : k + 4; }

// The pool of face fields: field k of the window at p + k * wn
template <typename T>
struct Pool {
  T* p;
  int wn;
  __device__ __forceinline__ T* operator[](int k) const { return p + k * wn; }
};

// A thread's cells: window column oj + tc, and rows oi + tr, oi + tr +
// rstep, ...; threads past rstep whole rows of the window have none.
struct Map {
  int oi, oj, tr, tc, rstep;
};

// f(i, j) on the thread's cells of rows [r0, r1) x columns [c0, c1)
template <typename F>
__device__ __forceinline__ void for_rect(const Map& mp, int r0, int r1, int c0,
                                         int c1, F f) {
  const int j = mp.oj + mp.tc;
  if (mp.tr >= mp.rstep || j < c0 || j >= c1) return;
  for (int i = mp.oi + mp.tr; i < r1; i += mp.rstep)
    if (i >= r0) f(i, j);
}

// extstep.cuh's reader of window cell (i, j), whose index is p in the
// read-only arrays and q in the window: d, the tps sums of aam2d and the
// faces come from the window (d is 0 wherever it may not be read; a face is
// read only where it was formed); the other reads are zero-filled as
// extstep.cuh's ld/ldc on a block (O), whose window may leave the block,
// and plain on the whole domain, whose region tests keep every read inside
// it.
template <typename T, int O>
struct Cell {
  using type = T;
  static constexpr int kFlags = O;
  const ExtArgs<T, O>& s;
  const Carry<T, true>& c;
  int i, j, p, q;
  const T *dw, *as;
  Pool<T> pool;

  __device__ __forceinline__ T r(const T* a, int di = 0, int dj = 0) const {
    if constexpr (O & extpom::kBlock) return extpom::ld(a, s, i + di, j + dj);
    return a[p + di * extpom::prow(s) + dj];
  }
  __device__ __forceinline__ T w(const T* a, int di = 0, int dj = 0) const {
    if constexpr (O & extpom::kBlock) return extpom::ldc(s, c, a, i + di, j + dj);
    return a[q + di * c.stride + dj];
  }
  __device__ __forceinline__ T d(int di = 0, int dj = 0) const {
    return dw[q + di * c.stride + dj];
  }
  __device__ __forceinline__ T asum() const { return as[q]; }
  __device__ __forceinline__ T face(int k, int di, int dj) const {
    return pool[k][q + di * c.stride + dj];
  }
  __device__ __forceinline__ T fu(int di = 0, int dj = 0) const {
    return face(0, di, dj);
  }
  __device__ __forceinline__ T fv(int di = 0, int dj = 0) const {
    return face(1, di, dj);
  }
  __device__ __forceinline__ T fua3(int di = 0, int dj = 0) const {
    return face(2, di, dj);
  }
  __device__ __forceinline__ T fva3(int di = 0, int dj = 0) const {
    return face(3, di, dj);
  }
  __device__ __forceinline__ T fua6(int di = 0, int dj = 0) const {
    return face(4, di, dj);
  }
  __device__ __forceinline__ T fva6(int di = 0, int dj = 0) const {
    return face(5, di, dj);
  }
};

// The faces of cell x into the pool: flux_u and flux_v and, with adv,
// advave's four fluxes (adv_tps once for the two that subtract it), each 0
// off its put region; the faces are formed under one test of their
// regions, so that their shared reads are read once
template <typename T, int O>
__device__ __forceinline__ void faces(const Cell<T, O>& x, bool adv) {
  const bool ij = extpom::on_face(x);
  T fu = T(0), fv = T(0);
  if (ij) {
    fu = extpom::flux_u(x);
    fv = extpom::flux_v(x);
  }
  x.pool[0][x.q] = fu;
  x.pool[1][x.q] = fv;
  if (!adv) return;
  // on_fua3 and on_fva6 lie inside on_face
  T fua3 = T(0), fva3 = T(0), fua6 = T(0), fva6 = T(0);
  if (ij) {
    if (extpom::on_fua3(x)) fua3 = extpom::adv_fua3(x);
    const T tps = extpom::adv_tps(x);
    fva3 = extpom::adv_fva3(x, tps);
    fua6 = extpom::adv_fua6(x, tps);
    if (extpom::on_fva6(x)) fva6 = extpom::adv_fva6(x);
  }
  x.pool[2][x.q] = fua3;
  x.pool[3][x.q] = fva3;
  x.pool[4][x.q] = fua6;
  x.pool[5][x.q] = fva6;
}

// The tile's nsub substeps, once its window is loaded into c and d.
template <typename T, int O>
__device__ void substeps(const ExtArgs<T, O>& s, const Carry<T, true>& c,
                         const Map& mp, T* d, const T* asum,
                         const Pool<T>& pool,
                         T* cout, long n, int iext0, int isplit, int ispadv,
                         int nsub, int i0, int j0, int ie, int je, int lo_i,
                         int lo_j, int hi_i, int hi_j) {
  const int im = s.im, jm = s.jm;
  // under the orlanski scheme an edge cell forms the interior uaf (vaf)
  // one row (column) in, from elf and advua/advva there: each substep
  // forms faces, elf and advave one cell further out on every side, and
  // the halo is 3 cells per substep
  constexpr int E = (O & extpom::kOrl) ? 1 : 0;
  for (int sub = 0; sub < nsub; ++sub) {
    const int iext = iext0 + sub;
    // margin still needed afterwards
    const int m = kRadius<O> * (nsub - 1 - sub);
    const int r0 = max(i0 - m, lo_i), r1 = min(ie + m, hi_i);
    const int c0 = max(j0 - m, lo_j), c1 = min(je + m, hi_j);
    const bool adv = iext % ispadv == 0;
    const auto cell = [&](int i, int j) {
      return Cell<T, O>{s, c, i, j, extpom::pix(s, i, j),
                        extpom::at(s, c, i, j), d, asum, pool};
    };
    // faces on the margin + 1, up to the face beyond the last cell (row or
    // column hi of a block's edge tile, which elf differences)
    for_rect(mp, max(r0 - 1 - E, lo_i), r1 + 1 + E, max(c0 - 1 - E, lo_j),
             c1 + 1 + E, [&](int i, int j) { faces(cell(i, j), adv); });
    __syncthreads();
    // elf one cell further out below and left: uaf and utf read it at
    // i-1, vaf and vtf at j-1; the domain's edge cells by elf_point, which
    // forms the faces of the clamped cell itself
    int er1 = r1, ec1 = c1;
    if constexpr (E != 0) {
      er1 = min(r1 + E, hi_i);
      ec1 = min(c1 + E, hi_j);
    }
    for_rect(mp, max(r0 - 1 - E, lo_i), er1, max(c0 - 1 - E, lo_j), ec1,
             [&](int i, int j) {
               const Cell<T, O> x = cell(i, j);
               c.elf[x.q] = i >= 1 && i <= im - 2 && j >= 1 && j <= jm - 2
                                ? extpom::elf_interior(x) * x.r(s.fsm)
                                : extpom::elf_point(s, c, i, j);
               if (adv && i >= r0 - E && j >= c0 - E) {
                 extpom::adv_point(x, c.advua[x.q], c.advva[x.q]);
                 if constexpr (O & extpom::kMode2)
                   extpom::mode2_point(x, c.advua[x.q], c.advva[x.q],
                                       c.wubot[x.q], c.wvbot[x.q]);
               }
             });
    __syncthreads();
    // uaf/vaf over the free-surface faces; the domain's edge cells by
    // velocity_point (bc_vel2d or orl_vel2d)
    for_rect(mp, r0, r1, c0, c1, [&](int i, int j) {
      const Cell<T, O> x = cell(i, j);
      if (i >= 2 && i <= im - 2 && j >= 2 && j <= jm - 2) {
        c.uaf[x.q] = extpom::uaf_interior(x) * s.dum[x.p];
        c.vaf[x.q] = extpom::vaf_interior(x) * s.dvm[x.p];
      } else {
        extpom::velocity_point(s, c, i, j, c.uaf[x.q], c.vaf[x.q]);
      }
    });
    __syncthreads();
    for_rect(mp, r0, r1, c0, c1, [&](int i, int j) {
      const int p = extpom::pix(s, i, j), q = extpom::at(s, c, i, j);
      if (i >= i0 && i < ie && j >= j0 && j < je)
        extpom::accumulate(s, c, i, j, iext, isplit, cout + ETF * n,
                           cout + EGF * n, cout + UTF * n, cout + VTF * n);
      extpom::rotate(s, c, q);
      d[q] = s.h[p] + c.el[q];
    });
    __syncthreads();
  }
}

// Tiles cover rows [lo_i, hi_i) and columns [lo_j, hi_j): the domain, or
// the block (O).  The kernel is bound by the latency of its passes' loads
// (PERF.md §6), so the register cap is set for resident warps: 3 blocks of
// 512 threads per SM in f32 (40 registers), 2 in f64 (64 registers).
template <typename T, int O>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 4 ? 3 : 2)
    k_window(ExtArgs<T, O> s, const T* __restrict__ cin, T* __restrict__ cout,
             int iext0, int isplit, int ispadv, int nsub, int halo, int ti,
             int tj) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  constexpr bool B = O & extpom::kBlock;
  const int lo_i = B ? s.oi : 0, lo_j = B ? s.oj : 0;
  const int hi_i = B ? s.oi + s.R : s.im, hi_j = B ? s.oj + s.L : s.jm;
  const long n = B ? (long)s.R * s.L : (long)s.im * s.jm;
  const int i0 = lo_i + blockIdx.y * ti, j0 = lo_j + blockIdx.x * tj;
  const int ie = min(i0 + ti, hi_i), je = min(j0 + tj, hi_j);
  const int wr = ti + 2 * halo, wj = tj + 2 * halo, wn = wr * wj;

  Carry<T, true> c;
  c.el = sm;
  c.elb = sm + wn;
  c.ua = sm + 2 * wn;
  c.uab = sm + 3 * wn;
  c.va = sm + 4 * wn;
  c.vab = sm + 5 * wn;
  c.advua = sm + 6 * wn;
  c.advva = sm + 7 * wn;
  constexpr int nl = kLoaded<O>;
  if constexpr (O & extpom::kMode2) {
    c.wubot = sm + 8 * wn;
    c.wvbot = sm + 9 * wn;
  }
  c.elf = sm + nl * wn;
  T* d = sm + (nl + 1) * wn;
  T* asum = sm + (nl + 2) * wn;
  const Pool<T> pool{sm + (nl + 3) * wn, wn};
  c.uaf = pool[0];
  c.vaf = pool[1];
  c.oi = i0 - halo;
  c.oj = j0 - halo;
  c.stride = wj;
  c.i0 = max(i0 - halo, lo_i);
  c.i1 = min(ie + halo, hi_i);
  c.j0 = max(j0 - halo, lo_j);
  c.j1 = min(je + halo, hi_j);
  s.wubot = cin + WUBOT * n;
  s.wvbot = cin + WVBOT * n;
  const int rstep = blockDim.x / wj;
  const Map mp{c.oi, c.oj, (int)threadIdx.x / wj, (int)threadIdx.x % wj,
               rstep};

  // the window's carry and d = h + el (0 where the window may not be
  // read); the tps sums of aam2d on every cell of tps's region, zero-filled
  // as adv_tps reads (a block's edge tile forms a face one cell beyond the
  // block)
  for_rect(mp, c.oi, c.oi + wr, c.oj, c.oj + wj, [&](int i, int j) {
    const int q = extpom::at(s, c, i, j);
    asum[q] = i >= 1 && i < s.im && j >= 1 && j < s.jm
                  ? extpom::ld(s.aam2d, s, i, j) +
                        extpom::ld(s.aam2d, s, i, j - 1) +
                        extpom::ld(s.aam2d, s, i - 1, j) +
                        extpom::ld(s.aam2d, s, i - 1, j - 1)
                  : T(0);
    if (!extpom::in(s, c, i, j)) {
      d[q] = T(0);
      return;
    }
    const int p = extpom::pix(s, i, j);
#pragma unroll
    for (int k = 0; k < nl; ++k) sm[k * wn + q] = cin[loaded(k) * n + p];
    d[q] = s.h[p] + c.el[q];
  });
  // the tile's accumulators and (outside mode 2, where it is a window
  // field) bottom stress start from the input
  for_rect(mp, i0, ie, j0, je, [&](int i, int j) {
    const int p = extpom::pix(s, i, j);
#pragma unroll
    for (int k = ETF; k <= (nl > 8 ? VTF : WVBOT); ++k)
      if (k < ADVUA || k > ADVVA) cout[k * n + p] = cin[k * n + p];
  });
  __syncthreads();

  substeps(s, c, mp, d, asum, pool, cout, n, iext0, isplit, ispadv, nsub, i0,
           j0, ie, je, lo_i, lo_j, hi_i, hi_j);

  for_rect(mp, i0, ie, j0, je, [&](int i, int j) {
    const int p = extpom::pix(s, i, j), q = extpom::at(s, c, i, j);
#pragma unroll
    for (int k = 0; k < nl; ++k) cout[loaded(k) * n + p] = sm[k * wn + q];
  });
}

// ptr: carry buffers A and B (each the 14 carry fields of (im, jm), or
// (R, L) on a block (O), back to back, CARRY_FIELDS order; the input is in
// A), then the extpom::kExtOperands read-only operands.  Runs substeps
// iext0 .. iext0+total-1 of isplit as total/nsub launches of nsub each;
// launch ic reads one buffer and writes the other, so the result is in A
// when total/nsub is even and in B when it is odd.
template <typename T, int O>
int run(void* const* ptr, const double* prm, int im, int jm, int R, int L,
        int oi, int oj, int iext0, int total, int isplit, int ispadv,
        int nsub, int halo, int ti, int tj, int threads, void* stream) {
  if (nsub < 1 || total % nsub != 0 || iext0 < 1 ||
      iext0 + total - 1 > isplit || halo < kRadius<O> * nsub || ti < 1 ||
      tj < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      threads < tj + 2 * halo || R < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  T* a = (T*)ptr[0];
  T* b = (T*)ptr[1];
  ExtArgs<T, O> s;
  extpom::set_ext_args(s, ptr + 2, prm, im, jm);
  s.R = R;
  s.L = L;
  s.oi = oi;
  s.oj = oj;
  const size_t smem =
      sizeof(T) * kShared<O> * (size_t)(ti + 2 * halo) * (tj + 2 * halo);
  cudaError_t err = cudaFuncSetAttribute(
      k_window<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;

  cudaStream_t st = (cudaStream_t)stream;
  const int n = R * L;
  extpom::k_metrics<T, O><<<(n + 255) / 256, 256, 0, st>>>(s);
  err = cudaGetLastError();
  const dim3 grid((L + tj - 1) / tj, (R + ti - 1) / ti);
  for (int ic = 0; ic < total / nsub && err == cudaSuccess; ++ic) {
    k_window<T, O><<<grid, threads, smem, st>>>(s, a, b, iext0 + ic * nsub,
                                                isplit, ispadv, nsub, halo,
                                                ti, tj);
    err = cudaGetLastError();
    T* t = a;
    a = b;
    b = t;
  }
  return (int)err;
}

// What the compiler and the card give k_window (the block variant with
// blk, the options of `flags`) for `threads` threads and `smem` bytes of
// dynamic shared memory: column.cuh's tile_info.
template <typename T, int B>
int info(int flags, int threads, int smem, int* out) {
  return extpom::with_flags<B>(flags, [&](auto c) {
    return extpom::tile_info(k_window<T, decltype(c)::value>, threads, smem,
                             out);
  });
}

}  // namespace

// `flags`: the options kOrl | kMode2 (extstep.cuh)
extern "C" int extpom_extwin_info(int f64, int blk, int flags, int threads,
                                  int smem, void* out) {
  int* o = (int*)out;
  if (f64)
    return blk ? info<double, extpom::kBlock>(flags, threads, smem, o)
               : info<double, 0>(flags, threads, smem, o);
  return blk ? info<float, extpom::kBlock>(flags, threads, smem, o)
             : info<float, 0>(flags, threads, smem, o);
}

extern "C" int extpom_extwin_f32(void* const* ptr, const double* prm, int im,
                                 int jm, int isplit, int ispadv, int flags,
                                 int nsub, int halo, int ti, int tj,
                                 int threads, void* stream) {
  return extpom::with_flags<0>(flags, [&](auto c) {
    return run<float, decltype(c)::value>(ptr, prm, im, jm, im, jm, 0, 0, 1,
                                          isplit, isplit, ispadv, nsub, halo,
                                          ti, tj, threads, stream);
  });
}

extern "C" int extpom_extwin_f64(void* const* ptr, const double* prm, int im,
                                 int jm, int isplit, int ispadv, int flags,
                                 int nsub, int halo, int ti, int tj,
                                 int threads, void* stream) {
  return extpom::with_flags<0>(flags, [&](auto c) {
    return run<double, decltype(c)::value>(ptr, prm, im, jm, im, jm, 0, 0, 1,
                                           isplit, isplit, ispadv, nsub, halo,
                                           ti, tj, threads, stream);
  });
}

extern "C" int extpom_extwin_chunk_f32(void* const* ptr, const double* prm,
                                       int im, int jm, int R, int L, int total,
                                       int iext0, int oi, int oj, int isplit,
                                       int ispadv, int flags, int nsub,
                                       int halo, int ti, int tj, int threads,
                                       void* stream) {
  return extpom::with_flags<extpom::kBlock>(flags, [&](auto c) {
    return run<float, decltype(c)::value>(ptr, prm, im, jm, R, L, oi, oj,
                                          iext0, total, isplit, ispadv, nsub,
                                          halo, ti, tj, threads, stream);
  });
}

extern "C" int extpom_extwin_chunk_f64(void* const* ptr, const double* prm,
                                       int im, int jm, int R, int L, int total,
                                       int iext0, int oi, int oj, int isplit,
                                       int ispadv, int flags, int nsub,
                                       int halo, int ti, int tj, int threads,
                                       void* stream) {
  return extpom::with_flags<extpom::kBlock>(flags, [&](auto c) {
    return run<double, decltype(c)::value>(ptr, prm, im, jm, R, L, oi, oj,
                                           iext0, total, isplit, ispadv, nsub,
                                           halo, ti, tj, threads, stream);
  });
}
