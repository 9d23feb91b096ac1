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
// kernel reads the carry from device memory once per C substeps instead:
// the operation count, not the bytes, is then the least time.  As built it
// is no faster than the chain at 2048x2048 on an H100 (PERF.md §6): both
// still read the 33 read-only operands at every point of every substep.
//
// Design (simple first, not tuned):
//   * a block owns a ti x tj tile of the output and keeps the window of the
//     tile grown by a halo of H = 2C cells on each side in shared memory:
//     the eight carry fields that a substep reads at neighbours (el, elb,
//     ua, uab, va, vab, advua, advva) and the substep's elf, uaf, vaf;
//   * the read-only operands (grid, step-constant terms, forcing, the
//     metrics, which k_metrics computes once per call) are read from device
//     memory, where neighbouring blocks share them through L2;
//   * a substep's stencil radius is 2 (extstep.cuh), so after substep s of
//     C only the margin 2(C-1-s) around the tile is still needed: each
//     substep computes elf on that margin + 1 and everything else on that
//     margin, and reads no cell outside the window;
//   * the accumulators etf/egf/utf/vtf are read and written only on the
//     tile, in the output buffer, which no other block touches;
//   * blocks read their neighbours' halo from the input carry while others
//     write their tiles, so input and output are separate buffers that
//     swap between launches (ping-pong), where the chain updates in place.
// Every per-point value comes from the device functions of extstep.cuh, so
// the results equal the chain's and the plain loop's bit for bit.
//
// Where an off-by-one would hide, beyond extstep.cuh's list:
//   * a window cell outside the domain is never loaded or computed; reads
//     there give 0 through ldc/dd as sft does, and edge tiles apply
//     bc_el/bc_vel2d at the global (i, j) exactly as the chain does;
//   * iext of the chunk's first substep is ic*C + 1, so the ispadv branch,
//     the etf tail on substeps isplit-2..isplit (which may span two chunks)
//     and the last-substep skip of the accumulators follow the global
//     substep count.
//
// extpom_extwin_chunk_f32/f64, the same kernel on one ring-extended block of
// the decomposed step (the O variant of extstep.cuh), replace
// extpom_tpu/pallas/extwin.py:_kernel with has_off (via
// run_external_chunk_windowed), which stripes a ring-extended local block
// into windows.  The tiles cover the (R, L) block whose cell (0, 0) is
// global (oi, oj) instead of the domain; a window is bounded by the block,
// cells keep their global (i, j) for masks and boundary conditions, and a
// chunk of nsub substeps (one ring exchange) runs as nsub/C launches, the
// metrics computed once.  Bound as the whole-domain kernel: at 2048x2048 on
// a 2x4 mesh the extended block (1084x572) is 124 MB of working set, past
// the L2.

#include <cuda_runtime.h>

#include "extstep.cuh"

namespace {

using extpom::Carry;
using extpom::ExtArgs;

constexpr int kMaxThreads = 512;  // a block's threads, at most
constexpr int kShared = 11;       // window fields in shared memory

// carry field indices (CARRY_FIELDS order)
enum {
  EL, ELB, UA, UAB, VA, VAB, ETF, EGF, UTF, VTF, ADVUA, ADVVA, WUBOT, WVBOT
};

// carry field of the k-th shared-memory field, k < 8
__device__ __forceinline__ int loaded(int k) { return k < 6 ? k : k + 4; }

// f(i, j) on rows [r0, r1) x columns [c0, c1), the block's threads in turn
template <typename F>
__device__ __forceinline__ void for_rect(int r0, int r1, int c0, int c1,
                                         F f) {
  const int nc = c1 - c0, n = (r1 - r0) * nc;
  for (int q = threadIdx.x; q < n; q += blockDim.x) f(r0 + q / nc, c0 + q % nc);
}

// Tiles cover rows [lo_i, hi_i) and columns [lo_j, hi_j): the domain, or
// the block (O).
template <typename T, bool O>
__global__ void __launch_bounds__(kMaxThreads)
    k_window(ExtArgs<T, O> s, const T* __restrict__ cin, T* __restrict__ cout,
             int iext0, int isplit, int ispadv, int nsub, int halo, int ti,
             int tj) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const int lo_i = O ? s.oi : 0, lo_j = O ? s.oj : 0;
  // hi_i, hi_j; the domain's own extents when O is false, so that the
  // whole-domain kernel keeps its parent code
  const int im = O ? s.oi + s.R : s.im, jm = O ? s.oj + s.L : s.jm;
  const long n = O ? (long)s.R * s.L : (long)im * jm;
  const int i0 = lo_i + blockIdx.y * ti, j0 = lo_j + blockIdx.x * tj;
  const int ie = min(i0 + ti, im), je = min(j0 + tj, jm);
  const int wj = tj + 2 * halo, wn = (ti + 2 * halo) * wj;

  // shared memory: el, elb, ua, uab, va, vab, advua, advva (carry fields
  // k < 6 and 10, 11, loaded and stored), then elf, uaf, vaf
  Carry<T, true> c;
  c.el = sm;
  c.elb = sm + wn;
  c.ua = sm + 2 * wn;
  c.uab = sm + 3 * wn;
  c.va = sm + 4 * wn;
  c.vab = sm + 5 * wn;
  c.advua = sm + 6 * wn;
  c.advva = sm + 7 * wn;
  c.elf = sm + 8 * wn;
  c.uaf = sm + 9 * wn;
  c.vaf = sm + 10 * wn;
  c.oi = i0 - halo;
  c.oj = j0 - halo;
  c.stride = wj;
  c.i0 = max(i0 - halo, lo_i);
  c.i1 = min(ie + halo, im);
  c.j0 = max(j0 - halo, lo_j);
  c.j1 = min(je + halo, jm);
  s.wubot = cin + WUBOT * n;
  s.wvbot = cin + WVBOT * n;

  for_rect(c.i0, c.i1, c.j0, c.j1, [&](int i, int j) {
    const int p = extpom::pix(s, i, j), q = extpom::at(s, c, i, j);
#pragma unroll
    for (int k = 0; k < 8; ++k) sm[k * wn + q] = cin[loaded(k) * n + p];
  });
  // the tile's accumulators and bottom stress start from the input
  for_rect(i0, ie, j0, je, [&](int i, int j) {
    const int p = extpom::pix(s, i, j);
#pragma unroll
    for (int k = ETF; k <= WVBOT; ++k)
      if (k < ADVUA || k > ADVVA) cout[k * n + p] = cin[k * n + p];
  });
  __syncthreads();

  for (int sub = 0; sub < nsub; ++sub) {
    const int iext = iext0 + sub;
    const int m = 2 * (nsub - 1 - sub);  // margin still needed afterwards
    const int r0 = max(i0 - m, lo_i), r1 = min(ie + m, im);
    const int c0 = max(j0 - m, lo_j), c1 = min(je + m, jm);
    const bool adv = iext % ispadv == 0;
    // elf one cell further out: uaf and utf read it at i-1, vaf and vtf at
    // j-1
    for_rect(max(r0 - 1, lo_i), min(r1 + 1, im), max(c0 - 1, lo_j),
             min(c1 + 1, jm),
             [&](int i, int j) {
               const int q = extpom::at(s, c, i, j);
               c.elf[q] = extpom::elf_point(s, c, i, j);
               if (adv && i >= r0 && i < r1 && j >= c0 && j < c1)
                 extpom::adv_point(s, c, i, j, c.advua[q], c.advva[q]);
             });
    __syncthreads();
    for_rect(r0, r1, c0, c1, [&](int i, int j) {
      const int q = extpom::at(s, c, i, j);
      extpom::velocity_point(s, c, i, j, c.uaf[q], c.vaf[q]);
    });
    __syncthreads();
    for_rect(r0, r1, c0, c1, [&](int i, int j) {
      if (i >= i0 && i < ie && j >= j0 && j < je)
        extpom::accumulate(s, c, i, j, iext, isplit, cout + ETF * n,
                           cout + EGF * n, cout + UTF * n, cout + VTF * n);
      extpom::rotate(s, c, extpom::at(s, c, i, j));
    });
    __syncthreads();
  }

  for_rect(i0, ie, j0, je, [&](int i, int j) {
    const int p = extpom::pix(s, i, j), q = extpom::at(s, c, i, j);
#pragma unroll
    for (int k = 0; k < 8; ++k) cout[loaded(k) * n + p] = sm[k * wn + q];
  });
}

// ptr: carry buffers A and B (each the 14 carry fields of (im, jm), or
// (R, L) on a block (O), back to back, CARRY_FIELDS order; the input is in
// A), then the extpom::kExtOperands read-only operands.  Runs substeps
// iext0 .. iext0+total-1 of isplit as total/nsub launches of nsub each;
// launch ic reads one buffer and writes the other, so the result is in A
// when total/nsub is even and in B when it is odd.
template <typename T, bool O>
int run(void* const* ptr, const double* prm, int im, int jm, int R, int L,
        int oi, int oj, int iext0, int total, int isplit, int ispadv,
        int nsub, int halo, int ti, int tj, int threads, void* stream) {
  if (nsub < 1 || total % nsub != 0 || iext0 < 1 ||
      iext0 + total - 1 > isplit || halo < 2 * nsub || ti < 1 || tj < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || R < 1 ||
      L < 1)
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
      sizeof(T) * kShared * (size_t)(ti + 2 * halo) * (tj + 2 * halo);
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

}  // namespace

extern "C" int extpom_extwin_f32(void* const* ptr, const double* prm, int im,
                                 int jm, int isplit, int ispadv, int nsub,
                                 int halo, int ti, int tj, int threads,
                                 void* stream) {
  return run<float, false>(ptr, prm, im, jm, im, jm, 0, 0, 1, isplit, isplit,
                           ispadv, nsub, halo, ti, tj, threads, stream);
}

extern "C" int extpom_extwin_f64(void* const* ptr, const double* prm, int im,
                                 int jm, int isplit, int ispadv, int nsub,
                                 int halo, int ti, int tj, int threads,
                                 void* stream) {
  return run<double, false>(ptr, prm, im, jm, im, jm, 0, 0, 1, isplit, isplit,
                            ispadv, nsub, halo, ti, tj, threads, stream);
}

extern "C" int extpom_extwin_chunk_f32(void* const* ptr, const double* prm,
                                       int im, int jm, int R, int L, int total,
                                       int iext0, int oi, int oj, int isplit,
                                       int ispadv, int nsub, int halo, int ti,
                                       int tj, int threads, void* stream) {
  return run<float, true>(ptr, prm, im, jm, R, L, oi, oj, iext0, total,
                          isplit, ispadv, nsub, halo, ti, tj, threads, stream);
}

extern "C" int extpom_extwin_chunk_f64(void* const* ptr, const double* prm,
                                       int im, int jm, int R, int L, int total,
                                       int iext0, int oi, int oj, int isplit,
                                       int ispadv, int nsub, int halo, int ti,
                                       int tj, int threads, void* stream) {
  return run<double, true>(ptr, prm, im, jm, R, L, oi, oj, iext0, total,
                           isplit, ispadv, nsub, halo, ti, tj, threads,
                           stream);
}
