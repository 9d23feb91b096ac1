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
// Design (the simplest correct one): extpom_extloop_f32/f64 loop over
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
// there instead of being stored.  The per-point arithmetic, and the edge
// cases where an off-by-one would hide, are in extstep.cuh, which extwin.cu
// shares; built with -fmad=false so each operation rounds as the plain
// PyTorch version's does.  The carry order is CARRY_FIELDS of the TPU
// kernel (extloop.py:48).
//
// extpom_extchunk_f32/f64, the same chain on one ring-extended block of the
// decomposed step (the O variant of extstep.cuh), replace
// extpom_tpu/pallas/extloop.py:_chunk_kernel (via run_external_chunk_vmem),
// which runs C substeps on a ring-extended local block held whole in VMEM.
// They run substeps iext0 .. iext0+C-1 of isplit on the (R, L) block whose
// cell (0, 0) is global (oi, oj): masks and boundary conditions at global
// (i, j) against the global (im, jm), reads zero-filled outside the block,
// so the block's cells that the ring covers come out as the whole-domain
// chain gives them (kernels/extloop.py:run_external_chunk_plain is the
// plain version).  Bound as the chain: the extended block of the main path
// (188x124 at 256x256 on a 2x4 mesh) fits the L2 many times over.

#include <cuda_runtime.h>

#include "extstep.cuh"

namespace {

using extpom::Carry;
using extpom::ExtArgs;

template <typename T, bool O>
__global__ void k_surface(ExtArgs<T, O> s, Carry<T, false> c, int do_adv) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= extpom::cells(s)) return;
  int i, j;
  extpom::cell(s, p, i, j);
  c.elf[p] = extpom::elf_point(s, c, i, j);
  // advave reads d/ua/va/uab/vab only; advua/advva are read by nobody else
  // in this kernel
  if (do_adv) extpom::adv_point(s, c, i, j, c.advua[p], c.advva[p]);
}

template <typename T, bool O>
__global__ void k_velocity(ExtArgs<T, O> s, Carry<T, false> c) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= extpom::cells(s)) return;
  int i, j;
  extpom::cell(s, p, i, j);
  extpom::velocity_point(s, c, i, j, c.uaf[p], c.vaf[p]);
}

template <typename T, bool O>
__global__ void k_update(ExtArgs<T, O> s, Carry<T, false> c, T* etf, T* egf,
                         T* utf, T* vtf, int iext, int isplit) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= extpom::cells(s)) return;
  int i, j;
  extpom::cell(s, p, i, j);
  extpom::accumulate(s, c, i, j, iext, isplit, etf, egf, utf, vtf);
  extpom::rotate(s, c, p);
}

constexpr int kThreads = 256;

// ptr: the 14 carry fields (CARRY_FIELDS order, updated in place), the
// extpom::kExtOperands read-only operands, then elf/uaf/vaf scratch; all
// (im, jm), or (R, L) on a block (O).  Runs substeps iext0 .. iext0+nsub-1
// of isplit.
template <typename T, bool O>
int run(void* const* ptr, const double* prm, int im, int jm, int R, int L,
        int oi, int oj, int iext0, int nsub, int isplit, int ispadv,
        void* stream) {
  if (nsub < 1 || iext0 < 1 || iext0 + nsub - 1 > isplit || R < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  T* const* cf = (T* const*)ptr;
  ExtArgs<T, O> s;
  extpom::set_ext_args(s, ptr + 14, prm, im, jm);
  s.R = R;
  s.L = L;
  s.oi = oi;
  s.oj = oj;
  s.wubot = cf[12];
  s.wvbot = cf[13];
  T* const* scr = cf + 14 + extpom::kExtOperands;
  Carry<T, false> c{};  // whole arrays: indexed like the read-only fields
  c.el = cf[0]; c.elb = cf[1]; c.ua = cf[2]; c.uab = cf[3]; c.va = cf[4];
  c.vab = cf[5]; c.advua = cf[10]; c.advva = cf[11];
  c.elf = scr[0]; c.uaf = scr[1]; c.vaf = scr[2];

  cudaStream_t st = (cudaStream_t)stream;
  const int n = R * L;
  const int blocks = (n + kThreads - 1) / kThreads;
  extpom::k_metrics<T, O><<<blocks, kThreads, 0, st>>>(s);
  cudaError_t err = cudaGetLastError();
  for (int iext = iext0; iext < iext0 + nsub && err == cudaSuccess; ++iext) {
    k_surface<T, O><<<blocks, kThreads, 0, st>>>(s, c, iext % ispadv == 0);
    k_velocity<T, O><<<blocks, kThreads, 0, st>>>(s, c);
    k_update<T, O><<<blocks, kThreads, 0, st>>>(s, c, cf[6], cf[7], cf[8],
                                                 cf[9], iext, isplit);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

extern "C" int extpom_extloop_f32(void* const* ptr, const double* prm, int im,
                                  int jm, int isplit, int ispadv,
                                  void* stream) {
  return run<float, false>(ptr, prm, im, jm, im, jm, 0, 0, 1, isplit, isplit,
                           ispadv, stream);
}

extern "C" int extpom_extloop_f64(void* const* ptr, const double* prm, int im,
                                  int jm, int isplit, int ispadv,
                                  void* stream) {
  return run<double, false>(ptr, prm, im, jm, im, jm, 0, 0, 1, isplit, isplit,
                            ispadv, stream);
}

extern "C" int extpom_extchunk_f32(void* const* ptr, const double* prm, int im,
                                   int jm, int R, int L, int nsub, int iext0,
                                   int oi, int oj, int isplit, int ispadv,
                                   void* stream) {
  return run<float, true>(ptr, prm, im, jm, R, L, oi, oj, iext0, nsub, isplit,
                          ispadv, stream);
}

extern "C" int extpom_extchunk_f64(void* const* ptr, const double* prm, int im,
                                   int jm, int R, int L, int nsub, int iext0,
                                   int oi, int oj, int isplit, int ispadv,
                                   void* stream) {
  return run<double, true>(ptr, prm, im, jm, R, L, oi, oj, iext0, nsub,
                           isplit, ispadv, stream);
}
