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

#include <cuda_runtime.h>

#include "extstep.cuh"

namespace {

using extpom::Carry;
using extpom::ExtArgs;

template <typename T>
__global__ void k_surface(ExtArgs<T> s, Carry<T, false> c, int do_adv) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= s.im * s.jm) return;
  const int i = p / s.jm, j = p % s.jm;
  c.elf[p] = extpom::elf_point(s, c, i, j);
  // advave reads d/ua/va/uab/vab only; advua/advva are read by nobody else
  // in this kernel
  if (do_adv) extpom::adv_point(s, c, i, j, c.advua[p], c.advva[p]);
}

template <typename T>
__global__ void k_velocity(ExtArgs<T> s, Carry<T, false> c) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= s.im * s.jm) return;
  extpom::velocity_point(s, c, p / s.jm, p % s.jm, c.uaf[p], c.vaf[p]);
}

template <typename T>
__global__ void k_update(ExtArgs<T> s, Carry<T, false> c, T* etf, T* egf,
                         T* utf, T* vtf, int iext, int isplit) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= s.im * s.jm) return;
  extpom::accumulate(s, c, p / s.jm, p % s.jm, iext, isplit, etf, egf, utf,
                     vtf);
  extpom::rotate(s, c, p);
}

constexpr int kThreads = 256;

// ptr: the 14 carry fields (CARRY_FIELDS order, updated in place), the
// extpom::kExtOperands read-only operands, then elf/uaf/vaf scratch
template <typename T>
int run(void* const* ptr, const double* prm, int im, int jm, int isplit,
        int ispadv, void* stream) {
  T* const* cf = (T* const*)ptr;
  ExtArgs<T> s;
  extpom::set_ext_args(s, ptr + 14, prm, im, jm);
  s.wubot = cf[12];
  s.wvbot = cf[13];
  T* const* scr = cf + 14 + extpom::kExtOperands;
  Carry<T, false> c{};  // whole arrays: indexed like the read-only fields
  c.el = cf[0]; c.elb = cf[1]; c.ua = cf[2]; c.uab = cf[3]; c.va = cf[4];
  c.vab = cf[5]; c.advua = cf[10]; c.advva = cf[11];
  c.elf = scr[0]; c.uaf = scr[1]; c.vaf = scr[2];

  cudaStream_t st = (cudaStream_t)stream;
  const int n = im * jm;
  const int blocks = (n + kThreads - 1) / kThreads;
  extpom::k_metrics<T><<<blocks, kThreads, 0, st>>>(s);
  cudaError_t err = cudaGetLastError();
  for (int iext = 1; iext <= isplit && err == cudaSuccess; ++iext) {
    k_surface<T><<<blocks, kThreads, 0, st>>>(s, c, iext % ispadv == 0);
    k_velocity<T><<<blocks, kThreads, 0, st>>>(s, c);
    k_update<T><<<blocks, kThreads, 0, st>>>(s, c, cf[6], cf[7], cf[8], cf[9],
                                              iext, isplit);
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
