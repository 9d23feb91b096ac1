// Vertical Thomas solve, one thread per (i, j) column.
//
// Replaces extpom_tpu/pallas/tridiag.py:_kernel (via thomas), which runs the
// same solve on VMEM blocks of 8192 columns on the TPU.  It serves the six
// implicit vertical solves of an internal step (proft x2, profu, profv,
// profq x2) through extpom_tpu_torch/ops/vertical.py:_solve.
//
// Bound on the H100: memory.  Per column the solve does ~11 flops per level
// on 4 inputs + 1 output of kb values each (4 kb + 6 + kb words), so at
// 256x256x31 it moves ~42 MB (f32) against ~22 Mflop: HBM time dominates by
// two orders of magnitude.
//
// Design: the (kb, im, jm) layout makes the column index the fastest axis,
// so one thread per column with a loop over k reads and writes every level
// coalesced (a warp touches 32 consecutive words of one level).  The
// elimination stacks ee/gg live in a (2, kb, n) scratch in the same
// column-fastest layout; at 256^2 x 31 they (16 MB f32) stay mostly in the
// 50 MB L2 between the forward and backward sweeps.  Any kb works.  Built
// with -fmad=false so each operation rounds as the plain PyTorch version's
// does.
//
// Semantics (must match _solve): ee/gg rows below k0-1 are zero; mask is
// applied at every back-substitution level (equal to masking once, mask is
// 0/1); rows > k_last are zero.  The solve itself is extpom::thomas_column
// (column.cuh), which the phase kernels call too.

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

template <typename T>
__global__ void thomas_kernel(const T* __restrict__ a, const T* __restrict__ c,
                              const T* __restrict__ den,
                              const T* __restrict__ rhs,
                              const T* __restrict__ ee0,
                              const T* __restrict__ gg0,
                              const T* __restrict__ cl,
                              const T* __restrict__ rb,
                              const T* __restrict__ db,
                              const T* __restrict__ mask, T* __restrict__ out,
                              T* __restrict__ ees, T* __restrict__ ggs, int kb,
                              int n, int k0, int k_last) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const long nn = n;
  // forward elimination and back substitution (solver.f:1650-1680 pattern)
  extpom::thomas_column<T>(
      [&](int k, T& ak, T& ck, T& dk, T& rk) {
        const long q = k * nn + p;
        ak = a[q];
        ck = c[q];
        dk = den[q];
        rk = rhs[q];
      },
      [&](int k, T f) { out[k * nn + p] = f; }, ee0[p], gg0[p], cl[p], rb[p],
      db[p], mask[p], ees, ggs, nn, p, k0, k_last);
  for (int k = k_last + 1; k < kb; ++k) out[k * nn + p] = T(0);
}

template <typename T>
int launch(const void* a, const void* c, const void* den, const void* rhs,
           const void* ee0, const void* gg0, const void* cl, const void* rb,
           const void* db, const void* mask, void* out, void* ees, void* ggs,
           int kb, int n, int k0, int k_last, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  thomas_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)a, (const T*)c, (const T*)den, (const T*)rhs, (const T*)ee0,
      (const T*)gg0, (const T*)cl, (const T*)rb, (const T*)db,
      (const T*)mask, (T*)out, (T*)ees, (T*)ggs, kb, n, k0, k_last);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int extpom_tridiag_f32(const void* a, const void* c,
                                  const void* den, const void* rhs,
                                  const void* ee0, const void* gg0,
                                  const void* cl, const void* rb,
                                  const void* db, const void* mask, void* out,
                                  void* ees, void* ggs, int kb, int n, int k0,
                                  int k_last, void* stream) {
  return launch<float>(a, c, den, rhs, ee0, gg0, cl, rb, db, mask, out, ees,
                       ggs, kb, n, k0, k_last, stream);
}

extern "C" int extpom_tridiag_f64(const void* a, const void* c,
                                  const void* den, const void* rhs,
                                  const void* ee0, const void* gg0,
                                  const void* cl, const void* rb,
                                  const void* db, const void* mask, void* out,
                                  void* ees, void* ggs, int kb, int n, int k0,
                                  int k_last, void* stream) {
  return launch<double>(a, c, den, rhs, ee0, gg0, cl, rb, db, mask, out, ees,
                        ggs, kb, n, k0, k_last, stream);
}
