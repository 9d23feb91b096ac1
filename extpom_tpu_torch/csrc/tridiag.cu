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
// coalesced (a warp touches 32 consecutive words of one level).
//   * The elimination stacks ee/gg live in shared memory, kb rows of the
//     block's columns each (stride = threads per block): the forward sweep
//     writes them and the back substitution of the same thread reads them,
//     so they never reach device memory and need no barrier.  The wrapper
//     picks the threads per block by kb and dtype so that two blocks fit an
//     SM (kernels/tridiag.py:block_threads).
//   * The four coefficients of the levels ahead are staged by cp.async,
//     kStages-1 levels ahead of the level the forward sweep eliminates,
//     into a ring of the thread's own slots: the loads do not wait on the
//     recurrence.
//   * The 2-D operands are read through a (row, column) stride each, 0
//     along an axis they are broadcast on, so a scalar or a row is read
//     where the caller keeps it and never copied.
// Any kb whose stacks fit a block works.  Built with -fmad=false so each
// operation rounds as the plain PyTorch version's does.
//
// Semantics (must match _solve): ee/gg rows below k0-1 are zero; mask is
// applied at every back-substitution level (equal to masking once, mask is
// 0/1); rows > k_last are zero.  The solve itself is extpom::thomas_column
// (column.cuh), which the phase kernels call too.

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

constexpr int kMaxThreads = 256;
// coefficient levels in the ring: level k read, k+1 .. k+kStages-1 in
// flight (kernels/tridiag.py:block_threads reads this constant)
constexpr int kStages = 8;
constexpr int kTwo = 6;  // ee0, gg0, cl, rb, db, mask

// the 2-D operands and their element strides along i and j
template <typename T>
struct Two {
  const T* x[kTwo];
  long si[kTwo], sj[kTwo];
};

// shared elements of a block of `threads` columns: ee and gg, kb rows
// each, then the ring of four coefficients
__host__ __device__ inline int smem_elems(int kb, int threads) {
  return (2 * kb + 4 * kStages) * threads;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    thomas_kernel(const T* __restrict__ a, const T* __restrict__ c,
                  const T* __restrict__ den, const T* __restrict__ rhs,
                  Two<T> two, T* __restrict__ out, int kb, int im, int jm,
                  int k0, int k_last) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int nt = blockDim.x, t = threadIdx.x;
  const long n = (long)im * jm;
  const long p = (long)blockIdx.x * nt + t;
  if (p >= n) return;  // no barrier below: every slot is the thread's own
  const long i = p / jm, j = p - i * jm;
  T* const ees = sm;
  T* const ggs = sm + kb * nt;
  T* const ring = sm + 2 * kb * nt;
  auto two2 = [&](int w) { return two.x[w][i * two.si[w] + j * two.sj[w]]; };
  auto stage = [&](int k) {
    if (k < k_last) {
      T* const d = ring + (k % kStages) * 4 * nt + t;
      const long q = k * n + p;
      extpom::cp_async(d, a + q, true);
      extpom::cp_async(d + nt, c + q, true);
      extpom::cp_async(d + 2 * nt, den + q, true);
      extpom::cp_async(d + 3 * nt, rhs + q, true);
    }
    extpom::cp_async_commit();
  };
  for (int k = k0; k < k0 + kStages - 1; ++k) stage(k);
  // forward elimination and back substitution (solver.f:1650-1680 pattern)
  extpom::thomas_column<T>(
      [&](int k, T& ak, T& ck, T& dk, T& rk) {
        extpom::cp_async_wait<kStages - 2>();
        stage(k + kStages - 1);  // into the slot of level k-1, read already
        const T* const d = ring + (k % kStages) * 4 * nt + t;
        ak = d[0];
        ck = d[nt];
        dk = d[2 * nt];
        rk = d[3 * nt];
      },
      [&](int k, T f) { out[k * n + p] = f; }, two2(0), two2(1), two2(2),
      two2(3), two2(4), two2(5), ees, ggs, nt, t, k0, k_last);
  for (int k = k_last + 1; k < kb; ++k) out[k * n + p] = T(0);
}

// ptr: a, c, den, rhs, the six 2-D operands, out; strides: (i, j) element
// strides of the six 2-D operands
template <typename T>
int launch(void* const* ptr, const long long* strides, int kb, int im, int jm,
           int k0, int k_last, int threads, void* stream) {
  const long n = (long)im * jm;
  const int smem = smem_elems(kb, threads) * (int)sizeof(T);
  if (threads < 32 || threads % 32 || threads > kMaxThreads || n < 1 ||
      !(1 <= k0 && k0 < k_last && k_last < kb))
    return (int)cudaErrorInvalidValue;
  Two<T> two;
  for (int w = 0; w < kTwo; ++w) {
    two.x[w] = (const T*)ptr[4 + w];
    two.si[w] = (long)strides[2 * w];
    two.sj[w] = (long)strides[2 * w + 1];
  }
  cudaError_t e = cudaFuncSetAttribute(
      thomas_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (int)((n + threads - 1) / threads);
  thomas_kernel<T><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)ptr[0], (const T*)ptr[1], (const T*)ptr[2], (const T*)ptr[3],
      two, (T*)ptr[10], kb, im, jm, k0, k_last);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int extpom_tridiag_f32(void* const* ptr, const long long* strides,
                                  int kb, int im, int jm, int k0, int k_last,
                                  int threads, void* stream) {
  return launch<float>(ptr, strides, kb, im, jm, k0, k_last, threads, stream);
}

extern "C" int extpom_tridiag_f64(void* const* ptr, const long long* strides,
                                  int kb, int im, int jm, int k0, int k_last,
                                  int threads, void* stream) {
  return launch<double>(ptr, strides, kb, im, jm, k0, k_last, threads,
                        stream);
}

// registers, static and dynamic shared bytes, resident blocks per SM, spill
// bytes and SMs of the kernel (column.cuh tile_info) with `threads` columns
// per block at kb levels
extern "C" int extpom_tridiag_info(int f64, int threads, int kb, int* out) {
  return f64 ? extpom::tile_info(thomas_kernel<double>, threads,
                                 smem_elems(kb, threads) * 8, out)
             : extpom::tile_info(thomas_kernel<float>, threads,
                                 smem_elems(kb, threads) * 4, out);
}
