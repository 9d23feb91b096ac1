// Device helpers shared by the column kernels: the zero-filled neighbour
// read of ops/stencil.py:sft, the Thomas solve of one column, and the
// column tiles of the lat, tke, tracer and mom kernels (level staging by
// cp.async).
//
// Layout: 3-D fields are (kb, im, jm) with the column index p = i*jm + j
// fastest, so level k of column p is a[k*n + p] (n = im*jm) and a warp of
// consecutive columns reads one level coalesced.  (i, j) below are array
// indices; GeomT says how they map onto the domain.
//
// Counterparts in the JAX package: extpom_tpu/ops/stencil.py sft/sfk (the
// zero fill) and extpom_tpu/pallas/tridiag.py:_kernel (the solve).

#pragma once

#include <cuda_runtime.h>

namespace extpom {

// Extents of a (kb, im, jm) field: the domain, or (O, "offset") one
// ring-extended block of it in the decomposed step.  On a block the arrays
// are (kb, R, L) (im, jm below), array cell (0, 0) is global (oi, oj) of
// the (gim, gjm) domain, region tests and boundary conditions use the
// global (i, j) (gi, gj, GI, GJ), and neighbour reads stay in the block: a
// launch skips the cells within (mi, mj) of a split edge of the block, so
// that its unguarded neighbour reads land inside it, and the zero-filled
// reads below fill 0 outside the block, as sft reads on the block.  The
// skipped cells lie in the ring, whose cells the caller trims.  O is a
// template parameter so that the whole-domain kernels compile to the code
// they had without it.
template <bool O = false>
struct GeomT {
  int kb, im, jm;
  long n;  // im * jm
  int gim, gjm, oi, oj, mi, mj;

  __device__ __forceinline__ int gi(int i) const {
    if constexpr (O) return i + oi;
    return i;
  }
  __device__ __forceinline__ int gj(int j) const {
    if constexpr (O) return j + oj;
    return j;
  }
  __device__ __forceinline__ int GI() const {
    if constexpr (O) return gim;
    return im;
  }
  __device__ __forceinline__ int GJ() const {
    if constexpr (O) return gjm;
    return jm;
  }
  // array row of global row i, array column of global column j
  __device__ __forceinline__ int li(int i) const {
    if constexpr (O) return i - oi;
    return i;
  }
  __device__ __forceinline__ int lj(int j) const {
    if constexpr (O) return j - oj;
    return j;
  }
  // whether a launch leaves array cell (i, j) alone
  __device__ __forceinline__ bool skip(int i, int j) const {
    if constexpr (O) return i < mi || i >= im - mi || j < mj || j >= jm - mj;
    return false;
  }
};

using Geom = GeomT<false>;

// The geometry of a launch: the domain, or (O) the (R, L) block at global
// (oi, oj) of the (im, jm) domain, skipping `margin` cells along each axis
// on which the block is not the whole domain.
template <bool O>
GeomT<O> geometry(int kb, int im, int jm, int R, int L, int oi, int oj,
                  int margin) {
  if constexpr (!O) return GeomT<O>{kb, im, jm, (long)im * jm, im, jm, 0, 0,
                                    0, 0};
  const int mi = (oi == 0 && R == im) ? 0 : margin;
  const int mj = (oj == 0 && L == jm) ? 0 : margin;
  return GeomT<O>{kb, R, L, (long)R * L, im, jm, oi, oj, mi, mj};
}

// Zero-filled read of a 2-D (im, jm) field: sft semantics, 0 outside the
// array, never a clamped edge value.
template <typename T>
__device__ __forceinline__ T ld2(const T* a, int im, int jm, int i, int j) {
  return (i >= 0 && i < im && j >= 0 && j < jm) ? a[(long)i * jm + j] : T(0);
}

template <typename T, bool O>
__device__ __forceinline__ T ld2(const T* a, const GeomT<O>& g, int i, int j) {
  return ld2(a, g.im, g.jm, i, j);
}

// Zero-filled read of level k of a (kb, im, jm) field (sfk reads 0 above
// level 0 and below level kb-1).
template <typename T, bool O>
__device__ __forceinline__ T ld3(const T* a, const GeomT<O>& g, int k, int i,
                                 int j) {
  return (k >= 0 && k < g.kb && i >= 0 && i < g.im && j >= 0 && j < g.jm)
             ? a[k * g.n + (long)i * g.jm + j]
             : T(0);
}

// Zero-filled read of level k of a (kb,) profile (sfk on grid.zz3).
template <typename T>
__device__ __forceinline__ T ld1(const T* a, int kb, int k) {
  return (k >= 0 && k < kb) ? a[k] : T(0);
}

// Thomas solve of column p (kernels/tridiag.py:thomas_plain):
//   forward elimination from the seeds (ee, gg) at level k0-1, for
//   k0 <= k < k_last:  g = 1/(a + c (1 - ee) - den); ee = a g;
//   gg = (rhs + c gg) g,
//   the closed-form bottom row
//   f[k_last] = (cl gg + rb) / (cl (1 - ee) + db) * mask,
//   and back substitution f[k] = (ee[k] f + gg[k]) * mask down to k = 0.
// The ee/gg rows below k0-1 are zero (the q2l solve back-substitutes
// through them).  coef(k, a, c, den, rhs) yields level k's coefficients and
// is called once per level in ascending k; out(k, f) receives the solution,
// level k_last first.  ees/ggs are (kb, n) scratch in the column-fastest
// layout.  mask is 0 or 1, so masking every level equals masking the stack
// once as the plain version does.
template <typename T, typename Coef, typename Out>
__device__ __forceinline__ void thomas_column(Coef coef, Out out, T ee, T gg,
                                              T cl, T rb, T db, T mask,
                                              T* ees, T* ggs, long n, long p,
                                              int k0, int k_last) {
  const T one = T(1);
  for (int k = 0; k < k0 - 1; ++k) {
    ees[k * n + p] = T(0);
    ggs[k * n + p] = T(0);
  }
  ees[(k0 - 1) * n + p] = ee;
  ggs[(k0 - 1) * n + p] = gg;
  for (int k = k0; k < k_last; ++k) {
    T a, c, den, rhs;
    coef(k, a, c, den, rhs);
    const T g = one / (a + c * (one - ee) - den);
    ee = a * g;
    gg = (rhs + c * gg) * g;
    ees[k * n + p] = ee;
    ggs[k * n + p] = gg;
  }
  // ee/gg hold row k_last-1 here
  T f = (cl * gg + rb) / (cl * (one - ee) + db) * mask;
  out(k_last, f);
  for (int k = k_last - 1; k >= 0; --k) {
    const long q = k * n + p;
    f = (ees[q] * f + ggs[q]) * mask;
    out(k, f);
  }
}

// ---- column tiles (phase_lat.cu, phase_tke.cu, phase_tracer.cu,
// phase_mom.cu) ----
//
// A block owns a TI x TJ tile of columns, one thread each (t = ti*TJ + tj,
// TJ along the contiguous j), and walks k once.  Level by level it stages
// the planes of the fields read at a neighbour into shared memory as a
// (TI+2) x (TJ+2) window (the tile and a one-cell halo, 0 outside the
// array as sft reads), and the planes read only at the own column as
// TI x TJ, with cp.async a couple of levels ahead of the level it computes.
// The tiles are row-major over the array; `grid` blocks walk them, so
// device scratch per block (ee/gg of the Thomas solves) is sized by the
// blocks that run at once, not by the grid of columns.
struct Tiles {
  int TI, TJ;     // tile rows and columns (TJ a multiple of 32)
  int nj, count;  // tiles along j, tiles in all
};

// the window cells a thread stages: window cell t + m*threads for
// m < kWindowCells (a TJ >= 32 tile has fewer than 4*threads of them)
constexpr int kWindowCells = 4;
constexpr int kBeyond = -2;   // past the window's last cell
constexpr int kOutside = -1;  // outside the array: staged as 0

// Array offset (i*jm + j) of each window cell thread t stages, kOutside or
// kBeyond; the window's cell (0, 0) is array cell (i0-1, j0-1).
__device__ __forceinline__ void window_cells(int* off, int t, int threads,
                                             int i0, int j0, int TI, int TJ,
                                             int im, int jm) {
  const int HJ = TJ + 2, HC = (TI + 2) * HJ;
#pragma unroll
  for (int m = 0; m < kWindowCells; ++m) {
    const int c = t + m * threads;
    const int i = i0 - 1 + c / HJ, j = j0 - 1 + c % HJ;
    off[m] = c >= HC ? kBeyond
             : (i >= 0 && i < im && j >= 0 && j < jm) ? i * jm + j
                                                      : kOutside;
  }
}

// Asynchronous copy of one element from device to shared memory (cp.async:
// no register holds it, and the thread goes on); ok false stores 0.  The
// host pass of nvcc, and a host build of the kernel source, copy at once.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool ok) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"((int)sizeof(T)), "r"(ok ? (int)sizeof(T) : 0)
               : "memory");
#else
  *dst = ok ? *src : T(0);
#endif
}

// close the group of copies issued since the last commit
__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait for every committed group (a __syncthreads must follow before other
// threads' copies are read)
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// wait until at most N committed groups are still in flight (the thread's
// own copies of the older groups have landed)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// Stage one plane (level base) of a field into a window of shared memory.
template <typename T>
__device__ __forceinline__ void stage_window(T* dst, const T* plane,
                                             const int* off, int t,
                                             int threads) {
#pragma unroll
  for (int m = 0; m < kWindowCells; ++m) {
    if (off[m] == kBeyond) continue;
    const bool ok = off[m] >= 0;
    cp_async(dst + t + m * threads, ok ? plane + off[m] : plane, ok);
  }
}

// Stage one plane of a field into a window with a `halo`-cell margin,
// (TI + 2 halo) x (TJ + 2 halo) cells from array cell (i0-halo, j0-halo),
// 0 outside the array; for planes staged once per tile.
template <typename T>
__device__ __forceinline__ void stage_halo(T* dst, const T* plane, int t,
                                           int threads, int i0, int j0,
                                           int TI, int TJ, int halo, int im,
                                           int jm) {
  const int HJ = TJ + 2 * halo, HC = (TI + 2 * halo) * HJ;
  for (int c = t; c < HC; c += threads) {
    const int i = i0 - halo + c / HJ, j = j0 - halo + c % HJ;
    const bool ok = i >= 0 && i < im && j >= 0 && j < jm;
    cp_async(dst + c, ok ? plane + (long)i * jm + j : plane, ok);
  }
}

// Stage the own column's value of one plane into the thread's slot dst (0
// for a thread past the array's edge).
template <typename T>
__device__ __forceinline__ void stage_own(T* dst, const T* plane, long p,
                                          bool in) {
  cp_async(dst, in ? plane + p : plane, in);
}

// What the compiler and the card give a tile kernel: out = registers per
// thread, static shared bytes, dynamic shared bytes, resident blocks per
// SM, local (spill) bytes per thread, SMs of the current device.
template <typename Kernel>
int tile_info(Kernel kernel, int threads, int smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  out[4] = (int)a.localSizeBytes;
  out[5] = sms;
  return 0;
}

// ---- Orlanski radiation (bc/orlanski.py) ----

// Orlanski phase speed (fb - ff) / (ff + fb - 2 f_i), a zero denominator
// read as 0.01, clamped to [0, 1] (a NaN passes through, as torch.clamp
// lets it)
template <typename T>
__device__ __forceinline__ T phase_speed(T ff_b, T fb_b, T f_i) {
  T denom = ff_b + fb_b - T(2) * f_i;
  denom = denom == T(0) ? T(0.01) : denom;
  const T x = (fb_b - ff_b) / denom;
  return x != x ? x : (x < T(0) ? T(0) : (x > T(1) ? T(1) : x));
}

// radiated value (fb (1 - cl) + 2 cl f_in) / (1 + cl)
template <typename T>
__device__ __forceinline__ T radiate(T cl, T fb, T f_in) {
  return (fb * (T(1) - cl) + T(2) * cl * f_in) / (T(1) + cl);
}

}  // namespace extpom
