// Device helpers shared by the column kernels: the zero-filled neighbour
// read of ops/stencil.py:sft and the Thomas solve of one column.
//
// Layout: 3-D fields are (kb, im, jm) with the column index p = i*jm + j
// fastest, so level k of column p is a[k*n + p] (n = im*jm) and a warp of
// consecutive columns reads one level coalesced.
//
// Counterparts in the JAX package: extpom_tpu/ops/stencil.py sft/sfk (the
// zero fill) and extpom_tpu/pallas/tridiag.py:_kernel (the solve).

#pragma once

#include <cuda_runtime.h>

namespace extpom {

// Extents of a (kb, im, jm) field.
struct Geom {
  int kb, im, jm;
  long n;  // im * jm
};

// Zero-filled read of a 2-D (im, jm) field: sft semantics, 0 outside the
// array, never a clamped edge value.
template <typename T>
__device__ __forceinline__ T ld2(const T* a, int im, int jm, int i, int j) {
  return (i >= 0 && i < im && j >= 0 && j < jm) ? a[(long)i * jm + j] : T(0);
}

template <typename T>
__device__ __forceinline__ T ld2(const T* a, const Geom& g, int i, int j) {
  return ld2(a, g.im, g.jm, i, j);
}

// Zero-filled read of level k of a (kb, im, jm) field (sfk reads 0 above
// level 0 and below level kb-1).
template <typename T>
__device__ __forceinline__ T ld3(const T* a, const Geom& g, int k, int i,
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

}  // namespace extpom
