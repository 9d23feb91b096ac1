// Compensated float64 sums of a print's diagnostics, one pass over the state.
//
// Replaces, on the card, the padded TwoSum tree that diag/stats.py:_csum2
// runs once per sum (one launch per level of the tree, 28 levels at
// 2048x2048x41, over float64 copies of every operand).  The JAX package's
// domain_stats (extpom_tpu/diag/stats.py) is plain jnp code; there is no
// Pallas counterpart.
//
// Bound on the H100: memory.  A print reads five 2-D fields (dx, dy, fsm, h,
// et) and five 3-D fields over kbm1 levels (rho, tb, sb, u, v) once: 3.44 GB
// in f32 at 2048x2048x41, 1.03 ms at 3.35 TB/s.  The float64 work is ~45
// operations a cell (the products, then five TwoSum additions), ~0.5 ms at
// the card's unfused f64 rate, so it hides under the loads.
//
// Design:
//   * k_diag_sums: one thread per (i, j) column of the active box (grid-
//     stride over the box, j fastest, so a warp reads one level coalesced),
//     one wave of resident blocks.  A column's 2-D values are read once;
//     its levels are walked in batches whose loads are all issued before
//     the first is used.  Each thread keeps seven (sum, error) float64
//     pairs, each addition by Knuth's TwoSum as _csum2 does; the block
//     combines its threads' pairs by TwoSum in a fixed tree in shared memory
//     and writes them as one row of a [rows, 7, 2] partials buffer.
//   * k_diag_finish: one block combines the rows in a fixed order and
//     writes the seven pairs, the eight values of domain_stats and nothing
//     else.  No atomics: the result is the same bit for bit from call to
//     call.
// Each cell's value is formed in float64 from the converted inputs in the
// order domain_stats forms it (darea = dx*dy*fsm, dvol = (darea*(h+et))*dz,
// dmass = dvol*(rho*rhoref + 1000), ke = dmass*(u*u + v*v)); built with
// -fmad=false, so no product is contracted and each value equals the plain
// path's bit for bit.  Only the order of the additions differs.
//
// Regions (diag/stats.py:_regions) arrive as five local rectangles of the
// array, clipped to it as _cells clips them: the interior, then the south,
// north, west and east edges without the corners.  The edge sums (atot,
// eavg, vtot, tavg, stot) take all five, mtot the interior, ekin half the
// interior and the north and east edges.  A block of a decomposed model
// passes its own rectangles (kernels/diagsum.py:pack).

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

constexpr int kSums = 7;  // atot, eavg, vtot, mtot, tavg, stot, ekin
enum { kAtot, kEavg, kVtot, kMtot, kTavg, kStot, kEkin };
constexpr int kPair = 2 * kSums;    // a row of the partials buffer
constexpr int kThreads = 256;       // both kernels; a power of two
constexpr int kRects = 5;           // interior, south, north, west, east
constexpr int kTwo = 5, kThree = 5;  // dx dy fsm h et; rho tb sb u v

template <typename T>
struct Operands {
  const T* two[kTwo];
  long si2[kTwo], sj2[kTwo];
  const T* three[kThree];
  long sk3[kThree], si3[kThree], sj3[kThree];
  const T* dz;
  long sdz;
};

// the active box of the array and the five rectangles, each [i0, i1) x
// [j0, j1) in array cells
struct Regions {
  int i0, i1, j0, j1;
  int r[kRects][4];
};

// (s, c) += x: Knuth's TwoSum, as _csum2 adds two values
__device__ __forceinline__ void add(double& s, double& c, double x) {
  const double t = s + x;
  const double bv = t - s;
  c += (s - (t - bv)) + (x - bv);
  s = t;
}

// (s, c) += (s2, c2): TwoSum of the sums, the errors added plainly, as
// _csum2 combines two halves
__device__ __forceinline__ void combine(double& s, double& c, double s2,
                                        double c2) {
  const double t = s + s2;
  const double bv = t - s;
  const double e = (s - (t - bv)) + (s2 - bv);
  c = (c + c2) + e;
  s = t;
}

// Combine every thread's pairs in red[kPair][kThreads] into red[.][0], in a
// fixed tree.  Every thread of the block calls it.
__device__ __forceinline__ void block_combine(double (*red)[kThreads],
                                              int t) {
#pragma unroll 1
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    __syncthreads();
    if (t < w) {
#pragma unroll
      for (int q = 0; q < kSums; ++q)
        combine(red[2 * q][t], red[2 * q + 1][t], red[2 * q][t + w],
                red[2 * q + 1][t + w]);
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ double wide(T x) {
  return static_cast<double>(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k_diag_sums(Operands<T> op, Regions g, double rhoref, int nk,
                double* __restrict__ part) {
  // levels whose loads are issued together: 40 (f32) or 20 (f64) loads
  constexpr int kBatch = sizeof(T) == 4 ? 8 : 4;
  __shared__ double red[kPair][kThreads];
  const int t = threadIdx.x;
  double s[kSums], c[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) s[q] = c[q] = 0.0;
  const int wj = g.j1 - g.j0;
  const long cols = (long)(g.i1 - g.i0) * wj;
  const long stride = (long)gridDim.x * kThreads;
  for (long p = (long)blockIdx.x * kThreads + t; p < cols; p += stride) {
    const int i = g.i0 + (int)(p / wj), j = g.j0 + (int)(p % wj);
    bool in[kRects];
#pragma unroll
    for (int r = 0; r < kRects; ++r)
      in[r] = i >= g.r[r][0] && i < g.r[r][1] && j >= g.r[r][2] &&
              j < g.r[r][3];
    const bool inner = in[0];
    if (!(inner || in[1] || in[2] || in[3] || in[4])) continue;  // corners
    const bool has_ke = inner || in[2] || in[4];  // interior, north, east
    auto two = [&](int f) {
      return wide(__ldg(op.two[f] + i * op.si2[f] + j * op.sj2[f]));
    };
    const double et = two(4);
    const double darea = two(0) * two(1) * two(2);
    const double dt2 = two(3) + et;
    add(s[kAtot], c[kAtot], darea);
    add(s[kEavg], c[kEavg], et * darea);
    const double col = darea * dt2;
    long at[kThree];
#pragma unroll
    for (int f = 0; f < kThree; ++f) at[f] = i * op.si3[f] + j * op.sj3[f];
#pragma unroll 1
    for (int k0 = 0; k0 < nk; k0 += kBatch) {
      T x[kBatch][kThree];
      T dz[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int k = k0 + b < nk ? k0 + b : nk - 1;
#pragma unroll
        for (int f = 0; f < kThree; ++f)
          x[b][f] = __ldg(op.three[f] + at[f] + k * op.sk3[f]);
        dz[b] = __ldg(op.dz + k * op.sdz);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (k0 + b >= nk) break;
        const double dvol = col * wide(dz[b]);
        add(s[kVtot], c[kVtot], dvol);
        const double dmass = dvol * (wide(x[b][0]) * rhoref + 1000.0);
        if (inner) add(s[kMtot], c[kMtot], dmass);
        add(s[kTavg], c[kTavg], wide(x[b][1]) * dvol);
        add(s[kStot], c[kStot], wide(x[b][2]) * dvol);
        if (has_ke) {
          const double u = wide(x[b][3]), v = wide(x[b][4]);
          const double ke = dmass * (u * u + v * v);
          add(s[kEkin], c[kEkin], inner ? 0.5 * ke : ke);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kSums; ++q) {
    red[2 * q][t] = s[q];
    red[2 * q + 1][t] = c[q];
  }
  block_combine(red, t);
  if (t < kPair) part[(long)blockIdx.x * kPair + t] = red[t][0];
}

// total of a pair, as _csum gives it
__device__ __forceinline__ double total(const double* pair) {
  return pair[0] + pair[1];
}

// a mean with domain_stats' guard for a zero divisor
__device__ __forceinline__ double mean(double num, double den) {
  return den != 0.0 ? num / den : 0.0;
}

__global__ void __launch_bounds__(kThreads)
    k_diag_finish(const double* __restrict__ part, int rows,
                  double* __restrict__ out) {
  __shared__ double red[kPair][kThreads];
  const int t = threadIdx.x;
  double s[kSums], c[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) s[q] = c[q] = 0.0;
  for (int r = t; r < rows; r += kThreads) {
#pragma unroll
    for (int q = 0; q < kSums; ++q)
      combine(s[q], c[q], part[(long)r * kPair + 2 * q],
              part[(long)r * kPair + 2 * q + 1]);
  }
#pragma unroll
  for (int q = 0; q < kSums; ++q) {
    red[2 * q][t] = s[q];
    red[2 * q + 1][t] = c[q];
  }
  block_combine(red, t);
  if (t == 0) {
    double pair[kPair], tot[kSums];
#pragma unroll
    for (int q = 0; q < kPair; ++q) out[q] = pair[q] = red[q][0];
#pragma unroll
    for (int q = 0; q < kSums; ++q) tot[q] = total(pair + 2 * q);
    // vtot, atot, mtot, tsalt, taver, saver, eaver, ekin
    out[kPair + 0] = tot[kVtot];
    out[kPair + 1] = tot[kAtot];
    out[kPair + 2] = tot[kMtot];
    out[kPair + 3] = tot[kStot];
    out[kPair + 4] = mean(tot[kTavg], tot[kVtot]);
    out[kPair + 5] = mean(tot[kStot], tot[kVtot]);
    out[kPair + 6] = mean(tot[kEavg], tot[kAtot]);
    out[kPair + 7] = tot[kEkin];
  }
}

// ptr: dx, dy, fsm, h, et, rho, tb, sb, u, v, dz, partials (rows from
// `row`); strides: (i, j) of the five 2-D operands, (k, i, j) of the five
// 3-D ones, dz's; geo: the box (i0, i1, j0, j1), then the five rectangles
template <typename T>
int launch(void* const* ptr, const long long* strides, const int* geo,
           double rhoref, int nk, int blocks, void* stream) {
  Operands<T> op;
  for (int f = 0; f < kTwo; ++f) {
    op.two[f] = (const T*)ptr[f];
    op.si2[f] = (long)strides[2 * f];
    op.sj2[f] = (long)strides[2 * f + 1];
  }
  for (int f = 0; f < kThree; ++f) {
    op.three[f] = (const T*)ptr[kTwo + f];
    op.sk3[f] = (long)strides[2 * kTwo + 3 * f];
    op.si3[f] = (long)strides[2 * kTwo + 3 * f + 1];
    op.sj3[f] = (long)strides[2 * kTwo + 3 * f + 2];
  }
  op.dz = (const T*)ptr[kTwo + kThree];
  op.sdz = (long)strides[2 * kTwo + 3 * kThree];
  Regions g;
  g.i0 = geo[0];
  g.i1 = geo[1];
  g.j0 = geo[2];
  g.j1 = geo[3];
  for (int r = 0; r < kRects; ++r)
    for (int e = 0; e < 4; ++e) g.r[r][e] = geo[4 + 4 * r + e];
  if (blocks < 1 || nk < 1 || g.i1 <= g.i0 || g.j1 <= g.j0)
    return (int)cudaErrorInvalidValue;
  k_diag_sums<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      op, g, rhoref, nk, (double*)ptr[kTwo + kThree + 1]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int extpom_diag_sums_f32(void* const* ptr,
                                    const long long* strides, const int* geo,
                                    double rhoref, int nk, int blocks,
                                    void* stream) {
  return launch<float>(ptr, strides, geo, rhoref, nk, blocks, stream);
}

extern "C" int extpom_diag_sums_f64(void* const* ptr,
                                    const long long* strides, const int* geo,
                                    double rhoref, int nk, int blocks,
                                    void* stream) {
  return launch<double>(ptr, strides, geo, rhoref, nk, blocks, stream);
}

// the [rows, 7, 2] partials into out: the seven pairs, then vtot, atot,
// mtot, tsalt, taver, saver, eaver, ekin
extern "C" int extpom_diag_finish(const void* part, int rows, void* out,
                                  void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  k_diag_finish<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)part, rows, (double*)out);
  return (int)cudaGetLastError();
}

// threads per block, then the six ints of column.cuh tile_info of
// k_diag_sums (f64: its double instantiation)
extern "C" int extpom_diag_sums_info(int f64, int* out) {
  out[0] = kThreads;
  return f64 ? extpom::tile_info(k_diag_sums<double>, kThreads, 0, out + 1)
             : extpom::tile_info(k_diag_sums<float>, kThreads, 0, out + 1);
}
