// The forcing of one internal step from the staged record stacks, in one
// launch.
//
// Replaces, on the card, the chain of forcing/device.py:forcing_at_plain:
// three plain elementwise kernels per interpolated series (b*w0, f*w1, their
// sum) and 2*kbm1 - 1 per depth-integrated edge profile, some 400 launches a
// step on a forced regional domain (27 interpolated series).  The JAX
// package's forcing_at (extpom_tpu/forcing/device.py) is plain jnp code;
// there is no Pallas counterpart.
//
// Bound on the H100: memory.  Each interpolated series' two records are read
// and its value written once, and the four depth-integrated edge values
// written: 6.41 GB a step at 2048x2048x41 f32 with the three 3-D restoring
// series (trstr, srstr, taurstr), 1.91 ms at 3.35 TB/s.
//
// Design (k_forcing_interp):
//   * One table of entries, a launch argument, in DevicePlan's order: the
//     record pair (b, f) of a series, its output, its element count and its
//     two weights.  Blocks are dealt to the entries in table order; a block
//     interpolates one contiguous chunk of kThreads * kUnroll 16-byte vectors
//     (where b, f and the output are all 16-byte aligned; else the same
//     chunk element by element), each thread issuing all of its loads before
//     the first use.
//   * An edge entry (levels > 0) is a (levels, cols) profile pair: one thread
//     a column forms the interpolated profile level by level and adds
//     p*dz in ascending k, as the plain path's loop does.
// Every value is formed as the plain path forms it: __fmul_rn(b, w0),
// __fmul_rn(f, w1), then __fadd_rn; the integral __fmul_rn(p0, dz0), then
// __fadd_rn(acc, __fmul_rn(pk, dzk)).  So the result equals the plain
// path's bit for bit in f32 and f64.  A table holds every series a plan can
// stage (28 interpolated and 4 edge integrals at most); more are refused.

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxEntries = 40;  // a table stays under 4 KB of arguments

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// b*w0 + f*w1, each product and the sum rounded once, in that order
template <typename T>
__device__ __forceinline__ T lerp(T b, T f, T w0, T w1) {
  return add_rn(mul_rn(b, w0), mul_rn(f, w1));
}

template <typename T>
struct Entry {
  const T* b;
  const T* f;
  T* out;
  long long n;  // elements of a record; an edge entry's columns
  T w0, w1;
  int levels;   // 0: an interpolated series; else the integral's levels
  int vec;      // b, f and out 16-byte aligned
  int block0;   // the entry's first block
};

template <typename T>
struct Table {
  Entry<T> e[kMaxEntries];
  const T* dz;
  int count;
};

// the elements one block of an interpolated entry takes
template <typename T>
__host__ __device__ constexpr long long chunk() {
  return (long long)kThreads * kUnroll * Vec<T>::n;
}

template <typename T>
__device__ void interp_chunk(const Entry<T>& en, long long c) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::n;
  const long long e0 = c * chunk<T>();
  const long long e1 = min(e0 + chunk<T>(), en.n);
  const T w0 = en.w0, w1 = en.w1;
  if (en.vec) {
    const V* b = reinterpret_cast<const V*>(en.b);
    const V* f = reinterpret_cast<const V*>(en.f);
    V* out = reinterpret_cast<V*>(en.out);
    const long long v0 = e0 / W, v1 = e1 / W;
    V bv[kUnroll], fv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v0 + threadIdx.x + (long long)u * kThreads;
      if (i < v1) {
        bv[u] = b[i];
        fv[u] = f[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = v0 + threadIdx.x + (long long)u * kThreads;
      if (i < v1) {
        V o;
        if constexpr (W == 4) {
          o.x = lerp(bv[u].x, fv[u].x, w0, w1);
          o.y = lerp(bv[u].y, fv[u].y, w0, w1);
          o.z = lerp(bv[u].z, fv[u].z, w0, w1);
          o.w = lerp(bv[u].w, fv[u].w, w0, w1);
        } else {
          o.x = lerp(bv[u].x, fv[u].x, w0, w1);
          o.y = lerp(bv[u].y, fv[u].y, w0, w1);
        }
        out[i] = o;
      }
    }
    // the record's last elements, fewer than a vector
    for (long long i = v1 * W + threadIdx.x; i < e1; i += kThreads)
      en.out[i] = lerp(en.b[i], en.f[i], w0, w1);
    return;
  }
  T bs[kUnroll * W], fs[kUnroll * W];
#pragma unroll
  for (int u = 0; u < kUnroll * W; ++u) {
    const long long i = e0 + threadIdx.x + (long long)u * kThreads;
    if (i < e1) {
      bs[u] = en.b[i];
      fs[u] = en.f[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll * W; ++u) {
    const long long i = e0 + threadIdx.x + (long long)u * kThreads;
    if (i < e1) en.out[i] = lerp(bs[u], fs[u], w0, w1);
  }
}

template <typename T>
__device__ void edge_integral(const Entry<T>& en, const T* dz, long long c) {
  const long long j = c * kThreads + threadIdx.x;
  if (j >= en.n) return;
  const long long cols = en.n;
  T acc = mul_rn(lerp(en.b[j], en.f[j], en.w0, en.w1), dz[0]);
  for (int k = 1; k < en.levels; ++k)
    acc = add_rn(acc, mul_rn(lerp(en.b[k * cols + j], en.f[k * cols + j],
                                  en.w0, en.w1),
                             dz[k]));
  en.out[j] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k_forcing_interp(const __grid_constant__ Table<T> t) {
  int q = 0;
  while (q + 1 < t.count && (int)blockIdx.x >= t.e[q + 1].block0) ++q;
  const Entry<T>& en = t.e[q];
  const long long c = (long long)blockIdx.x - en.block0;
  if (en.levels > 0)
    edge_integral(en, t.dz, c);
  else
    interp_chunk(en, c);
}

bool aligned(const void* p) {
  return ((unsigned long long)p & 15ull) == 0;
}

// ptr: (b, f, out) of each entry; n: its elements (an edge entry's
// columns); w: its (w0, w1); levels: 0, or an edge entry's levels
template <typename T>
int launch(void* const* ptr, const long long* n, const double* w,
           const int* levels, int count, const void* dz, void* stream) {
  if (count < 1 || count > kMaxEntries) return (int)cudaErrorInvalidValue;
  Table<T> t;
  t.dz = (const T*)dz;
  t.count = count;
  long long blocks = 0;
  for (int q = 0; q < count; ++q) {
    if (n[q] < 0 || levels[q] < 0 || (levels[q] > 0 && dz == nullptr))
      return (int)cudaErrorInvalidValue;
    Entry<T>& en = t.e[q];
    en.b = (const T*)ptr[3 * q];
    en.f = (const T*)ptr[3 * q + 1];
    en.out = (T*)ptr[3 * q + 2];
    en.n = n[q];
    en.w0 = (T)w[2 * q];
    en.w1 = (T)w[2 * q + 1];
    en.levels = levels[q];
    en.vec = aligned(en.b) && aligned(en.f) && aligned(en.out);
    en.block0 = (int)blocks;
    blocks += levels[q] > 0 ? (n[q] + kThreads - 1) / kThreads
                            : (n[q] + chunk<T>() - 1) / chunk<T>();
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  if (blocks == 0) return 0;
  k_forcing_interp<T><<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int extpom_forcing_f32(void* const* ptr, const long long* n,
                                  const double* w, const int* levels,
                                  int count, const void* dz, void* stream) {
  return launch<float>(ptr, n, w, levels, count, dz, stream);
}

extern "C" int extpom_forcing_f64(void* const* ptr, const long long* n,
                                  const double* w, const int* levels,
                                  int count, const void* dz, void* stream) {
  return launch<double>(ptr, n, w, levels, count, dz, stream);
}

// threads per block, entries per launch, then the six ints of column.cuh
// tile_info of k_forcing_interp (f64: its double instantiation)
extern "C" int extpom_forcing_info(int f64, int* out) {
  out[0] = kThreads;
  out[1] = kMaxEntries;
  return f64 ? extpom::tile_info(k_forcing_interp<double>, kThreads, 0,
                                 out + 2)
             : extpom::tile_info(k_forcing_interp<float>, kThreads, 0,
                                 out + 2);
}
