// Internal-mode phase uvw: depth-mean adjustment of u, v and the vertical
// velocity w from continuity (advance.f:364-400).
//
// Replaces phase "uvw" of extpom_tpu/pallas/phases.py:_kernel (via
// windowed_phase and runner.uvw), which runs core/stepper.py:phase_uvw on
// halo-extended i-stripes in TPU VMEM.  Counterpart here of
// kernels/phases.py:phase_uvw_plain (core/stepper.py:236-251,
// ops/continuity.py:vertvl, bc/orlanski.py:orl_w).
//
// Bound on the H100: memory.  Per column it reads u and v (2 kb words; w
// only on the domain's edge columns, whose w passes through) and ~14 2-D
// words, and writes u, v, w (3 kb words), with ~20 flops per level.
//
// Design: one launch, column tiles (column.cuh Tiles), one block per tile.
// A block owns a TI x TJ tile of columns, one thread each.  w at a column
// needs the adjusted u one cell east and the adjusted v one cell north, so
// the block works on u at the tile's x faces (the tile plus the row below,
// (TI+1) x TJ) and v at its y faces (the tile plus the column beside,
// TI x (TJ+1)); the tile's last row and last column read those extra faces.
//   pass 1  walks k upward and sums u dz and v dz over k < kbm1 at the
//     thread's faces in ascending k, the order of
//     kernels/phases.py:_depth_sum (vertvl's integral amplifies a last-bit
//     difference in w), and shares the sums in shared memory;
//   pass 2  walks k upward again: the adjusted u and v of the column and of
//     its east and north faces ((u - tps) + (utb + utf) / (dt + dt_w)),
//     written at the column only, and the running sum of w
//     (w + dz (div / (dx dy) + (etf - etb) / dti2), then orl_w's fsm
//     product); edge columns pass w through, times fsm on k < kbm1.
// The adjusted u and v never leave the chip.  Each thread issues the loads
// of kBatch levels before it uses them: the kernel does ~20 flops per level
// and is bound by the loads it keeps in flight.  With keep (template K)
// pass 1 also stores every level of u and v at the tile's faces in shared
// memory, and pass 2 reads them there, so u and v are read from device
// memory once; without, pass 2 reads them again (the column's own from the
// L2 where they are still there, the neighbours' mostly from the L1), which
// works at any depth.  The planner keeps them where two blocks of the kept
// tile fit an SM (kernels/phases.py:plan_tile).  Staging the levels by cp.async
// ahead of a barrier per level instead reached a third of the bandwidth
// (PERF.md §6).
// Every per-point expression is the one of the plain version, operand for
// operand, and the sources build with -fmad=false, so each operation
// rounds as the plain PyTorch version's does.
//
// extpom_phase_uvw_mesh_f32/f64 run the same kernel on one ring-extended
// block of the decomposed step (O, column.cuh), replacing the same TPU
// kernel with has_off (via mesh_runner): regions at global (i, j), the
// launch skipping 2 cells next to the block's split edges (its reads reach
// 1 cell).

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

using extpom::GeomT;
using extpom::Tiles;

// at most 256 threads a block; registers for the loads of kBatch levels in
// flight: 128 a thread in f32 (two such blocks an SM), as many as it takes
// in f64 (at 128 it spilled and lost 12-18 %)
constexpr int kMaxThreads = 256;
// levels whose loads a thread issues before it uses them (f64 half as
// many, for its registers)
template <typename T>
constexpr int kBatch = sizeof(T) == 4 ? 8 : 4;
// no level ring, fields on the one-cell window or at the own column, 2-D
// arrays or wide window
constexpr int kStages = 0;
constexpr int kHalo = 0;
constexpr int kOwn = 0;
constexpr int k2D = 0;
constexpr int kWide = 0;
// face pairs per kept level: u at the x faces, v at the y faces
constexpr int kStageFaces = 1;
// face pairs once per tile: the depth sums of u and v
constexpr int kFaces = 1;
// ee/gg rows per level in device scratch, values kept per column: none
constexpr int kScratch = 0;
constexpr int kKeep = 0;
// with keep, every level below kbm1 is kept (the ring is kb-1 deep)
constexpr int kKeepRing = 1;

// library-side count of kernel launches (both entries and both types)
int launches = 0;

// Shared memory of a tile, in elements: the kept face pairs (kbm1 levels
// with keep, else none), then the depth sums.
// kernels/phases.py:column_tile counts the same from the constants above,
// which it reads from this file.
struct Layout {
  int FU;     // x faces, (TI+1) x TJ; the y faces TI x (TJ+1) follow
  int FP;     // one face pair
  int slots;  // levels kept
  int total;
};

__host__ __device__ inline Layout layout(int TI, int TJ, int kb, bool keep) {
  Layout L;
  L.FU = (TI + 1) * TJ;
  L.FP = L.FU + TI * (TJ + 1);
  L.slots = keep ? kb - 1 : kStages;
  L.total = L.slots * kStageFaces * L.FP + kFaces * L.FP;
  return L;
}

template <typename T, bool O>
struct Uvw {
  const T *u, *v, *w;                                // (kb, im, jm)
  const T *dt, *utb, *vtb, *utf, *vtf, *etb, *etf;  // (im, jm)
  const T *vfluxb, *vflux;                          // (im, jm)
  const T *dx, *dy, *fsm;                           // (im, jm)
  const T* dz;                                      // (kb,)
  T *uo, *vo, *wo;                                  // outputs
  GeomT<O> g;
  Tiles tl;
  int kbm1;
  T rdti2;  // 1/dti2: PyTorch on the card divides by a Python float as a
            // product with its reciprocal
};

template <typename T, bool O, bool K>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 4 ? 2 : 1)
    k_uvw_tile(Uvw<T, O> s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const auto& g = s.g;
  const Tiles tl = s.tl;
  const int TI = tl.TI, TJ = tl.TJ;
  const int t = threadIdx.x, ti = t / TJ, tj = t % TJ;
  const int kbm1 = s.kbm1, jm = g.jm;
  const long n = g.n;
  const Layout L = layout(TI, TJ, g.kb, K);
  const int FU = L.FU;
  T* const tps = sm + L.slots * L.FP;  // the depth sums on the faces
  // the column's x face and y face in a face pair
  const int ou = t, ov = FU + ti * (TJ + 1) + tj;
  const T* __restrict__ u = s.u;
  const T* __restrict__ v = s.v;

  for (int tile = blockIdx.x; tile < tl.count; tile += gridDim.x) {
    const int i0 = (tile / tl.nj) * TI, j0 = (tile % tl.nj) * TJ;
    const int i = i0 + ti, j = j0 + tj;
    const bool in = i < g.im && j < jm;
    const long p = in ? (long)i * jm + j : 0;
    const bool act = in && !g.skip(i, j);
    const int gi = g.gi(i), gj = g.gj(j);
    const bool inner =
        act && gi >= 1 && gi <= g.GI() - 2 && gj >= 1 && gj <= g.GJ() - 2;
    // the tile's last row also reads the x faces of the row below it, its
    // last column the y faces of the column beside it
    const bool below = in && ti == TI - 1 && i + 1 < g.im;
    const bool beside = in && tj == TJ - 1 && j + 1 < jm;
    __syncthreads();  // the previous tile is done with shared memory

    // ---- pass 1: the depth sums of the thread's faces ----
    T tu = T(0), tv = T(0), tb = T(0), ts = T(0);
    for (int k0 = 0; in && k0 < kbm1; k0 += kBatch<T>) {
      T xu[kBatch<T>], xv[kBatch<T>], xb[kBatch<T>], xs[kBatch<T>];
#pragma unroll
      for (int c = 0; c < kBatch<T>; ++c) {
        const long q = (long)(k0 + c) * n + p;
        if (k0 + c < kbm1) {
          xu[c] = __ldg(u + q);
          xv[c] = __ldg(v + q);
          xb[c] = below ? __ldg(u + q + jm) : T(0);
          xs[c] = beside ? __ldg(v + q + 1) : T(0);
        }
      }
#pragma unroll
      for (int c = 0; c < kBatch<T>; ++c) {
        const int k = k0 + c;
        if (k < kbm1) {
          const T dz = __ldg(s.dz + k);
          tu = k == 0 ? xu[c] * dz : tu + xu[c] * dz;
          tv = k == 0 ? xv[c] * dz : tv + xv[c] * dz;
          tb = k == 0 ? xb[c] * dz : tb + xb[c] * dz;
          ts = k == 0 ? xs[c] * dz : ts + xs[c] * dz;
          if (K) {
            T* const d = sm + k * L.FP;
            d[ou] = xu[c];
            d[ov] = xv[c];
            if (below) d[ou + TJ] = xb[c];
            if (beside) d[ov + 1] = xs[c];
          }
        }
      }
    }
    tps[ou] = tu;
    tps[ov] = tv;
    if (below) tps[ou + TJ] = tb;
    if (beside) tps[ov + 1] = ts;
    __syncthreads();  // the sums (and, with K, every level) are shared
    if (!act) continue;

    // the column's 2-D terms: the adjustments of u and v at the column
    // (regions [1:, :] and [:, 1:]) and, on the interior, at its east and
    // north faces; vertvl's face metrics, dx dy, the surface tendency
    const bool adju = gi >= 1, adjv = gj >= 1;
    T au = T(0), av = T(0);
    if (adju) au = (s.utb[p] + s.utf[p]) / (s.dt[p] + s.dt[p - jm]);
    if (adjv) av = (s.vtb[p] + s.vtf[p]) / (s.dt[p] + s.dt[p - 1]);
    const T fsm = s.fsm[p];
    T tue = T(0), tvn = T(0), aue = T(0), avn = T(0), cx = T(0), cxe = T(0),
      cy = T(0), cyn = T(0), dxy = T(0), ddt = T(0), wk = T(0);
    const long pe = p + jm, pn = p + 1;
    if (inner) {
      tue = tps[ou + TJ];
      tvn = tps[ov + 1];
      aue = (s.utb[pe] + s.utf[pe]) / (s.dt[pe] + s.dt[p]);
      avn = (s.vtb[pn] + s.vtf[pn]) / (s.dt[pn] + s.dt[p]);
      // xflux = put(z3, .25 (dy + dy_w) (dt + dt_w) u, [KM1, 1:, 1:]), the
      // interior's i and i+1 faces both inside the region (yflux likewise)
      cx = T(0.25) * (s.dy[p] + s.dy[p - jm]) * (s.dt[p] + s.dt[p - jm]);
      cxe = T(0.25) * (s.dy[pe] + s.dy[p]) * (s.dt[pe] + s.dt[p]);
      cy = T(0.25) * (s.dx[p] + s.dx[p - 1]) * (s.dt[p] + s.dt[p - 1]);
      cyn = T(0.25) * (s.dx[pn] + s.dx[p]) * (s.dt[pn] + s.dt[p]);
      dxy = s.dx[p] * s.dy[p];
      ddt = (s.etf[p] - s.etb[p]) * s.rdti2;
      wk = T(0.5) * (s.vfluxb[p] + s.vflux[p]);
      s.wo[p] = wk * fsm;  // level 0 < kbm1
    }

    // ---- pass 2: the adjusted u, v and the running sum of w ----
    for (int k0 = 0; k0 < kbm1; k0 += kBatch<T>) {
      T xu[kBatch<T>], xv[kBatch<T>], xe[kBatch<T>], xn[kBatch<T>];
#pragma unroll
      for (int c = 0; c < kBatch<T>; ++c) {
        const int k = k0 + c;
        const long q = (long)k * n + p;
        const T* const d = sm + k * L.FP;
        if (k < kbm1) {
          xu[c] = K ? d[ou] : __ldg(u + q);
          xv[c] = K ? d[ov] : __ldg(v + q);
          xe[c] = K ? d[ou + TJ] : inner ? __ldg(u + q + jm) : T(0);
          xn[c] = K ? d[ov + 1] : inner ? __ldg(v + q + 1) : T(0);
        }
      }
#pragma unroll
      for (int c = 0; c < kBatch<T>; ++c) {
        const int k = k0 + c;
        if (k >= kbm1) break;
        const long q = (long)k * n + p;
        const T uo = adju ? (xu[c] - tu) + au : xu[c];
        const T vo = adjv ? (xv[c] - tv) + av : xv[c];
        s.uo[q] = uo;
        s.vo[q] = vo;
        if (inner) {
          const T ue = (xe[c] - tue) + aue;
          const T vn = (xn[c] - tvn) + avn;
          const T div = cxe * ue - cx * uo + cyn * vn - cy * vo;
          wk = wk + __ldg(s.dz + k) * (div / dxy + ddt);
          s.wo[q + n] = k + 1 < kbm1 ? wk * fsm : wk;
        } else {
          s.wo[q] = s.w[q] * fsm;
        }
      }
    }
    // level kbm1 passes u and v through, and w on the edge columns
    const long q = (long)kbm1 * n + p;
    s.uo[q] = u[q];
    s.vo[q] = v[q];
    if (!inner) s.wo[q] = s.w[q];
  }
}

constexpr int kPointers = 19;

// ptr: the operands and outputs; the domain is (im, jm), the arrays the
// domain or (O) the (R, L) block at global (oi, oj); the tiles TI x TJ,
// walked by `grid` blocks, with every level kept in shared memory when
// keep
template <typename T, bool O>
int run(void* const* ptr, const double* prm, int kb, int im, int jm, int R,
        int L, int oi, int oj, int keep, int TI, int TJ, int grid,
        void* stream) {
  Uvw<T, O> s;
  int k = 0;
#define NEXT(f) s.f = (decltype(s.f))ptr[k++]
  NEXT(u); NEXT(v); NEXT(w);
  NEXT(dt); NEXT(utb); NEXT(vtb); NEXT(utf); NEXT(vtf); NEXT(etb); NEXT(etf);
  NEXT(vfluxb); NEXT(vflux);
  NEXT(dx); NEXT(dy); NEXT(fsm); NEXT(dz);
  NEXT(uo); NEXT(vo); NEXT(wo);
#undef NEXT
  if (k != kPointers) return (int)cudaErrorInvalidValue;
  const int threads = TI * TJ;
  if (TI < 1 || TJ < 32 || TJ % 32 || threads > kMaxThreads || grid < 1 ||
      kb < 2)
    return (int)cudaErrorInvalidValue;
  s.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 2);
  s.tl.TI = TI;
  s.tl.TJ = TJ;
  s.tl.nj = (s.g.jm + TJ - 1) / TJ;
  s.tl.count = ((s.g.im + TI - 1) / TI) * s.tl.nj;
  s.kbm1 = kb - 1;
  // prm: dti2
  s.rdti2 = T(1) / T(prm[0]);
  const int smem = layout(TI, TJ, kb, keep != 0).total * (int)sizeof(T);
  auto kernel = keep ? k_uvw_tile<T, O, true> : k_uvw_tile<T, O, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(s);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++launches;
  return (int)e;
}

template <typename T, bool O>
int info(int TI, int TJ, int kb, int keep, int* out) {
  return extpom::tile_info(keep ? k_uvw_tile<T, O, true>
                                : k_uvw_tile<T, O, false>,
                           TI * TJ,
                           layout(TI, TJ, kb, keep != 0).total *
                               (int)sizeof(T),
                           out);
}

}  // namespace

extern "C" int extpom_phase_uvw_f32(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int keep, int,
                                    int TI, int TJ, int grid, void* stream) {
  return run<float, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, keep, TI, TJ,
                           grid, stream);
}

extern "C" int extpom_phase_uvw_f64(void* const* ptr, const double* prm,
                                    int kb, int im, int jm, int keep, int,
                                    int TI, int TJ, int grid, void* stream) {
  return run<double, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, keep, TI, TJ,
                            grid, stream);
}

extern "C" int extpom_phase_uvw_mesh_f32(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int keep, int,
                                         int TI, int TJ, int grid,
                                         void* stream) {
  return run<float, true>(ptr, prm, kb, im, jm, R, L, oi, oj, keep, TI, TJ,
                          grid, stream);
}

extern "C" int extpom_phase_uvw_mesh_f64(void* const* ptr, const double* prm,
                                         int kb, int im, int jm, int R, int L,
                                         int oi, int oj, int keep, int,
                                         int TI, int TJ, int grid,
                                         void* stream) {
  return run<double, true>(ptr, prm, kb, im, jm, R, L, oi, oj, keep, TI, TJ,
                           grid, stream);
}

// registers, static and dynamic shared bytes, resident blocks per SM,
// spill bytes and SMs of the tile kernel (column.cuh tile_info) at kb
// levels, keep saying whether the ring holds them all; f64 and mesh pick
// the instantiation
extern "C" int extpom_phase_uvw_info(int f64, int mesh, int TI, int TJ,
                                     int kb, int keep, int* out) {
  if (f64)
    return mesh ? info<double, true>(TI, TJ, kb, keep, out)
                : info<double, false>(TI, TJ, kb, keep, out);
  return mesh ? info<float, true>(TI, TJ, kb, keep, out)
              : info<float, false>(TI, TJ, kb, keep, out);
}

// kernels launched by the four entries above since the library loaded
extern "C" int extpom_phase_uvw_launches() { return launches; }
