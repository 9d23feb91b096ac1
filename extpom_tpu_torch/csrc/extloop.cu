// External-mode (2-D barotropic) loop: all isplit substeps of one internal
// step, as one persistent kernel.
//
// Replaces extpom_tpu/pallas/extloop.py:_kernel (via run_external_loop),
// which holds the whole 2-D working set in TPU VMEM and runs the isplit
// substeps of stepper.mode_external_substep there.  Counterpart here of
// extpom_tpu_torch/core/stepper.py:mode_external_substep.
//
// Bound on the H100: per substep a point does ~200 flops over ~40 words of
// 2-D fields.  At 256x256 f32 the whole working set (~51 fields, ~13.4 MB)
// is far beyond a block's 227 KB of shared memory but fits the 50 MB L2, so
// after the first substep the stencil reads are L2 hits; the least HBM
// traffic is one read of the inputs and one write of the carry.  What bounds
// the loop in practice is the grid-wide dependence between the stages of a
// substep: the velocity pass reads elf at i-1 and j-1, and el/elb/ua/va of
// neighbours; the next substep's surface pass reads the new levels of
// neighbours.  The first design put a kernel boundary at each (k_metrics,
// then k_surface, k_velocity and k_update per substep: 91 launches per
// call, each less than one wave of blocks at 256x256).
//
// Design: one cooperative launch (every block resident at once) whose
// blocks visit the cells grid-stride, so any (R, L) works; the wrapper
// picks the threads per block so that one block per SM covers the cells
// where it can (kernels/extloop.py:block_threads: 512 at 256x256, 192 on a
// 188x124 block) and sizes the grid from the occupancy the card reports
// for this kernel (persistent_grid).  A grid-wide barrier
// (cooperative_groups' grid sync: a release fence before the arrival, an
// acquire fence after the wait) stands where the chain had a kernel
// boundary, and there are two per substep, not three:
//   metrics (ext_precompute) once                           | barrier
//   surface: elf (+ bc_el) and advave (advua/advva,
//            iext % ispadv == 0)                            | barrier
//   velocity: uaf/vaf (+ bc_vel2d) times dum/dvm, then at the same cell
//            the etf tail, the egf/utf/vtf accumulators and the Asselin
//            filter                                  | barrier (not the last)
// The chain's third boundary existed because the rotation overwrote
// el/elb/ua/uab/va/vab in place while neighbours still read them.  Here the
// time levels of el, ua and va live in four slots each (the carry's two and
// two of the wrapper's scratch): a substep reads the current and b levels
// from one pair and writes the new level (elf/uaf/vaf) and the filtered b
// level into the other pair, so the rotation is a change of index.  The
// filter and the accumulators read only their own cell, and elf of a
// neighbour, which the surface pass finished before the barrier.  When the
// call's substep count is odd the first pass copies the carry's levels into
// the second pair, so that the last substep leaves them in the carry.
// Fields written inside the launch and read by other blocks after a barrier
// (the metrics, the slots, advua/advva) are plain T* loads, never the
// non-coherent read-only path.
//
// Every value is formed by extstep.cuh's per-point functions (metrics_point,
// elf_point, adv_point, velocity_point, accumulate, asselin) through the
// chain's reader, as the chain formed them, so the loop equals the plain
// PyTorch version bit for bit (built with -fmad=false).  What bounds it now
// (256x256 f32 on the H100, PERF.md): the barrier floor, an empty
// persistent kernel passing the same 60 barriers on the same grid
// (extpom_extloop_floor, ~1.2 us a barrier), is a quarter of the call; the
// rest is each pass's chain of dependent L2 reads at one cell per thread.
// The read-only operands take about a seventh of that (a variant that skips
// their reads), so staging them in shared memory would not pay; the carry's
// neighbours are what each pass waits on.  The carry order is CARRY_FIELDS
// of the TPU kernel (extloop.py:48).
//
// The options of extstep.cuh (kOrl, the orlanski scheme's edges; kMode2,
// mode 2's advave) are template flags chosen per call (`flags` of the
// entries, extpom::with_flags): in mode 2 the surface pass also writes the
// bottom stress of its cell, which the velocity pass reads at that cell
// after the barrier; an Orlanski edge cell forms the interior velocity one
// row in itself, so neither option adds a barrier.
//
// extpom_extchunk_f32/f64, the same kernel on one ring-extended block of
// the decomposed step (the O variant of extstep.cuh), replace
// extpom_tpu/pallas/extloop.py:_chunk_kernel (via run_external_chunk_vmem),
// which runs C substeps on a ring-extended local block held whole in VMEM.
// They run substeps iext0 .. iext0+C-1 of isplit on the (R, L) block whose
// cell (0, 0) is global (oi, oj): masks and boundary conditions at global
// (i, j) against the global (im, jm), reads zero-filled outside the block,
// so the block's cells that the ring covers come out as the whole-domain
// loop gives them (kernels/extloop.py:run_external_chunk_plain is the
// plain version).  The extended block of the main path (188x124 at 256x256
// on a 2x4 mesh) fits the L2 many times over.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "extstep.cuh"

namespace {

using extpom::Carry;
using extpom::ExtArgs;

constexpr int kMaxThreads = 512;

// kernels launched by extpom_extloop_* and extpom_extchunk_* (the
// library's own count, extpom_extloop_launches)
int launches = 0;

// The four slots of the time levels of el, ua and va: 0 and 1 the carry's
// own (el, elb), 2 and 3 the wrapper's scratch.  A substep reads one pair
// (current, b) and writes the other (new, filtered b).
template <typename T>
struct Levels {
  T* el[4];
  T* ua[4];
  T* va[4];
};

// substeps iext0 .. iext0+nsub-1 of isplit, cells grid-stride
template <typename T, int O>
__global__ void __launch_bounds__(kMaxThreads)
    k_extloop(ExtArgs<T, O> s, Levels<T> lv, T* advua, T* advva, T* etf,
              T* egf, T* utf, T* vtf, int iext0, int nsub, int isplit,
              int ispadv) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int n = extpom::cells(s);
  const int step = gridDim.x * blockDim.x;
  const int p0 = blockIdx.x * blockDim.x + threadIdx.x;
  // the pair of the first substep: 1 when nsub is odd, so that the last
  // substep writes pair 0, the carry
  const int first = nsub & 1;
  for (int p = p0; p < n; p += step) {
    extpom::metrics_point(s, p);
    if (first) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        lv.el[2 + k][p] = lv.el[k][p];
        lv.ua[2 + k][p] = lv.ua[k][p];
        lv.va[2 + k][p] = lv.va[k][p];
      }
    }
  }
  for (int k = 0; k < nsub; ++k) {
    grid.sync();
    const int iext = iext0 + k;
    // this substep reads pair 1 and writes pair 0 (odd), or the reverse;
    // selects between constant indices keep the slots out of local memory
    const bool odd = (first + k) & 1;
    Carry<T, false> c{};  // whole arrays: indexed like the read-only fields
    c.el = odd ? lv.el[2] : lv.el[0];
    c.elb = odd ? lv.el[3] : lv.el[1];
    c.elf = odd ? lv.el[0] : lv.el[2];
    c.ua = odd ? lv.ua[2] : lv.ua[0];
    c.uab = odd ? lv.ua[3] : lv.ua[1];
    c.uaf = odd ? lv.ua[0] : lv.ua[2];
    c.va = odd ? lv.va[2] : lv.va[0];
    c.vab = odd ? lv.va[3] : lv.va[1];
    c.vaf = odd ? lv.va[0] : lv.va[2];
    T* const elb = odd ? lv.el[1] : lv.el[3];
    T* const uab = odd ? lv.ua[1] : lv.ua[3];
    T* const vab = odd ? lv.va[1] : lv.va[3];
    c.advua = advua;
    c.advva = advva;
    // mode 2 rewrites the bottom stress in the surface pass; a cell's is
    // read by the thread that wrote it
    c.wubot = const_cast<T*>(s.wubot);
    c.wvbot = const_cast<T*>(s.wvbot);
    const bool adv = iext % ispadv == 0;
    for (int p = p0; p < n; p += step) {
      int i, j;
      extpom::cell(s, p, i, j);
      c.elf[p] = extpom::elf_point(s, c, i, j);
      // advave reads d/ua/va/uab/vab only; advua/advva (and in mode 2
      // wubot/wvbot) are read at their own cell, by the velocity pass
      if (adv) extpom::adv_point(s, c, i, j, c.advua[p], c.advva[p]);
    }
    grid.sync();
    for (int p = p0; p < n; p += step) {
      int i, j;
      extpom::cell(s, p, i, j);
      extpom::velocity_point(s, c, i, j, c.uaf[p], c.vaf[p]);
      extpom::accumulate(s, c, i, j, iext, isplit, etf, egf, utf, vtf);
      extpom::asselin(s, c, p, elb, uab, vab);
    }
  }
}

// ptr: the 14 carry fields (CARRY_FIELDS order, updated in place), the
// extpom::kExtOperands read-only operands, then the scratch: the third
// and fourth slots of el, ua, va (kernels/extloop.py:N_SCRATCH); all
// (im, jm), or (R, L) on a block (O).  Runs substeps iext0 .. iext0+nsub-1
// of isplit in one cooperative launch of `blocks` blocks of `threads`.
template <typename T, int O>
int run(void* const* ptr, const double* prm, int im, int jm, int R, int L,
        int oi, int oj, int iext0, int nsub, int isplit, int ispadv,
        int threads, int blocks, void* stream) {
  static_assert(O >= 0 && O < 8, "flags: kBlock | kOrl | kMode2");
  if (nsub < 1 || iext0 < 1 || iext0 + nsub - 1 > isplit || R < 1 || L < 1 ||
      ispadv < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || blocks < 1)
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
  Levels<T> lv{{cf[0], cf[1], scr[0], scr[3]},
               {cf[2], cf[3], scr[1], scr[4]},
               {cf[4], cf[5], scr[2], scr[5]}};
  T *advua = cf[10], *advva = cf[11], *etf = cf[6], *egf = cf[7],
    *utf = cf[8], *vtf = cf[9];
  void* args[] = {&s,   &lv,  &advua, &advva, &etf,    &egf,
                  &utf, &vtf, &iext0, &nsub,  &isplit, &ispadv};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)k_extloop<T, O>, dim3(blocks), dim3(threads), args, 0,
      (cudaStream_t)stream);
  if (err == cudaSuccess)
    ++launches;
  else
    cudaGetLastError();  // returned here: clear it for the next launch
  return (int)err;
}

// ---- the grid-barrier floor ----
//
// An empty persistent kernel that only passes n grid-wide barriers: the
// least time any kernel with n barriers can take on that grid.  The barrier
// is cooperative_groups' grid sync, or with kHand a counter in device
// memory (zero before the launch) whose top bit flips once per barrier,
// the same protocol with a release fence before the arrival and an acquire
// fence after the wait.

__device__ __forceinline__ void hand_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    while (((old ^ *(volatile unsigned*)bar) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

template <bool kHand>
__global__ void k_floor(unsigned* bar, int n) {
  for (int b = 0; b < n; ++b) {
    if constexpr (kHand)
      hand_barrier(bar);
    else
      cooperative_groups::this_grid().sync();
  }
}

template <typename T, int B>
int loop_info(int flags, int threads, int* o) {
  return extpom::with_flags<B>(flags, [&](auto c) {
    return extpom::tile_info(k_extloop<T, decltype(c)::value>, threads, 0, o);
  });
}

}  // namespace

// What the compiler and the card give k_extloop (the block variant with
// blk, the options of `flags`, kOrl | kMode2) for `threads` threads:
// column.cuh's tile_info (no shared memory)
extern "C" int extpom_extloop_info(int f64, int blk, int flags, int threads,
                                   void* out) {
  int* o = (int*)out;
  if (f64)
    return blk ? loop_info<double, extpom::kBlock>(flags, threads, o)
               : loop_info<double, 0>(flags, threads, o);
  return blk ? loop_info<float, extpom::kBlock>(flags, threads, o)
             : loop_info<float, 0>(flags, threads, o);
}

extern "C" int extpom_extloop_launches() { return launches; }

// n barriers on `blocks` blocks of `threads` threads, launched
// cooperatively (all blocks resident at once, or cudaErrorCooperative-
// LaunchTooLarge); `counter` is one zeroed unsigned for the hand-written
// barrier
extern "C" int extpom_extloop_floor(int threads, int blocks, int n, int hand,
                                    void* counter, void* stream) {
  unsigned* bar = (unsigned*)counter;
  void* args[] = {&bar, &n};
  const void* fn =
      hand ? (const void*)k_floor<true> : (const void*)k_floor<false>;
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(threads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// `flags`: the options kOrl | kMode2 (extstep.cuh)
extern "C" int extpom_extloop_f32(void* const* ptr, const double* prm, int im,
                                  int jm, int isplit, int ispadv, int flags,
                                  int threads, int blocks, void* stream) {
  return extpom::with_flags<0>(flags, [&](auto c) {
    return run<float, decltype(c)::value>(ptr, prm, im, jm, im, jm, 0, 0, 1,
                                          isplit, isplit, ispadv, threads,
                                          blocks, stream);
  });
}

extern "C" int extpom_extloop_f64(void* const* ptr, const double* prm, int im,
                                  int jm, int isplit, int ispadv, int flags,
                                  int threads, int blocks, void* stream) {
  return extpom::with_flags<0>(flags, [&](auto c) {
    return run<double, decltype(c)::value>(ptr, prm, im, jm, im, jm, 0, 0, 1,
                                           isplit, isplit, ispadv, threads,
                                           blocks, stream);
  });
}

extern "C" int extpom_extchunk_f32(void* const* ptr, const double* prm, int im,
                                   int jm, int R, int L, int nsub, int iext0,
                                   int oi, int oj, int isplit, int ispadv,
                                   int flags, int threads, int blocks,
                                   void* stream) {
  return extpom::with_flags<extpom::kBlock>(flags, [&](auto c) {
    return run<float, decltype(c)::value>(ptr, prm, im, jm, R, L, oi, oj,
                                          iext0, nsub, isplit, ispadv,
                                          threads, blocks, stream);
  });
}

extern "C" int extpom_extchunk_f64(void* const* ptr, const double* prm, int im,
                                   int jm, int R, int L, int nsub, int iext0,
                                   int oi, int oj, int isplit, int ispadv,
                                   int flags, int threads, int blocks,
                                   void* stream) {
  return extpom::with_flags<extpom::kBlock>(flags, [&](auto c) {
    return run<double, decltype(c)::value>(ptr, prm, im, jm, R, L, oi, oj,
                                           iext0, nsub, isplit, ispadv,
                                           threads, blocks, stream);
  });
}
