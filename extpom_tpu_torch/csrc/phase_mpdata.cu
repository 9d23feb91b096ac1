// MPDATA's upstream steps of the tracer phase, T and S: ops/tracers.py:
// advt2 before its closing diffusion (mpdata_steps: mass_fluxes, then
// nitera times mpdata_upwind and smol_adif).
//
// Replaces that part of phase "tracer" of extpom_tpu/pallas/phases.py:
// _kernel (:771, and with has_off via mesh_runner, :904), which runs
// extpom_tpu/ops/tracers.py:162-210 on halo-extended i-stripes in TPU VMEM.
// Counterpart here of kernels/phases.py:mpdata_plain; the tracer tile
// (phase_tracer.cu, flag X) takes its two fields in place of advt1's.
//
// Bound on the H100: memory.  The call reads tb, sb, u, v and w and writes
// the field of T and of S (kb levels each), with the surface of t and s and
// ten 2-D fields; ~110 flops per point and step, ~90 per antidiffusion.
//
// Design: one launch per group of up to G steps (kernels/phases.py:
// mpdata_plan; all nitera steps where they fit), T and S in separate blocks
// (blockIdx.y).  A block owns a TI x TJ tile of columns widened by a halo
// of H cells (the box) and walks the levels once.  Each count of steps NS
// and halo H is its own instantiation, so the box, every plane's offset
// and every domain's extent are constants.  Step n of the group at
// level k reads the field of step n-1 at k-1..k+1 and a cell either way,
// and the antidiffusive velocities of step n-1 at k (zw also at k+1) and at
// i+1/j+1, which read the field of step n-1 at i-1/j-1 and k-1.  So with
// level s staged (stage s of the walk) step n runs at level s-n, on the box
// less n cells, and shared memory holds over the box:
//   * the input field (tb/sb with the ghost level kb-1 read as kb-2 in the
//     first group, the group before's field otherwise), levels k-2..k with
//     k+1 in flight, and the input velocities (u and v turned into xm and ym
//     once per cell and level, and w, in the first group; the group
//     before's xm, ym, zw otherwise), levels k-1, k with k+1 in flight, each
//     level staged a stage ahead by cp.async;
//   * the ten 2-D operands, staged once per tile, and a table of the box's
//     cells with their regions and array offsets, found once, ordered so
//     that each phase's domain is a prefix of it (no thread tests whether
//     a cell is in the domain; the block has a thread per cell of the
//     first step's domain, so each phase is one cell per thread);
//   * each step's field, three levels, and, but for the last step, its
//     velocities, two levels; the rings rotate by one slot a stage.
// Stage s runs one phase per step between barriers: phase n forms the
// velocities of step n-1 at level s-n+1 and then the upstream step n at
// level s-n, cell by cell in the same thread, so zw at k+1, read at the own
// column only, needs no barrier of its own.  Only the last step's field,
// times fsm, leaves the kernel.  A group that is not the last also writes
// the velocities of its last step, which read that step's field at i-1 and
// j-1: it is planned with a halo one cell wider, and the next group reads
// its field and velocities back.  Where the tiles leave SMs idle (a block
// of the decomposed step), each column is cut into KC chunks of levels
// (blockIdx.z), each widened by the halo's levels, so that more blocks walk
// fewer levels each.  The regions are selected, not branched on, so each
// cell's x, y and z work is straight-line code.  The f32 kernel's launch
// bounds hold it to 51 registers, so that two blocks of 640 threads fit an
// SM.
//
// Bit for bit: every per-point expression is mpdata_upwind's, smol_adif's
// or mass_fluxes', operand for operand, and the sources build with
// -fmad=false.  Where an off-by-one would hide:
//   * the first step alone reads tb/sb with the ghost level kb-1 = kb-2,
//     has eta = etb, the surface flux w[0] f[0] art (f the current t or s)
//     and xm/ym from mass_fluxes' formula (0 outside k < kbm1 and its
//     region); later steps read the velocities smol_adif left, which pass
//     through outside its regions;
//   * outside the upstream interior (k < kbm1, 1 <= i <= im-2,
//     1 <= j <= jm-2) the step's field is its input times fsm;
//   * smol_adif's regions: x k < kbm1, i 1.., j 1..jm-2; y k < kbm1,
//     i 1..im-2, j 1..; z 1 <= k < kbm1 of the interior;
//   * every read outside the array is 0 (sft's fill), also on a block.
//
// extpom_phase_tracer_mpdata_mesh_f32/f64 run the same template (O,
// column.cuh GeomT) on one ring-extended block of the decomposed step:
// regions at global (i, j), reads 0 outside the block; only the block's own
// cells (mpdata_radius inside the ring) are what the whole domain gives.

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

using extpom::GeomT;

constexpr int kMaxThreads = 640;
// steps one launch chains at most, and the widest halo (the kernel is
// instantiated for each count of steps and its halos up to these)
constexpr int kMaxGroup = 4;
constexpr int kMaxHalo = 4;
// levels of each ring: the input field (k-2..k, k+1 in flight), the input
// velocities (k-1, k, k+1 in flight), a step's field (k-1..k+1) and a
// step's velocities (k, k+1)
constexpr int kInRing = 4;
constexpr int kInVelRing = 3;
constexpr int kFieldRing = 3;
constexpr int kVelRing = 2;
// the 2-D operands, staged over the box once per tile
constexpr int k2D = 10;
enum { DDT, DDX, DDY, DH, DART, DARU, DARV, DFSM, DETB, DETF };
// 32-bit planes of the cell table: box index and flags, array offsets
constexpr int kTable = 2;
// the tile by type (kernels/phases.py:MPDATA_TILE): TI x TJ columns
template <typename T>
constexpr int kTileI = sizeof(T) == 4 ? 16 : 8;
constexpr int kTileJ = 32;
constexpr int kMpdPointers = 35;
constexpr long kSmemLimit = 232448;

// Shared planes (each the box, (TI + 2H) x (TJ + 2H)) of a group of ns
// steps, besides the cell table; kernels/phases.py:mpdata_plan counts the
// same.
__host__ __device__ constexpr int planes(int ns) {
  return kInRing + 3 * kInVelRing + kFieldRing * ns +
         3 * kVelRing * (ns - 1) + k2D;
}

// dynamic shared bytes of a launch of ns steps with a halo of H cells
template <typename T>
long smem_bytes(int ns, int H, int TI, int TJ) {
  return (long)(TI + 2 * H) * (TJ + 2 * H) *
         ((long)planes(ns) * (long)sizeof(T) + kTable * 4L);
}

template <typename T, bool O>
struct Mpd {
  const T *t, *s, *tb, *sb, *u, *v, *w;  // 3-D, read in the first group
  const T* two[k2D];  // dt, dx, dy, h, art, aru, arv, fsm, etb, etf
  const T *dz, *dzz;  // (kb,)
  // the group before's field of T and S and its xm, ym, zw of T, then of
  // S (null in the first group)
  const T* fin[2];
  const T* vin[6];
  // the last step's field of T and S; its velocities (null in the last
  // group)
  T* fout[2];
  T* vout[6];
  GeomT<O> g;
  int kbm1, nj, KC;
  bool first, last;
  T dti2, sw, vmin, eps;
};

// The cell table, found once per block, in an order in which the domain of
// every phase is a prefix: the domains nest, U1 > A1 > U2 > A2 > ..., where
// Un (rows and columns n .. B-1-n of the box) is where step n's field is
// formed and An (n+1 .. B-1-n) where its velocities are, so the cells are
// ordered by the innermost of these rectangles that holds them, deepest
// first, and row-major within a rank.  Each entry packs the box index (bits
// 16..31) and the cell's region flags; a second plane holds its array offset
// i*jm + j.
enum : unsigned {
  CIN = 1u,     // in the array
  CINT = 2u,    // the upstream interior 1 <= i <= im-2, 1 <= j <= jm-2
  CXF1 = 4u,    // the face fluxes' region i 1.., j 1.. at (i+1, j)
  CYF1 = 8u,    // ... at (i, j+1)
  CXR = 16u,    // smol_adif's and mass_fluxes' x region i 1.., 1..jm-2
  CYR = 32u,    // their y region 1..im-2, j 1..
  COWN = 64u,   // in the tile
  CBI = 128u,   // box row >= 1 (its x velocity is read)
  CBJ = 256u    // box column >= 1
};

// rectangle k of the chain over a box side of B cells: [rk_lo, rk_hi);
// k = 0 the box, 2n-1 the domain Un, 2n the domain An
__host__ __device__ constexpr int rk_lo(int k) {
  return k == 0 ? 0 : k / 2 + 1;
}
__host__ __device__ constexpr int rk_hi(int k, int B) {
  return B - (k + 1) / 2;
}
// cells of rectangle k of a BH x BW box: the prefix of the table it is
__host__ __device__ constexpr int rk_count(int k, int BH, int BW) {
  return (rk_hi(k, BH) - rk_lo(k)) * (rk_hi(k, BW) - rk_lo(k));
}

// slot of the level d after the level whose slot is r, in a ring of R
template <int R>
__device__ __forceinline__ int slot(int r, int d) {
  const int x = r + ((d % R) + R) % R;
  return x >= R ? x - R : x;
}

// The kernel of NS steps on TI x TJ tiles with a halo of H cells (each
// combination the planner uses is its own instantiation, so that the box,
// every plane's offset and every domain's extent are constants).
template <typename T, bool O, int NS, int TI, int TJ, int H>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 4 ? 2 : 1)
    k_mpdata_tile(Mpd<T, O> m) {
  constexpr int BW = TJ + 2 * H, BH = TI + 2 * H, P = BH * BW;
  // the deepest rectangle of the chain
  constexpr int K = 2 * H;
  // plane offsets: the input field's ring, the input velocities' rings,
  // each step's field and velocities, the 2-D operands, the cell table
  constexpr int kInF = 0, kInV = kInRing * P;
  constexpr int kFld = kInV + 3 * kInVelRing * P;
  constexpr int kVel = kFld + kFieldRing * NS * P;
  constexpr int kTwo = kVel + 3 * kVelRing * (NS - 1) * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const T* const two = sm + kTwo;
  unsigned* const cfl = reinterpret_cast<unsigned*>(sm + kTwo + k2D * P);
  int* const cof = reinterpret_cast<int*>(cfl + P);
  const auto& g = m.g;
  const int c = blockIdx.y, t = threadIdx.x, nt = blockDim.x;
  const int kb = g.kb, kbm1 = m.kbm1;
  // array (i, j) of box cell (0, 0)
  const int i0 = (int)(blockIdx.x / m.nj) * TI - H;
  const int j0 = (int)(blockIdx.x % m.nj) * TJ - H;
  // the levels [k0, k1) of the last step this block writes; a chunk of the
  // column widens the levels of step n by H - n below and NS - n above,
  // the vertical counterpart of the halo (the whole column: clipped away)
  const int k0 = (int)(blockIdx.z * kb) / m.KC;
  const int k1 = (int)((blockIdx.z + 1) * kb) / m.KC;
  const bool first = m.first, last = m.last;
  const T* const fsurf = c ? m.s : m.t;
  const T* const pf0 = first ? (c ? m.sb : m.tb) : (c ? m.fin[1] : m.fin[0]);
  const T* const px0 = first ? m.u : (c ? m.vin[3] : m.vin[0]);
  const T* const py0 = first ? m.v : (c ? m.vin[4] : m.vin[1]);
  const T* const pz0 = first ? m.w : (c ? m.vin[5] : m.vin[2]);
  T* const fout = c ? m.fout[1] : m.fout[0];
  T* const xout = c ? m.vout[3] : m.vout[0];
  T* const yout = c ? m.vout[4] : m.vout[1];
  T* const zout = c ? m.vout[5] : m.vout[2];

  // the slots of level s in the rings of 2, 3 and 4 levels
  int r2 = 0, r3 = 0, r4 = 0;
  // offset of the field of step n (0: the input) at level s + d
  auto F = [&](int n, int d) -> int {
    return n == 0 ? kInF + slot<kInRing>(r4, d) * P
                  : kFld + ((n - 1) * kFieldRing + slot<kFieldRing>(r3, d)) *
                               P;
  };
  // offset of velocity a (0 xm, 1 ym, 2 zw) of step n (0: the input) at
  // level s + d
  auto V = [&](int n, int a, int d) -> int {
    return n == 0 ? kInV + (a * kInVelRing + slot<kInVelRing>(r3, d)) * P
                  : kVel + (((n - 1) * 3 + a) * kVelRing +
                            slot<kVelRing>(r2, d)) * P;
  };
  auto in = [&](int i, int j) {
    return i >= 0 && i < g.im && j >= 0 && j < g.jm;
  };

  // the cell table, and the 2-D operands by box index
  for (int q = t; q < P; q += nt) {
    const int bi = q / BW, bj = q - bi * BW;
    const int i = i0 + bi, j = j0 + bj;
    const int gi = g.gi(i), gj = g.gj(j), GI = g.GI(), GJ = g.GJ();
    unsigned f = 0;
    int p = 0;
    if (in(i, j)) {
      f |= CIN;
      p = i * g.jm + j;
      if (gi >= 1 && gi <= GI - 2 && gj >= 1 && gj <= GJ - 2) f |= CINT;
      if (gi >= 1 && gj >= 1 && gj <= GJ - 2) f |= CXR;
      if (gj >= 1 && gi >= 1 && gi <= GI - 2) f |= CYR;
    }
    if (in(i + 1, j) && g.gi(i + 1) >= 1 && gj >= 1) f |= CXF1;
    if (in(i, j + 1) && gi >= 1 && g.gj(j + 1) >= 1) f |= CYF1;
    if (bi >= H && bi < H + TI && bj >= H && bj < H + TJ) f |= COWN;
    if (bi >= 1) f |= CBI;
    if (bj >= 1) f |= CBJ;
    // the innermost rectangle r that holds the cell, and the cell's place
    // among those of rectangle r that rectangle r + 1 does not hold
    int r = 0;
#pragma unroll
    for (int k = 1; k <= K; ++k)
      if (bi >= rk_lo(k) && bi < rk_hi(k, BH) && bj >= rk_lo(k) &&
          bj < rk_hi(k, BW))
        r = k;
    const int ro = rk_lo(r), co = rk_lo(r);
    const int wo = rk_hi(r, BW) - co;
    int o = (bi - ro) * wo + (bj - co);
    if (r < K) {
      const int ri0 = rk_lo(r + 1), ri1 = rk_hi(r + 1, BH);
      const int ci0 = rk_lo(r + 1), ci1 = rk_hi(r + 1, BW);
      const int wi = ci1 - ci0;
      o -= wi * max(0, min(bi, ri1) - ri0);
      if (bi >= ri0 && bi < ri1) o -= max(0, min(bj, ci1) - ci0);
      o += rk_count(r + 1, BH, BW);
    }
    cfl[o] = f | (unsigned)q << 16;
    cof[o] = p;
#pragma unroll
    for (int d = 0; d < k2D; ++d)
      extpom::cp_async(sm + kTwo + d * P + q, m.two[d] + p, f & CIN);
  }
  __syncthreads();

  // level s + 1 of the input field and velocities into their rings, 0
  // outside the array
  auto stage = [&](int k) {
    const long lf = (long)(first && k == kb - 1 ? kb - 2 : k) * g.n;
    const long lk = (long)k * g.n;
    T *const df = sm + F(0, 1), *const dx = sm + V(0, 0, 1),
             *const dy = sm + V(0, 1, 1), *const dz = sm + V(0, 2, 1);
    for (int o = t; o < P; o += nt) {
      const unsigned e = cfl[o];
      const int q = (int)(e >> 16), p = cof[o];
      const bool ok = e & CIN;
      extpom::cp_async(df + q, pf0 + lf + p, ok);
      extpom::cp_async(dx + q, px0 + lk + p, ok);
      extpom::cp_async(dy + q, py0 + lk + p, ok);
      extpom::cp_async(dz + q, pz0 + lk + p, ok);
    }
    extpom::cp_async_commit();
  };

  constexpr int E = H;  // step n's levels widen by E - n below
  const int lo_in = max(k0 - E, 0), hi_in = min(k1 + NS, kb);
  stage(lo_in);  // as level s + 1 of s = lo_in - 1, in slot 1
  r2 = 1, r3 = 1, r4 = 1;

  for (int s = lo_in; s < k1 + NS; ++s) {
    extpom::cp_async_wait_all();
    __syncthreads();
    if (s + 1 < hi_in) stage(s + 1);
#pragma unroll
    for (int n = 1; n <= NS + 1; ++n) {
      // phase n: the velocities of step a = n-1 at level ka (on A(n-1),
      // the table's first rk_count(2n-2) cells), then the upstream step n
      // at level ku (on Un, its first rk_count(2n-1))
      if (n == NS + 1 && last) break;
      if (n > 1) __syncthreads();
      const int a = n - 1, ka = s - n + 1, ku = s - n;
      const bool conv = n == 1 && first && s < hi_in;
      const bool do_a = n > 1 && ka >= 0 && ka < kb &&
                        ka >= k0 - (E - a - 1) && ka < k1 + (NS - a);
      const bool do_u = n <= NS && ku >= 0 && ku < kb &&
                        ku >= k0 - (E - n) && ku < k1 + (NS - n);
      if (!(conv || do_a || do_u)) continue;
      const int na = do_a ? rk_count(2 * n - 2, BH, BW) : 0;
      const int nu = do_u ? rk_count(2 * n - 1, BH, BW) : 0;
      const int nc = conv ? P : 0;
      const int cells = max(max(na, nu), nc);
      // mass_fluxes at level s: xm, ym in place of the staged u, v
      T* const X0 = sm + V(0, 0, 0);
      T* const Y0 = sm + V(0, 1, 0);
      const bool kx0 = s < kbm1;
      // the velocities of step a at ka from its field and step a-1's
      const T* const Fa = sm + F(a, 1 - n);
      const T* const Fa1 = sm + F(a, -n);
      const T* const Xo = sm + V(a > 0 ? a - 1 : 0, 0, 1 - n);
      const T* const Yo = sm + V(a > 0 ? a - 1 : 0, 1, 1 - n);
      const T* const Zo = sm + V(a > 0 ? a - 1 : 0, 2, 1 - n);
      const bool store = a < NS;
      T* const Xa = store ? sm + V(a, 0, 1 - n) : xout + (long)ka * g.n;
      T* const Ya = store ? sm + V(a, 1, 1 - n) : yout + (long)ka * g.n;
      T* const Za = store ? sm + V(a, 2, 1 - n) : zout + (long)ka * g.n;
      const bool kxa = ka < kbm1, kza = ka >= 1 && ka < kbm1;
      const T dzza = do_a && kza ? m.dzz[ka - 1] : T(1);
      const bool own_a = ka >= k0 && ka < k1;
      // the upstream step n at ku from step n-1
      const T* const Fm = sm + F(n - 1, -n - 1);
      const T* const F0 = sm + F(n - 1, -n);
      const T* const Fp = sm + F(n - 1, 1 - n);
      const T* const Xu = sm + V(n - 1, 0, -n);
      const T* const Yu = sm + V(n - 1, 1, -n);
      const T* const Zk = sm + V(n - 1, 2, -n);
      const T* const Zk1 = sm + V(n - 1, 2, 1 - n);
      T* const Fn = sm + F(n <= NS ? n : NS, -n);
      const bool kint = ku < kbm1, surf = first && n == 1 && ku == 0;
      const bool ztop = ku >= 1, zbot = ku + 1 < kbm1;
      const T dzu = do_u && kint ? m.dz[ku] : T(1);
      const int deta = (first && n == 1 ? DETB : DETF) * P;
      const bool out = do_u && n == NS && ku >= k0 && ku < k1;
      T* const Fo = fout + (long)ku * g.n;
      const T dti2 = m.dti2, vmin = m.vmin, eps = m.eps, sw = m.sw;
      for (int o = t; o < cells; o += nt) {
        const unsigned f = cfl[o];
        const int q = (int)(f >> 16);
        if (o < nc && (f & CIN)) {
          const T dtq = two[DDT * P + q];
          if (f & CBI) {
            const T x = T(0.25) * (two[DDY * P + q - BW] + two[DDY * P + q]) *
                        (two[DDT * P + q - BW] + dtq) * X0[q];
            X0[q] = (kx0 && (f & CXR)) ? x : T(0);
          }
          if (f & CBJ) {
            const T y = T(0.25) * (two[DDX * P + q - 1] + two[DDX * P + q]) *
                        (two[DDT * P + q - 1] + dtq) * Y0[q];
            Y0[q] = (kx0 && (f & CYR)) ? y : T(0);
          }
        }
        if (o < na) {
          // smol_adif, every region formed and selected: the velocities
          // pass through outside their regions, and 0 outside the array
          const T fv = Fa[q];
          const T dt = two[DDT * P + q];
          const T xo = Xo[q], yo = Yo[q], zo = Zo[q];
          const T fw = Fa[q - BW], fs = Fa[q - 1], fu = Fa1[q];
          const T udx = fabs(xo);
          const T u2dt = dti2 * xo * xo * T(2) /
                         (two[DARU * P + q] * (two[DDT * P + q - BW] + dt));
          const T molx = (fv - fw) / (fw + fv + eps);
          const T vdy = fabs(yo);
          const T v2dt = dti2 * yo * yo * T(2) /
                         (two[DARV * P + q] * (two[DDT * P + q - 1] + dt));
          const T moly = (fv - fs) / (fs + fv + eps);
          const T wdz = fabs(zo);
          const T w2dt = dti2 * zo * zo / dzza / dt;
          const T molz = (fu - fv) / (fv + fu + eps);
          const bool low = fv < vmin;
          const T xn = (low || fw < vmin || udx < u2dt)
                           ? T(0) : (udx - u2dt) * molx * sw;
          const T yn = (low || fs < vmin || vdy < v2dt)
                           ? T(0) : (vdy - v2dt) * moly * sw;
          const T zn = (low || fu < vmin || wdz < w2dt)
                           ? T(0) : (wdz - w2dt) * molz * sw;
          const bool inq = f & CIN;
          const T x = !inq ? T(0) : (kxa && (f & CXR)) ? xn : xo;
          const T y = !inq ? T(0) : (kxa && (f & CYR)) ? yn : yo;
          const T z = !inq ? T(0) : (kza && (f & CINT)) ? zn : zo;
          if (store) {
            Xa[q] = x;
            Ya[q] = y;
            Za[q] = z;
          } else if (own_a && (f & (CIN | COWN)) == (CIN | COWN)) {
            const int p = cof[o];
            Xa[p] = x;
            Ya[p] = y;
            Za[p] = z;
          }
        }
        if (o < nu) {
          // the upstream step, formed in the interior and selected; the
          // input elsewhere; times fsm, 0 outside the array
          const T fb = F0[q];
          const T art = two[DART * P + q], h = two[DH * P + q];
          // the upwind fluxes across the faces at (i+1, j), (i, j),
          // (i, j+1), (i, j): 0 outside the array and the region
          const T xe0 = Xu[q + BW], xw0 = Xu[q];
          const T ye0 = Yu[q + 1], ys0 = Yu[q];
          const T fe = F0[q + BW], fwc = F0[q - BW], fn = F0[q + 1],
                  fsc = F0[q - 1];
          const T xe1 = T(0.5) * ((xe0 + fabs(xe0)) * fb +
                                  (xe0 - fabs(xe0)) * fe);
          const T xw = T(0.5) * ((xw0 + fabs(xw0)) * fwc +
                                 (xw0 - fabs(xw0)) * fb);
          const T ye1 = T(0.5) * ((ye0 + fabs(ye0)) * fb +
                                  (ye0 - fabs(ye0)) * fn);
          const T ys = T(0.5) * ((ys0 + fabs(ys0)) * fsc +
                                 (ys0 - fabs(ys0)) * fb);
          const T xe = (f & CXF1) ? xe1 : T(0);
          const T ye = (f & CYF1) ? ye1 : T(0);
          // the vertical fluxes at the top faces of levels ku, ku+1
          T zt = T(0), zb = T(0);
          if (ztop) {
            const T z = Zk[q];
            zt = T(0.5) * ((z + fabs(z)) * fb + (z - fabs(z)) * Fm[q]) * art;
          } else if (surf) {
            zt = Zk[q] * fsurf[cof[o]] * art;
          }
          if (zbot) {
            const T z = Zk1[q];
            zb = T(0.5) * ((z + fabs(z)) * Fp[q] + (z - fabs(z)) * fb) * art;
          }
          const T ff = xe - xw + ye - ys + (zt - zb) / dzu;
          const T fi = (fb * (h + two[deta + q]) * art - dti2 * ff) /
                       ((h + two[DETF * P + q]) * art);
          const T fv = (f & CIN) ? ((kint && (f & CINT)) ? fi : fb) *
                                       two[DFSM * P + q]
                                 : T(0);
          Fn[q] = fv;
          if (out && (f & (CIN | COWN)) == (CIN | COWN)) Fo[cof[o]] = fv;
        }
      }
    }
    r2 = r2 == 1 ? 0 : r2 + 1;
    r3 = r3 == 2 ? 0 : r3 + 1;
    r4 = r4 == 3 ? 0 : r4 + 1;
  }
}

// fn(the instantiation of ns steps with a halo of H) for each pair the
// planner uses, cudaErrorInvalidValue for any other
template <typename T, bool O, typename Fn>
int with_kernel(int ns, int H, Fn fn) {
  constexpr int TI = kTileI<T>, TJ = kTileJ;
  switch (ns * 8 + H) {
    case 1 * 8 + 1: return fn(k_mpdata_tile<T, O, 1, TI, TJ, 1>);
    case 1 * 8 + 2: return fn(k_mpdata_tile<T, O, 1, TI, TJ, 2>);
    case 2 * 8 + 2: return fn(k_mpdata_tile<T, O, 2, TI, TJ, 2>);
    case 2 * 8 + 3: return fn(k_mpdata_tile<T, O, 2, TI, TJ, 3>);
    case 3 * 8 + 3: return fn(k_mpdata_tile<T, O, 3, TI, TJ, 3>);
    case 3 * 8 + 4: return fn(k_mpdata_tile<T, O, 3, TI, TJ, 4>);
    case 4 * 8 + 4: return fn(k_mpdata_tile<T, O, 4, TI, TJ, 4>);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename P>
void take(P& dst, void* const* ptr, int& k) {
  dst = static_cast<P>(ptr[k++]);
}

// ptr: t, s, tb, sb, u, v, w; dt, dx, dy, h, art, aru, arv, fsm, etb, etf;
// dz, dzz; the group before's field of T and S and its six velocities
// (null in the first group); the field of T and S out; the six velocities
// out (null in the last group).  prm: dti2, sw, value_min, epsilon.
// ns steps in the group, `threads` per block, TI x TJ tiles, the column in
// KC chunks of levels.
template <typename T, bool O>
int run(void* const* ptr, const double* prm, int kb, int im, int jm, int R,
        int L, int oi, int oj, int ns, int threads, int TI, int TJ, int KC,
        void* stream) {
  Mpd<T, O> m;
  int k = 0;
  take(m.t, ptr, k); take(m.s, ptr, k); take(m.tb, ptr, k);
  take(m.sb, ptr, k); take(m.u, ptr, k); take(m.v, ptr, k);
  take(m.w, ptr, k);
  for (int d = 0; d < k2D; ++d) take(m.two[d], ptr, k);
  take(m.dz, ptr, k); take(m.dzz, ptr, k);
  for (int f = 0; f < 2; ++f) take(m.fin[f], ptr, k);
  for (int f = 0; f < 6; ++f) take(m.vin[f], ptr, k);
  for (int f = 0; f < 2; ++f) take(m.fout[f], ptr, k);
  for (int f = 0; f < 6; ++f) take(m.vout[f], ptr, k);
  m.first = m.fin[0] == nullptr;
  m.last = m.vout[0] == nullptr;
  bool bad = k != kMpdPointers || kb < 4 || ns < 1 || ns > kMaxGroup ||
             TI < 1 || TJ < 1 || KC < 1 || KC > kb || threads < 32 ||
             threads > kMaxThreads || threads % 32 || !m.dz || !m.dzz ||
             !m.fout[0] || !m.fout[1];
  for (int d = 0; d < k2D; ++d) bad |= !m.two[d];
  bad |= (m.fin[1] == nullptr) != m.first;
  for (int f = 0; f < 6; ++f) {
    bad |= (m.vin[f] == nullptr) != m.first;
    bad |= (m.vout[f] == nullptr) != m.last;
  }
  if (m.first)
    bad |= !m.t || !m.s || !m.tb || !m.sb || !m.u || !m.v || !m.w;
  if (bad) return (int)cudaErrorInvalidValue;
  if (TI != kTileI<T> || TJ != kTileJ) return (int)cudaErrorInvalidValue;
  m.g = extpom::geometry<O>(kb, im, jm, R, L, oi, oj, 0);
  m.kbm1 = kb - 1;
  const int H = ns + (m.last ? 0 : 1);
  m.nj = (m.g.jm + TJ - 1) / TJ;
  m.KC = KC;
  const int ni = (m.g.im + TI - 1) / TI;
  m.dti2 = T(prm[0]);
  m.sw = T(prm[1]);
  m.vmin = T(prm[2]);
  m.eps = T(prm[3]);
  const long smem = smem_bytes<T>(ns, H, TI, TJ);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  return with_kernel<T, O>(ns, H, [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(ni * m.nj, 2, KC), threads, smem, (cudaStream_t)stream>>>(
        m);
    return (int)cudaGetLastError();
  });
}

template <typename T, bool O>
int info(int ns, int H, int threads, int smem, int* out) {
  return with_kernel<T, O>(ns, H, [&](auto kernel) {
    return extpom::tile_info(kernel, threads, smem, out);
  });
}

}  // namespace

extern "C" int extpom_phase_tracer_mpdata_f32(void* const* ptr,
                                              const double* prm, int kb,
                                              int im, int jm, int ns,
                                              int threads, int TI, int TJ,
                                              int KC, void* stream) {
  return run<float, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, ns, threads,
                           TI, TJ, KC, stream);
}

extern "C" int extpom_phase_tracer_mpdata_f64(void* const* ptr,
                                              const double* prm, int kb,
                                              int im, int jm, int ns,
                                              int threads, int TI, int TJ,
                                              int KC, void* stream) {
  return run<double, false>(ptr, prm, kb, im, jm, im, jm, 0, 0, ns, threads,
                            TI, TJ, KC, stream);
}

extern "C" int extpom_phase_tracer_mpdata_mesh_f32(
    void* const* ptr, const double* prm, int kb, int im, int jm, int R, int L,
    int oi, int oj, int ns, int threads, int TI, int TJ, int KC,
    void* stream) {
  return run<float, true>(ptr, prm, kb, im, jm, R, L, oi, oj, ns, threads,
                          TI, TJ, KC, stream);
}

extern "C" int extpom_phase_tracer_mpdata_mesh_f64(
    void* const* ptr, const double* prm, int kb, int im, int jm, int R, int L,
    int oi, int oj, int ns, int threads, int TI, int TJ, int KC,
    void* stream) {
  return run<double, true>(ptr, prm, kb, im, jm, R, L, oi, oj, ns, threads,
                           TI, TJ, KC, stream);
}

// registers, static and dynamic shared bytes, resident blocks per SM,
// spill bytes and SMs (column.cuh tile_info) of the kernel of ns steps with
// a halo of H, `threads` per block and `smem` dynamic shared bytes; f64
// and mesh pick the instantiation
extern "C" int extpom_phase_tracer_mpdata_info(int f64, int mesh, int ns,
                                               int H, int threads, int smem,
                                               int* out) {
  if (f64)
    return mesh ? info<double, true>(ns, H, threads, smem, out)
                : info<double, false>(ns, H, threads, smem, out);
  return mesh ? info<float, true>(ns, H, threads, smem, out)
              : info<float, false>(ns, H, threads, smem, out);
}
