"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``extpom_tpu_torch/csrc``, holds each
kernel (tridiag, extloop, extwin and the phases lat, uvw, tke, tracer, mom,
and the decomposed step's block kernels extchunk, extwin_chunk and
phase_<p>_mesh) against its plain PyTorch version at the shapes of the
paths that run it, and drives four paths through ``seamount_model`` /
``Model.run_segment`` on the card in float32: the main path (256x256x31,
whose external loop is the whole-grid loop), the large-grid path of
``configs/config5_2048.json`` (2048x2048x41 on one card, whose external
loop is the window kernel), and each of them decomposed over config5's 2x4
mesh with every block on the card (``Model.shard``).  The phase kernels
(column tiles) are also held to their plain versions at config5's depth on
a small grid and on two ragged grids (kb 9 and 4), lat, uvw and mom bit
for bit (uvw with one device launch per call, by the library's count),
and timed on the large-grid path's operands (``[large_phases]``) and, with
the window chunks, on every call of one step of its decomposed blocks
(``[large_mesh_phases]``), with the registers, shared memory and resident
blocks the card gives them.  Two more paths go through the run driver
``extpom_tpu_torch.run`` with NetCDF snapshots and Zarr restarts
(the port's own store, blosc-lz4 chunks as the JAX package writes them,
each store gated on that format and the last snapshot and restart read
back bit-equal to the run's state), each resumed from its mid-run restart
and held equal to the whole run: the main path's seamount (``[cli]``, 48
steps; ``[cli_zarr]`` the same with Zarr snapshots) and the tidal channel
at 512x512x31, whose lateral
series are staged on the card a window per segment and interpolated at
every step (``[channel]``, 120 steps; the window kernel where the L2
dispatch picks it), each of whose kernels is held to its plain version on
the operands of steps after the restart (``[channel_kernels]``);
``[channel_check]`` holds the channel's float64 kernel path, with the
whole-grid loop and with the window kernel, to the plain path on the CPU,
beside the plain path on the card and a one-ulp change of T.  Then the
options: ``[orlanski]`` and ``[orlanski_mesh]`` (the main path under
Orlanski edges), ``[basin]`` (mode 2 at 512x512x31), ``[mode2]`` (the
main path in mode 2 under extpom edges, against the CPU), and the phase
options of lat, tracer and mom: ``[options]`` (the main path under
McCalpin's pressure gradient and MPDATA, 22 steps, lat, tracer and
MPDATA's launches held to their plain versions on step 3's operands;
``[mpdata_edges]`` holds MPDATA's kernel bit for bit at every nitera up to
8, on grids no tile divides, on fields that cross value_min and on every
block of a 2x4 mesh),
``[options_mesh]`` (the same on the 2x4 mesh, bit-equal to one device) and
``[file_restore]`` (the 512x512x31 channel through ``run.main`` under the
file scheme with interior restoring from an lbry file written from a
seed; mom and tracer held to their plain versions on steps whose series
change), with their float64 checks against the CPU (``[options_check]``,
``[file_restore_check]``).  Then the forced and the padded paths:
``[channel_mesh]`` and ``[file_restore_mesh]`` (``[channel]`` and
``[file_restore]`` with config5's 2x4 mesh block, their series staged and
cut to the blocks; each bit-equal to its single-device run, mom's block
variant with ``bc_vel3d`` held to its plain version) and ``[ragged]`` (the
main path at 255x255x31, which ``Model.shard`` pads to 256x256 on the 2x4
mesh, and ``pad_model`` on one device, held on the active region to the
unpadded run; the block kernels on the corner block that holds pad cells
on both axes).  Last, several processes: two ranks of this script
(``--rank``, launched as torchrun would, the kernels built by this
process) share the card over gloo, each holding its block row of
config5's 2x4 mesh, built through ``run.build_model`` (the case on the
host, each block cold-started on the card): ``[distributed]`` (the main
path, 22 steps) and ``[distributed_large]`` (config5's case, config, mesh
and two processes, 7 steps), each held bit for bit to ``[mesh]``'s or
``[large_mesh]``'s blocks by fingerprints of every field, their launches
summed to that run's, with each rank's ms per step, exchange, busy
device time and peak memory; ``[nccl_refusal]`` shows nccl refusing two
ranks on one card before a step; ``[config4]`` runs BASELINE config 4
(the seamount at 512x512x31 on config5's 2x4 mesh) through ``python -m
extpom_tpu_torch.run`` as two processes with Zarr snapshots and restarts,
resumes it from its mid-run restart as two processes (the last restart
bit-equal) and holds its snapshots to the same file run in one process,
with each rank's ms per step, writer and encoder seconds and bytes written,
raw and stored.  ``[tolerance]`` holds the float32 kernels to the float64
kernels over the f32 tolerance ladder's runs (VALIDATION.md §2).
``[forcing]`` holds the step's forcing on the card (``kernels/forcing.py``,
one launch of ``k_forcing_interp``) to the plain path by ``torch.equal``
in float32 and float64, on the staged series of ``[channel]`` and
``[file_restore]``, whole and windowed, and on every series of the forced
regional domain at 2048x2048x41, timed there beside its byte bound; the
paths that stage a plan count its launches under ``forcing``.
``[diag]`` holds the print's compensated sums on the card
(``kernels/diagsum.py``) to the plain sums, and at 256² to ``math.fsum``
of their cells, in float32 and float64 at 256x256x31, on config5's
2048x2048x41 (synthetic operands), on a ragged 255x255x31 grid under
``pad_model``, on block (0, 1) of the 2x4 mesh and through the mesh's
block form, with five calls of the same bits and both paths timed.  The
Thomas kernel is held to its plain
version bit for bit and timed at 256x256x31, 256x256x41 and
2048x2048x41.  It checks the
results, prints the dispatch echo of ten, one ``kernels`` JSON line,
the card's name and power limit, and a last JSON line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero; without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

IM, JM, KB = 256, 256, 31      # main-path grid
SEG_WARM, SEG_TIMED = 2, 20    # run_segment lengths of the slice phase
LARGE_WARM, LARGE_TIMED = 2, 5  # run_segment lengths of the large phase
# fields the decomposed large-grid run is held to the single-device one on
LARGE_CHECK = ("el", "ua", "va", "u", "v", "t", "s", "q2")
ROOT = os.path.dirname(os.path.abspath(__file__))
LARGE = os.path.join(ROOT, "configs", "config5_2048.json")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}   # non-tensor
# flops per grid point per external substep of the plain algorithm
# (core/stepper.py:mode_external_substep): d 1, fluxes 8, elf 8, bc_el 1,
# advave 71, uaf 38, vaf 38, dum/dvm 2, tail + Asselin + accumulators 32
EXTLOOP_FLOPS_PER_POINT = 199
# device kernels of the external loops, as the profiler names them: the
# persistent loop is one launch per call (metrics included); the window
# kernel launches k_metrics once per step
EXT_KERNELS = {"extloop": ("::k_extloop<",),
               "extwin": ("::k_window<",), "ext_metrics": ("::k_metrics<",)}
PHASES = ("lat", "uvw", "tke", "tracer", "mom")
TILED = PHASES   # every phase kernel is a column tile (kernels/phases.py)
# phase kernels held to their plain versions bit for bit (+, -, *, / and
# sqrt only, each correctly rounded on the card)
BIT_EQUAL = ("lat", "uvw", "mom")
# config5's depth on a small grid; ragged grids (one-row and one-column
# last tiles) at kb 9 and the smallest solve's kb 4
DEEP = ((96, 80, 41), (33, 65, 9), (17, 33, 4))
# device kernels of each phase (csrc/phase_*.cu), as the profiler names them
PHASE_KERNELS = {"lat": ("::k_lat_tile<",), "uvw": ("::k_uvw_tile<",),
                 "tke": ("::k_tke_tile<",),
                 "tracer": ("::k_tracer_tile<", "::k_tracer_edge<",
                            "::k_mpdata_tile<"),
                 "mom": ("::k_mom_tile<", "::k_mom_edge<")}
# the block kernels of the decomposed step, as the profiler names them
MESH_KERNELS = {"extchunk": EXT_KERNELS["extloop"],
                "extwin_chunk": EXT_KERNELS["extwin"],
                "ext_metrics": EXT_KERNELS["ext_metrics"],
                **{f"phase_{p}_mesh": PHASE_KERNELS[p] for p in PHASES}}
# each phase's outputs, in the order it returns them
PHASE_OUTPUTS = {"lat": ("aam", "advx", "advy", "drhox", "drhoy"),
                 "uvw": ("u", "v", "w"),
                 "tke": ("q2", "q2b", "q2l", "q2lb", "km", "kh", "kq", "l"),
                 "tracer": ("t", "tb", "s", "sb", "rho"),
                 "mom": ("u", "ub", "v", "vb", "wubot", "wvbot")}
# flops per grid point (column level) of each phase's plain algorithm,
# counted from its source: lat advct ~220, baropg ~40, aam ~20; uvw ~20; tke
# advq ~60 per field, profq ~170 (sound speed, buoyancy, length scale,
# production, two solves, stability functions), bc and Asselin ~10; tracer
# ~120 per tracer (fluxes, solve, Asselin) and ~45 for dens; mom ~50 per
# component and ~20 for Orlanski and Asselin
PHASE_FLOPS_PER_POINT = {"lat": 280, "uvw": 20, "tke": 300, "tracer": 285,
                         "mom": 120}
SPIN_CYCLES = 2_000_000        # ~1 ms spin ahead of each timed call
TOL = {  # max |kernel - plain| / max |plain|, per output field
    "tridiag": {torch.float64: 1e-12, torch.float32: 1e-5},
    "extloop": {torch.float64: 1e-10, torch.float32: 1e-5},
    "phase": {torch.float64: 1e-10, torch.float32: 1e-5},
}
GOLDEN = os.path.join(ROOT, "tests", "golden", "seamount_33x33x11_10steps.npz")


def say(tag: str, **kv) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


class L2Flush:
    """Writes 64 MB (more than the 50 MB L2) so that the next launch finds
    its inputs in device memory, as a caller that just produced them
    elsewhere would."""

    def __init__(self):
        self.buf = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                               device="cuda")

    def __call__(self):
        self.buf.zero_()


def call_ms(fn, reps: int, flush: L2Flush) -> float:
    """Mean time of one call of ``fn`` in ms, host work included: CUDA
    events around each call, after an L2 flush."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def host_ms(fn, reps: int) -> float:
    """Mean host time in ms to issue one call of ``fn``: the wrapper's
    checks, planning, allocations and launch, while a spin kernel keeps the
    card busy so that no launch waits for room in the queue."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(4 * SPIN_CYCLES)
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / reps * 1e3


def _kernel_events(prof):
    """The profile's device-side kernel rows (the CPU op rows carry the
    same device time again, so they are left out)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def device_ms(fn, reps: int, flush: L2Flush) -> float:
    """Mean device time of one call of ``fn`` in ms, from CUDA events.

    Before each call a spin kernel holds the card for about a millisecond
    while the host enqueues the L2 flush and the call, so the events span
    the call's kernels run back to back rather than the host work that
    issues them.  A call whose host work outlasts the spin (the plain
    versions) also counts the gaps the host leaves on the card."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|): each field is held to
    its own scale, so a field of small values is checked as closely as a
    large one (0 where both are 0, inf where only ``want`` is)."""
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    return err, (err / scale if scale > 0 else (0.0 if err == 0 else
                                                  float("inf")))


def tridiag_operands(kb: int, im: int, jm: int, dtype, variant, scalar: bool,
                     gen: torch.Generator) -> list:
    """The ten operands of one solve on the card, from ``gen``: diagonally
    dominant coefficients, and for a ``variant`` without a bottom row
    coupling (profq's) cl = 0, db = 1 and mask = 1, as 0-d tensors when
    ``scalar`` (the kernel reads them by stride, broadcast)."""
    k0, k_last, use_cl, use_mask = variant
    r = lambda shape, s, o: o + s * torch.rand(shape, generator=gen,
                                               device="cuda", dtype=dtype)
    r3 = lambda s=1.0, o=0.0: r((kb, im, jm), s, o)
    r2 = lambda s=1.0, o=0.0: r((im, jm), s, o)
    const = lambda x: (torch.tensor(x, dtype=dtype, device="cuda") if scalar
                       else torch.full((im, jm), x, dtype=dtype,
                                       device="cuda"))
    a, c = -r3(0.5, 0.1), -r3(0.5, 0.1)
    den, rhs = r3(0.2, 1.0), r3(2.0, -1.0)
    ee0, gg0 = r2(0.5), r2(1.0)
    cl = a[k_last] if use_cl else const(0.0)
    rb = r2(1.0)
    db = r2(0.5, -1.5) if use_cl else const(1.0)
    mask = ((r2() > 0.3).to(dtype) if use_mask else const(1.0))
    return [a, c, den, rhs, ee0, gg0, cl, rb, db, mask]


def tridiag_phase(flush: L2Flush) -> dict:
    """The Thomas kernel against thomas_plain, bit for bit, and timed beside
    its bound: at the main path's 256x256x31 the three (k0, k_last)
    variants of the vertical solvers (profq's also with scalar cl, db and
    mask), at 256x256x41 and at config5's 2048x2048x41 the proft/profu
    variant, f64 and f32."""
    from extpom_tpu_torch.kernels import tridiag
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    entry = {}
    for kb, im, jm in ((KB, IM, JM), (41, IM, JM), (41, 2048, 2048)):
        n = im * jm
        main = (kb, im, jm) == (KB, IM, JM)
        # (k0, k_last, use_cl, use_mask, scalar): proft/profu/profv, profq
        # q2, profq q2l
        cases = [(1, kb - 2, True, True, False)]
        if main:
            cases += [(1, kb - 1, False, False, s) for s in (False, True)]
            cases += [(2, kb - 1, False, False, s) for s in (False, True)]
        for dtype in (torch.float64, torch.float32):
            item = torch.finfo(dtype).bits // 8
            info = tridiag.kernel_info(kb, dtype)
            for k0, k_last, use_cl, use_mask, scalar in cases:
                args = tridiag_operands(kb, im, jm, dtype,
                                        (k0, k_last, use_cl, use_mask),
                                        scalar, gen)
                # the plain version takes (im, jm) operands: the
                # broadcast views of the scalars (no copy either)
                full = [x if i < 4 else torch.broadcast_to(x, (im, jm))
                        for i, x in enumerate(args)]
                got = tridiag.thomas(*args, k0, k_last)
                want = tridiag.thomas_plain(*full, k0, k_last)
                torch.cuda.synchronize()
                err, rel = rel_err(got, want)
                equal = torch.equal(got, want)
                del got, want
                run = lambda: tridiag.thomas(*args, k0, k_last)
                reps = 20 if n <= IM * JM else 5
                ms = device_ms(run, reps, flush)
                wall_ms = call_ms(run, reps, flush)
                plain_ms = device_ms(
                    lambda: tridiag.thomas_plain(*full, k0, k_last), 3,
                    flush)
                # each operand read once as the caller keeps it, out once
                nbytes = (sum(x.numel() for x in args) + kb * n) * item
                flops = n * (9 * (k_last - k0) + 7 + 3 * k_last)
                bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                bound_ops = flops / PEAK_FLOPS[dtype] * 1e3
                bound = max(bound_bytes, bound_ops)
                say("tridiag", grid=f"{im}x{jm}x{kb}",
                    dtype=str(dtype).split(".")[1], k0=k0, k_last=k_last,
                    scalar_2d=scalar, max_abs_err=f"{err:.3e}",
                    rel_err=f"{rel:.3e}", bit_equal=equal, ms=f"{ms:.5f}",
                    call_ms=f"{wall_ms:.5f}", plain_ms=f"{plain_ms:.4f}",
                    bound_ms=f"{bound:.5f}", threads=info["threads"],
                    registers=info["registers"],
                    shared_bytes=info["static_smem"] + info["dynamic_smem"],
                    blocks_per_sm=info["blocks_per_sm"],
                    spill_bytes=info["spill_bytes"])
                if not equal:
                    raise AssertionError(
                        f"tridiag kernel is not bit-equal to thomas_plain "
                        f"({im}x{jm}x{kb} {dtype}, k0={k0}, "
                        f"k_last={k_last}, scalar={scalar}): rel {rel}")
                del args, full
                if (k0, k_last) != (1, kb - 2):   # 4 of the 6 solves
                    continue
                if dtype == torch.float64:
                    if main:
                        entry["f64_max_abs_err"] = err
                elif main:
                    entry.update(
                        max_abs_err=err, ms=ms, call_ms=wall_ms,
                        plain_ms=plain_ms, bound_ms=bound,
                        bound_by="bytes" if bound_bytes >= bound_ops
                        else "operations", bit_equal=equal,
                        variant=f"k0=1,k_last={kb - 2}",
                        threads=info["threads"],
                        registers=info["registers"],
                        shared_bytes=info["dynamic_smem"],
                        blocks_per_sm=info["blocks_per_sm"])
                else:
                    key = "kb41" if im == IM else "large_2048"
                    entry.update({f"{key}_ms": ms, f"{key}_bound_ms": bound,
                                  f"{key}_plain_ms": plain_ms})
        torch.cuda.empty_cache()
    return entry


def step_inputs():
    """The operands of the third step of a 256x256x31 float64 seamount cold
    start, all computed by the plain path on the CPU: two steps, then the
    third step's lateral terms, vertical integrals, external loop and
    internal phases, keeping the external loop's and each phase kernel's
    operands.  Returns (extloop operands, grid, cfg, {phase: arguments})."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.core import stepper
    from extpom_tpu_torch.kernels import extloop, phases
    m = seamount_model(im=IM, jm=JM, kb=KB, dtype="float64", device="cpu")
    m.run_segment(2)
    g, cfg, st = m.grid, m.cfg, m.state
    fc = m.base_forcing.replace(ramp=torch.tensor(
        stepper.ramp_at(cfg, 3, m.period), dtype=torch.float64))
    dt = g.h + st.et
    # d = h + el only where the phase reads it, as core/stepper.py passes it
    depth = lambda p, el: g.h + el if phases.reads_depth(p, cfg) else None
    args = {"lat": (st.u, st.v, st.ub, st.vb, st.aam, st.rho, m.rmean, dt,
                    depth("lat", st.el), fc.ramp)}
    aam, advx, advy, drhox, drhoy = phases.phase_lat(g, cfg, *args["lat"])
    (adx2d, ady2d, drx2d, dry2d, aam2d, advua, advva, wubot, wvbot,
     egf, utf, vtf) = stepper.mode_interaction(g, cfg, st, aam, advx, advy,
                                               drhox, drhoy)
    c0 = stepper.ExtCarry(st.el, st.elb, st.ua, st.uab, st.va, st.vab,
                          st.etf, egf, utf, vtf, advua, advva, wubot, wvbot)
    aux = (adx2d, ady2d, drx2d, dry2d, aam2d)
    c = extloop.run_external_loop(g, cfg, c0, fc, aux)
    # mode_internal's sequence (core/stepper.py)
    args["uvw"] = (st.u, st.v, st.w, dt, st.utb, st.vtb, c.utf, c.vtf,
                   st.etb, c.etf, st.vfluxb, fc.vflux)
    u, v, w = phases.phase_uvw(g, cfg, *args["uvw"])
    args["tke"] = (st.q2, st.q2b, st.q2l, st.q2lb, u, v, w, aam, st.t, st.s,
                   st.rho, st.km, st.kh, st.kq, dt, st.etb, c.etf, c.wubot,
                   c.wvbot, fc)
    _, _, _, _, km, kh, _, _ = phases.phase_tke(g, cfg, *args["tke"])
    args["tracer"] = (st.t, st.tb, st.s, st.sb, m.tclim, m.sclim, u, v, w,
                      aam, kh, dt, st.etb, c.etf, fc)
    args["mom"] = (u, st.ub, v, st.vb, w, advx, advy, drhox, drhoy, km, dt,
                   c.egf, st.egb, st.etb, c.etf, depth("mom", c.el), fc)
    return (g, cfg, c0, fc, aux), g, cfg, args


def cast(x, dtype):
    """A tensor, or a Grid/Forcing of tensors, on the card in ``dtype``
    (None stays None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device="cuda", dtype=dtype).contiguous()
    return x.__class__(**{k: cast(v, dtype) for k, v in vars(x).items()})


def on_card(inputs, dtype):
    """The extloop operands of ``step_inputs`` on the card in ``dtype``."""
    from extpom_tpu_torch.core import stepper
    g, cfg, c0, fc, aux = inputs
    return (cast(g, dtype), cfg.replace(dtype=str(dtype).split(".")[1]),
            stepper.ExtCarry(*(cast(x, dtype) for x in c0)),
            cast(fc, dtype), tuple(cast(x, dtype) for x in aux))


def loop_fields(run, dtype, cells: int, block: bool, nsub: int,
                flush: L2Flush) -> dict:
    """The persistent external loop's launch: kernels the library launched
    in one call of ``run``, the threads, grid and what the card gives the
    kernel there (registers, shared bytes, blocks per SM, spill), its
    barriers per substep and the barrier floor (an empty persistent
    kernel passing the same barriers on the same grid)."""
    from extpom_tpu_torch.kernels import extloop
    before = extloop.device_launches()
    run()
    launches = extloop.device_launches() - before
    threads, blocks = extloop.plan_grid(dtype, cells, block)
    info = extloop.loop_info(dtype, block, threads)
    n = extloop.BARRIERS * nsub
    floor = device_ms(lambda: extloop.barrier_floor("cuda", threads, blocks,
                                                    n), 20, flush)
    return dict(device_launches=launches,
                barriers_per_substep=extloop.BARRIERS,
                barrier_floor_ms=floor, threads=threads, grid=blocks,
                registers=info["registers"],
                shared_bytes=info["static_smem"] + info["dynamic_smem"],
                blocks_per_sm=info["blocks_per_sm"],
                spill_bytes=info["spill_bytes"])


def extloop_phase(flush: L2Flush, inputs) -> dict:
    from extpom_tpu_torch.kernels import extloop
    entry = {}
    n = IM * JM
    for dtype in (torch.float64, torch.float32):
        item = torch.finfo(dtype).bits // 8
        grid, cfg, c0, fc, aux = on_card(inputs, dtype)
        got = extloop.run_external_loop(grid, cfg, c0, fc, aux)
        want = extloop.run_external_loop_plain(grid, cfg, c0, fc, aux)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, want))
        if not bit_equal:
            raise AssertionError(f"extloop kernel is not bit-equal to the "
                                 f"plain loop ({dtype})")
        tol = TOL["extloop"][dtype]
        worst = (0.0, 0.0, "none")
        for name, a, b in zip(extloop.CARRY_FIELDS, got, want):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"extloop kernel: {name} not finite")
            err, rel = rel_err(a, b)
            if rel > worst[1]:
                worst = (err, rel, name)
            if not rel <= tol:
                raise AssertionError(
                    f"extloop kernel disagrees with the plain loop on "
                    f"{name}: {rel} > {tol} ({dtype})")
        run = lambda: extloop.run_external_loop(grid, cfg, c0, fc, aux)
        launch = loop_fields(run, dtype, n, False, cfg.isplit, flush)
        ms = device_ms(run, 20, flush)
        wall_ms = call_ms(run, 20, flush)
        plain_ms = device_ms(
            lambda: extloop.run_external_loop_plain(grid, cfg, c0, fc, aux),
            3, flush)
        nbytes = ((34 + 14) * n + 6 * JM + 6 * IM + 1) * item
        flops = EXTLOOP_FLOPS_PER_POINT * cfg.isplit * n
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / PEAK_FLOPS[dtype] * 1e3
        say("extloop", dtype=str(dtype).split(".")[1], isplit=cfg.isplit,
            max_abs_err=f"{worst[0]:.3e}", rel_err=f"{worst[1]:.3e}",
            worst_field=worst[2], tol=tol, ms=f"{ms:.4f}",
            call_ms=f"{wall_ms:.4f}", plain_ms=f"{plain_ms:.3f}",
            bound_ms=f"{max(bound_bytes, bound_ops):.5f}",
            bit_equal=bit_equal,
            **{k: f"{v:.4f}" if isinstance(v, float) else v
               for k, v in launch.items()})
        if dtype == torch.float64:
            entry.update(f64_max_abs_err=worst[0], f64_ms=ms,
                         f64_barrier_floor_ms=launch["barrier_floor_ms"])
        else:
            entry.update(**launch, bit_equal=bit_equal)
            entry.update(max_abs_err=worst[0], ms=ms, call_ms=wall_ms,
                         plain_ms=plain_ms,
                         bound_ms=max(bound_bytes, bound_ops),
                         bound_by="bytes" if bound_bytes >= bound_ops
                         else "operations")
    return entry


def tile_fields(phase: str, dtype, kb: int, shape, mesh: bool = False) -> dict:
    """The tile a column-tile kernel is planned with on (kb, R, L) operands
    (``shape`` ends in R, L) and what the card gives it: whether it keeps
    its levels in shared memory (mom), the blocks launched, registers,
    static and dynamic shared bytes, resident blocks per SM."""
    from extpom_tpu_torch.kernels import phases
    tile, blocks = phases.plan_tile(phase, dtype, kb, *shape[-2:], mesh)
    info = phases.tile_info(phase, dtype, tile, mesh)
    return dict(tile=f"{tile.ti}x{tile.tj}", keep=tile.keep,
                launch_blocks=blocks,
                registers=info["registers"],
                static_smem=info["static_smem"],
                dynamic_smem=info["dynamic_smem"],
                blocks_per_sm=info["blocks_per_sm"],
                spill_bytes=info["spill_bytes"])


def edge_columns(c, shape, off) -> int:
    """Columns of an (R, L) array at global ``off`` (the domain's when
    None) on the domain's edge rows or columns (the active domain's of a
    padded grid)."""
    R, L = shape
    oi, oj = off or (0, 0)
    gi, gj = torch.arange(oi, oi + R), torch.arange(oj, oj + L)
    ia, ja = c.active
    ei = (gi == 0) | (gi == ia - 1)
    ej = (gj == 0) | (gj == ja - 1)
    return int((ei[:, None] | ej[None, :]).sum())


def device_launches(phase: str, run) -> tuple:
    """(result, kernels the library launched) of one call of ``run``; the
    count is the library's own, kept by the uvw entries (None for the
    other kernels)."""
    from extpom_tpu_torch.kernels import phases
    if phase != "uvw":
        return run(), None
    before = phases.uvw_device_launches()
    got = run()
    return got, phases.uvw_device_launches() - before


def phase_bound(phase: str, g, c, a, got, item: int, dtype,
                off=None) -> tuple:
    """(bound ms, bound_by, MB moved) of one phase call: each operand read
    once (the options' too) and each output written once over the HBM rate,
    or its flops over the non-tensor peak.  uvw reads w only where it
    passes through, on the domain's edge columns (vertvl replaces the
    rest)."""
    from extpom_tpu_torch.kernels import phases
    ins = phases.kernel_inputs(phase, g, c, *a)
    ins += phases.option_inputs(phase, g, c, a[-1])
    elems = sum(x.numel() for x in list(ins) + list(got) if x is not None)
    # lat's dzz: read by McCalpin's pressure gradient only
    if phase == "lat" and c.npg == 1:
        elems -= g.dzz.numel()
    if phase == "uvw":
        w = ins[2]
        elems -= w.numel() - w.shape[0] * edge_columns(c, w.shape[-2:], off)
    nbytes = elems * item
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = (PHASE_FLOPS_PER_POINT[phase] * got[0].numel()
                 / PEAK_FLOPS[dtype] * 1e3)
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations",
            nbytes / 1e6)


def phases_phase(flush: L2Flush, grid, cfg, args) -> dict:
    """Each phase kernel against its plain PyTorch version on the card, at
    the main path's shapes, on the operands of ``step_inputs``."""
    from extpom_tpu_torch.kernels import phases
    entries, failed = {}, []
    for phase in PHASES:
        kernel = getattr(phases, f"phase_{phase}")
        plain = getattr(phases, f"phase_{phase}_plain")
        for dtype in (torch.float64, torch.float32):
            item = torch.finfo(dtype).bits // 8
            g = cast(grid, dtype)
            c = cfg.replace(dtype=str(dtype).split(".")[1])
            a = [cast(x, dtype) for x in args[phase]]
            got, launched = device_launches(phase, lambda: kernel(g, c, *a))
            if launched not in (None, 1):
                failed.append(f"phase_{phase} {dtype}: {launched} device "
                              f"launches in one call")
            want = plain(g, c, *a)
            torch.cuda.synchronize()
            tol = TOL["phase"][dtype]
            worst = (0.0, 0.0, "none")
            rels = {}
            for name, x, y in zip(PHASE_OUTPUTS[phase], got, want):
                err, rel = rel_err(x, y)
                rels[name] = float(f"{rel:.3e}")
                if rel >= worst[1]:
                    worst = (err, rel, name)
                if not bool(torch.isfinite(x).all()):
                    failed.append(f"phase_{phase} {dtype}: {name} is not "
                                  f"finite")
                elif not rel <= tol:
                    failed.append(f"phase_{phase} {dtype}: {name} "
                                  f"disagrees with the plain phase, {rel} "
                                  f"> {tol}")
            equal = all(torch.equal(x, y) for x, y in zip(got, want))
            if phase in BIT_EQUAL and not equal:
                failed.append(f"phase_{phase} {dtype}: not bit-equal to "
                              f"the plain phase")
            run = lambda: kernel(g, c, *a)
            ms = device_ms(run, 20, flush)
            wall_ms = call_ms(run, 20, flush)
            issue_ms = host_ms(run, 20)
            plain_ms = device_ms(lambda: plain(g, c, *a), 3, flush)
            bound, by, mb = phase_bound(phase, g, c, a, got, item, dtype)
            tiles = (tile_fields(phase, dtype, KB, a[0].shape)
                     if phase in TILED else {})
            if launched is not None:
                tiles["device_launches"] = launched
            say("phases", phase=phase, dtype=str(dtype).split(".")[1],
                max_abs_err=f"{worst[0]:.3e}", rel_err=f"{worst[1]:.3e}",
                worst_output=worst[2], tol=tol, bit_equal=equal,
                ms=f"{ms:.5f}",
                call_ms=f"{wall_ms:.5f}", host_ms=f"{issue_ms:.5f}",
                plain_ms=f"{plain_ms:.4f}",
                bound_ms=f"{bound:.5f}", mbytes=f"{mb:.2f}", **tiles,
                field_rel_err=json.dumps(rels, separators=(",", ":")))
            if dtype == torch.float64:
                entries[phase] = {"f64_max_abs_err": worst[0]}
            else:
                entries[phase].update(
                    max_abs_err=worst[0], ms=ms, call_ms=wall_ms,
                    plain_ms=plain_ms, bound_ms=bound, bound_by=by, **tiles)
    if failed:
        raise AssertionError("phase kernels disagree with their plain "
                             "versions:\n" + "\n".join(failed))
    return entries


def deep_phases_check() -> None:
    """The tile kernels against their plain versions on the grids of DEEP
    (config5's depth, 96x80x41; ragged 33x65x9 and 17x33x4), f64 and f32,
    on the phases' operands of the second step of a float64 seamount run
    on the card; lat and mom bit for bit."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.kernels import phases
    failed = []
    for im, jm, kb in DEEP:
        m = seamount_model(im=im, jm=jm, kb=kb, dtype="float64")
        m.run_segment(1)
        calls = record_calls(lambda: m.run_segment(1), TILED)
        for phase in TILED:
            (g0, cfg0, *args0), _ = calls[phase][0]
            for dtype in (torch.float64, torch.float32):
                g = cast(g0, dtype)
                c = cfg0.replace(dtype=str(dtype).split(".")[1])
                a = [cast(x, dtype) for x in args0]
                got = getattr(phases, f"phase_{phase}")(g, c, *a)
                want = getattr(phases, f"phase_{phase}_plain")(g, c, *a)
                torch.cuda.synchronize()
                tol = TOL["phase"][dtype]
                worst = (0.0, 0.0, "none")
                for name, x, y in zip(PHASE_OUTPUTS[phase], got, want):
                    err, rel = rel_err(x, y)
                    if rel >= worst[1]:
                        worst = (err, rel, name)
                    if not bool(torch.isfinite(x).all()) or not rel <= tol:
                        failed.append(f"phase_{phase} {dtype} {name}: {rel}")
                equal = all(torch.equal(x, y) for x, y in zip(got, want))
                if phase in BIT_EQUAL and not equal:
                    failed.append(f"phase_{phase} {dtype} {im}x{jm}x{kb}: "
                                  f"not bit-equal")
                say("phases", phase=phase, dtype=str(dtype).split(".")[1],
                    grid=f"{im}x{jm}x{kb}", max_abs_err=f"{worst[0]:.3e}",
                    rel_err=f"{worst[1]:.3e}", worst_output=worst[2],
                    tol=tol, bit_equal=equal,
                    **tile_fields(phase, dtype, kb, a[0].shape))
    if failed:
        raise AssertionError("tile kernels disagree with their plain "
                             "versions:\n" + "\n".join(failed))


def golden_phase() -> None:
    """The kernel path in float64 on the card against the repository's
    golden snapshot (tests/golden, 33x33x11 seamount after 10 steps), at
    tests/test_golden.py's 1e-9 relative tolerance."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    g = np.load(GOLDEN)
    im, jm, kb, n = (int(x) for x in g["meta"])
    m = seamount_model(im=im, jm=jm, kb=kb, dtype="float64", device="cuda")
    m.run(n_steps=n)
    worst = 0.0
    for name in ("el", "u", "v", "t", "s", "q2", "q2l"):
        a = getattr(m.state, name).cpu().numpy()
        b = g[name]
        tol = 1e-9 * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        worst = max(worst, err / tol * 1e-9)
        if not err <= tol:
            raise AssertionError(f"golden {name}: {err} > {tol}")
    say("golden", grid=f"{im}x{jm}x{kb}", steps=n, dtype="float64",
        worst_rel_err=f"{worst:.3e}", tol="1e-9")


def nonsquare_phase(im: int = 40, jm: int = 56, kb: int = 9,
                    steps: int = 4) -> None:
    """The kernel path on the card against the plain path on the CPU, in
    float64 on a grid with im != jm (an i/j mix-up in a kernel's indexing
    would pass on square grids), over the first step and full steps."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    kw = dict(im=im, jm=jm, kb=kb, dtype="float64")
    card = seamount_model(device="cuda", **kw)
    cpu = seamount_model(device="cpu", **kw)
    card.run_segment(steps)
    cpu.run_segment(steps)
    worst = (0.0, "none")
    for name in cpu.state.field_names():
        a = getattr(card.state, name).cpu()
        b = getattr(cpu.state, name)
        err = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        if not err <= 1e-10:
            raise AssertionError(f"card vs CPU, {name}: {err} > 1e-10")
        if err > worst[0]:
            worst = (err, name)
    say("nonsquare", grid=f"{im}x{jm}x{kb}", steps=steps, dtype="float64",
        worst_rel_err=f"{worst[0]:.3e}", worst_field=worst[1], tol="1e-10")


def slice_phase(card: str) -> dict:
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.diag import stats
    m = seamount_model(im=IM, jm=JM, kb=KB)        # float32, on the card
    kernels.reset_launches()
    m.run_segment(SEG_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run_segment(SEG_TIMED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n = SEG_WARM + SEG_TIMED
    # lat runs every step; the first step of a cold start skips the internal
    # phases.  The standalone tridiag kernel is not on the path: the phase
    # kernels solve their columns themselves (column.cuh), as the TPU's
    # fused phase kernel does.
    want = {**dict.fromkeys(launches, 0), "extloop": n, "phase_lat": n,
            "phase_uvw": n - 1, "phase_tke": n - 1, "phase_tracer": n - 1,
            "phase_mom": n - 1}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    for name in m.state.field_names():
        if not bool(torch.isfinite(getattr(m.state, name)).all()):
            raise AssertionError(f"state field {name} is not finite")
    s = {k: float(v) for k, v in
         stats.domain_stats(m.grid, m.cfg, m.state).items()}
    if not abs(s["saver"] - 15.0) <= 1e-4:
        raise AssertionError(f"saver drifted: {s['saver']}")
    ms_step = wall / SEG_TIMED * 1e3
    say("slice", grid=f"{IM}x{JM}x{KB}", dtype="float32", steps=n,
        timed_steps=SEG_TIMED, ms_per_step=f"{ms_step:.3f}",
        grid_point_steps_per_s=f"{IM * JM * KB * SEG_TIMED / wall:.4e}",
        saver=f"{s['saver']:.7f}", taver=f"{s['taver']:.7f}",
        launches=json.dumps(launches, separators=(",", ":")),
        card=f"'{card}'")
    profile_phase(m)
    parts_phase(m)
    return launches


def profile_phase(m, steps: int = 3, tag: str = "profile",
                  groups=None) -> None:
    """Where a step's time goes: device time by kernel group (``groups``,
    the single-device kernels by default) from torch.profiler over
    ``steps`` steps, against the host wall clock."""
    from torch.profiler import ProfilerActivity, profile
    groups = groups or {**EXT_KERNELS, "tridiag": ("thomas_kernel",),
                        **{f"phase_{p}": PHASE_KERNELS[p] for p in PHASES}}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.run_segment(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = dict.fromkeys(list(groups) + ["other"], 0.0)
    n_other = 0
    for e in _kernel_events(prof):
        t = e.self_device_time_total / 1e3   # us -> ms
        key = next((g for g, names in groups.items()
                    if any(k in e.key for k in names)), "other")
        dev[key] += t
        if key == "other":
            n_other += e.count
    busy = sum(dev.values())
    if busy == 0.0:
        say(tag, device_time="not measured (no device events)")
        return
    say(tag, steps=steps, wall_ms_per_step=f"{wall_ms / steps:.3f}",
        device_busy_ms_per_step=f"{busy / steps:.3f}",
        device_idle_share=f"{1.0 - busy / wall_ms:.3f}",
        **{f"{k}_ms_per_step": f"{dev[k] / steps:.4f}" for k in groups},
        plain_torch_ms_per_step=f"{dev['other'] / steps:.3f}",
        plain_torch_kernels_per_step=n_other // steps)


def parts_phase(m, steps: int = 3, tag: str = "parts", parts=None) -> None:
    """Wall time of a step by part: each part that ``stepper.step`` calls
    (or ``stepper.mesh_step``, given its ``parts``) is wrapped so that the
    card is synchronized before and after it, and the host clock time in
    between is summed.  The synchronizations take away the overlap of host
    and card, so the parts of a wrapped step add up to at least the
    unwrapped step's time."""
    from extpom_tpu_torch.core import stepper
    from extpom_tpu_torch.kernels import extloop, extwin, phases
    parts = parts or [
        (phases, "phase_lat"), (stepper, "mode_interaction"),
        (extloop, "run_external_loop"),
        (extwin, "run_external_loop_windowed"), (phases, "phase_uvw"),
        (phases, "phase_tke"), (phases, "phase_tracer"),
        (phases, "phase_mom")]
    spent = dict.fromkeys((name for _, name in parts), 0.0)

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return wrapper

    saved = [(mod, name, getattr(mod, name)) for mod, name in parts]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, timed(name, fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run_segment(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    ms = {k: v / steps * 1e3 for k, v in spent.items()}
    say(tag, steps=steps, wall_ms_per_step=f"{wall / steps * 1e3:.3f}",
        **{f"{k}_ms": f"{v:.3f}" for k, v in ms.items()},
        rest_ms=f"{wall / steps * 1e3 - sum(ms.values()):.3f}")


ALLOC_STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def timed_window(m, steps: int) -> dict:
    """Run ``steps`` steps of ``m`` in one ``run_segment`` and time them.
    Returns the host wall of the window in s, each step's span on the
    card's stream in ms (CUDA events recorded after each call of
    ``stepper.step``, or ``stepper.mesh_step`` on a mesh; no
    synchronization inside the window), and the caching allocator's device
    allocations, frees and retries during the window (each stalls the
    host), with the device allocations of each step."""
    from extpom_tpu_torch.core import stepper
    name = "step" if m.blocks is None else "mesh_step"
    fn = getattr(stepper, name)
    ev = [torch.cuda.Event(enable_timing=True)]
    allocs = []

    def step(*a, **k):
        out = fn(*a, **k)
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
        allocs.append(torch.cuda.memory_stats().get("num_device_alloc", 0))
        return out

    before = torch.cuda.memory_stats()
    torch.cuda.synchronize()
    setattr(stepper, name, step)
    try:
        t0 = time.perf_counter()
        ev[0].record()
        m.run_segment(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        setattr(stepper, name, fn)
    after = torch.cuda.memory_stats()
    allocs = [b - a for a, b in
              zip([before.get("num_device_alloc", 0)] + allocs, allocs)]
    return dict(wall=wall, step_ms=[round(a.elapsed_time(b), 3)
                                    for a, b in zip(ev, ev[1:])],
                step_device_allocs=allocs,
                **{k: after[k] - before[k] for k in ALLOC_STATS
                   if k in after and k in before})


def window_fields(w: dict) -> dict:
    """The say() fields of a ``timed_window``: its spans and allocator
    counts."""
    return dict(**{k: json.dumps(w[k], separators=(",", ":"))
                   for k in ("step_ms", "step_device_allocs")},
                **{k: w[k] for k in ALLOC_STATS if k in w})


def ext_operands(m):
    """The external loop's operands of model ``m``'s next step, on the card:
    that step's lateral terms, from the plain lat phase so that no kernel
    launch is counted, and ``mode_interaction``.  Returns (grid, cfg,
    carry, forcing, aux)."""
    from extpom_tpu_torch.core import stepper
    from extpom_tpu_torch.kernels import phases
    g, cfg, st = m.grid, m.cfg, m.state
    period = m.period if np.isfinite(m.period) else 1.0
    fc = m.base_forcing.replace(ramp=torch.tensor(
        stepper.ramp_at(cfg, m.iint + 1, period), dtype=st.dtype,
        device=g.h.device))
    lat = phases.phase_lat_plain(g, cfg, st.u, st.v, st.ub, st.vb, st.aam,
                                 st.rho, m.rmean, g.h + st.et, g.h + st.el,
                                 fc.ramp)
    (adx2d, ady2d, drx2d, dry2d, aam2d, advua, advva, wubot, wvbot,
     egf, utf, vtf) = stepper.mode_interaction(g, cfg, st, *lat)
    del lat
    c0 = stepper.ExtCarry(st.el.clone(), st.elb.clone(), st.ua.clone(),
                          st.uab.clone(), st.va.clone(), st.vab.clone(),
                          st.etf.clone(), egf, utf, vtf, advua, advva,
                          wubot, wvbot)
    return g, cfg, c0, fc, (adx2d, ady2d, drx2d, dry2d, aam2d)


def large_phase(card: str, flush: L2Flush):
    """The large-grid path: the case and config blocks of
    configs/config5_2048.json (2048x2048x41 float32) on one card through
    ``seamount_model`` / ``Model.run_segment``, LARGE_WARM steps from a cold
    start, then LARGE_TIMED timed steps; the launch counts cover all of
    them.  Between the two, the external loop's operands of the next step
    are kept for ``extwin_phase``.  A second window of LARGE_TIMED steps in
    the same process follows, timed alike, so that a first window that
    reads slower than its profile shows beside one that does not.  Returns
    (launches, those operands, the LARGE_CHECK fields after the first
    window, on the host, and the ``large_phases`` times)."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.diag import stats
    from extpom_tpu_torch.kernels import extwin
    with open(LARGE) as f:
        run = json.load(f)
    t0 = time.perf_counter()
    m = seamount_model(**run["case_args"], **run["config"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = m.cfg
    say("large", config=os.path.relpath(LARGE, ROOT),
        grid=f"{cfg.im}x{cfg.jm}x{cfg.kb}", dtype=cfg.dtype,
        isplit=cfg.isplit, setup_s=f"{setup_s:.1f}",
        not_applied="'mesh block (see [large_mesh]) and distributed block'")
    kernels.reset_launches()
    m.run_segment(LARGE_WARM)
    torch.cuda.synchronize()
    ops = ext_operands(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w1 = timed_window(m, LARGE_TIMED)
    wall = w1["wall"]
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n = LARGE_WARM + LARGE_TIMED
    chunks = cfg.isplit // extwin.chunk_geometry(cfg, 4).C
    want = {**dict.fromkeys(launches, 0), "extwin": n * chunks,
            "phase_lat": n, "phase_uvw": n - 1, "phase_tke": n - 1,
            "phase_tracer": n - 1, "phase_mom": n - 1}
    if launches != want:
        raise AssertionError(f"large: launch counts {launches} != {want}")
    for name in m.state.field_names():
        if not bool(torch.isfinite(getattr(m.state, name)).all()):
            raise AssertionError(f"large: state field {name} is not finite")
    st = {k: float(v) for k, v in
          stats.domain_stats(m.grid, cfg, m.state).items()}
    if not abs(st["saver"] - 15.0) <= 1e-4:
        raise AssertionError(f"large: saver drifted: {st['saver']}")
    cfl = float(stats.cfl_min(m.grid, cfg))
    points = cfg.im * cfg.jm * cfg.kb
    say("large", steps=n, timed_steps=LARGE_TIMED,
        ms_per_step=f"{wall / LARGE_TIMED * 1e3:.3f}",
        grid_point_steps_per_s=f"{points * LARGE_TIMED / wall:.4e}",
        saver=f"{st['saver']:.7f}", taver=f"{st['taver']:.7f}",
        cfl_min_s=f"{cfl:.4f}", dte_s=cfg.dte, dte_below_cfl=cfg.dte < cfl,
        peak_mem_gb=f"{peak / 1e9:.3f}", **window_fields(w1),
        launches=json.dumps(launches, separators=(",", ":")),
        card=f"'{card}'")
    ref = {f: getattr(m.state, f).cpu() for f in LARGE_CHECK}
    w2 = timed_window(m, LARGE_TIMED)
    say("large", window=2, timed_steps=LARGE_TIMED,
        ms_per_step=f"{w2['wall'] / LARGE_TIMED * 1e3:.3f}",
        **window_fields(w2))
    profile_phase(m, steps=2, tag="large_profile")
    parts_phase(m, steps=2, tag="large_parts")
    large = large_phases(flush, m)
    return launches, ops, ref, large


def large_phases(flush: L2Flush, m) -> dict:
    """The phase kernels timed on the large-grid model's next step's
    operands (2048x2048x41 f32): device time by CUDA events after an L2
    flush, beside the bound; the tile kernels with their tiles.  Returns
    {phase: (ms, bound ms)}."""
    from extpom_tpu_torch.kernels import phases
    calls = record_calls(lambda: m.run_segment(1), PHASES)
    out = {}
    for phase in TILED:
        (g, c, *a), _ = calls.pop(phase)[0]
        run = lambda: getattr(phases, f"phase_{phase}")(g, c, *a)
        got = run()
        ms = device_ms(run, 5, flush)
        bound, by, mb = phase_bound(phase, g, c, a, got, 4, torch.float32)
        del got
        tiles = (tile_fields(phase, torch.float32, c.kb, a[0].shape)
                 if phase in TILED else {})
        say("large_phases", phase=phase,
            grid=f"{c.im}x{c.jm}x{c.kb}", dtype="float32", ms=f"{ms:.4f}",
            bound_ms=f"{bound:.5f}", bound_by=by, mbytes=f"{mb:.1f}",
            **tiles)
        out[phase] = (ms, bound)
        del g, c, a, run
    return out


def extwin_info() -> None:
    """What the compiler and the card give ``k_window`` at the geometry
    each path launches it with: the whole-grid kernel at config5's isplit,
    the block variant at the 2048x2048 mesh's ring chunk of 10 substeps."""
    from extpom_tpu_torch.kernels import extwin
    for variant, n_substeps in (("whole", 30), ("block", 10)):
        for dtype in (torch.float32, torch.float64):
            geo = extwin.win_geometry(n_substeps,
                                      torch.finfo(dtype).bits // 8)
            info = extwin.window_info(dtype, geo, block=variant == "block")
            say("extwin_info", kernel=f"k_window<{str(dtype)[6:]},"
                f"{str(variant == 'block').lower()}>", variant=variant,
                C=geo.C, H=geo.H, tile=f"{geo.ti}x{geo.tj}",
                threads=geo.threads, **info)


def extwin_phase(flush: L2Flush, large) -> dict:
    """The window kernel against its plain version and the whole-grid
    chain on the card, bit for bit, in f64 and f32 with ispadv 1 and 2, at
    2048x2048 (the operands of ``large_phase``), at 520x392 (im != jm, not
    a whole number of tiles) and at 40x56 (a few tiles), each from a
    seamount run's third step.  At 2048x2048 ispadv=1 it also times the
    kernel, the plain loop and the chain on the same operands."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.kernels import extloop, extwin
    extwin_info()
    cases = [("2048x2048", large)]
    for im, jm in ((520, 392), (40, 56)):
        m = seamount_model(im=im, jm=jm, kb=5, dtype="float64")
        m.run_segment(2)
        cases.append((f"{im}x{jm}", ext_operands(m)))
    entry = {}
    for grid_name, inputs in cases:
        for dtype in (torch.float64, torch.float32):
            item = torch.finfo(dtype).bits // 8
            g, cfg0, c0, fc, aux = on_card(inputs, dtype)
            for ispadv in (1, 2):
                cfg = cfg0.replace(ispadv=ispadv)
                geo = extwin.chunk_geometry(cfg, item)
                run = lambda: extwin.run_external_loop_windowed(g, cfg, c0,
                                                                fc, aux)
                plain = lambda: extwin.run_external_loop_windowed_plain(
                    g, cfg, c0, fc, aux)
                chain = lambda: extloop.run_external_loop(g, cfg, c0, fc,
                                                          aux)
                got, want = run(), plain()
                same_chain = all(torch.equal(a, b)
                                 for a, b in zip(got, chain()))
                same_plain = all(torch.equal(a, b) for a, b in zip(got, want))
                torch.cuda.synchronize()
                if not (same_chain and same_plain):
                    raise AssertionError(
                        f"extwin kernel not bit-equal ({grid_name}, {dtype}, "
                        f"ispadv={ispadv}): chain {same_chain}, plain "
                        f"{same_plain}")
                tol = TOL["extloop"][dtype]
                worst = (0.0, 0.0, "none")
                for name, a, b in zip(extloop.CARRY_FIELDS, got, want):
                    if not bool(torch.isfinite(a).all()):
                        raise AssertionError(f"extwin kernel: {name} not "
                                             f"finite ({grid_name})")
                    err, rel = rel_err(a, b)
                    if rel >= worst[1]:
                        worst = (err, rel, name)
                    if not rel <= tol:
                        raise AssertionError(
                            f"extwin kernel disagrees with the plain loop on "
                            f"{name}: {rel} > {tol} ({grid_name}, {dtype}, "
                            f"ispadv={ispadv})")
                line = dict(grid=grid_name, dtype=str(dtype).split(".")[1],
                            ispadv=ispadv, isplit=cfg.isplit, C=geo.C,
                            H=geo.H, tile=f"{geo.ti}x{geo.tj}",
                            smem_bytes=geo.smem,
                            max_abs_err=f"{worst[0]:.3e}",
                            rel_err=f"{worst[1]:.3e}",
                            worst_field=worst[2], tol=tol,
                            chain_equal=same_chain, plain_equal=same_plain)
                if grid_name == "2048x2048" and ispadv == 1:
                    n = cfg.im * cfg.jm
                    ms = device_ms(run, 10, flush)
                    wall_ms = call_ms(run, 10, flush)
                    plain_ms = device_ms(plain, 2, flush)
                    nbytes = ((34 + 14) * n + 6 * cfg.jm + 6 * cfg.im
                              + 1) * item
                    flops = EXTLOOP_FLOPS_PER_POINT * cfg.isplit * n
                    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    bound_ops = flops / PEAK_FLOPS[dtype] * 1e3
                    line.update(ms=f"{ms:.4f}", call_ms=f"{wall_ms:.4f}",
                                plain_ms=f"{plain_ms:.3f}",
                                bound_ms=f"{max(bound_bytes, bound_ops):.5f}")
                    chain_ms = device_ms(chain, 5, flush)
                    line.update(chain_ms=f"{chain_ms:.4f}",
                                vs_chain=f"{ms / chain_ms:.4f}")
                    if dtype == torch.float64:
                        entry["f64_max_abs_err"] = worst[0]
                        entry["f64_ms"] = ms
                        entry["f64_chain_ms"] = chain_ms
                    else:
                        entry.update(
                            grid=grid_name, max_abs_err=worst[0], ms=ms,
                            call_ms=wall_ms, plain_ms=plain_ms,
                            bound_ms=max(bound_bytes, bound_ops),
                            bound_by="bytes" if bound_bytes >= bound_ops
                            else "operations", chain_ms=chain_ms,
                            vs_chain=ms / chain_ms)
                say("extwin", **line)
    return entry


# ---------------------------------------------------------------------------
# the decomposed step (Model.shard over config5's mesh, every block on the
# card)
# ---------------------------------------------------------------------------


def mesh_of(run: dict):
    """The ``Mesh`` of a run file's mesh block, every block on the card."""
    from extpom_tpu_torch.mesh.shardmap import Mesh
    if run["mesh"].get("mode", "shardmap") != "shardmap":
        raise AssertionError(f"mesh mode {run['mesh']['mode']!r}")
    return Mesh(run["mesh"]["px"], run["mesh"]["py"], device="cuda")


def record_calls(steps_fn, kinds=PHASES + ("chunk",)):
    """Every call of a phase wrapper, of a block chunk's or of a whole-grid
    external loop's that ``steps_fn()`` makes, as {"lat", ..., "mom",
    "chunk", "extwin_chunk", "extloop", "extwin": [(args, kwargs)]} for
    those of ``kinds``: the wrappers pass through, the operands are
    kept."""
    from extpom_tpu_torch.kernels import extloop, extwin, phases
    calls = {}
    saved = [(phases, f"phase_{p}", p) for p in PHASES if p in kinds]
    if "chunk" in kinds:
        saved.append((extloop, "run_external_chunk", "chunk"))
    if "extwin_chunk" in kinds:
        saved.append((extwin, "run_external_chunk_windowed", "extwin_chunk"))
    if "extloop" in kinds:
        saved.append((extloop, "run_external_loop", "extloop"))
    if "extwin" in kinds:
        saved.append((extwin, "run_external_loop_windowed", "extwin"))
    fns = [getattr(mod, name) for mod, name, _ in saved]

    def spy(key, fn):
        def wrapper(*a, **k):
            calls.setdefault(key, []).append((a, k))
            return fn(*a, **k)
        return wrapper

    try:
        for (mod, name, key), fn in zip(saved, fns):
            setattr(mod, name, spy(key, fn))
        steps_fn()
    finally:
        for (mod, name, _), fn in zip(saved, fns):
            setattr(mod, name, fn)
    return calls


def ring_of(blocks, shape) -> tuple:
    """The ring (hx, hy) of a ring-extended (.., R, L) block."""
    return ((shape[-2] - blocks.ni) // 2, (shape[-1] - blocks.nj) // 2)


def trim_to(blocks, x: torch.Tensor) -> torch.Tensor:
    """The block's own cells of a ring-extended (.., R, L) tensor."""
    return blocks.trim(x, ring_of(blocks, x.shape))


def block_at(blocks, shape, off) -> tuple:
    """The block whose extension by the ring of ``shape`` starts at global
    ``off``."""
    hx, hy = ring_of(blocks, shape)
    return ((off[0] + hx) // blocks.ni, (off[1] + hy) // blocks.nj)


def cast_any(x, dtype):
    """``cast`` of a tensor, Grid or Forcing, through the carry and the aux
    tuple; other values (the Config, ints) as they are."""
    from extpom_tpu_torch.core.grid import Grid
    from extpom_tpu_torch.core.state import Forcing
    if isinstance(x, (torch.Tensor, Grid, Forcing)):
        return cast(x, dtype)
    if hasattr(x, "_fields"):
        return type(x)(*(cast_any(y, dtype) for y in x))
    if isinstance(x, tuple):
        return tuple(cast_any(y, dtype) for y in x)
    return x


def chunk_bound(c, C: int, item: int, dtype) -> tuple:
    """(bound ms, bound_by) of C substeps on an (R, L) block: the chain's
    operands read once and the carry written once, or its operations."""
    R, L = c.el.shape
    n = R * L
    nbytes = ((34 + 14) * n + 6 * L + 6 * R + 1) * item
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = EXTLOOP_FLOPS_PER_POINT * C * n / PEAK_FLOPS[dtype] * 1e3
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations")


def block_call(kind: str, args, kw):
    """(kernel, plain version, block shape (R, L), global offset) of one
    recorded wrapper call; ``kind`` is a phase, ``extchunk`` or
    ``extwin_chunk``."""
    from extpom_tpu_torch.kernels import extloop, extwin, phases
    if kind in PHASES:
        g, cfg, *rest = args
        kernel = lambda: getattr(phases, f"phase_{kind}")(g, cfg, *rest,
                                                          **kw)
        plain = lambda: phases._plain(
            kind, g, cfg, rest, kw["off"],
            **{k: v for k, v in kw.items() if k == "ub"})
        return kernel, plain, rest[0].shape[-2:], kw["off"]
    wrapper = (extloop.run_external_chunk if kind == "extchunk"
               else extwin.run_external_chunk_windowed)
    kernel = lambda: wrapper(*args)
    plain = lambda: extloop.run_external_chunk_plain(*args)
    return kernel, plain, args[2].el.shape, args[7]


def mesh_kernels_phase(flush: L2Flush) -> tuple:
    """The block kernels against their plain versions on the card, in
    float64 and float32, on every block's operands of the third step of the
    main path decomposed 2x4 (256x256x31 f64 seamount; blocks 128x64, phase
    rings of 8, chunks of C=10 substeps on rings of 30), each output to its
    own scale on the block's own cells; the window kernel (whose main path
    is [large_mesh]) on the chunk operands too.  Times each kernel on block
    (0, 1) in float32.  Then holds the f64 decomposed run after 3 steps to
    the single-device one.  Returns ({kernel: entry}, worst f64 error)."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    with open(LARGE) as f:
        mesh = mesh_of(json.load(f))
    kw = dict(im=IM, jm=JM, kb=KB, dtype="float64")
    m = seamount_model(**kw).shard(mesh)
    m.run_segment(2)
    calls = record_calls(lambda: m.run_segment(1))
    blocks = m.blocks
    target = (0, 1)
    kinds = [(p, calls[p]) for p in PHASES] + [
        ("extchunk", calls["chunk"]), ("extwin_chunk", calls["chunk"])]
    entries, failed = {}, []
    for kind, recorded in kinds:
        name = kind if kind.startswith("ext") else f"phase_{kind}_mesh"
        for dtype in (torch.float64, torch.float32):
            item = torch.finfo(dtype).bits // 8
            tol = TOL["phase" if kind in PHASES else "extloop"][dtype]
            worst, timed, equal = (0.0, 0.0, "none"), None, True
            launched = None
            for args, k in recorded:
                args = [cast_any(x, dtype) for x in args]
                args[1] = args[1].replace(dtype=str(dtype).split(".")[1])
                kernel, plain, shape, off = block_call(kind, args, k)
                got, launched = device_launches(kind, kernel)
                if launched not in (None, 1):
                    failed.append(f"{name} {dtype} at {off}: {launched} "
                                  f"device launches in one call")
                want = plain()
                torch.cuda.synchronize()
                for i, (a, b) in enumerate(zip(got, want)):
                    a, b = trim_to(blocks, a), trim_to(blocks, b)
                    err, rel = rel_err(a, b)
                    if rel >= worst[1]:
                        worst = (err, rel, i)
                    if not bool(torch.isfinite(a).all()) or not rel <= tol:
                        failed.append(f"{name} {dtype} output {i}: {rel}")
                    if not torch.equal(a, b):
                        equal = False
                        if kind in BIT_EQUAL or kind == "extchunk":
                            failed.append(f"{name} {dtype} output {i} at "
                                          f"{off}: not bit-equal")
                if timed is None and block_at(blocks, shape, off) == target:
                    timed = (kernel, plain, args, got, off)
            line = dict(kernel=name, dtype=str(dtype).split(".")[1],
                        calls=len(recorded), max_abs_err=f"{worst[0]:.3e}",
                        rel_err=f"{worst[1]:.3e}", worst_output=worst[2],
                        tol=tol, bit_equal=equal)
            if launched is not None:
                line["device_launches_per_call"] = launched
            launch = {}
            if kind == "extchunk":
                kernel, _, args, _, _ = timed
                launch = loop_fields(kernel, dtype, args[2].el.numel(), True,
                                     args[5], flush)
                line.update({k: f"{v:.4f}" if isinstance(v, float) else v
                             for k, v in launch.items()})
            if dtype == torch.float64:
                entries[name] = {"f64_max_abs_err": worst[0]}
                if launch:
                    entries[name]["f64_barrier_floor_ms"] = \
                        launch["barrier_floor_ms"]
            else:
                entries[name].update(**launch, bit_equal=equal)
                kernel, plain, args, got, off = timed
                ms = device_ms(kernel, 20, flush)
                wall_ms = call_ms(kernel, 20, flush)
                plain_ms = device_ms(plain, 3, flush)
                if kind in PHASES:
                    bound, by, _ = phase_bound(kind, args[0], args[1],
                                               args[2:], got, item, dtype,
                                               off)
                    shape = "x".join(map(str, got[0].shape))
                else:
                    bound, by = chunk_bound(args[2], args[5], item, dtype)
                    shape = "x".join(map(str, shape))
                tiles = (tile_fields(kind, dtype, args[1].kb, args[2].shape,
                                     mesh=True)
                         if kind in TILED else {})
                line.update(block=f"'{target} {shape}'", ms=f"{ms:.5f}",
                            call_ms=f"{wall_ms:.5f}",
                            plain_ms=f"{plain_ms:.4f}",
                            bound_ms=f"{bound:.5f}", **tiles)
                entries[name].update(max_abs_err=worst[0], ms=ms,
                                     call_ms=wall_ms, plain_ms=plain_ms,
                                     bound_ms=bound, bound_by=by,
                                     shape=shape, **tiles)
            say("mesh_kernels", **line)
    if failed:
        raise AssertionError("block kernels disagree with their plain "
                             "versions:\n" + "\n".join(failed))
    # the f64 decomposed run (3 steps, the kernels above) against the
    # single-device run
    ref = seamount_model(**kw)
    ref.run_segment(3)
    st = m.gathered_state()
    worst = (0.0, "none")
    for f in st.field_names():
        _, rel = rel_err(getattr(st, f), getattr(ref.state, f))
        if not rel <= 1e-10:
            raise AssertionError(f"mesh f64 vs single device, {f}: {rel}")
        if rel >= worst[0]:
            worst = (rel, f)
    say("mesh_f64", grid=f"{IM}x{JM}x{KB}", mesh=f"{mesh.px}x{mesh.py}",
        steps=3, worst_rel_err=f"{worst[0]:.3e}", worst_field=worst[1],
        tol="1e-10")
    return entries, worst[0]


def chunk_plan(m):
    """The external loop's chunk plan of a decomposed model on the card."""
    from extpom_tpu_torch.mesh import extchunk
    b = m.blocks
    return extchunk.chunk_plan(m.cfg, b.px, b.py, b.ni, b.nj, "cuda",
                               m.grid.h.element_size())


def mesh_parts():
    """The parts of ``stepper.mesh_step`` that ``parts_phase`` times."""
    from extpom_tpu_torch.core import stepper
    from extpom_tpu_torch.kernels import extloop, extwin, phases
    from extpom_tpu_torch.mesh import shardmap
    return [(phases, "phase_lat"), (stepper, "depth_integrals"),
            (stepper, "interaction_2d"), (extloop, "run_external_chunk"),
            (extwin, "run_external_chunk_windowed"), (phases, "phase_uvw"),
            (phases, "phase_tke"), (phases, "phase_tracer"),
            (phases, "phase_mom"), (shardmap, "_ring_extend"),
            (shardmap.Blocks, "trim")]


def mesh_phase(card: str) -> dict:
    """The main path decomposed: 256x256x31 float32 on config5's 2x4 mesh,
    every block on the card, SEG_WARM + SEG_TIMED steps from a cold start
    through ``Model.shard`` / ``Model.run_segment``; then the same steps on
    one device, against which every field is held (1e-5 of its scale)."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.diag import stats
    with open(LARGE) as f:
        mesh = mesh_of(json.load(f))
    m = seamount_model(im=IM, jm=JM, kb=KB).shard(mesh)     # float32
    nb = mesh.px * mesh.py
    kernels.reset_launches()
    m.run_segment(SEG_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run_segment(SEG_TIMED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    prints = block_prints(m.blocks)     # [distributed] is held to them
    n = SEG_WARM + SEG_TIMED
    chunks = nb * m.cfg.isplit // chunk_plan(m).C
    want = {**dict.fromkeys(launches, 0), "extchunk": n * chunks,
            "phase_lat_mesh": n * nb,
            **{f"phase_{p}_mesh": (n - 1) * nb for p in PHASES[1:]}}
    if launches != want:
        raise AssertionError(f"mesh: launch counts {launches} != {want}")
    st = m.gathered_state()
    ref = seamount_model(im=IM, jm=JM, kb=KB)
    ref.run_segment(n)
    worst, equal = (0.0, "none"), True
    for f in st.field_names():
        a, b = getattr(st, f), getattr(ref.state, f)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"mesh: state field {f} is not finite")
        _, rel = rel_err(a, b)
        equal = equal and torch.equal(a, b)
        if not rel <= TOL["phase"][torch.float32]:
            raise AssertionError(f"mesh vs single device, {f}: {rel}")
        if rel >= worst[0]:
            worst = (rel, f)
    s = {k: float(v) for k, v in
         stats.domain_stats(m.grid, m.cfg, st).items()}
    if not abs(s["saver"] - 15.0) <= 1e-4:
        raise AssertionError(f"mesh: saver drifted: {s['saver']}")
    del st, ref
    say("mesh", grid=f"{IM}x{JM}x{KB}", mesh=f"{mesh.px}x{mesh.py}",
        local_tile=f"{m.blocks.ni}x{m.blocks.nj}x{KB}", dtype="float32",
        steps=n, timed_steps=SEG_TIMED,
        ms_per_step=f"{wall / SEG_TIMED * 1e3:.3f}",
        grid_point_steps_per_s=f"{IM * JM * KB * SEG_TIMED / wall:.4e}",
        saver=f"{s['saver']:.7f}", taver=f"{s['taver']:.7f}",
        vs_single_device_max_rel_err=f"{worst[0]:.3e}",
        worst_field=worst[1], bit_equal=equal,
        launches=json.dumps(launches, separators=(",", ":")),
        card=f"'{card}'")
    profile_phase(m, tag="mesh_profile", groups=MESH_KERNELS)
    parts_phase(m, tag="mesh_parts", parts=mesh_parts())
    return launches, prints


def large_mesh_phase(card: str, flush: L2Flush, large_ref: dict):
    """The large-grid path decomposed: configs/config5_2048.json's case,
    config and mesh blocks (2048x2048x41 float32 on 2x4, blocks
    1024x512x41, every block on the card), LARGE_WARM + LARGE_TIMED steps;
    held to ``large_ref``, the single-device run's LARGE_CHECK fields after
    the same steps (1e-5 of each field's scale).  The distributed block is
    not applied.  On block (0, 1)'s first window chunk of the second step
    it holds the window kernel to its plain version (f64 and f32) and times
    it.  Returns (launches, the window kernel's entry)."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.diag import stats
    from extpom_tpu_torch.kernels import extwin
    from extpom_tpu_torch.mesh import shardmap
    with open(LARGE) as f:
        run = json.load(f)
    mesh = mesh_of(run)
    nb = mesh.px * mesh.py
    t0 = time.perf_counter()
    m = seamount_model(**run["case_args"], **run["config"]).shard(mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg, blocks = m.cfg, m.blocks
    say("large_mesh", config=os.path.relpath(LARGE, ROOT),
        grid=f"{cfg.im}x{cfg.jm}x{cfg.kb}", mesh=f"{mesh.px}x{mesh.py}",
        local_tile=f"{blocks.ni}x{blocks.nj}x{cfg.kb}", dtype=cfg.dtype,
        setup_s=f"{setup_s:.1f}",
        not_applied="'distributed block: every block on one card'")
    kept = []
    orig = extwin.run_external_chunk_windowed

    def keep(*a, **k):
        # the operands of block (0, 1)'s first chunk of each warm step
        if a[6] == 1 and block_at(blocks, a[2].el.shape, a[7]) == (0, 1):
            kept.append(a)
        return orig(*a, **k)

    kernels.reset_launches()
    extwin.run_external_chunk_windowed = keep
    try:
        m.run_segment(LARGE_WARM)
    finally:
        extwin.run_external_chunk_windowed = orig
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w1 = timed_window(m, LARGE_TIMED)
    wall = w1["wall"]
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.LAUNCHES)
    prints = block_prints(blocks)       # [distributed_large] is held to them
    n = LARGE_WARM + LARGE_TIMED
    chunks = nb * cfg.isplit // chunk_plan(m).C
    want = {**dict.fromkeys(launches, 0), "extwin_chunk": n * chunks,
            "phase_lat_mesh": n * nb,
            **{f"phase_{p}_mesh": (n - 1) * nb for p in PHASES[1:]}}
    if launches != want:
        raise AssertionError(f"large_mesh: launch counts {launches} != "
                             f"{want}")
    worst, equal = (0.0, "none"), True
    for f in LARGE_CHECK:
        a = shardmap.gather(blocks, blocks.field(f)).cpu()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"large_mesh: {f} is not finite")
        _, rel = rel_err(a, large_ref[f])
        equal = equal and torch.equal(a, large_ref[f])
        if not rel <= TOL["phase"][torch.float32]:
            raise AssertionError(f"large_mesh vs large, {f}: {rel}")
        if rel >= worst[0]:
            worst = (rel, f)
    st = m.gathered_state()
    for f in st.field_names():
        if not bool(torch.isfinite(getattr(st, f)).all()):
            raise AssertionError(f"large_mesh: state field {f} not finite")
    s = {k: float(v) for k, v in stats.domain_stats(m.grid, cfg, st).items()}
    del st
    if not abs(s["saver"] - 15.0) <= 1e-4:
        raise AssertionError(f"large_mesh: saver drifted: {s['saver']}")
    if not peak < 80e9:
        raise AssertionError(f"large_mesh: peak memory {peak}")
    points = cfg.im * cfg.jm * cfg.kb
    say("large_mesh", steps=n, timed_steps=LARGE_TIMED,
        ms_per_step=f"{wall / LARGE_TIMED * 1e3:.3f}",
        grid_point_steps_per_s=f"{points * LARGE_TIMED / wall:.4e}",
        saver=f"{s['saver']:.7f}", taver=f"{s['taver']:.7f}",
        peak_mem_gb=f"{peak / 1e9:.3f}",
        vs_large_max_rel_err=f"{worst[0]:.3e}", worst_field=worst[1],
        bit_equal=equal, **window_fields(w1),
        launches=json.dumps(launches, separators=(",", ":")),
        card=f"'{card}'")
    entry = window_chunk_check(flush, blocks, kept[-1])
    del kept
    profile_phase(m, steps=2, tag="large_mesh_profile", groups=MESH_KERNELS)
    parts_phase(m, steps=2, tag="large_mesh_parts", parts=mesh_parts())
    return launches, entry, large_mesh_phases(flush, m), prints


def large_mesh_phases(flush: L2Flush, m) -> dict:
    """The tile kernels' block variants and the window chunks timed on every
    block of the next step of the decomposed large-grid model (2048x2048x41
    f32 on 2x4): the sum over the step's calls of each call's device time
    (CUDA events after an L2 flush) and of its bound.  Returns {phase or
    "extwin_chunk": (ms, bound ms)} per step."""
    from extpom_tpu_torch.kernels import extwin, phases
    calls = record_calls(lambda: m.run_segment(1), TILED + ("extwin_chunk",))
    out = {}
    for phase in TILED:
        ms = bound = 0.0
        shape = None
        for (g, c, *a), kw in calls.pop(phase):
            run = lambda: getattr(phases, f"phase_{phase}")(g, c, *a, **kw)
            got = run()
            ms += device_ms(run, 5, flush)
            b, by, _ = phase_bound(phase, g, c, a, got, 4, torch.float32,
                                   kw.get("off"))
            bound += b
            shape = "x".join(map(str, got[0].shape))
            del got
        say("large_mesh_phases", phase=phase, block=shape, blocks=m.mesh.px *
            m.mesh.py, dtype="float32", ms_per_step=f"{ms:.4f}",
            bound_ms_per_step=f"{bound:.5f}", bound_by=by,
            **tile_fields(phase, torch.float32, c.kb, a[0].shape,
                          mesh=True))
        out[phase] = (ms, bound)
    ms = bound = 0.0
    chunks = calls.pop("extwin_chunk")
    for a, kw in chunks:
        ms += device_ms(lambda: extwin.run_external_chunk_windowed(*a, **kw),
                        3, flush)
        b, by = chunk_bound(a[2], a[5], 4, torch.float32)
        bound += b
    say("large_mesh_phases", phase="extwin_chunk", chunks=len(chunks),
        blocks=m.mesh.px * m.mesh.py, dtype="float32",
        ms_per_step=f"{ms:.4f}", bound_ms_per_step=f"{bound:.5f}",
        bound_by=by)
    out["extwin_chunk"] = (ms, bound)
    return out


def window_chunk_check(flush: L2Flush, blocks, args) -> dict:
    """The window kernel on one block of [large_mesh] against its plain
    version in f64 and f32 on the block's own cells, and its time in f32."""
    from extpom_tpu_torch.kernels import extloop, extwin
    entry = {}
    _, cfg0, c, _, _, C, iext0, _ = args
    R, L = c.el.shape
    for dtype in (torch.float64, torch.float32):
        item = torch.finfo(dtype).bits // 8
        a = [cast_any(x, dtype) for x in args]
        a[1] = cfg0.replace(dtype=str(dtype).split(".")[1])
        run = lambda: extwin.run_external_chunk_windowed(*a)
        plain = lambda: extloop.run_external_chunk_plain(*a)
        got, want = run(), plain()
        same_chain = all(torch.equal(trim_to(blocks, x), trim_to(blocks, y))
                         for x, y in zip(got, extloop.run_external_chunk(*a)))
        torch.cuda.synchronize()
        if not same_chain:
            raise AssertionError(f"extwin_chunk is not bit-equal to extchunk "
                                 f"on block (0, 1) ({dtype})")
        worst = (0.0, 0.0, 0)
        for i, (x, y) in enumerate(zip(got, want)):
            x, y = trim_to(blocks, x), trim_to(blocks, y)
            err, rel = rel_err(x, y)
            if rel >= worst[1]:
                worst = (err, rel, i)
            tol = TOL["extloop"][dtype]
            if not bool(torch.isfinite(x).all()) or not rel <= tol:
                raise AssertionError(f"extwin_chunk disagrees with the "
                                     f"plain chunk, output {i}: {rel} > "
                                     f"{tol} ({dtype})")
        line = dict(kernel="extwin_chunk", dtype=str(dtype).split(".")[1],
                    block=f"'(0, 1) {R}x{L}'",
                    C=C, iext0=iext0, max_abs_err=f"{worst[0]:.3e}",
                    rel_err=f"{worst[1]:.3e}", worst_output=worst[2],
                    chain_equal=same_chain)
        if dtype == torch.float64:
            entry["f64_max_abs_err"] = worst[0]
        else:
            ms = device_ms(run, 10, flush)
            wall_ms = call_ms(run, 10, flush)
            plain_ms = device_ms(plain, 2, flush)
            bound, by = chunk_bound(a[2], C, item, dtype)
            line.update(ms=f"{ms:.4f}", call_ms=f"{wall_ms:.4f}",
                        plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.5f}")
            entry.update(max_abs_err=worst[0], ms=ms, call_ms=wall_ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         shape=f"{R}x{L}")
        say("mesh_kernels", **line)
    return entry


STEP_S = 180.0                 # dti of the CLI paths (dte 6 s x isplit 30)
CLI_STEPS, CLI_PRINT, CLI_RESTART = 48, 12, 24      # [cli], 256x256x31
CHANNEL = (512, 512, 31)                            # [channel]
CHANNEL_STEPS, CHANNEL_PRINT, CHANNEL_RESTART = 120, 30, 60


def run_cli(conf: dict, tmp: str, tag: str, **extra) -> tuple:
    """The run driver (``extpom_tpu_torch.run.execute``, what ``run.main``
    runs on a run file) on ``conf`` (with ``extra``), out_dir ``tmp/tag``,
    on the card, its output captured.  Returns (the driver's lines, the
    launch counts of the run, its peak device memory, the model at the
    run's end)."""
    from extpom_tpu_torch import kernels, run
    conf = {**conf, **extra, "out_dir": os.path.join(tmp, tag)}
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = run.execute(conf)
    if res.rc != 0:
        raise AssertionError(f"{tag}: the driver returned {res.rc}:\n"
                             + buf.getvalue())
    return (buf.getvalue().splitlines(), dict(kernels.LAUNCHES),
            torch.cuda.max_memory_allocated(), res.model)


# the driver's line of the Zarr chunks it encoded (run.execute)
ENCODER = re.compile(r"encoder: (\d+) chunks in ([\d.]+) s, ([\d.]+) MB "
                     r"into ([\d.]+) MB")


def driver_numbers(lines) -> dict:
    """The numbers of the driver's closing lines: wall seconds and steps,
    the writes, the writer thread's seconds and the driver's blocked
    seconds, the chunks it encoded, their seconds and raw and encoded MB;
    the diagnostics lines; the external machine it echoed."""
    text = "\n".join(lines)
    wall, steps = re.search(r"wall clock: ([\d.]+) s for (\d+) steps",
                            text).groups()
    n, busy, blocked = re.search(
        r"writes: (\d+) in ([\d.]+) s on the writer thread, ([\d.]+) s",
        text).groups()
    machine = re.search(r"external mode: (\S+)", text).group(1)
    enc = ENCODER.search(text).groups()
    return dict(wall=float(wall), steps=int(steps), writes=int(n),
                busy=float(busy), blocked=float(blocked), machine=machine,
                encoded=int(enc[0]), encode_s=float(enc[1]),
                encoded_raw_mb=float(enc[2]), encoded_mb=float(enc[3]),
                prints=[l for l in lines if l.startswith("time =")])


def records(path: str) -> int:
    from scipy.io import netcdf_file
    f = netcdf_file(path, "r", mmap=False)
    try:
        return f.variables["time"].shape[0]
    finally:
        f.close()


def restart_state(path: str, cfg):
    """The State of a (Zarr) restart the driver wrote, on the card."""
    from extpom_tpu_torch.io import zarrstore as zio
    return zio.read_restart(path, cfg, "cuda")


def tree_bytes(path: str) -> int:
    """The bytes of the file ``path``, or of the files under it."""
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def blosc_stores(path: str) -> dict:
    """The Zarr arrays under ``path``, each held to the format the JAX
    package writes through tensorstore: ``.zarray`` carries tensorstore's
    default compressor entry (``zarr.BLOSC``), every chunk file is one
    blosc1 frame of LZ4 (version 2, LZ4 format 1, byte shuffle or none, the
    array's typesize, the chunk's bytes, ``cbytes`` the file's size), and
    no temporary is left.  Returns the arrays, the chunks, their raw bytes
    and the bytes of their frames."""
    from extpom_tpu_torch.io import zarr
    from extpom_tpu_torch.native import zcodec
    n = dict(arrays=0, chunks=0, raw=0, stored=0)
    for d, _, files in os.walk(path):
        if zarr.ZARRAY not in files:
            continue
        with open(os.path.join(d, zarr.ZARRAY)) as f:
            comp = json.load(f)["compressor"]
        if comp != zarr.BLOSC:
            raise AssertionError(f"{d}: compressor {comp}")
        if any(f.startswith(".tmp-") for f in files):
            raise AssertionError(f"{d}: a temporary left")
        z = zarr.Array(d)
        for name in files:
            if not re.fullmatch(r"\d+(\.\d+)*", name):
                continue
            with open(os.path.join(d, name), "rb") as f:
                frame = f.read()
            flags, ts, nbytes, blocksize, cbytes = zcodec.header(frame)
            if not (frame[:2] == b"\x02\x01" and flags >> 5 == 1
                    and not flags & zcodec.BITSHUFFLE
                    and ts == z.dtype.itemsize and nbytes == z.chunk_nbytes
                    and cbytes == len(frame) and blocksize > 0):
                raise AssertionError(
                    f"{d}/{name}: not an LZ4 blosc1 frame of its chunk: "
                    f"{frame[:2]!r}, flags {flags:#x}, typesize {ts}, "
                    f"nbytes {nbytes}, blocksize {blocksize}, cbytes "
                    f"{cbytes} of {len(frame)}")
            n["chunks"] += 1
            n["raw"] += nbytes
            n["stored"] += cbytes
        n["arrays"] += 1
    return n


def per_store(paths) -> tuple:
    """(MB stored, raw MB) per Zarr dataset of ``paths``, each gated by
    :func:`blosc_stores`."""
    sums = [blosc_stores(p) for p in paths]
    return (sum(x["stored"] for x in sums) / len(sums) / 1e6,
            sum(x["raw"] for x in sums) / len(sums) / 1e6)


def assert_lossless(snapshot, restart: str, model, what: str) -> None:
    """The snapshot (a Zarr dataset, or None) and the restart a run wrote at
    its last step, read back through the port's decoder, bit-equal to the
    run's model there: every State field of the restart, every field and
    grid variable of the snapshot."""
    from extpom_tpu_torch.io import zarrstore as zio
    st = model.gathered_state()
    for f in st.field_names():
        got = zio.read_array(restart, f)
        want = getattr(st, f).cpu().numpy()
        if not (got.dtype == want.dtype and np.array_equal(got, want)):
            raise AssertionError(f"{what}: restart field {f} is not the "
                                 f"run's")
    if snapshot is None:
        return
    snap = zio.read_output(snapshot)
    for name in zio.OUTPUT_FIELDS + zio.OUTPUT_GRID_VARS:
        src = st if name in zio.OUTPUT_FIELDS else model.grid
        want = getattr(src, name).cpu().numpy()
        if not (snap[name].dtype == want.dtype
                and np.array_equal(snap[name], want)):
            raise AssertionError(f"{what}: snapshot {name} is not the run's")


def assert_states_equal(a, b, what: str) -> None:
    for f in a.field_names():
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")


def say_driver(tag: str, nums: dict, cells: int, peak: int, card: str,
               **kv) -> None:
    steps = nums["steps"]
    hidden = (1.0 - nums["blocked"] / nums["busy"]) if nums["busy"] else 0.0
    say(tag, wall_s=f"{nums['wall']:.3f}", steps=steps,
        ms_per_step=f"{nums['wall'] / steps * 1e3:.3f}",
        ms_per_step_not_blocked=(
            f"{(nums['wall'] - nums['blocked']) / steps * 1e3:.3f}"),
        mgrid_pt_steps_per_s=f"{cells * steps / nums['wall'] / 1e6:.2f}",
        writes=nums["writes"], write_s=f"{nums['busy']:.3f}",
        driver_blocked_s=f"{nums['blocked']:.3f}",
        write_share_hidden=f"{hidden:.3f}", encoded_chunks=nums["encoded"],
        encode_s=f"{nums['encode_s']:.3f}",
        encoded_raw_mb=f"{nums['encoded_raw_mb']:.3f}",
        encoded_mb=f"{nums['encoded_mb']:.3f}",
        peak_mem_gb=f"{peak / 1e9:.3f}", external=nums["machine"], **kv,
        card=f"'{card}'")


def cli_phase(card: str, fmt: str = "nc") -> tuple:
    """The run driver on the main path's configuration (``run_cli``) on
    the seamount case at 256x256x31 float32 (mode 3, extpom, isplit 30),
    CLI_STEPS steps with a print every CLI_PRINT, a restart every
    CLI_RESTART, snapshots in ``fmt`` (``[cli]``: NetCDF, ``[cli_zarr]``:
    Zarr; the restarts are Zarr under both); then resumed from the restart
    at CLI_RESTART to the end.  The two runs' final restarts are held equal
    field by field, and to a ``Model.run_segment`` run of the same steps;
    one snapshot per print, saver, the exact launch counts of each run,
    every Zarr store as the JAX package writes it (``blosc_stores``), and
    the last restart (and with Zarr snapshots the last snapshot) read back
    bit-equal to the run's model (``assert_lossless``).  Prints the bytes
    written per snapshot and per restart, raw and stored, the writer's and
    the encoder's seconds.  Returns (the whole run's launch counts, the
    resumed run's)."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.diag import stats
    from extpom_tpu_torch.io import netcdf as ncio
    tag = "cli" if fmt == "nc" else f"cli_{fmt}"
    conf = {"run_name": "cli", "case": "seamount",
            "case_args": {"im": IM, "jm": JM, "kb": KB},
            "config": {"dtype": "float32",
                       "days": CLI_STEPS * STEP_S / 86400,
                       "prtd1": CLI_PRINT * STEP_S / 86400,
                       "write_rst": CLI_RESTART * STEP_S / 86400},
            "out_format": fmt}
    with tempfile.TemporaryDirectory() as tmp:
        lines, launches, peak, model = run_cli(conf, tmp, "whole")
        nums = driver_numbers(lines)
        n = CLI_STEPS
        want = {**dict.fromkeys(launches, 0), "extloop": n, "phase_lat": n,
                **{f"phase_{p}": n - 1 for p in PHASES[1:]}}
        if launches != want or nums["machine"] != "cuda-chain":
            raise AssertionError(f"{tag}: {nums['machine']}, launch counts "
                                 f"{launches} != {want}")
        out = os.path.join(tmp, "whole")
        if fmt == "nc":
            n_rec = records(os.path.join(out, "cli.nc"))
            snap_bytes = tree_bytes(os.path.join(out, "cli.nc")) / n_rec
        else:
            snaps = [os.path.join(out, f"cli.{k:06d}")
                     for k in range(CLI_PRINT, n + 1, CLI_PRINT)]
            n_rec = sum(os.path.isfile(os.path.join(d, "attrs.json"))
                        for d in snaps)
            snap_bytes = sum(map(tree_bytes, snaps)) / len(snaps)
        if n_rec != n // CLI_PRINT or len(nums["prints"]) != n_rec:
            raise AssertionError(f"{tag}: {n_rec} snapshots, "
                                 f"{len(nums['prints'])} prints")
        rst = os.path.join(out, f"cli.rst.{n:06d}")
        rst_bytes = tree_bytes(rst)
        rst_mb, rst_raw_mb = per_store([rst])
        if fmt == "nc":
            assert_lossless(None, rst, model, tag)
        else:
            snap_mb, snap_raw_mb = per_store(snaps)
            assert_lossless(snaps[-1], rst, model, tag)
        del model
        ref = seamount_model(im=IM, jm=JM, kb=KB)
        cfg = ref.cfg
        whole, iint, _ = restart_state(rst, cfg)
        s = {k: float(v) for k, v in
             stats.domain_stats(ref.grid, cfg, whole).items()}
        if iint != n or not abs(s["saver"] - 15.0) <= 1e-4:
            raise AssertionError(f"{tag}: iint {iint}, saver {s['saver']}")
        # the fields the reference checkpoints (the run's state after the
        # same steps; the others are held by the resume below)
        ref.run_segment(n)
        for f in ncio.RESTART_FIELDS:
            if not torch.equal(getattr(whole, f), getattr(ref.state, f)):
                raise AssertionError(f"{tag} vs run_segment: {f} differs")
        del ref
        r_lines, r_launches, _, _ = run_cli(
            conf, tmp, "resumed", nread_rst=1,
            read_rst_path=os.path.join(out, f"cli.rst.{CLI_RESTART:06d}"))
        r_nums = driver_numbers(r_lines)
        half = n - CLI_RESTART
        r_want = {**dict.fromkeys(r_launches, 0), "extloop": half,
                  **{f"phase_{p}": half for p in PHASES}}
        if r_launches != r_want:
            raise AssertionError(f"{tag} resumed: launch counts "
                                 f"{r_launches} != {r_want}")
        if r_nums["prints"] != nums["prints"][-len(r_nums["prints"]):]:
            raise AssertionError(f"{tag} resumed: its prints differ")
        resumed, _, _ = restart_state(
            os.path.join(tmp, "resumed", f"cli.rst.{n:06d}"), cfg)
        assert_states_equal(resumed, whole, f"{tag} resumed vs whole")
        stores = blosc_stores(tmp)
    for line in nums["prints"]:
        print(f"[{tag}] {line}", flush=True)
    snap_kv = ({} if fmt == "nc" else dict(
        raw_mb_per_snapshot=f"{snap_raw_mb:.3f}",
        snapshot_ratio=f"{snap_raw_mb / snap_mb:.3f}"))
    say_driver(tag, nums, IM * JM * KB, peak, card,
               grid=f"{IM}x{JM}x{KB}", dtype="float32", out_format=fmt,
               saver=f"{s['saver']:.7f}", snapshots=n_rec,
               mb_per_snapshot=f"{snap_bytes / 1e6:.3f}", **snap_kv,
               mb_per_restart=f"{rst_bytes / 1e6:.3f}",
               raw_mb_per_restart=f"{rst_raw_mb:.3f}",
               restart_ratio=f"{rst_raw_mb / rst_mb:.3f}",
               zarr_arrays_blosc=stores["arrays"],
               zarr_chunks_blosc=stores["chunks"],
               zarr_ratio=f"{stores['raw'] / stores['stored']:.3f}",
               lossless=True, resumed_from=CLI_RESTART,
               resumed_equal=True, run_segment_equal=True,
               launches=json.dumps(launches, separators=(",", ":")),
               resumed_launches=json.dumps(r_launches,
                                           separators=(",", ":")))
    return launches, r_launches


class OpCount:
    """Counts the ATen operations that are not views (each launches a
    kernel on the card) while it is entered."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if not getattr(func, "is_view", False):
                    outer.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


@contextlib.contextmanager
def plain_path():
    """While entered, the stepper calls each kernel's plain PyTorch version
    in place of its wrapper, so that a model on the card runs no kernel of
    its own (the module attributes ``stepper`` reads are swapped)."""
    from extpom_tpu_torch.kernels import extloop, extwin, phases
    swaps = [(phases, f"phase_{p}", getattr(phases, f"phase_{p}_plain"))
             for p in PHASES]
    swaps += [(extloop, "run_external_loop", extloop.run_external_loop_plain),
              (extwin, "run_external_loop_windowed",
               extwin.run_external_loop_windowed_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def channel_kernels(m, steps: int = 3) -> dict:
    """Each kernel of the channel's path held to its plain version on the
    card, on the operands of ``steps`` steps of ``m`` (the 512x512x31 f32
    channel resumed from a restart, its lateral series staged as a window
    for each one-step segment and interpolated): the external loop (the
    window kernel where the L2 dispatch picks it), lat, uvw and mom bit for
    bit, tke and tracer within TOL["phase"] of each output's scale, as in
    ``[phases]``.  The boundary series the external loop reads must change
    from step to step.  Returns {kernel: (worst relative error, bit
    equal)} over the steps."""
    from extpom_tpu_torch.kernels import extloop, extwin, phases
    plain = {"extwin": extwin.run_external_loop_windowed_plain,
             "extloop": extloop.run_external_loop_plain,
             **{p: getattr(phases, f"phase_{p}_plain") for p in PHASES}}
    wrapper = {"extwin": lambda: extwin.run_external_loop_windowed,
               "extloop": lambda: extloop.run_external_loop,
               **{p: (lambda p=p: getattr(phases, f"phase_{p}"))
                  for p in PHASES}}
    tol = TOL["phase"][torch.float32]
    out, failed, series = {}, [], []
    for step in range(steps):
        calls = record_calls(lambda: m.run_segment(1),
                             PHASES + ("extloop", "extwin"))
        for key, recorded in calls.items():
            (args, kw), = recorded
            got = wrapper[key]()(*args, **kw)
            want = plain[key](*args)
            torch.cuda.synchronize()
            rel = max(rel_err(x, y)[1] for x, y in zip(got, want))
            equal = all(torch.equal(x, y) for x, y in zip(got, want))
            bit = key in BIT_EQUAL or key in ("extloop", "extwin")
            if (bit and not equal) or not rel <= tol:
                failed.append(f"{key} at step {m.iint}: rel {rel:.3e}, "
                              f"bit_equal {equal}")
            worst, all_equal = out.get(key, (0.0, True))
            out[key] = (max(worst, rel), all_equal and equal)
            if key in ("extloop", "extwin"):
                fc = args[3]
                series.append((fc.elw.clone(), fc.ele.clone()))
        del calls
    if any(torch.equal(a[0], b[0]) for a, b in zip(series, series[1:])):
        failed.append("elw did not change from step to step")
    if failed:
        raise AssertionError("channel kernels disagree with their plain "
                             "versions:\n" + "\n".join(failed))
    for key, (rel, equal) in out.items():
        say("channel_kernels", kernel=key, grid="x".join(map(str, CHANNEL)),
            dtype="float32", steps=steps, rel_err=f"{rel:.3e}",
            bit_equal=equal, tol="torch.equal" if key in BIT_EQUAL
            or key in ("extloop", "extwin") else tol)
    return out


def channel_phase(card: str, flush: L2Flush) -> dict:
    """The tidal channel at CHANNEL (512x512x31) float32 through
    ``run.main`` (``case: "channel"``) with ``forcing_hbm_mb: 0``, so that
    the lateral series are staged as a window for every segment:
    CHANNEL_STEPS steps of 180 s with a print every CHANNEL_PRINT, a
    restart every CHANNEL_RESTART, NetCDF output; then resumed from the
    restart at CHANNEL_RESTART and held equal to the whole run.  Gates:
    finite fields, the tide in the western tenth, salinity 15, the dispatch
    echo's machine and its exact launch counts.  Then each kernel of the
    path against its plain version on the operands of steps after the
    restart (``channel_kernels``), the device busy time of a few more steps,
    and the time per step of the forcing interpolation by its one launch
    (``k_forcing_interp``, counted under ``forcing`` in the launch counts)
    and by the plain path, with the plain path's kernels.
    Returns (the whole run's launch counts, its State at the last step)."""
    from extpom_tpu_torch.core.config import Config
    from extpom_tpu_torch.forcing import device as fdev
    from extpom_tpu_torch.kernels import extwin
    from extpom_tpu_torch import run
    im, jm, kb = CHANNEL
    conf = channel_conf()
    n = CHANNEL_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        lines, launches, peak, _ = run_cli(conf, tmp, "whole")
        nums = driver_numbers(lines)
        cfg = Config(im=im, jm=jm, kb=kb, dtype="float32")
        windowed = extwin.use_windowed(im, jm, 4, extwin.l2_bytes(
            torch.device("cuda")))
        if nums["machine"] != ("cuda-window" if windowed else "cuda-chain"):
            raise AssertionError(f"channel: the echo names "
                                 f"{nums['machine']}, windowed={windowed}")
        ext = ({"extwin": n * (cfg.isplit
                               // extwin.chunk_geometry(cfg, 4).C)}
               if windowed else {"extloop": n})
        want = {**dict.fromkeys(launches, 0), **ext, "phase_lat": n,
                **{f"phase_{p}": n - 1 for p in PHASES[1:]}, "forcing": n}
        if launches != want:
            raise AssertionError(f"channel: launch counts {launches} != "
                                 f"{want}")
        n_rec = records(os.path.join(tmp, "whole", "channel.nc"))
        if n_rec != n // CHANNEL_PRINT:
            raise AssertionError(f"channel: {n_rec} snapshots")
        os.remove(os.path.join(tmp, "whole", "channel.nc"))
        whole, iint, _ = restart_state(
            os.path.join(tmp, "whole", f"channel.rst.{n:06d}"), cfg)
        for f in whole.field_names():
            if not bool(torch.isfinite(getattr(whole, f)).all()):
                raise AssertionError(f"channel: {f} is not finite")
        west = (im - 2) // 10
        tide = float(whole.el[1:1 + west, 1:-1].abs().max())
        if not tide > 0.005:
            raise AssertionError(f"channel: no tide in the west: {tide}")
        salt = float((whole.s[:kb - 1, :, 1:-1] - 15.0).abs().max())
        if not salt <= 1e-4:
            raise AssertionError(f"channel: salinity drifted by {salt}")
        r_lines, r_launches, _, _ = run_cli(
            conf, tmp, "resumed", nread_rst=1,
            read_rst_path=os.path.join(tmp, "whole",
                                       f"channel.rst.{CHANNEL_RESTART:06d}"))
        resumed, _, _ = restart_state(
            os.path.join(tmp, "resumed", f"channel.rst.{n:06d}"), cfg)
        assert_states_equal(resumed, whole, "channel resumed vs whole")
        if driver_numbers(r_lines)["prints"] != nums["prints"][-2:]:
            raise AssertionError("channel resumed: its prints differ")
        m = run.build_model({**conf, "nread_rst": 1,
                             "read_rst_path": os.path.join(
                                 tmp, "whole",
                                 f"channel.rst.{CHANNEL_RESTART:06d}")})
        channel_kernels(m)
        del m
        m = run.build_model({**conf, "nread_rst": 1,
                             "read_rst_path": os.path.join(
                                 tmp, "whole", f"channel.rst.{n:06d}")})
        del resumed
    for line in nums["prints"]:
        print(f"[channel] {line}", flush=True)
    # the forcing's own cost: the Forcing of one step from the plan, by the
    # hand-written launch (k_forcing_interp) and by the plain path
    plan = m._device_plan(m.time_days, m.time_days + STEP_S / 86400)
    t = fdev.t_days_at(m.cfg, m.iint + 1, m.time0, torch.float32)
    interp = lambda: fdev.forcing_at(plan, m.base_forcing, m.cfg, m.grid.dz,
                                     t)
    ps = fdev.picks(plan, t)
    plain = lambda: fdev.forcing_at_plain(ps, m.base_forcing, m.cfg,
                                          m.grid.dz)
    with OpCount() as ops:
        plain()
    interp_ms = device_ms(interp, 20, flush)
    plain_ms = device_ms(plain, 20, flush)
    say_driver("channel", nums, im * jm * kb, peak, card,
               grid=f"{im}x{jm}x{kb}", dtype="float32",
               series=",".join(plan.names),
               window_records=plan.stacks[0].shape[0],
               tide_west_max_m=f"{tide:.4f}", salinity_drift=f"{salt:.3e}",
               snapshots=n_rec, resumed_from=CHANNEL_RESTART,
               resumed_equal=True, forcing_launches_per_step=1,
               forcing_ms_per_step=f"{interp_ms:.4f}",
               interp_plain_kernels_per_step=ops.n,
               interp_plain_ms_per_step=f"{plain_ms:.4f}",
               launches=json.dumps(launches, separators=(",", ":")))
    profile_phase(m, steps=3, tag="channel_profile")
    return launches, whole


def channel_conf() -> dict:
    """``[channel]``'s run file: the tidal channel at CHANNEL, float32,
    its series staged a window per segment (``forcing_hbm_mb`` 0),
    CHANNEL_STEPS steps with a print every CHANNEL_PRINT and a restart
    every CHANNEL_RESTART, NetCDF output."""
    im, jm, kb = CHANNEL
    return {"run_name": "channel", "case": "channel",
            "case_args": {"im": im, "jm": jm, "kb": kb},
            "config": {"dtype": "float32", "forcing_hbm_mb": 0,
                       "days": CHANNEL_STEPS * STEP_S / 86400,
                       "prtd1": CHANNEL_PRINT * STEP_S / 86400,
                       "write_rst": CHANNEL_RESTART * STEP_S / 86400},
            "out_format": "nc"}


def mesh_want(launches: dict, cfg, n: int, nb: int, plan,
              forcing: int = 0) -> dict:
    """The launch counts of n steps from a cold start on nb blocks: the
    chunk kernel the plan names (``extchunk`` or ``extwin_chunk``, one
    count per chunk call) nb x isplit / C times a step, lat's block
    variant every step and the other phases' from the second, each under
    the name of the instantiation cfg runs (``phases.counter``); and
    ``forcing`` launches of the step's forcing (n where a staged plan is
    interpolated on the whole grid every step)."""
    from extpom_tpu_torch.kernels import phases
    chunk = ("extwin_chunk" if plan.machine == "cuda-extwin-chunk"
             else "extchunk")
    return {**dict.fromkeys(launches, 0),
            chunk: n * nb * cfg.isplit // plan.C,
            phases.counter("lat", cfg) + "_mesh": n * nb,
            **{phases.counter(p, cfg) + "_mesh": (n - 1) * nb
               for p in PHASES[1:]}, "forcing": forcing}


def west_series(m, steps: int) -> float:
    """elw as the external chunks of the blocks on the west edge read it,
    over ``steps`` one-step segments of the decomposed ``m``: it must
    change from step to step in every such block.  Returns its largest
    |value|."""
    seen = []
    for _ in range(steps):
        calls = record_calls(lambda: m.run_segment(1),
                             ("chunk", "extwin_chunk"))
        west = {}
        for recorded in calls.values():
            for args, _ in recorded:
                if args[7][0] < 0:        # the extension starts west of i=0
                    west.setdefault(args[7], args[3].elw.clone())
        if not west:
            raise AssertionError("no chunk of a block on the west edge")
        seen.append(west)
    for a, b in zip(seen, seen[1:]):
        for off, elw in a.items():
            if torch.equal(elw, b[off]):
                raise AssertionError(f"elw of the block at {off} did not "
                                     f"change from step to step")
    return max(float(e.abs().max()) for w in seen for e in w.values())


def channel_mesh_phase(card: str, flush: L2Flush, want) -> dict:
    """``[channel]``'s run file with config5's mesh block (2x4, blocks
    256x128x31, every block on the card): the tidal series staged a window
    per segment and cut to the blocks, CHANNEL_STEPS steps through
    ``run.main``, then resumed from the restart at CHANNEL_RESTART.  Gates:
    the state at the last step ``torch.equal`` to ``[channel]``'s
    (``want``), the resume bit-equal, the launch counts, elw changing from
    step to step in the blocks on the west edge; then the device busy time
    and the plain kernels per step of a few more steps.  Returns the whole
    run's launch counts."""
    from extpom_tpu_torch import run
    from extpom_tpu_torch.core.config import Config
    im, jm, kb = CHANNEL
    with open(LARGE) as f:
        mesh_block = json.load(f)["mesh"]
    conf = {**channel_conf(), "mesh": mesh_block}
    n = CHANNEL_STEPS
    rst = f"channel.rst.{CHANNEL_RESTART:06d}"
    with tempfile.TemporaryDirectory() as tmp:
        lines, launches, peak, _ = run_cli(conf, tmp, "whole")
        nums = driver_numbers(lines)
        cfg = Config(im=im, jm=jm, kb=kb, dtype="float32")
        whole, _, _ = restart_state(
            os.path.join(tmp, "whole", f"channel.rst.{n:06d}"), cfg)
        assert_states_equal(whole, want, "channel_mesh vs channel")
        del whole
        r_lines, _, _, _ = run_cli(conf, tmp, "resumed", nread_rst=1,
                                read_rst_path=os.path.join(tmp, "whole",
                                                           rst))
        resumed, _, _ = restart_state(
            os.path.join(tmp, "resumed", f"channel.rst.{n:06d}"), cfg)
        assert_states_equal(resumed, want, "channel_mesh resumed")
        del resumed
        if driver_numbers(r_lines)["prints"] != nums["prints"][-2:]:
            raise AssertionError("channel_mesh resumed: its prints differ")
        m = run.build_model({**conf, "nread_rst": 1,
                             "read_rst_path": os.path.join(tmp, "whole",
                                                           rst)})
    plan = chunk_plan(m)
    nb = m.blocks.px * m.blocks.py
    expect = mesh_want(launches, m.cfg, n, nb, plan, forcing=n)
    if launches != expect:
        raise AssertionError(f"channel_mesh: launch counts {launches} != "
                             f"{expect}")
    elw_max = west_series(m, 3)
    for line in nums["prints"]:
        print(f"[channel_mesh] {line}", flush=True)
    say_driver("channel_mesh", nums, im * jm * kb, peak, card,
               grid=f"{im}x{jm}x{kb}", dtype="float32",
               mesh=f"{mesh_block['px']}x{mesh_block['py']}",
               local_tile=f"{m.blocks.ni}x{m.blocks.nj}x{kb}",
               chunk=f"{plan.machine}:C={plan.C}:block={plan.R}x{plan.L}",
               equal_to_channel=True, resumed_from=CHANNEL_RESTART,
               resumed_equal=True, west_elw_max_m=f"{elw_max:.4f}",
               launches=json.dumps(launches, separators=(",", ":")))
    profile_phase(m, steps=3, tag="channel_mesh_profile",
                  groups=MESH_KERNELS)
    return launches


def state_errors(a, b) -> dict:
    """{field: max |a - b| / max(1, max |b|)} over every State field, on
    the host."""
    out = {}
    for name in b.field_names():
        x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
        out[name] = float((x - y).abs().max()) / max(1.0,
                                                     float(y.abs().max()))
    return out


# the channel_check runs, each compared with the second of its pair
CHECK_PAIRS = (("kernels", "cpu"), ("window", "cpu"), ("plain", "cpu"),
               ("kernels", "plain"), ("cpu_ulp", "cpu"))


def channel_check() -> None:
    """The channel at its case size (97x33x16) in float64 with its staged
    plan, 4 and then 16 more steps of ``run_segment``.  Gates at step 20:
    the kernel path on the card against the plain path on the CPU, every
    field within 1e-9 of its scale (the golden check's limit for the
    float64 kernel path); the same with the window kernel in place of the
    whole-grid loop (the dispatch's choice forced, as the L2 rule makes it
    at 512x512 f32), which must also end bit-equal to the whole-grid loop's
    run.  Reported at steps 4 and 20, to show where the difference between
    the card and the CPU comes from: the plain path on the card against the
    CPU, the kernels against the plain path on the card, and the CPU
    against itself with T raised by one ulp; each with its worst field, the
    errors of the baroclinic depth sums drx2d/dry2d and dry2d's size."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.channel import channel_model
    from extpom_tpu_torch.kernels import extwin
    runs = {name: channel_model(device=dev, dtype="float64")
            for name, dev in (("kernels", "cuda"), ("window", "cuda"),
                              ("plain", "cuda"), ("cpu", "cpu"),
                              ("cpu_ulp", "cpu"))}
    ulp = 1.0 + 2.0 ** -52
    m = runs["cpu_ulp"]
    m.state = m.state.replace(t=m.state.t * ulp, tb=m.state.tb * ulp)
    use_windowed = extwin.use_windowed
    window_launches = 0
    for n in (4, 16):
        for name, m in runs.items():
            if name == "plain":
                with plain_path():
                    m.run_segment(n)
                continue
            if name == "window":
                extwin.use_windowed = lambda *a: True
                before = kernels.LAUNCHES["extwin"]
            try:
                m.run_segment(n)
            finally:
                extwin.use_windowed = use_windowed
            if name == "window":
                window_launches += kernels.LAUNCHES["extwin"] - before
        step = runs["cpu"].iint
        errs = {pair: state_errors(runs[pair[0]].state, runs[pair[1]].state)
                for pair in CHECK_PAIRS}
        for (a, b), err in errs.items():
            worst = max(err, key=err.get)
            say("channel_check", grid="97x33x16", step=step, dtype="float64",
                compare=f"{a}-{b}", worst_rel_err=f"{err[worst]:.3e}",
                worst_field=worst, drx2d_err=f"{err['drx2d']:.3e}",
                dry2d_err=f"{err['dry2d']:.3e}",
                dry2d_max=f"{float(runs[b].state.dry2d.abs().max()):.3e}")
    for a in ("kernels", "window"):
        err = errs[(a, "cpu")]
        worst = max(err, key=err.get)
        if not err[worst] <= 1e-9:
            raise AssertionError(f"channel {a} on the card vs the CPU, "
                                 f"{worst}: {err[worst]}")
    cfg = runs["window"].cfg
    want = 20 * cfg.isplit // extwin.chunk_geometry(cfg, 8).C
    if window_launches != want:
        raise AssertionError(f"channel window run: {window_launches} window "
                             f"launches, not {want}")
    assert_states_equal(runs["window"].state, runs["kernels"].state,
                        "channel window vs whole-grid loop")
    say("channel_check", grid="97x33x16", steps=20, dtype="float64",
        worst_rel_err=f"{max(errs[('kernels', 'cpu')].values()):.3e}",
        window_worst_rel_err=f"{max(errs[('window', 'cpu')].values()):.3e}",
        window_launches=window_launches, window_equal_to_loop=True,
        tol="1e-9")


# ---- the orlanski scheme and mode 2 ----

BASIN = (512, 512, 31)                              # [basin]
# the case's own cell of its default 51x51 basin (1,000 km over 49 cells,
# 20.41 km), kept at 512x512: cfl_min 103 s against the case's dte of 60 s
BASIN_LENGTH = 1.0e6 * (BASIN[0] - 2) / 49
BASIN_DAYS = 12.0
BASIN_CHECK = (48, 48, 5, 200)                      # [basin_check]
MODE2_STEPS = 20                                    # [mode2]
MODE2_TOL = 1e-4
ORL_MESH_STEPS = 5                                  # [orlanski_mesh]
# flops per grid point per external substep that mode 2 adds to
# EXTLOOP_FLOPS_PER_POINT (advection2d.py's mode-2 branch): wubot and wvbot
# 12 each, curv2d at three points 9 each, advua's and advva's terms 10 each
EXTLOOP_MODE2_FLOPS = 71


def ext_bound(n: int, ni: int, nj: int, nsub: int, item: int, dtype,
              mode2: bool) -> tuple:
    """(bound ms, bound_by) of ``nsub`` external substeps on an (ni, nj)
    grid of n cells: the chain's operands read once and the carry written
    once, or its operations (mode 2's too)."""
    nbytes = ((34 + 14) * n + 6 * nj + 6 * ni + 1) * item
    flops = (EXTLOOP_FLOPS_PER_POINT
             + (EXTLOOP_MODE2_FLOPS if mode2 else 0)) * nsub * n
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations")


def hold(tag: str, kernel: str, got, want, names, bit: bool, tol: float,
         **kv) -> float:
    """Hold a kernel's outputs to its plain version's on the card: each
    output's largest difference over its scale, reported; raises where an
    output is not finite, differs by more than ``tol`` of its scale, or
    (``bit``) is not bit-equal.  Returns the worst absolute error."""
    torch.cuda.synchronize()
    rels, worst = {}, 0.0
    for name, a, b in zip(names, got, want):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag} {kernel}: {name} is not finite")
        err, rel = rel_err(a, b)
        rels[name] = float(f"{rel:.3e}")
        worst = max(worst, err)
        if not rel <= tol:
            raise AssertionError(f"{tag} {kernel}: {name} differs from the "
                                 f"plain version by {rel} of its scale")
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    if bit and not equal:
        raise AssertionError(f"{tag} {kernel}: not bit-equal to the plain "
                             f"version")
    say(tag, kernel=kernel, bit_equal=equal,
        tol="torch.equal" if bit else tol, max_abs_err=f"{worst:.3e}",
        field_rel_err=json.dumps(rels, separators=(",", ":")), **kv)
    return worst


def assert_finite(st, tag: str, names=None) -> None:
    for f in names or st.field_names():
        if not bool(torch.isfinite(getattr(st, f)).all()):
            raise AssertionError(f"{tag}: state field {f} is not finite")


def orlanski_phase(card: str) -> tuple:
    """The main path's configuration under Orlanski edges: 256x256x31
    float32 seamount with bc_scheme="orlanski", SEG_WARM + SEG_TIMED steps
    from a cold start through ``Model.run_segment`` (the whole-grid loop
    with orl_el/orl_vel2d, tke with orl_turb, tracer with orl_ts).  Gates:
    every field finite, saver 15 within 1e-4, the launch counts.  Returns
    (launches, the model)."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.diag import stats
    m = seamount_model(im=IM, jm=JM, kb=KB, bc_scheme="orlanski")
    kernels.reset_launches()
    m.run_segment(SEG_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run_segment(SEG_TIMED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n = SEG_WARM + SEG_TIMED
    want = {**dict.fromkeys(launches, 0), "extloop": n, "phase_lat": n,
            **{f"phase_{p}": n - 1 for p in PHASES[1:]}}
    if launches != want:
        raise AssertionError(f"orlanski: launch counts {launches} != {want}")
    assert_finite(m.state, "orlanski")
    s = {k: float(v) for k, v in
         stats.domain_stats(m.grid, m.cfg, m.state).items()}
    if not abs(s["saver"] - 15.0) <= 1e-4:
        raise AssertionError(f"orlanski: saver drifted: {s['saver']}")
    say("orlanski", grid=f"{IM}x{JM}x{KB}", dtype="float32",
        bc_scheme="orlanski", steps=n, timed_steps=SEG_TIMED,
        ms_per_step=f"{wall / SEG_TIMED * 1e3:.3f}",
        grid_point_steps_per_s=f"{IM * JM * KB * SEG_TIMED / wall:.4e}",
        saver=f"{s['saver']:.7f}", taver=f"{s['taver']:.7f}",
        launches=json.dumps(launches, separators=(",", ":")),
        card=f"'{card}'")
    profile_phase(m, tag="orlanski_profile")
    return launches, m


def orlanski_kernels(m, flush: L2Flush) -> dict:
    """On the operands of one mid-run step of ``[orlanski]``'s model: the
    whole-grid loop (orl_el, orl_vel2d) bit for bit, tke (orl_turb) and
    tracer (orl_ts, the tile launch and the perimeter launch) within
    TOL["phase"] of each output's scale; each timed (CUDA events, L2
    flush) beside its plain version, with what the card gives it.
    Returns {kernel: entry}."""
    from extpom_tpu_torch.kernels import extloop, phases
    calls = record_calls(lambda: m.run_segment(1), ("tke", "tracer",
                                                    "extloop"))
    out = {}
    (args, _), = calls["extloop"]
    cfg = args[1]
    run = lambda: extloop.run_external_loop(*args)
    flags = extloop.ext_flags(cfg)
    worst = hold("orlanski_kernels", "extloop", run(),
                 extloop.run_external_loop_plain(*args), extloop.CARRY_FIELDS,
                 True, 0.0)
    ms = device_ms(run, 20, flush)
    plain_ms = device_ms(lambda: extloop.run_external_loop_plain(*args), 3,
                         flush)
    bound, by = ext_bound(IM * JM, IM, JM, cfg.isplit, 4, torch.float32,
                          False)
    threads, blocks = extloop.plan_grid(torch.float32, IM * JM, False,
                                        flags=flags)
    info = extloop.loop_info(torch.float32, False, threads, flags=flags)
    say("orlanski_kernels", kernel="extloop", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.5f}", bound_by=by,
        threads=threads, grid=blocks, registers=info["registers"],
        blocks_per_sm=info["blocks_per_sm"],
        spill_bytes=info["spill_bytes"])
    out["extloop"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=by,
                          registers=info["registers"])
    tol = TOL["phase"][torch.float32]
    for phase in ("tke", "tracer"):
        (args, kw), = calls[phase]
        g, cfg, *rest = args
        kernel = getattr(phases, f"phase_{phase}")
        plain = getattr(phases, f"phase_{phase}_plain")
        run = lambda: kernel(g, cfg, *rest, **kw)
        worst = hold("orlanski_kernels", phase, run(), plain(g, cfg, *rest,
                                                             **kw),
                     PHASE_OUTPUTS[phase], False, tol)
        ms = device_ms(run, 20, flush)
        plain_ms = device_ms(lambda: plain(g, cfg, *rest, **kw), 3, flush)
        bound, by, mb = phase_bound(phase, g, cfg, rest, run(), 4,
                                    torch.float32)
        tile, _ = phases.plan_tile(phase, torch.float32, KB, IM, JM)
        info = phases.tile_info(phase, torch.float32, tile, orl=True)
        say("orlanski_kernels", kernel=phase, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.3f}", bound_ms=f"{bound:.5f}",
            bound_by=by, registers=info["registers"],
            dynamic_smem=info["dynamic_smem"],
            blocks_per_sm=info["blocks_per_sm"],
            spill_bytes=info["spill_bytes"])
        out[phase] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=by,
                          registers=info["registers"])
    return out


def orlanski_mesh_phase(card: str) -> dict:
    """``[orlanski]``'s model on config5's 2x4 mesh, every block on the
    card, ORL_MESH_STEPS steps (extchunk, phase_tke_mesh and
    phase_tracer_mesh under the options), held to the same steps on one
    device (1e-5 of each field's scale; bit-equal so far).  Returns the
    launches."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.diag import stats
    with open(LARGE) as f:
        mesh = mesh_of(json.load(f))
    kw = dict(im=IM, jm=JM, kb=KB, bc_scheme="orlanski")
    m = seamount_model(**kw).shard(mesh)
    nb = mesh.px * mesh.py
    n = ORL_MESH_STEPS
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run_segment(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    chunks = nb * m.cfg.isplit // chunk_plan(m).C
    want = {**dict.fromkeys(launches, 0), "extchunk": n * chunks,
            "phase_lat_mesh": n * nb,
            **{f"phase_{p}_mesh": (n - 1) * nb for p in PHASES[1:]}}
    if launches != want:
        raise AssertionError(f"orlanski_mesh: launch counts {launches} != "
                             f"{want}")
    st = m.gathered_state()
    ref = seamount_model(**kw)
    ref.run_segment(n)
    worst, equal = (0.0, "none"), True
    for f in st.field_names():
        a, b = getattr(st, f), getattr(ref.state, f)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"orlanski_mesh: {f} is not finite")
        _, rel = rel_err(a, b)
        equal = equal and torch.equal(a, b)
        if not rel <= TOL["phase"][torch.float32]:
            raise AssertionError(f"orlanski_mesh vs one device, {f}: {rel}")
        if rel >= worst[0]:
            worst = (rel, f)
    s = {k: float(v) for k, v in
         stats.domain_stats(m.grid, m.cfg, st).items()}
    say("orlanski_mesh", grid=f"{IM}x{JM}x{KB}", mesh=f"{mesh.px}x{mesh.py}",
        dtype="float32", bc_scheme="orlanski", steps=n,
        ms_per_step=f"{wall / n * 1e3:.3f}", saver=f"{s['saver']:.7f}",
        vs_single_device_max_rel_err=f"{worst[0]:.3e}",
        worst_field=worst[1], bit_equal=equal,
        launches=json.dumps(launches, separators=(",", ":")),
        card=f"'{card}'")
    return launches


def basin_stats(st, grid) -> dict:
    """The closed basin's mean level and the gyre's numbers of
    test_physics.py's western-intensification test on ``va``."""
    va = st.va.double()
    im, jm = va.shape
    third = im // 3
    w = float(va[1:third, 1:-1].abs().max())
    e = float(va[-third:-1, 1:-1].abs().max())
    wet = (grid.art * grid.fsm).double()
    return dict(mean_level_m=float((st.el.double() * wet).sum() / wet.sum()),
                west_max=w, east_max=e, ratio=w / e if e > 0 else float("inf"),
                interior_mean=float(va[third:-third,
                                       jm // 3:2 * jm // 3].mean()),
                western_strip_mean=float(va[2:6, jm // 3:2 * jm // 3].mean()))


def basin_phase(card: str, flush: L2Flush) -> tuple:
    """The wind-driven basin at BASIN (512x512x31) float32, mode 2 under
    Orlanski edges, BASIN_DAYS model days (1,728 steps of 600 s) from a
    cold start through ``basin_model`` / ``Model.run_segment``: the
    external kernel the L2 dispatch picks and no phase.  Halfway, the
    operands of one step are kept for ``basin_kernels``.  Gates: el and va
    finite, the mean level of the closed basin within 1e-4 m of its start,
    the launch counts.  Reports the gyre's numbers (not gated at this
    size).  Returns (launches, the model, the kept call)."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.basin import basin_model
    from extpom_tpu_torch.diag import stats
    from extpom_tpu_torch.kernels import extwin
    im, jm, kb = BASIN
    m = basin_model(im=im, jm=jm, kb=kb, length=BASIN_LENGTH,
                    dtype="float32")
    cfg = m.cfg
    l2 = extwin.l2_bytes(torch.device("cuda"))
    ws = extwin.working_set_bytes(im, jm, 4)
    windowed = extwin.use_windowed(im, jm, 4, l2)
    n = int(BASIN_DAYS * 86400 / cfg.dti)
    level0 = basin_stats(m.state, m.grid)["mean_level_m"]
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    m.run_segment(2)
    half = n // 2 - 2
    w1 = timed_window(m, half)
    kept = record_calls(lambda: m.run_segment(1), ("extloop", "extwin"))
    w2 = timed_window(m, n - 3 - half)
    peak = torch.cuda.max_memory_allocated()
    timed = n - 3
    wall = w1["wall"] + w2["wall"]
    launches = dict(kernels.LAUNCHES)
    ext = ({"extwin": n * (cfg.isplit // extwin.chunk_geometry(cfg, 4).C)}
           if windowed else {"extloop": n})
    want = {**dict.fromkeys(launches, 0), **ext}
    if launches != want:
        raise AssertionError(f"basin: launch counts {launches} != {want}")
    assert_finite(m.state, "basin", ("el", "va"))
    b = basin_stats(m.state, m.grid)
    if not abs(b["mean_level_m"] - level0) <= 1e-4:
        raise AssertionError(f"basin: the mean level moved from {level0} "
                             f"to {b['mean_level_m']}")
    say("basin", grid=f"{im}x{jm}x{kb}", dtype="float32", mode=cfg.mode,
        bc_scheme=cfg.bc_scheme, dx_m=f"{float(m.grid.dx[0, 0]):.1f}",
        dte_s=cfg.dte, isplit=cfg.isplit,
        cfl_min_s=f"{float(stats.cfl_min(m.grid, cfg)):.4f}", days=BASIN_DAYS,
        steps=n, timed_steps=timed,
        ms_per_step=f"{wall / timed * 1e3:.4f}",
        grid_point_steps_per_s=f"{im * jm * kb * timed / wall:.4e}",
        external=("cuda-window" if windowed else "cuda-chain"),
        working_set_bytes=ws, l2_bytes=l2,
        peak_mem_gb=f"{peak / 1e9:.3f}",
        mean_level_drift_m=f"{b['mean_level_m'] - level0:.3e}",
        va_west_max=f"{b['west_max']:.5e}", va_east_max=f"{b['east_max']:.5e}",
        west_east_ratio=f"{b['ratio']:.3f}",
        va_interior_mean=f"{b['interior_mean']:.5e}",
        va_western_strip_mean=f"{b['western_strip_mean']:.5e}",
        launches=json.dumps(launches, separators=(",", ":")),
        card=f"'{card}'")
    profile_phase(m, steps=20, tag="basin_profile",
                  groups=dict(EXT_KERNELS))
    return launches, m, kept


def basin_kernels(m, kept, flush: L2Flush) -> dict:
    """The basin's external kernels on the operands of its mid-run step
    (512x512 f32, mode 2 and orlanski): the window kernel and the
    whole-grid loop, each bit-equal to the plain loop and timed (CUDA
    events, spin, L2 flush) beside its bound, mode 2's operations
    included; then, on ``m`` decomposed 2x4, extchunk and extwin_chunk on
    the first block's chunk (the domain's west and south edges) held to
    the plain chunk bit for bit on the block's own cells.  Returns
    {kernel: entry}."""
    from extpom_tpu_torch.kernels import extloop, extwin
    (args, _), = kept.get("extwin", kept.get("extloop"))
    cfg = args[1]
    im, jm = cfg.im, cfg.jm
    flags = extloop.ext_flags(cfg)
    plain = extloop.run_external_loop_plain(*args)
    out = {}
    bound, by = ext_bound(im * jm, im, jm, cfg.isplit, 4, torch.float32,
                          cfg.mode == 2)
    for name, fn in (("extwin", extwin.run_external_loop_windowed),
                     ("extloop", extloop.run_external_loop)):
        run = lambda: fn(*args)
        worst = hold("basin_kernels", name, run(), plain,
                     extloop.CARRY_FIELDS, True, 0.0)
        ms = device_ms(run, 20, flush)
        if name == "extwin":
            geo = extwin.chunk_geometry(cfg, 4)
            info = extwin.window_info(torch.float32, geo, flags=flags)
            extra = dict(C=geo.C, H=geo.H, tile=f"{geo.ti}x{geo.tj}",
                         threads=geo.threads, smem=geo.smem)
        else:
            threads, blocks = extloop.plan_grid(torch.float32, im * jm,
                                                flags=flags)
            info = extloop.loop_info(torch.float32, False, threads,
                                     flags=flags)
            extra = dict(threads=threads, launch_grid=blocks)
        say("basin_kernels", kernel=name, grid=f"{im}x{jm}",
            dtype="float32", ms=f"{ms:.4f}", bound_ms=f"{bound:.5f}",
            bound_by=by, registers=info["registers"],
            blocks_per_sm=info["blocks_per_sm"],
            spill_bytes=info["spill_bytes"], **extra)
        out[name] = dict(max_abs_err=worst, ms=ms, bound_ms=bound,
                         bound_by=by)
    out["extwin"]["plain_ms"] = device_ms(
        lambda: extloop.run_external_loop_plain(*args), 3, flush)
    del plain, args
    with open(LARGE) as f:
        mesh = mesh_of(json.load(f))
    m.shard(mesh)
    calls = record_calls(lambda: m.run_segment(1), ("chunk",))
    (args, _) = calls["chunk"][0]
    C, off = args[5], args[7]
    want = extloop.run_external_chunk_plain(*args)
    geo = extwin.win_geometry(C, 4, flags)
    for name, run in (
            ("extchunk", lambda: extloop.run_external_chunk(*args)),
            ("extwin_chunk", lambda: extwin.run_external_chunk_windowed(
                *args, geo=geo))):
        got = run()
        worst = hold("basin_kernels", name,
                     [trim_to(m.blocks, x) for x in got],
                     [trim_to(m.blocks, x) for x in want],
                     extloop.CARRY_FIELDS, True, 0.0,
                     block="x".join(map(str, args[2].el.shape)),
                     off=f"{off[0]},{off[1]}", C=C)
        out[name] = dict(max_abs_err=worst, ms=device_ms(run, 5, flush))
    return out


def basin_check() -> None:
    """The basin at BASIN_CHECK (48x48x5) in float64 for 200 steps on the
    card through the whole-grid loop and through the window kernel (the
    dispatch forced), against the plain path on the CPU.  Gates: both
    within 1e-9 of each field's scale of the CPU run, the channel_check's
    limit, and bit-equal to each other."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.basin import basin_model
    from extpom_tpu_torch.kernels import extwin
    im, jm, kb, n = BASIN_CHECK
    kw = dict(im=im, jm=jm, kb=kb, dtype="float64")
    runs = {"kernels": basin_model(device="cuda", **kw),
            "window": basin_model(device="cuda", **kw),
            "cpu": basin_model(device="cpu", **kw)}
    use_windowed = extwin.use_windowed
    kernels.reset_launches()
    for name, m in runs.items():
        extwin.use_windowed = lambda *a, w=name == "window": w
        try:
            m.run_segment(n)
        finally:
            extwin.use_windowed = use_windowed
    cfg = runs["cpu"].cfg
    want = {**dict.fromkeys(kernels.LAUNCHES, 0), "extloop": n,
            "extwin": n * cfg.isplit // extwin.chunk_geometry(cfg, 8).C}
    if kernels.LAUNCHES != want:
        raise AssertionError(f"basin_check: launches {kernels.LAUNCHES}")
    worst = {}
    for a in ("kernels", "window"):
        err = state_errors(runs[a].state, runs["cpu"].state)
        f = max(err, key=err.get)
        worst[a] = err[f]
        say("basin_check", grid=f"{im}x{jm}x{kb}", steps=n, dtype="float64",
            compare=f"{a}-cpu", worst_rel_err=f"{err[f]:.3e}",
            worst_field=f, **{k: f"{err[k]:.3e}" for k in
                              ("el", "ua", "va", "wubot", "advua")})
        if not err[f] <= 1e-9:
            raise AssertionError(f"basin_check {a} vs the CPU, {f}: {err[f]}")
    assert_states_equal(runs["window"].state, runs["kernels"].state,
                        "basin_check window vs whole-grid loop")
    say("basin_check", grid=f"{im}x{jm}x{kb}", steps=n, dtype="float64",
        worst_rel_err=f"{worst['kernels']:.3e}",
        window_worst_rel_err=f"{worst['window']:.3e}",
        window_equal_to_loop=True, tol="1e-9")


def mode2_check(card: str) -> None:
    """The seamount in mode 2 (the external mode alone) at the main path's
    256x256x31 float32 on the card, MODE2_STEPS steps of ``run_segment``
    from a cold start: the whole-grid loop under ``extpom`` edges, its
    flags mode 2 alone, against the same model on the CPU (the plain
    loop).  Gates: one ``extloop`` launch a step and no other launch,
    every field finite, each field within MODE2_TOL of its scale."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.kernels import extloop
    n = MODE2_STEPS
    runs = {dev: seamount_model(device=dev, im=IM, jm=JM, kb=KB, mode=2)
            for dev in ("cuda", "cpu")}
    flags = extloop.ext_flags(runs["cuda"].cfg)
    if flags != extloop.MODE2:
        raise AssertionError(f"mode2: the loop's flags {flags}")
    kernels.reset_launches()
    lib0 = extloop.device_launches()
    runs["cuda"].run_segment(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs["cuda"].run_segment(n - 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    lib = extloop.device_launches() - lib0
    if launches != {**dict.fromkeys(launches, 0), "extloop": n} or lib != n:
        raise AssertionError(f"mode2: launch counts {launches}, the "
                             f"library's {lib}")
    runs["cpu"].run_segment(n)
    assert_finite(runs["cuda"].state, "mode2")
    err = state_errors(runs["cuda"].state, runs["cpu"].state)
    f = max(err, key=err.get)
    say("mode2", grid=f"{IM}x{JM}x{KB}", dtype="float32", mode=2,
        bc_scheme="extpom", steps=n, worst_rel_err=f"{err[f]:.3e}",
        worst_field=f, tol=MODE2_TOL,
        **{k: f"{err[k]:.3e}" for k in ("el", "ua", "va", "utb", "egb")},
        ms_per_step=f"{wall / (n - 1) * 1e3:.4f}", flags=flags,
        launches=json.dumps(launches, separators=(",", ":")),
        device_launches=lib, card=f"'{card}'")
    if not err[f] <= MODE2_TOL:
        raise AssertionError(f"mode2: the card vs the CPU, {f}: {err[f]}")


# ---- the phase options: McCalpin, MPDATA, restoring, bc_vel3d ----

OPTIONS = dict(npg=2, nadv=2, nitera=2, sw=0.5)     # [options]
OPT_MESH_STEPS = 5                                  # [options_mesh]
FILE_RESTORE = (512, 512, 31)                       # [file_restore]
FILE_RESTORE_STEPS, FILE_RESTORE_PRINT = 60, 30
OPTIONS_CHECK = (33, 33, 11, 10)                    # [options_check]
FILE_RESTORE_CHECK = (97, 33, 16, 10)               # [file_restore_check]
# flops per grid point of MPDATA's steps, T and S (csrc/phase_mpdata.cu):
# each upstream step (four upwind face fluxes, two vertical ones and the
# step), each antidiffusion between two steps (the three velocities)
MPDATA_FLOPS = {"upwind": 110, "adif": 90}
# ... and what McCalpin adds to lat's PHASE_FLOPS_PER_POINT (the
# corrections and the second-order building blocks of both components)
MCC_FLOPS = 60


def option_want(launches: dict, cfg, n: int, nb: int = 0,
                chunks: int = 0) -> dict:
    """The launch counts of n steps from a cold start under cfg's options:
    lat every step, the other phases from the second, each under the name
    of the instantiation cfg runs (``phases.counter``), MPDATA's
    launches per tracer phase (:func:`mpdata_launches`); on nb blocks
    (chunks external chunks per step) the block variants'."""
    from extpom_tpu_torch.kernels import phases
    mp = mpdata_launches(cfg)
    sfx = "_mesh" if nb else ""
    nb = nb or 1
    name = lambda p: phases.counter(p, cfg) + sfx
    ext = {"extchunk": n * chunks} if chunks else {"extloop": n}
    return {**dict.fromkeys(launches, 0), **ext, name("lat"): n * nb,
            **{name(p): (n - 1) * nb for p in PHASES[1:]},
            f"phase_tracer_mpdata{sfx}": (n - 1) * nb * mp}


def mpdata_launches(cfg) -> int:
    """MPDATA's launches per tracer phase under cfg: the groups of
    ``phases.mpdata_plan`` (which depend on nitera and the dtype, not on
    the grid or block), 0 unless nadv=2."""
    from extpom_tpu_torch.kernels import phases
    if cfg.nadv != 2:
        return 0
    return phases.mpdata_plan(cfg.nitera, getattr(torch, cfg.dtype), cfg.kb,
                              cfg.im, cfg.jm).launches


def options_phase(card: str) -> tuple:
    """The main path's widths under the options of test_features.py's
    MPDATA and McCalpin tests together: 256x256x31 float32 seamount with
    npg=2, nadv=2, nitera=2, sw=0.5, SEG_WARM + SEG_TIMED steps through
    ``Model.run_segment`` (the whole-grid loop; lat with McCalpin, tracer
    with MPDATA's launches).  Gates: saver 15 within 1e-4, every field
    finite, the launch counts.  Returns (launches, the model)."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.diag import stats
    m = seamount_model(im=IM, jm=JM, kb=KB, **OPTIONS)
    kernels.reset_launches()
    m.run_segment(SEG_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run_segment(SEG_TIMED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n = SEG_WARM + SEG_TIMED
    want = option_want(launches, m.cfg, n)
    if launches != want:
        raise AssertionError(f"options: launch counts {launches} != {want}")
    assert_finite(m.state, "options")
    s = {k: float(v) for k, v in
         stats.domain_stats(m.grid, m.cfg, m.state).items()}
    if not abs(s["saver"] - 15.0) <= 1e-4:
        raise AssertionError(f"options: saver drifted: {s['saver']}")
    say("options", grid=f"{IM}x{JM}x{KB}", dtype="float32",
        options=json.dumps(OPTIONS, separators=(",", ":")), steps=n,
        timed_steps=SEG_TIMED, ms_per_step=f"{wall / SEG_TIMED * 1e3:.3f}",
        grid_point_steps_per_s=f"{IM * JM * KB * SEG_TIMED / wall:.4e}",
        saver=f"{s['saver']:.7f}", taver=f"{s['taver']:.7f}",
        launches=json.dumps(launches, separators=(",", ":")),
        card=f"'{card}'")
    profile_phase(m, tag="options_profile")
    return launches, m


def mpdata_work(cfg, n: int, item: int) -> tuple:
    """(bytes, flops) of MPDATA's steps on n points (``phases.mpdata``'s
    call, each operand read once and each output written once): tb, sb,
    u, v and w read and the fields of T and S written (kb levels each),
    the surfaces of t and s and the ten 2-D fields read, and the
    operations of nitera upstream steps and nitera - 1 antidiffusions.
    The fields and velocities between the steps are work inside the call
    (:func:`mpdata_work_launches` counts them as a launch per step
    would move them)."""
    n2 = n // cfg.kb
    nbytes = (7 * n + (2 + 10) * n2 + 2 * cfg.kb) * item
    flops = (MPDATA_FLOPS["upwind"] * cfg.nitera
             + MPDATA_FLOPS["adif"] * (cfg.nitera - 1)) * n
    return nbytes, flops


def mpdata_work_launches(cfg, n: int, item: int) -> int:
    """The bytes of MPDATA's steps on n points counted by launches of
    one step each (2 nitera - 1 of them), for the record beside
    :func:`mpdata_work`'s bound: each launch reading and writing its fields
    and velocities (3-D: the step's field of T and S, the velocities or u,
    v, w; the first step tb, sb and the surface of t, s; 12 2-D fields a
    launch)."""
    n3 = 0
    for it in range(cfg.nitera):
        n3 += (2 + 3 if it == 0 else 2 + 6) + 2          # upwind
        if it + 1 < cfg.nitera:
            n3 += 2 + (3 if it == 0 else 6) + 6          # adif
    return (n3 * n + 12 * (n // cfg.kb) * (2 * cfg.nitera - 1)) * item


def mpdata_bound(cfg, n: int, item: int, dtype) -> tuple:
    """(bound ms, bound_by) of MPDATA's steps on n points
    (:func:`mpdata_work`)."""
    nbytes, flops = mpdata_work(cfg, n, item)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations")


def option_entry(tag: str, phase: str, key: str, run, plain, g, cfg, rest,
                 flush: L2Flush, dtype, extra=None,
                 mesh: bool = False, raw=None, **kv) -> dict:
    """Hold one option variant to its plain version (lat and mom bit for
    bit, tracer's t, tb, s, sb bit for bit and rho within TOL["phase"]),
    time it with CUDA events beside the plain version, and count its bound
    from its own operands (kernel_inputs under cfg, the outputs) and its
    operations (PHASE_FLOPS_PER_POINT), plus ``extra(points)``'s (bytes,
    flops) of the work the variant adds; on a block ``run`` and ``plain``
    give the block's own cells and ``raw`` the kernel's whole outputs,
    which the bound counts and which is timed."""
    from extpom_tpu_torch.kernels import phases
    item = torch.finfo(dtype).bits // 8
    got, want = run(), plain()
    names = PHASE_OUTPUTS[phase]
    if phase == "tracer":
        worst = hold(tag, key, got[:4], want[:4], names[:4], True, 0.0)
        worst = max(worst, hold(tag, key + "_rho", got[4:], want[4:],
                                names[4:], False, TOL["phase"][dtype]))
    else:
        worst = hold(tag, key, got, want, names, True, 0.0)
    ms = device_ms(raw or run, 20, flush)
    plain_ms = device_ms(plain, 3, flush)
    outs = raw() if raw else got
    bound, by, mb = phase_bound(phase, g, cfg, rest, outs, item, dtype)
    if extra:
        nbytes, flops = extra(outs[0].numel())
        mb += nbytes / 1e6
        ops = PHASE_FLOPS_PER_POINT[phase] * outs[0].numel() + flops
        bound_ops = ops / PEAK_FLOPS[dtype] * 1e3
        bound_bytes = mb * 1e6 / HBM_BYTES_PER_S * 1e3
        bound, by = (max(bound_bytes, bound_ops),
                     "bytes" if bound_bytes >= bound_ops else "operations")
    tile, blocks = phases.plan_tile(phase, dtype, cfg.kb, *rest[0].shape[-2:],
                                    mesh, opt=phases.variant(phase, cfg))
    info = phases.tile_info(phase, dtype, tile, mesh,
                            opt=phases.variant(phase, cfg),
                            orl=cfg.bc_scheme == "orlanski")
    say(tag, kernel=key, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
        bound_ms=f"{bound:.5f}", bound_by=by, mbytes=f"{mb:.2f}",
        tile=f"{tile.ti}x{tile.tj}", launch_blocks=blocks,
        registers=info["registers"], dynamic_smem=info["dynamic_smem"],
        blocks_per_sm=info["blocks_per_sm"],
        spill_bytes=info["spill_bytes"], **kv)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, registers=info["registers"],
                dynamic_smem=info["dynamic_smem"])


def mcc_extra(n: int) -> tuple:
    """(bytes, flops) McCalpin adds to lat on n points: its operations (d
    and dzz are among lat's operands)."""
    return 0, MCC_FLOPS * n


def mpdata_extra(cfg, item: int):
    """n -> (bytes, flops) MPDATA adds to the tracer phase on n points:
    the operands of its steps that the phase's own operands do not hold
    (aru and arv) and its operations; its two fields are work inside the
    phase.  The entry then covers the whole phase."""
    def extra(n):
        _, flops = mpdata_work(cfg, n, item)
        return 2 * (n // cfg.kb) * item, flops
    return extra


def mpdata_entry(tag: str, key: str, g, cfg, mops, flush: L2Flush,
                 off=None, trim=None) -> dict:
    """MPDATA's launches (``phases.mpdata`` on the operands ``mops``, on
    a block at ``off``) held bit for bit to ``mpdata_plain`` (on a block's
    own cells, ``trim``), timed beside it, with :func:`mpdata_bound` (and
    the count by launches, ``launch_count_bound_ms``), the plan's tile,
    halo and group and what the card gives the kernel."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.kernels import phases
    from extpom_tpu_torch.ops.stencil import DomainCtx, domain
    trim = trim or (lambda x: x)
    raw = lambda: phases.mpdata(g, cfg, *mops, off=off)
    t = mops[0]
    plan = phases.mpdata_launch_plan(cfg, t, off is not None)
    info = phases.mpdata_info(t.dtype, plan, off is not None)
    name = "phase_tracer_mpdata" + ("" if off is None else "_mesh")
    before = kernels.LAUNCHES[name]

    def plain():
        with (contextlib.nullcontext() if off is None else
              domain(DomainCtx(cfg.im, cfg.jm, *off))):
            return phases.mpdata_plain(g, cfg, *mops)
    got = raw()
    launched = kernels.LAUNCHES[name] - before
    if launched != plan.launches:
        raise AssertionError(f"{tag}: {launched} MPDATA launches, the plan "
                             f"has {plan.launches}")
    worst = hold(tag, key, [trim(x) for x in got],
                 [trim(x) for x in plain()], ("ff_t", "ff_s"), True, 0.0)
    ms = device_ms(raw, 20, flush)
    plain_ms = device_ms(plain, 3, flush)
    item = t.element_size()
    bound, by = mpdata_bound(cfg, t.numel(), item, t.dtype)
    old = mpdata_work_launches(cfg, t.numel(), item) / HBM_BYTES_PER_S * 1e3
    say(tag, kernel=key, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
        bound_ms=f"{bound:.5f}", bound_by=by,
        launch_count_bound_ms=f"{old:.5f}", device_launches=launched,
        tile=f"{plan.ti}x{plan.tj}", threads=plan.threads,
        halo=plan.halos[0],
        group=plan.group, groups=",".join(map(str, plan.groups)),
        chunks=plan.chunks, launch_blocks=plan.blocks,
        registers=info["registers"], dynamic_smem=info["dynamic_smem"],
        blocks_per_sm=info["blocks_per_sm"],
        spill_bytes=info["spill_bytes"], points=t.numel())
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, registers=info["registers"],
                dynamic_smem=info["dynamic_smem"])


# MPDATA's kernel at the edges of its plan (tests/test_torch_cuda.py's
# MPDATA cases): grids no tile divides, every nitera up to the phase ring's
# 8 (8 chains two launches in both dtypes), fields that cross value_min,
# and every block of a 2x4 mesh
MPDATA_EDGE_SHAPES = ((33, 65, 9), (257, 131, 31))
MPDATA_EDGE_NITERA = (1, 2, 3, 4, 8)
MPDATA_EDGE_MESH = (32, 48, 6)


def mpdata_edges_phase() -> None:
    """``phases.mpdata`` against ``mpdata_plain`` on the card, bit for bit
    and with the plan's launches, on the operands of float64 seamount runs
    (two steps, then seeded perturbations; T positive): at
    MPDATA_EDGE_SHAPES for each nitera of MPDATA_EDGE_NITERA in float64
    and float32, on the first shape also T and S that cross value_min, and
    every block of MPDATA_EDGE_MESH on 2x4 (tracer's block calls of its
    third step), held on the block's own cells."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.kernels import phases
    from extpom_tpu_torch.mesh.shardmap import Mesh
    from extpom_tpu_torch.ops.stencil import domain_of

    def held(g, cfg, ops, off=None, trim=lambda x: x) -> str:
        name = "phase_tracer_mpdata" + ("" if off is None else "_mesh")
        plan = phases.mpdata_launch_plan(cfg, ops[0], off is not None)
        before = kernels.LAUNCHES[name]
        got = phases.mpdata(g, cfg, *ops, off=off)
        if kernels.LAUNCHES[name] - before != plan.launches:
            raise AssertionError(f"mpdata_edges: {name} launched "
                                 f"{kernels.LAUNCHES[name] - before}, the "
                                 f"plan {plan.launches}")
        with domain_of(cfg, off):
            want = phases.mpdata_plain(g, cfg, *ops)
        for f, a, b in zip(("ff_t", "ff_s"), got, want):
            if not torch.equal(trim(a), trim(b)):
                raise AssertionError(f"mpdata_edges: {f} differs at nitera "
                                     f"{cfg.nitera}, {ops[0].dtype}, shape "
                                     f"{tuple(a.shape)}, off {off}")
        return "+".join(map(str, plan.groups))

    def operands(st, g, rng, cutoff=False) -> list:
        noise = lambda x, s: x + s * torch.from_numpy(
            rng.standard_normal(tuple(x.shape))).to(x)
        t, tb, s_, sb = noise(st.t, 0.1) + 20.0, st.tb + 20.0, \
            noise(st.s, 0.01), st.sb
        if cutoff:
            r = rng.random((2,) + tuple(st.t.shape))
            fb = torch.from_numpy(np.where(r[0] < 0.3, 0.0, r[1])).to(st.t)
            t, tb, s_, sb = fb, fb, 2.0 * fb, 2.0 * fb
        return [t, tb, s_, sb, noise(st.u, 0.05), noise(st.v, 0.05),
                noise(st.w, 1e-5), g.h + st.et, st.etb, noise(st.et, 1e-3)]

    for shape in MPDATA_EDGE_SHAPES:
        im, jm, kb = shape
        m = seamount_model(im=im, jm=jm, kb=kb, dtype="float64")
        m.run_segment(2)
        rng = np.random.default_rng(3)
        cases = [("tracers", operands(m.state, m.grid, rng))]
        if shape == MPDATA_EDGE_SHAPES[0]:
            cases.append(("value_min", operands(m.state, m.grid, rng, True)))
        for field, ops in cases:
            for dtype in (torch.float64, torch.float32):
                g = cast(m.grid, dtype)
                groups = [held(g, m.cfg.replace(
                    dtype=str(dtype).split(".")[1], nadv=2, nitera=n),
                    [cast(x, dtype) for x in ops])
                    for n in MPDATA_EDGE_NITERA]
                say("mpdata_edges", grid=f"{im}x{jm}x{kb}", field=field,
                    dtype=str(dtype).split(".")[1],
                    nitera=",".join(map(str, MPDATA_EDGE_NITERA)),
                    launches_of_steps=",".join(groups), bit_equal=True)
    im, jm, kb = MPDATA_EDGE_MESH
    m = seamount_model(im=im, jm=jm, kb=kb, dtype="float64",
                       isplit=6).shard(Mesh(2, 4))
    m.run_segment(2)
    calls = record_calls(lambda: m.run_segment(1), ("tracer",))["tracer"]
    for dtype in (torch.float64, torch.float32):
        for n in MPDATA_EDGE_NITERA:
            for args, kw in calls:
                g, cfg, t, tb, s_, sb, _, _, u, v, w, _, _, dt, etb, etf = \
                    args[:16]
                ops = [cast(x, dtype) for x in (t + 20.0, tb + 20.0, s_, sb,
                                                u, v, w, dt, etb, etf)]
                held(cast(g, dtype), cfg.replace(
                    dtype=str(dtype).split(".")[1], nadv=2, nitera=n), ops,
                    kw["off"], lambda x: trim_to(m.blocks, x))
        say("mpdata_edges", grid=f"{im}x{jm}x{kb}", mesh="2x4",
            blocks=len(calls), dtype=str(dtype).split(".")[1],
            nitera=",".join(map(str, MPDATA_EDGE_NITERA)), bit_equal=True)


def mpdata_operands(rest) -> tuple:
    """MPDATA's operands (t, tb, s, sb, u, v, w, dt, etb, etf) among the
    tracer phase's."""
    t, tb, s_, sb, _, _, u, v, w, _, _, dt, etb, etf, _ = rest
    return (t, tb, s_, sb, u, v, w, dt, etb, etf)


def options_kernels(flush: L2Flush) -> dict:
    """On the operands of step 3 of ``[options]``'s configuration (a fresh
    model: two steps, then the third recorded): lat with McCalpin and the
    whole tracer phase with MPDATA (its launches and the tile) against
    their plain versions, MPDATA's launches alone against mpdata_plain bit
    for bit; each timed beside its plain version, with its bound.  Returns
    {kernel: entry}."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.kernels import phases
    m = seamount_model(im=IM, jm=JM, kb=KB, **OPTIONS)
    m.run_segment(2)
    calls = record_calls(lambda: m.run_segment(1), ("lat", "tracer"))
    del m
    out = {}
    (args, kw), = calls["lat"]
    g, cfg, *rest = args
    out["lat"] = option_entry(
        "options_kernels", "lat", "phase_lat_npg2",
        lambda: phases.phase_lat(g, cfg, *rest, **kw),
        lambda: phases.phase_lat_plain(g, cfg, *rest), g, cfg, rest, flush,
        torch.float32, extra=mcc_extra)
    (args, kw), = calls["tracer"]
    g, cfg, *rest = args
    out["mpdata"] = mpdata_entry("options_kernels", "phase_tracer_mpdata", g,
                                 cfg, mpdata_operands(rest), flush)
    out["tracer"] = option_entry(
        "options_kernels", "tracer", "phase_tracer_options",
        lambda: phases.phase_tracer(g, cfg, *rest, **kw),
        lambda: phases.phase_tracer_plain(g, cfg, *rest, **kw), g, cfg,
        rest, flush, torch.float32, extra=mpdata_extra(cfg, 4))
    return out


def options_mesh_phase(card: str, flush: L2Flush) -> tuple:
    """``[options]``'s configuration on config5's 2x4 mesh (blocks
    128x64x31), every block on the card, OPT_MESH_STEPS steps (extchunk,
    lat with McCalpin and tracer with MPDATA on each block), held bit for
    bit to the same steps on one device; then lat's and tracer's block
    variants and MPDATA's block launches timed on block (0, 1)'s operands
    of one more step.  Returns
    (launches, {kernel: entry})."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.diag import stats
    from extpom_tpu_torch.kernels import phases
    with open(LARGE) as f:
        mesh = mesh_of(json.load(f))
    kw = dict(im=IM, jm=JM, kb=KB, **OPTIONS)
    m = seamount_model(**kw).shard(mesh)
    nb = mesh.px * mesh.py
    n = OPT_MESH_STEPS
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run_segment(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = option_want(launches, m.cfg, n, nb,
                       nb * m.cfg.isplit // chunk_plan(m).C)
    if launches != want:
        raise AssertionError(f"options_mesh: launch counts {launches} != "
                             f"{want}")
    st = m.gathered_state()
    ref = seamount_model(**kw)
    ref.run_segment(n)
    for f in st.field_names():
        if not bool(torch.isfinite(getattr(st, f)).all()):
            raise AssertionError(f"options_mesh: {f} is not finite")
        if not torch.equal(getattr(st, f), getattr(ref.state, f)):
            raise AssertionError(f"options_mesh: {f} differs from the "
                                 f"single-device run")
    s = {k: float(v) for k, v in
         stats.domain_stats(m.grid, m.cfg, st).items()}
    del st, ref
    say("options_mesh", grid=f"{IM}x{JM}x{KB}", mesh=f"{mesh.px}x{mesh.py}",
        local_tile=f"{m.blocks.ni}x{m.blocks.nj}x{KB}", dtype="float32",
        steps=n, ms_per_step=f"{wall / n * 1e3:.3f}",
        saver=f"{s['saver']:.7f}", bit_equal=True,
        launches=json.dumps(launches, separators=(",", ":")),
        card=f"'{card}'")
    calls = record_calls(lambda: m.run_segment(1), ("lat", "tracer"))
    blocks = m.blocks
    out = {}
    for phase, key, extra in (("lat", "phase_lat_npg2_mesh", mcc_extra),
                              ("tracer", "phase_tracer_options_mesh",
                               mpdata_extra(m.cfg, 4))):
        for (args, kwb) in calls[phase]:
            if block_at(blocks, args[2].shape, kwb["off"]) != (0, 1):
                continue
            g, cfg, *rest = args
            kernel, plain, _, _ = block_call(phase, args, kwb)
            trim = lambda fn: (lambda: [trim_to(blocks, x) for x in fn()])
            out[phase] = option_entry(
                "options_mesh_kernels", phase, key, trim(kernel),
                trim(plain), g, cfg, rest, flush, torch.float32,
                extra=extra, mesh=True, raw=kernel, block="(0,1)")
            if phase == "tracer":
                out["mpdata"] = mpdata_entry(
                    "options_mesh_kernels", "phase_tracer_mpdata_mesh", g,
                    cfg, mpdata_operands(rest), flush, kwb["off"],
                    lambda x: trim_to(blocks, x))
    return launches, out


def lbry_series(grid, st, rng) -> dict:
    """An lbry file's series for the file scheme with restoring: the
    velocity profiles of all four sides (ub*, vb*) as two records at the
    lateral cadence, a smooth inflow plus seeded noise; trstr/srstr as two
    30-day records, the initial T/S plus a seeded offset in [0, 0.5)."""
    kb, im, jm = st.t.shape
    prof = np.cos(np.pi * 0.5 * np.asarray(grid.zz.cpu()))[:, None]
    side = lambda n: np.stack([(0.02 * (1 + r) * prof
                                + 0.005 * rng.standard_normal((kb, n)))
                               for r in range(2)])
    data = {f"{v}b{s}": side(jm if s in ("w", "e") else im)
            for v in ("u", "v") for s in ("w", "e", "s", "n")}
    t0, s0 = st.t.double().cpu().numpy(), st.s.double().cpu().numpy()
    data["trstr"] = np.stack([t0 + 0.5 * rng.random(t0.shape)
                              for _ in range(2)])
    data["srstr"] = np.stack([s0 + 0.5 * rng.random(s0.shape)
                              for _ in range(2)])
    return data


def wet_mean(f, grid, kbm1: int) -> float:
    """The mean of f over the wet cells of levels k < kbm1."""
    w = grid.fsm.double().cpu()
    return float((f[:kbm1].double().cpu() * w).sum() / (w.sum() * kbm1))


def file_restore_kernels(m, steps: int = 2) -> dict:
    """mom (bc_vel3d) and tracer (restoring) held to their plain versions
    on the operands of ``steps`` steps of ``m`` in the first hour, whose
    velocity profiles and restoring series change from step to step: mom
    and tracer's t, tb, s, sb bit for bit, rho within TOL["phase"].
    Returns {phase: (worst abs error, mom and tracer calls of the last
    step)}."""
    from extpom_tpu_torch.kernels import phases
    out, series = {}, []
    for _ in range(steps):
        calls = record_calls(lambda: m.run_segment(1), ("mom", "tracer"))
        for phase, ((args, kw),) in calls.items():
            g, cfg, *rest = args
            got = getattr(phases, f"phase_{phase}")(g, cfg, *rest, **kw)
            want = getattr(phases, f"phase_{phase}_plain")(g, cfg, *rest,
                                                           **kw)
            names = PHASE_OUTPUTS[phase]
            n_bit = 4 if phase == "tracer" else len(names)
            worst = hold("file_restore_kernels", phase, got[:n_bit],
                         want[:n_bit], names[:n_bit], True, 0.0,
                         step=m.iint)
            if phase == "tracer":
                worst = max(worst, hold(
                    "file_restore_kernels", "tracer_rho", got[4:], want[4:],
                    names[4:], False, TOL["phase"][torch.float32],
                    step=m.iint))
                series.append((rest[-1].trstr.clone(),
                               rest[-1].ubw.clone()))
            out[phase] = (max(worst, out.get(phase, (0.0,))[0]), args, kw)
    for (a, b), (c, d) in zip(series, series[1:]):
        if torch.equal(a, c) or torch.equal(b, d):
            raise AssertionError("file_restore: the series did not change "
                                 "from step to step")
    return out


def file_restore_phase(card: str, flush: L2Flush) -> tuple:
    """The tidal channel at FILE_RESTORE (512x512x31) float32 through
    ``run.main`` under the file scheme with interior restoring: an lbry
    NetCDF file written here from a fixed seed (``lbry_series``; no
    taurstr, so the default 1/TRST applies; the channel's own elw/ele
    stay), FILE_RESTORE_STEPS steps with a print every FILE_RESTORE_PRINT.
    Gates: every field finite, the launch counts, the domain mean of T
    moving toward trstr's (which lies above it).  Then mom (bc_vel3d) and
    tracer (restoring) against their plain versions on steps whose series
    change, each timed beside its plain version.  Returns (launches,
    {kernel: entry}, the State at the last step)."""
    from extpom_tpu_torch import run
    from extpom_tpu_torch.kernels import extwin, phases
    im, jm, kb = FILE_RESTORE
    n = FILE_RESTORE_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        conf, data, t_start, tr_mean, cfg = file_restore_conf(tmp)
        lines, launches, peak, _ = run_cli(conf, tmp, "run")
        nums = driver_numbers(lines)
        windowed = extwin.use_windowed(im, jm, 4, extwin.l2_bytes(
            torch.device("cuda")))
        ext = ({"extwin": n * (cfg.isplit
                               // extwin.chunk_geometry(cfg, 4).C)}
               if windowed else {"extloop": n})
        want = {**dict.fromkeys(launches, 0), **ext,
                phases.counter("lat", cfg): n,
                **{phases.counter(p, cfg): n - 1 for p in PHASES[1:]},
                "forcing": n}
        if launches != want:
            raise AssertionError(f"file_restore: launch counts {launches} "
                                 f"!= {want}")
        end, _, _ = restart_state(
            os.path.join(tmp, "run", f"file_restore.rst.{n:06d}"), cfg)
        assert_finite(end, "file_restore")
        m = run.build_model(conf)
        t_end = wet_mean(end.t, m.grid, kb - 1)
        if not t_end - t_start > 1e-4:
            raise AssertionError(f"file_restore: mean T {t_start} -> "
                                 f"{t_end} does not move toward trstr's "
                                 f"{tr_mean}")
        m.run_segment(4)
        k = file_restore_kernels(m)
        del m
    for line in nums["prints"]:
        print(f"[file_restore] {line}", flush=True)
    say_driver("file_restore", nums, im * jm * kb, peak, card,
               grid=f"{im}x{jm}x{kb}", dtype="float32", bc_scheme="file",
               do_restore=True, lbry_series=len(data),
               mean_t_start=f"{t_start:.6f}", mean_t_end=f"{t_end:.6f}",
               trstr_mean=f"{tr_mean:.6f}",
               launches=json.dumps(launches, separators=(",", ":")))
    out = {}
    for phase, key in (("mom", "phase_mom_file"),
                       ("tracer", "phase_tracer_options")):
        _, args, kw = k[phase]
        g, cfg, *rest = args
        out[phase] = option_entry(
            "file_restore_kernels", phase, key,
            lambda: getattr(phases, f"phase_{phase}")(g, cfg, *rest, **kw),
            lambda: getattr(phases, f"phase_{phase}_plain")(g, cfg, *rest,
                                                            **kw),
            g, cfg, rest, flush, torch.float32)
    return launches, out, end


def file_restore_conf(tmp: str) -> tuple:
    """``[file_restore]``'s run file, with its lbry NetCDF file written
    under ``tmp`` from the fixed seed (``lbry_series``).  Returns (conf,
    the series, the wet mean of the initial T, trstr's first record's,
    the cfg)."""
    from extpom_tpu_torch import run
    from extpom_tpu_torch.io import netcdf as ncio
    im, jm, kb = FILE_RESTORE
    n = FILE_RESTORE_STEPS
    cfg_kw = {"dtype": "float32", "bc_scheme": "file", "do_restore": True,
              "days": n * STEP_S / 86400,
              "prtd1": FILE_RESTORE_PRINT * STEP_S / 86400,
              "write_rst": n * STEP_S / 86400}
    conf = {"run_name": "file_restore", "case": "channel",
            "case_args": {"im": im, "jm": jm, "kb": kb}, "config": cfg_kw,
            "out_format": "nc"}
    base = run.build_model(conf)
    data = lbry_series(base.grid, base.state, np.random.default_rng(2026))
    t_start = wet_mean(base.state.t, base.grid, kb - 1)
    tr_mean = wet_mean(torch.from_numpy(data["trstr"][0]), base.grid, kb - 1)
    cfg = base.cfg
    del base
    lbry = os.path.join(tmp, "file_restore.lbry.nc")
    ncio.write_forcing_series_nc(lbry, data, im, jm, kb)
    conf["lbry"] = lbry
    return conf, data, t_start, tr_mean, cfg


def file_restore_mesh_phase(card: str, flush: L2Flush, want) -> tuple:
    """``[file_restore]``'s run file with config5's mesh block (2x4, blocks
    256x128x31 on the card): the file scheme's velocity profiles and the
    restoring series staged and cut to the blocks, FILE_RESTORE_STEPS
    steps through ``run.main``.  Gates: the state at the last step
    ``torch.equal`` to ``[file_restore]``'s (``want``), the mean T rising
    toward trstr's, the launch counts.  Then, on the operands of one more
    step of block (0, 0), which holds the west and south edges, mom's
    block variant with ``bc_vel3d`` (``phase_mom_file_mesh``) held to its
    plain version bit for bit and timed, and tracer's with restoring held.
    Returns (launches, {kernel: entry})."""
    from extpom_tpu_torch import run
    im, jm, kb = FILE_RESTORE
    n = FILE_RESTORE_STEPS
    with open(LARGE) as f:
        mesh_block = json.load(f)["mesh"]
    with tempfile.TemporaryDirectory() as tmp:
        conf, data, t_start, tr_mean, cfg = file_restore_conf(tmp)
        conf["mesh"] = mesh_block
        lines, launches, peak, _ = run_cli(conf, tmp, "run")
        nums = driver_numbers(lines)
        end, _, _ = restart_state(
            os.path.join(tmp, "run", f"file_restore.rst.{n:06d}"), cfg)
        assert_states_equal(end, want, "file_restore_mesh vs file_restore")
        m = run.build_model(conf)
    t_end = wet_mean(end.t, m.grid, kb - 1)
    del end
    if not t_end - t_start > 1e-4:
        raise AssertionError(f"file_restore_mesh: mean T {t_start} -> "
                             f"{t_end} does not move toward trstr's "
                             f"{tr_mean}")
    nb = m.blocks.px * m.blocks.py
    expect = mesh_want(launches, m.cfg, n, nb, chunk_plan(m), forcing=n)
    if launches != expect:
        raise AssertionError(f"file_restore_mesh: launch counts {launches} "
                             f"!= {expect}")
    for line in nums["prints"]:
        print(f"[file_restore_mesh] {line}", flush=True)
    say_driver("file_restore_mesh", nums, im * jm * kb, peak, card,
               grid=f"{im}x{jm}x{kb}", dtype="float32", bc_scheme="file",
               do_restore=True, mesh=f"{mesh_block['px']}x{mesh_block['py']}",
               local_tile=f"{m.blocks.ni}x{m.blocks.nj}x{kb}",
               equal_to_file_restore=True, mean_t_start=f"{t_start:.6f}",
               mean_t_end=f"{t_end:.6f}", trstr_mean=f"{tr_mean:.6f}",
               launches=json.dumps(launches, separators=(",", ":")))
    m.run_segment(4)
    calls = record_calls(lambda: m.run_segment(1), ("mom", "tracer"))
    blocks, target, out = m.blocks, (0, 0), {}
    for phase, key in (("mom", "phase_mom_file_mesh"),
                       ("tracer", "phase_tracer_options_mesh")):
        for args, kwb in calls[phase]:
            if block_at(blocks, args[2].shape, kwb["off"]) != target:
                continue
            g, cfg, *rest = args
            kernel, plain, _, _ = block_call(phase, args, kwb)
            trim = lambda fn: (lambda: [trim_to(blocks, x) for x in fn()])
            out[phase] = option_entry(
                "file_restore_mesh_kernels", phase, key, trim(kernel),
                trim(plain), g, cfg, rest, flush, torch.float32, mesh=True,
                raw=kernel, block=f"'{target}'")
    profile_phase(m, steps=3, tag="file_restore_mesh_profile",
                  groups=MESH_KERNELS)
    return launches, out


RAGGED = (255, 255, 31)        # [ragged]: neither axis divides config5's mesh
RAGGED_STEPS = 22
# State fields whose pad cells hold exactly 0 on a padded grid (the
# turbulence fields' pad holds the closure's floor values, read by no
# active cell)
PAD_ZERO = ("el", "elb", "et", "etb", "etf", "ua", "uab", "va", "vab", "u",
            "ub", "v", "vb", "w", "t", "tb", "s", "sb", "rho")


def timed_run(m, n: int) -> tuple:
    """(launch counts of n steps from a zero count, wall ms per step of
    the last n - SEG_WARM) of ``m.run_segment``."""
    from extpom_tpu_torch import kernels
    kernels.reset_launches()
    m.run_segment(SEG_WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.run_segment(n - SEG_WARM)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (n - SEG_WARM) * 1e3
    return dict(kernels.LAUNCHES), ms


def active_errors(st, cfg, ref) -> tuple:
    """(every field bit-equal, worst relative error, its field) of the
    active region of the padded State ``st`` against the unpadded ``ref``;
    raises beyond 1e-10 of a field's scale (tests/test_ragged.py's gate)
    or where the active region is not finite."""
    from extpom_tpu_torch.mesh.padding import unpad
    equal, worst = True, (0.0, "none")
    for f in ref.field_names():
        a, b = unpad(getattr(st, f), cfg), getattr(ref, f)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"ragged: {f} is not finite")
        _, rel = rel_err(a, b)
        equal = equal and torch.equal(a, b)
        if rel >= worst[0]:
            worst = (rel, f)
    if not worst[0] <= 1e-10:
        raise AssertionError(f"ragged vs unpadded, {worst[1]}: {worst[0]}")
    return equal, worst[0], worst[1]


def pad_zero(st, cfg) -> None:
    """The pad cells of the PAD_ZERO fields hold exactly 0."""
    ia, ja = cfg.im_act, cfg.jm_act
    bad = {}
    for f in PAD_ZERO:
        a = getattr(st, f)
        pad = torch.cat([a[..., ia:, :].reshape(-1), a[..., :, ja:].reshape(-1)])
        if pad.any():
            bad[f] = float(pad.abs().max())
    if bad:
        raise AssertionError(f"ragged: pad cells not 0: {bad}")


def ragged_kernels(m) -> dict:
    """On the operands of one more step of the decomposed padded ``m``,
    block (1, 3), the corner that holds pad cells on both axes: each
    phase's block variant and the external chunk against their plain
    versions on the block's active cells (lat, uvw, mom and the chunk
    ``torch.equal``, tke and tracer within TOL["phase"]); whether they
    also agree on its pad cells is printed.  Returns {kernel: (worst
    relative error, bit equal)}."""
    calls = record_calls(lambda: m.run_segment(1),
                         PHASES + ("chunk", "extwin_chunk"))
    blocks, cfg, target = m.blocks, m.cfg, (1, 3)
    ia = cfg.im_act - target[0] * blocks.ni
    ja = cfg.jm_act - target[1] * blocks.nj
    kinds = [(p, calls[p]) for p in PHASES]
    kinds += [("extchunk" if key == "chunk" else key, calls[key])
              for key in ("chunk", "extwin_chunk") if key in calls]
    out, failed = {}, []
    for kind, recorded in kinds:
        name = kind if kind.startswith("ext") else f"phase_{kind}_mesh"
        for args, kw in recorded:
            kernel, plain, shape, off = block_call(kind, args, kw)
            if block_at(blocks, shape, off) != target:
                continue
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            worst, equal, pad_equal = 0.0, True, True
            for a, b in zip(got, want):
                a, b = trim_to(blocks, a), trim_to(blocks, b)
                _, rel = rel_err(a[..., :ia, :ja], b[..., :ia, :ja])
                worst = max(worst, rel)
                equal = equal and torch.equal(a[..., :ia, :ja],
                                              b[..., :ia, :ja])
                pad_equal = pad_equal and torch.equal(a, b)
            bit = kind in BIT_EQUAL or kind in ("extchunk", "extwin_chunk")
            if (bit and not equal) or not worst <= TOL["phase"][
                    torch.float32]:
                failed.append(f"{name}: rel {worst:.3e}, bit_equal {equal}")
            say("ragged_kernels", kernel=name, block=f"'{target}'",
                shape="x".join(map(str, shape)), off=f"'{off}'",
                active=f"{ia}x{ja}", rel_err=f"{worst:.3e}",
                bit_equal=equal, pad_cells_equal=pad_equal,
                tol="torch.equal" if bit else TOL["phase"][torch.float32])
            out[name] = (worst, equal)
    if failed:
        raise AssertionError("ragged: block kernels disagree with their "
                             "plain versions:\n" + "\n".join(failed))
    return out


def ragged_phase(card: str) -> dict:
    """Padding, at the main path's width: the seamount main path (extpom
    scheme, nadv=1, npg=1) at RAGGED (255x255x31) float32, which neither
    axis of config5's 2x4 mesh divides, RAGGED_STEPS steps from a cold
    start: on the mesh (``Model.shard`` pads to 256x256; blocks 128x64),
    with ``pad_model`` on one device (a 1x1 mesh whose padded axes carry a
    ring), and a padded run whose pad cells start as NaN, each held on the
    active region to the unpadded run on one device through the
    whole-grid kernels (bit-equal expected; within 1e-10 of each field's
    scale, or it fails); the pad cells of the prognostic fields stay 0.
    Then the block kernels on the corner block (``ragged_kernels``).
    Returns {path: launch counts} of the three padded-or-not runs."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.core.state import State
    from extpom_tpu_torch.diag import stats
    from extpom_tpu_torch.mesh import extchunk
    from extpom_tpu_torch.mesh.padding import pad_model
    im, jm, kb = RAGGED
    n = RAGGED_STEPS
    with open(LARGE) as f:
        mesh = mesh_of(json.load(f))
    ref = seamount_model(im=im, jm=jm, kb=kb)
    one_launches, one_ms = timed_run(ref, n)
    want = {**dict.fromkeys(one_launches, 0), "extloop": n,
            "phase_lat": n, **{f"phase_{p}": n - 1 for p in PHASES[1:]}}
    if one_launches != want:
        raise AssertionError(f"ragged one device: launch counts "
                             f"{one_launches} != {want}")

    m = seamount_model(im=im, jm=jm, kb=kb).shard(mesh)
    if (m.cfg.im, m.cfg.jm) != (256, 256):
        raise AssertionError(f"ragged: padded to {m.cfg.im}x{m.cfg.jm}")
    nb = mesh.px * mesh.py
    mesh_launches, mesh_ms = timed_run(m, n)
    want = mesh_want(mesh_launches, m.cfg, n, nb, chunk_plan(m))
    if mesh_launches != want:
        raise AssertionError(f"ragged mesh: launch counts {mesh_launches} "
                             f"!= {want}")
    st = m.gathered_state()
    mesh_equal, mesh_rel, mesh_field = active_errors(st, m.cfg, ref.state)
    pad_zero(st, m.cfg)
    s = {k: float(v) for k, v in
         stats.domain_stats(m.grid, m.cfg, st).items()}
    del st

    p = seamount_model(im=im, jm=jm, kb=kb)
    pad_model(p, mesh.px, mesh.py)
    pad_launches, pad_ms = timed_run(p, n)
    solo = extchunk.chunk_plan(p.cfg, 1, 1, p.cfg.im, p.cfg.jm, "cuda", 4)
    want = mesh_want(pad_launches, p.cfg, n, 1, solo)
    if pad_launches != want:
        raise AssertionError(f"ragged pad_model: launch counts "
                             f"{pad_launches} != {want}")
    pad_equal, pad_rel, pad_field = active_errors(p.state, p.cfg, ref.state)
    pad_zero(p.state, p.cfg)
    profile_phase(p, steps=3, tag="ragged_pad_model_profile",
                  groups=MESH_KERNELS)
    del p

    q = seamount_model(im=im, jm=jm, kb=kb)
    pad_model(q, mesh.px, mesh.py)

    def poison(a):
        a = a.clone()
        if a.dim() >= 2 and a.shape[-2:] == (q.cfg.im, q.cfg.jm):
            a[..., im:, :] = float("nan")
            a[..., :, jm:] = float("nan")
        return a

    q.state = State(**{f: poison(getattr(q.state, f))
                       for f in State.field_names()})
    q.run_segment(n)
    nan_equal, _, _ = active_errors(q.state, q.cfg, ref.state)
    del q, ref
    say("ragged", grid=f"{im}x{jm}x{kb}", padded=f"{m.cfg.im}x{m.cfg.jm}",
        mesh=f"{mesh.px}x{mesh.py}",
        local_tile=f"{m.blocks.ni}x{m.blocks.nj}x{kb}", dtype="float32",
        steps=n, timed_steps=n - SEG_WARM,
        one_device_ms_per_step=f"{one_ms:.3f}",
        mesh_ms_per_step=f"{mesh_ms:.3f}",
        pad_model_ms_per_step=f"{pad_ms:.3f}",
        pad_model_chunk=f"{solo.machine}:C={solo.C}:block={solo.R}x{solo.L}",
        mesh_bit_equal=mesh_equal,
        mesh_worst=f"'{mesh_field} {mesh_rel:.3e}'",
        pad_model_bit_equal=pad_equal,
        pad_model_worst=f"'{pad_field} {pad_rel:.3e}'",
        nan_pad_finite=True, nan_pad_bit_equal=nan_equal,
        pad_cells_zero=True, saver=f"{s['saver']:.7f}",
        mesh_launches=json.dumps(mesh_launches, separators=(",", ":")),
        pad_model_launches=json.dumps(pad_launches, separators=(",", ":")),
        card=f"'{card}'")
    profile_phase(m, steps=3, tag="ragged_profile", groups=MESH_KERNELS)
    ragged_kernels(m)
    return {"ragged_one_255": one_launches, "ragged_mesh_255": mesh_launches,
            "ragged_pad_255": pad_launches}


def state_check(tag: str, make, steps: int, tol: float = 1e-10) -> None:
    """``make(device)``'s model in float64 on the card against the CPU
    after ``steps`` steps of ``run_segment``: every field within ``tol`` of
    max(1, its scale)."""
    runs = {dev: make(dev) for dev in ("cuda", "cpu")}
    for m in runs.values():
        m.run_segment(steps)
    err = state_errors(runs["cuda"].state, runs["cpu"].state)
    worst = max(err, key=err.get)
    cfg = runs["cpu"].cfg
    say(tag, grid=f"{cfg.im}x{cfg.jm}x{cfg.kb}", steps=steps,
        dtype="float64", worst_rel_err=f"{err[worst]:.3e}",
        worst_field=worst, tol=tol)
    if not err[worst] <= tol:
        raise AssertionError(f"{tag}: the card vs the CPU, {worst}: "
                             f"{err[worst]}")


def options_check() -> None:
    """``[options]``'s options on the 33x33x11 seamount in float64: the
    card against the CPU after 10 steps, 1e-10 of each field's scale."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    im, jm, kb, n = OPTIONS_CHECK
    state_check("options_check", lambda dev: seamount_model(
        device=dev, im=im, jm=jm, kb=kb, dtype="float64", **OPTIONS), n)


def file_restore_check() -> None:
    """The channel at its case size (97x33x16) in float64 under the file
    scheme with interior restoring from ``lbry_series`` (staged, with the
    default taurstr): the card against the CPU after 10 steps, 1e-10 of
    each field's scale."""
    from extpom_tpu_torch.cases.channel import channel_model
    from extpom_tpu_torch.forcing import provider as prov
    im, jm, kb, n = FILE_RESTORE_CHECK

    def make(dev):
        m = channel_model(device=dev, im=im, jm=jm, kb=kb, dtype="float64",
                          bc_scheme="file", do_restore=True)
        data = lbry_series(m.grid, m.state, np.random.default_rng(2026))
        data.update(m.forcing_fn.source.data)
        m.forcing_fn = prov.ForcingProvider(m.grid, m.cfg, m.base_forcing,
                                            prov.ArraySource(data))
        return m

    state_check("file_restore_check", make, n)


def tolerance_phase(card: str) -> None:
    """The f32-against-f64 tolerance ladder on the card
    (``diag/ladder.py``, VALIDATION.md §2, ``tests/test_torch_tolerance.py``
    on the CPU): the seamount (33x33x11, 60 steps) and the channel
    (32x24x7, 40 steps) each run by the kernels in float64 and in float32;
    every field's and scalar's drift is printed beside its bound, and a
    drift at or over its bound fails.  Each run must have launched the
    whole-grid loop and the five phases, and the channel the step's forcing
    (its tide series staged)."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.diag import ladder
    for case, (kw, steps) in ladder.CASES.items():
        want = {"extloop", *(f"phase_{p}" for p in PHASES),
                *(("forcing",) if case == "channel" else ())}
        runs = {}
        for dtype in ("float64", "float32"):
            kernels.reset_launches()
            runs[dtype] = ladder.run(case, dtype, "cuda")
            torch.cuda.synchronize()
            launched = {k for k, v in kernels.LAUNCHES.items() if v}
            if launched != want:
                raise AssertionError(f"tolerance {case} {dtype}: kernels "
                                     f"launched {dict(kernels.LAUNCHES)}")
        d = ladder.drift(runs["float64"], runs["float32"])
        bounds = ladder.BOUNDS[case]
        bad = ladder.over(case, d)
        say("tolerance", case=case, grid=f"{kw['im']}x{kw['jm']}x{kw['kb']}",
            steps=steps, **{k: f"{v:.3e}" + (f"/{bounds[k]:.0e}"
                                             if k in bounds else "")
                            for k, v in d.items()},
            within_bounds=not bad, card=f"'{card}'")
        if bad:
            raise AssertionError(f"tolerance {case}: drift over its bounds "
                                 f"(drift, bound): {bad}")


# -- the print's compensated sums (kernels/diagsum.py) -----------------------

DIAG_STEPS = 4                 # steps before a 256² state is summed
DIAG_LARGE = (2048, 41)        # the synthetic 2048x2048x41 operands
DIAG_REPEATS = 5               # calls that must give the same bits
DIAG_ULP = 2                   # the largest gap of a total, in ulp
DIAG_MEAN_ULP = 4              # of taver and saver, each a ratio of totals
DIAG_CANCEL = 1e-15            # eavg's numerator, of the sum of |et darea|


def one_block(grid, st, n) -> object:
    """A whole array as the one block of ``stats._block_pairs_plain`` and
    ``diagsum.block_pairs``: ``n`` cells at global (0, 0)."""
    import types
    return types.SimpleNamespace(ni=n[0], nj=n[1], ids=[(0, 0)],
                                 grid={(0, 0): grid}, state={(0, 0): st},
                                 goff=lambda b, h: (0, 0))


def diag_large_operands(dtype, seed: int = 20481):
    """Synthetic operands of ``domain_stats`` at DIAG_LARGE on the card, of
    the magnitudes of config5's state: cells of 4 km, a seamount in 4500 m,
    a land mask, a surface of centimetres, T near 15 and S near 35, speeds
    of 0.1 m/s, rho an anomaly of 1e-3.  Returns (grid, config, state), the
    parts of each that ``domain_stats`` reads."""
    import types
    n, kb = DIAG_LARGE
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda",
                                 dtype=torch.float64)
    x = torch.linspace(-1.0, 1.0, n, device="cuda", dtype=torch.float64)
    r2 = x[:, None] ** 2 + x[None, :] ** 2
    cast = lambda a: a.to(dtype).contiguous()
    dz = torch.full((kb,), 1.0 / (kb - 1), device="cuda", dtype=dtype)
    dz[-1] = 0.0
    grid = types.SimpleNamespace(
        dx=cast(4000.0 * (1 + 0.01 * rnd(n, n))),
        dy=cast(4000.0 * (1 + 0.01 * rnd(n, n))),
        fsm=cast((rnd(n, n) > -2.0).double()),
        h=cast(4500.0 - 4000.0 * torch.exp(-r2 / 0.02)), dz=dz)
    grid.dz3 = dz[:, None, None]
    st = types.SimpleNamespace(
        et=cast(0.05 * rnd(n, n)), rho=cast(1e-3 * rnd(kb, n, n)),
        tb=cast(15.0 + rnd(kb, n, n)), sb=cast(35.0 + 0.1 * rnd(kb, n, n)),
        u=cast(0.1 * rnd(kb, n, n)), v=cast(0.1 * rnd(kb, n, n)))
    cfg = types.SimpleNamespace(kbm1=kb - 1, active=(n, n), rhoref=1025.0)
    return grid, cfg, st


def diag_bound_ms(cfg, n, item: int) -> float:
    """The least time of one print's sums: the five 2-D and the five 3-D
    operands (kbm1 levels) of the active cells read once, at 3.35 TB/s."""
    cells = n[0] * n[1]
    return (5 + 5 * cfg.kbm1) * cells * item / HBM_BYTES_PER_S * 1e3


def ulp_gap(a: float, b: float) -> float:
    import math
    return 0.0 if a == b else abs(a - b) / math.ulp(max(abs(a), abs(b)))


def diag_entry(card: str, flush: L2Flush, tag: str, grid, cfg, st, blocks,
               fsum: bool, timed: bool) -> float:
    """Hold the kernel's pairs over ``blocks`` (each block's own regions)
    to the plain pairs (``stats._block_pairs_plain``), and, with ``fsum``,
    to ``math.fsum`` of the plain path's cells: every total within DIAG_ULP
    but eavg's numerator, which cancels, within DIAG_CANCEL of the sum of
    |et darea|; where ``blocks`` is the whole grid the eight values too
    (the means of T and S within DIAG_MEAN_ULP); DIAG_REPEATS calls of the
    same bits.  With ``timed``, both paths' ms beside the byte bound.
    Returns the sum of |et darea|."""
    import math
    from extpom_tpu_torch.diag import stats
    from extpom_tpu_torch.kernels import diagsum
    reg = stats._regions(*cfg.active)
    dtype = blocks.state[blocks.ids[0]].et.dtype
    runs = [diagsum.block_pairs(blocks, cfg, reg).clone()
            for _ in range(DIAG_REPEATS)]
    same = all(torch.equal(runs[0], r) for r in runs[1:])
    got = runs[0].cpu()
    want = stats._block_pairs_plain(blocks, cfg, reg)
    tot = lambda p: [float(p[q, 0]) + float(p[q, 1])
                     for q in range(len(diagsum.SUMS))]
    got_t, want_t = dict(zip(diagsum.SUMS, tot(got))), \
        dict(zip(diagsum.SUMS, tot(want)))
    n = (blocks.ni, blocks.nj)
    cells = {k: [] for k in diagsum.SUMS}
    for b in blocks.ids:
        for k, v in stats.block_cells(blocks.grid[b], blocks.state[b], cfg,
                                      reg, blocks.goff(b, (0, 0)),
                                      n).items():
            cells[k] += v
    cancel = float(sum(c.abs().sum() for c in cells["eavg"]))
    fs = ({k: math.fsum(torch.cat(v).tolist()) for k, v in cells.items()}
          if fsum else None)
    del cells
    gaps, bad = {}, []
    for k in diagsum.SUMS:
        refs = {"plain": want_t[k], **({"fsum": fs[k]} if fsum else {})}
        for ref, w in refs.items():
            if k == "eavg":
                gap = abs(got_t[k] - w) / cancel if cancel else 0.0
                ok = gap <= DIAG_CANCEL
                gaps[f"{k}_{ref}_rel"] = f"{gap:.2e}"
            else:
                gap = ulp_gap(got_t[k], w)
                ok = gap <= DIAG_ULP
                gaps[f"{k}_{ref}_ulp"] = f"{gap:g}"
            if not ok:
                bad.append((k, ref, got_t[k], w))
    if len(blocks.ids) == 1 and blocks.goff(blocks.ids[0], (0, 0)) == (0, 0):
        vals = {k: float(v) for k, v in
                stats.domain_stats(grid, cfg, st).items()}
        plain = {k: float(v) for k, v in
                 stats.domain_stats_plain(grid, cfg, st).items()}
        for k in diagsum.NAMES:
            gap = ulp_gap(vals[k], plain[k])
            if k == "eaver":
                gap = (abs(vals[k] - plain[k]) * abs(plain["atot"]) / cancel
                       if cancel else 0.0)
                ok = gap <= DIAG_CANCEL
            else:
                ok = gap <= (DIAG_MEAN_ULP if k in ("taver", "saver")
                             else DIAG_ULP)
            gaps[f"{k}_gap"] = f"{gap:.3g}"
            if not ok:
                bad.append((k, "values", vals[k], plain[k]))
    extra = {}
    if timed:
        info = diagsum.kernel_info(dtype)
        item = torch.finfo(dtype).bits // 8
        reps = 3 if n[0] * n[1] > 2 ** 20 else 10
        kernel = lambda: diagsum.block_pairs(blocks, cfg, reg)
        plain_fn = lambda: stats.domain_stats_plain(grid, cfg, st)
        extra = dict(ms=f"{device_ms(kernel, 20, flush):.4f}",
                     plain_ms=f"{device_ms(plain_fn, reps, flush):.3f}",
                     bound_ms=f"{diag_bound_ms(cfg, cfg.active, item):.4f}",
                     rows=sum(diagsum.rows(
                         diagsum.pack(reg, cfg.active,
                                      blocks.goff(b, (0, 0)), n), dtype,
                         st.et.device) for b in blocks.ids),
                     **{k: info[k] for k in ("threads", "registers",
                                             "static_smem", "blocks_per_sm",
                                             "spill_bytes")})
    say("diag", case=tag, dtype=str(dtype).split(".")[-1],
        same_bits=same, **gaps, **extra, ok=not bad and same,
        card=f"'{card}'")
    if bad or not same:
        raise AssertionError(f"diag {tag} {dtype}: same_bits={same}, over "
                             f"the limits (sum, reference, kernel, "
                             f"reference): {bad}")
    return cancel


def diag_phase(card: str, flush: L2Flush) -> None:
    """The print's compensated sums on the card (``kernels/diagsum.py``,
    ``k_diag_sums`` and ``k_diag_finish``) against the plain sums that the
    CPU runs, in float32 and float64: the seamount at 256x256x31 after
    DIAG_STEPS steps (also against ``math.fsum`` of its cells), config5's
    2048x2048x41 on synthetic operands, a ragged 255x255x31 seamount under
    ``pad_model`` (2x4) and block (0, 1) of the 256x256x31 seamount on
    config5's 2x4 mesh, then that mesh's whole block form
    (``domain_stats_blocks``) against the gathered state's plain sums.
    Each line: every gap, whether 5 calls gave the same bits; at 256² and
    2048² both paths' ms (CUDA events after an L2 flush) beside the byte
    bound and what the card gives the kernel."""
    import gc
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.diag import stats
    from extpom_tpu_torch.mesh.padding import pad_model
    with open(LARGE) as f:
        mesh = mesh_of(json.load(f))
    for dtype in ("float32", "float64"):
        m = seamount_model(im=256, jm=256, kb=31, dtype=dtype)
        m.run_segment(DIAG_STEPS)
        n = tuple(m.state.et.shape)
        cancel = diag_entry(card, flush, "256", m.grid, m.cfg, m.state,
                            one_block(m.grid, m.state, n), fsum=True,
                            timed=True)
        whole = stats.domain_stats_plain(m.grid, m.cfg, m.state)
        m.shard(mesh)
        b = (0, 1)
        blk = one_block(m.blocks.grid[b], m.blocks.state[b],
                        (m.blocks.ni, m.blocks.nj))
        blk.goff = lambda _, h, b=b: m.blocks.goff(b, h)
        diag_entry(card, flush, "256_block_0_1", None, m.cfg, None, blk,
                   fsum=False, timed=False)
        got = {k: float(v) for k, v in
               stats.domain_stats_blocks(m.blocks, m.cfg).items()}
        gaps = {k: ulp_gap(got[k], float(whole[k])) for k in got}
        gaps["eaver"] = (abs(got["eaver"] - float(whole["eaver"]))
                         * got["atot"] / cancel)
        limit = lambda k: (DIAG_CANCEL if k == "eaver" else DIAG_MEAN_ULP
                           if k in ("taver", "saver") else DIAG_ULP)
        say("diag", case="256_mesh_2x4", dtype=dtype,
            **{f"{k}_gap": f"{v:.3g}" for k, v in gaps.items()},
            card=f"'{card}'")
        if any(v > limit(k) for k, v in gaps.items()):
            raise AssertionError(f"diag 256_mesh_2x4 {dtype}: {gaps}")
        del m, whole
        r = seamount_model(im=255, jm=255, kb=31, dtype=dtype)
        r.run_segment(DIAG_STEPS)
        pad_model(r, mesh.px, mesh.py)
        n = tuple(r.state.et.shape)
        diag_entry(card, flush, f"255_padded_{n[0]}x{n[1]}", r.grid, r.cfg,
                   r.state, one_block(r.grid, r.state, n), fsum=False,
                   timed=False)
        del r
        gc.collect()
        torch.cuda.empty_cache()
        grid, cfg, st = diag_large_operands(getattr(torch, dtype))
        diag_entry(card, flush, "2048x41_synthetic", grid, cfg, st,
                   one_block(grid, st, cfg.active), fsum=False, timed=True)
        del grid, st
        gc.collect()
        torch.cuda.empty_cache()


# -- the step's forcing (kernels/forcing.py) ---------------------------------

FORCING_LARGE = (2048, 2048, 41)   # the forced regional domain's grid
FORCING_STEPS = (1, 19, 20, 21, 61, 10 ** 4)   # steps held on each plan
# records of each dataset on FORCING_LARGE: enough that a window of the
# lateral series starts past the first record
FORCING_NREC = {"lbry": 8, "sfrc": 3, "clim": 2}


def forcing_large_provider(card, seed: int = 2304):
    """A provider of every series of the forced regional domain at
    FORCING_LARGE (``pombench/configs/forced2048.json``): the 20 lateral
    series, the four fluxes, tsurf and ssurf, and the 3-D trstr, srstr and
    taurstr, at bounds_forcing.f's periods with FORCING_NREC records of
    each dataset, drawn on the host in float64 (a 3-D record is a drawn
    plane times a drawn profile).  Returns (provider, its float32 cfg)."""
    import types
    from extpom_tpu_torch.core.config import Config
    from extpom_tpu_torch.forcing import provider as prov
    im, jm, kb = FORCING_LARGE
    cfg = Config(im=im, jm=jm, kb=kb, dtype="float32", bc_scheme="file",
                 do_restore=True, forcing_hbm_mb=16384)
    r = np.random.default_rng(seed)
    data = {}
    nrec = FORCING_NREC["lbry"]
    for side in prov.BRY_SIDES:
        n = jm if side in "we" else im
        data[f"el{side}"] = r.standard_normal((nrec, n))
        for v in "tsuv":
            data[f"{v}b{side}"] = r.standard_normal((nrec, kb, n))
    nrec = FORCING_NREC["sfrc"]
    for v in prov.WIND_VARS + prov.HEAT_VARS + prov.SURF_VARS:
        data[v] = r.standard_normal((nrec, im, jm))
    nrec = FORCING_NREC["clim"]
    for v in prov.RESTORE_VARS:
        data[v] = np.stack([r.uniform(0.5, 1.5, (kb, 1, 1))
                            * r.standard_normal((im, jm))[None]
                            for _ in range(nrec)])
    grid = types.SimpleNamespace(device=card)
    return prov.ForcingProvider(grid, cfg, None, prov.ArraySource(data),
                                prefetch=False), cfg


def forcing_bytes(ps, item: int) -> int:
    """Compulsory bytes of one step's forcing from the picks ``ps``: each
    interpolated series' two records read and its value written once, and
    each edge profile's barotropic value written."""
    from extpom_tpu_torch.forcing import provider as prov
    interp = {p.name: p for p in ps if p.f is not None}
    profiles = [prov.barotropic_name(s)[0] for s in prov.BRY_SIDES]
    edges = sum(interp[u].b.shape[-1] for u in profiles if u in interp)
    return (3 * sum(p.b.numel() for p in interp.values()) + edges) * item


def forcing_entry(card: str, flush: L2Flush, tag: str, staged, cfg, dz,
                  timed: bool) -> dict:
    """Hold ``forcing_at`` on the card (``k_forcing_interp``) to
    ``forcing_at_plain`` on each (plan, model time) of ``staged`` by
    ``torch.equal`` on every field, with one launch a call by the
    library's count and by the profiler's (and no other device kernel);
    with ``timed``, both paths' ms on the last pair beside the byte bound
    and what the card gives the kernel.  Prints and returns the line's
    numbers."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.core.state import zero_forcing
    from extpom_tpu_torch.forcing import device as fdev
    from extpom_tpu_torch.kernels import forcing as kforcing
    dtype = staged[0][0].stacks[0].dtype
    name = str(dtype).split(".")[-1]
    cfg = cfg.replace(dtype=name)
    base = zero_forcing(cfg, torch.device("cuda"))
    bad = []
    for plan, t in staged:
        ps = fdev.picks(plan, t)
        before = kernels.LAUNCHES["forcing"]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = fdev.forcing_at(plan, base, cfg, dz, t)
            torch.cuda.synchronize()
        launched = kernels.LAUNCHES["forcing"] - before
        names = [k.key for k in _kernel_events(prof)]
        if launched != 1 or len(names) != 1 \
                or "k_forcing_interp" not in names[0]:
            raise AssertionError(f"forcing {tag}: {launched} launches by "
                                 f"the count, device kernels {names}")
        want = fdev.forcing_at_plain(ps, base, cfg, dz)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if not (a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a, b)):
                bad.append((float(t), f.name))
    rows = kforcing.rows(ps, cfg.kbm1)
    nums = dict(case=tag, dtype=name,
                windowed=any(any(p.starts) for p, _ in staged),
                times=len(staged),
                interpolated=sum(lev == 0 for _, _, lev in rows),
                edge_integrals=sum(lev > 0 for _, _, lev in rows),
                launches_per_call=1, bit_equal=not bad)
    if timed:
        item = torch.finfo(dtype).bits // 8
        info = kforcing.kernel_info(dtype)
        bound = forcing_bytes(ps, item) / HBM_BYTES_PER_S * 1e3
        ms = device_ms(lambda: fdev.forcing_at(plan, base, cfg, dz, t), 20,
                       flush)
        plain = device_ms(lambda: fdev.forcing_at_plain(ps, base, cfg, dz),
                          5, flush)
        with OpCount() as ops:
            fdev.forcing_at_plain(ps, base, cfg, dz)
        nums.update(ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                    bound_ms=f"{bound:.4f}",
                    roofline_pct=f"{100 * bound / ms:.1f}",
                    plain_kernels=ops.n,
                    **{k: info[k] for k in ("threads", "entries",
                                            "registers", "blocks_per_sm",
                                            "spill_bytes")})
    say("forcing", **nums, card=f"'{card}'")
    if bad:
        raise AssertionError(f"forcing {tag} {name}: the kernel and the "
                             f"plain path differ at (time, field) "
                             f"{bad[:8]}")
    return nums


def model_plans(m, dtype, windowed: bool) -> list:
    """(plan, model time) of ``m``'s provider at each step of
    FORCING_STEPS (inside a record, at and across a lateral record, past
    the last): the whole staged plan, or the window that a print from the
    step before stages."""
    from extpom_tpu_torch.forcing import device as fdev
    p, dt = m.forcing_fn, m.cfg.dti / 86400.0
    whole = None if windowed else fdev.make_device_plan(
        p, dtype=dtype, device=m.device)
    return [(whole or fdev.make_device_plan(
                p, dtype=dtype, budget_bytes=0, t0_days=(i - 1) * dt,
                t1_days=(i - 1 + m.cfg.iprint) * dt, device=m.device),
             fdev.t_days_at(m.cfg, i, m.time0, dtype))
            for i in FORCING_STEPS]


def forcing_phase(card: str, flush: L2Flush) -> dict:
    """The step's forcing on the card (``kernels/forcing.py``,
    ``k_forcing_interp``) against the plain path that the CPU runs
    (``forcing_at_plain``), by ``torch.equal`` in float32 and float64:
    on the providers of ``[channel]`` (the tidal channel's lateral series,
    512x512x31) and ``[file_restore]`` (its lbry file: every lateral series
    and the 3-D restoring, the default taurstr), whole and windowed, at
    each step of FORCING_STEPS; and on every series of the forced regional
    domain at FORCING_LARGE, whole and windowed, timed there beside its
    byte bound and the plain path.  Returns the float32 2048² line's
    numbers for the ``kernels`` line."""
    import gc
    from extpom_tpu_torch import run
    from extpom_tpu_torch.forcing import device as fdev
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        confs = {"channel_512": channel_conf(),
                 "file_restore_512": file_restore_conf(tmp)[0]}
        for tag, conf in confs.items():
            for dtype in ("float32", "float64"):
                m = run.build_model({**conf, "config": {
                    **conf["config"], "dtype": dtype}})
                for windowed in (False, True):
                    nums = forcing_entry(
                        card, flush, tag,
                        model_plans(m, getattr(torch, dtype), windowed),
                        m.cfg, m.grid.dz,
                        timed=dtype == "float32" and not windowed)
                    if "ms" in nums:
                        out.update({f"{tag}_{k}": nums[k]
                                    for k in ("ms", "plain_ms", "bound_ms")})
                del m
    p, cfg = forcing_large_provider(torch.device("cuda"))
    for dtype in ("float32", "float64"):
        dt = getattr(torch, dtype)
        c = cfg.replace(dtype=dtype)
        dz = torch.linspace(0.01, 0.04, cfg.kb, dtype=dt, device="cuda")
        times = [fdev.t_days_at(c, 0, t, dt)
                 for t in (0.0, 0.0104, 1 / 24, 0.1, 0.125, 0.13)]
        plan = fdev.make_device_plan(p, dtype=dt, device="cuda")
        nums = forcing_entry(card, flush, "2048x41",
                             [(plan, t) for t in times], c, dz, timed=True)
        if dtype == "float32":
            out = {**{k: nums[k] for k in (
                "ms", "plain_ms", "bound_ms", "roofline_pct",
                "plain_kernels", "threads", "entries", "registers",
                "blocks_per_sm", "spill_bytes")}, **out}
        del plan
        plan = fdev.make_device_plan(p, dtype=dt, budget_bytes=0,
                                     t0_days=0.09, t1_days=0.135,
                                     device="cuda")
        forcing_entry(card, flush, "2048x41", [(plan, t) for t in times[3:]],
                      c, dz, timed=False)
        del plan
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- several processes on the one card ---------------------------------------

DIST_RANKS = 2                 # [distributed], [distributed_large]
DIST_TIMEOUT_S = 480.0         # each two-rank path, its set-up included
DIST_PROFILE_STEPS = 2


def fingerprint(x: torch.Tensor) -> str:
    """The bits of a tensor as two int64 sums on the card: of its words,
    and of its words weighted by their position (mod 65521, plus 1), so
    that a changed or a moved word shows.  Integer sums wrap the same in
    any order."""
    v = x.detach().contiguous().view(-1)
    v = v.view(torch.int32 if v.element_size() == 4 else torch.int64).to(
        torch.int64)
    w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) % 65521
    return f"{int(v.sum())}:{int((v * (w + 1)).sum())}"


def block_prints(blocks) -> dict:
    """"(bi, bj)" -> State field -> :func:`fingerprint`, for every block
    this process holds."""
    from extpom_tpu_torch.core.state import State
    return {str(b): {f: fingerprint(getattr(blocks.state[b], f))
                     for f in State.field_names()} for b in blocks.ids}


def rank_main(spec: dict) -> int:
    """One rank of a two-process path (``python3 chip_smoke.py --rank
    SPEC``, started by :func:`distributed_phase` with torchrun's variables):
    joins the gloo group with its blocks on the one card (``cuda:0``),
    builds the run file ``spec["conf"]`` through ``run.build_model`` (the
    case on the host, each block cold-started on the card), runs
    ``spec["warm"]`` then ``spec["timed"]`` steps and prints one
    ``RANK_RESULT`` JSON line: its blocks' fingerprints after those steps,
    its launches, ms per step, what the exchange cost, the device's busy
    time over DIST_PROFILE_STEPS more steps, its peak memory.  With
    ``spec["nccl"]`` it asks for nccl instead, which must refuse two ranks
    on one card before any step."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch import run as ptrun
    from extpom_tpu_torch.core import dispatch
    from extpom_tpu_torch.kernels import build
    from extpom_tpu_torch.mesh import distributed
    torch.set_num_threads(max(1, (os.cpu_count() or 2)
                              // int(os.environ["WORLD_SIZE"])))
    if spec.get("nccl"):
        try:
            distributed.init_distributed(backend="nccl", device="cuda:0",
                                         timeout_s=120)
        except ValueError as e:
            print("RANK_RESULT " + json.dumps({"refused": str(e)}),
                  flush=True)
            return 0
        raise AssertionError("nccl took two ranks on one card")
    p = distributed.init_distributed(backend="gloo", device="cuda:0",
                                     timeout_s=DIST_TIMEOUT_S)
    build.library()                # the parent built it
    t0 = time.perf_counter()
    m = ptrun.build_model(spec["conf"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kernels.reset_launches()
    m.run_segment(spec["warm"])
    torch.cuda.synchronize()
    distributed.process_barrier()  # the window starts together
    distributed.EXCHANGE.reset()
    t0 = time.perf_counter()
    m.run_segment(spec["timed"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ex = dataclasses.replace(distributed.EXCHANGE)
    launches = dict(kernels.LAUNCHES)
    prints = block_prints(m.blocks)
    peak = torch.cuda.max_memory_allocated()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.run_segment(DIST_PROFILE_STEPS)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in _kernel_events(prof)) / 1e3
    n = spec["timed"]
    out = dict(rank=p.rank, blocks=[list(b) for b in m.blocks.ids],
               launches=launches, prints=prints, setup_s=setup_s,
               ms_per_step=wall / n * 1e3,
               exchange_ms_per_step=ex.seconds / n * 1e3,
               exchange_calls_per_step=ex.calls / n,
               sent_mb_per_step=ex.sent_bytes / n / 1e6,
               staged_mb_per_step=ex.staged_bytes / n / 1e6,
               profiled_ms_per_step=prof_ms / DIST_PROFILE_STEPS,
               device_busy_ms_per_step=(busy / DIST_PROFILE_STEPS
                                        if busy else None),
               peak_bytes=peak, device=str(m.device))
    if p.rank == 0:
        out["dispatch"] = dispatch.format_report(dispatch.dispatch_report(
            m.cfg, m.cfg.torch_dtype, m.device, mesh=spec["conf"]["mesh"]))
    print("RANK_RESULT " + json.dumps(out), flush=True)
    distributed.destroy()
    return 0


def spawn_ranks(spec: dict, tag: str, n: int = DIST_RANKS) -> list:
    """Run :func:`rank_main` as ``n`` processes on the one card; each
    rank's RANK_RESULT.  A rank that exits with an error, or outlasts
    DIST_TIMEOUT_S, fails the path (the others are killed)."""
    from extpom_tpu_torch.mesh import distributed
    res = distributed.spawn(
        [sys.executable, os.path.abspath(__file__), "--rank",
         json.dumps(spec)], n, DIST_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT)
    outs = []
    for r, (rc, so, se) in enumerate(res):
        if rc != 0:
            raise AssertionError(f"{tag}: rank {r} exited {rc} (None: cut "
                                 f"at {DIST_TIMEOUT_S} s):\n{so[-1500:]}\n"
                                 f"{se[-3000:]}")
        line = [ln for ln in so.splitlines() if ln.startswith("RANK_RESULT ")]
        outs.append(json.loads(line[-1][len("RANK_RESULT "):]))
    return outs


def nccl_refusal_phase() -> None:
    """Two ranks asking nccl for the one card: each must refuse at init,
    before any step, and name gloo."""
    outs = spawn_ranks({"nccl": True}, "nccl_refusal")
    for r, o in enumerate(outs):
        if "two ranks on one card" not in o.get("refused", ""):
            raise AssertionError(f"nccl_refusal: rank {r}: {o}")
    say("nccl_refusal", ranks=len(outs), refused=True,
        reason=f"'{outs[0]['refused']}'")


def distributed_phase(card: str, tag: str, conf: dict, warm: int,
                      timed: int, want_prints: dict,
                      want_launches: dict) -> tuple:
    """A run file on ``conf``'s mesh split over two processes on the one
    card (gloo, each ring staged through pinned host memory), ``warm`` +
    ``timed`` steps; every block's fingerprints held bit-equal to
    ``want_prints`` (the single-process mesh run's after the same steps)
    and the ranks' launches summed to ``want_launches``.  Prints a line per
    rank and one for the path; returns (summed launches, launches by
    rank)."""
    t0 = time.perf_counter()
    outs = spawn_ranks(dict(conf=conf, warm=warm, timed=timed), tag)
    wall = time.perf_counter() - t0
    prints = {}
    for o in outs:
        prints.update(o["prints"])
    if sorted(prints) != sorted(want_prints):
        raise AssertionError(f"{tag}: blocks {sorted(prints)} != "
                             f"{sorted(want_prints)}")
    bad = [(b, f) for b in want_prints for f in want_prints[b]
           if prints[b][f] != want_prints[b][f]]
    if bad:
        raise AssertionError(f"{tag}: not bit-equal to the single-process "
                             f"mesh run in {bad[:8]} ({len(bad)} fields)")
    launches = {k: sum(o["launches"][k] for o in outs)
                for k in outs[0]["launches"]}
    if launches != want_launches:
        raise AssertionError(f"{tag}: launches of the ranks {launches} != "
                             f"the single-process mesh's {want_launches}")
    peak = sum(o["peak_bytes"] for o in outs)
    if not peak < 80e9:
        raise AssertionError(f"{tag}: the ranks' peaks sum to {peak}")
    for o in outs:
        busy = o["device_busy_ms_per_step"]
        say(tag, rank=o["rank"], blocks=f"'{o['blocks']}'",
            device=o["device"], transport="gloo",
            ms_per_step=f"{o['ms_per_step']:.3f}",
            exchange_ms_per_step=f"{o['exchange_ms_per_step']:.3f}",
            exchange_calls_per_step=f"{o['exchange_calls_per_step']:.1f}",
            staged_mb_per_step=f"{o['staged_mb_per_step']:.3f}",
            sent_mb_per_step=f"{o['sent_mb_per_step']:.3f}",
            device_busy_ms_per_step=("not measured" if busy is None
                                     else f"{busy:.3f}"),
            device_idle_share=("not measured" if busy is None else
                               f"{1 - busy / o['profiled_ms_per_step']:.3f}"),
            peak_mem_gb=f"{o['peak_bytes'] / 1e9:.3f}",
            setup_s=f"{o['setup_s']:.1f}",
            launches=json.dumps({k: v for k, v in o["launches"].items() if v},
                                separators=(",", ":")))
    say(tag, processes=len(outs), steps=warm + timed, timed_steps=timed,
        bit_equal=True, blocks_checked=len(prints),
        fields_checked=sum(len(v) for v in prints.values()),
        launches_equal_single_process=True,
        peak_sum_gb=f"{peak / 1e9:.3f}", wall_s=f"{wall:.1f}",
        card=f"'{card}'")
    for line in outs[0]["dispatch"].splitlines():
        print(f"[dispatch] ({tag}) " + line.strip(), flush=True)
    return launches, {k: [o["launches"][k] for o in outs] for k in launches}


def distributed_conf(large: bool) -> dict:
    """The run file of a two-process path: config5's case, config and mesh
    blocks ([distributed_large]), or the main path's seamount on config5's
    mesh ([distributed])."""
    with open(LARGE) as f:
        run = json.load(f)
    if run["distributed"]["num_processes"] != DIST_RANKS:
        raise AssertionError(f"config5 names {run['distributed']} processes")
    if large:
        return {k: run[k] for k in ("case", "case_args", "config", "mesh")}
    return {"case": "seamount", "case_args": {"im": IM, "jm": JM, "kb": KB},
            "config": {}, "mesh": run["mesh"]}


CONFIG4 = (512, 512, 31)       # [config4]: BASELINE config 4
CONFIG4_STEPS, CONFIG4_PRINT, CONFIG4_RESTART = 48, 24, 24
CONFIG4_TOL = 1e-5             # of each field's scale, f32 (PERF.md §2)
RANK_LINE = re.compile(
    r"rank (\d+): wall clock ([\d.]+) s, writes: (\d+) in ([\d.]+) s on the "
    r"writer thread, ([\d.]+) s of the driver's time, encoder: (\d+) chunks "
    r"in ([\d.]+) s, ([\d.]+) MB into ([\d.]+) MB, kernel launches "
    r"(\{.*\})")


def config4_conf() -> dict:
    """``[config4]``'s run file: BASELINE config 4, the seamount at
    CONFIG4 float32 with the main path's options, config5's 2x4 mesh block
    and a distributed block of two processes over gloo, Zarr output, a
    print and a snapshot every CONFIG4_PRINT steps and a restart every
    CONFIG4_RESTART."""
    with open(LARGE) as f:
        run = json.load(f)
    im, jm, kb = CONFIG4
    return {"run_name": "config4", "case": "seamount",
            "case_args": {"im": im, "jm": jm, "kb": kb},
            "config": {"dtype": "float32", "mode": 3, "bc_scheme": "extpom",
                       "nadv": 1, "npg": 1, "dte": 6.0, "isplit": 30,
                       "days": CONFIG4_STEPS * STEP_S / 86400,
                       "prtd1": CONFIG4_PRINT * STEP_S / 86400,
                       "write_rst": CONFIG4_RESTART * STEP_S / 86400},
            "out_format": "zarr", "mesh": run["mesh"],
            "distributed": {"backend": "gloo", "num_processes":
                            run["distributed"]["num_processes"]}}


def driver_ranks(conf: dict, tmp: str, tag: str) -> tuple:
    """``python -m extpom_tpu_torch.run`` on ``conf`` (its out_dir
    ``tmp/tag``) as DIST_RANKS processes on the one card (``--device
    cuda:0``), launched as torchrun would.  Returns (rank 0's lines, each
    rank's wall clock, writes, writer and blocked seconds and launches from
    the driver's closing lines, with its encoder's chunks, seconds and
    MB); rank 1 must print nothing."""
    from extpom_tpu_torch.mesh import distributed
    conf = {**conf, "out_dir": os.path.join(tmp, tag)}
    path = os.path.join(tmp, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    threads = str(max(1, (os.cpu_count() or 2) // DIST_RANKS))
    res = distributed.spawn(
        [sys.executable, "-m", "extpom_tpu_torch.run", path, "--device",
         "cuda:0"], DIST_RANKS, DIST_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=threads),
        cwd=tmp)
    for r, (rc, so, se) in enumerate(res):
        if rc != 0:
            raise AssertionError(f"{tag}: rank {r} exited {rc} (None: cut "
                                 f"at {DIST_TIMEOUT_S} s):\n{so[-1500:]}\n"
                                 f"{se[-3000:]}")
    if any(so.strip() for _, so, _ in res[1:]):
        raise AssertionError(f"{tag}: a rank other than 0 printed")
    ranks = [dict(wall=float(w), writes=int(n), busy=float(b),
                  blocked=float(bl), encoded=int(ec), encode_s=float(es),
                  encoded_raw_mb=float(er), encoded_mb=float(em),
                  launches=json.loads(la))
             for _, w, n, b, bl, ec, es, er, em, la
             in RANK_LINE.findall(res[0][1])]
    if len(ranks) != DIST_RANKS:
        raise AssertionError(f"{tag}: {len(ranks)} rank lines")
    return res[0][1].splitlines(), ranks


def config4_phase(card: str) -> tuple:
    """BASELINE config 4 through the run driver on the card
    (``config4_conf``): CONFIG4_STEPS steps as two processes sharing the
    card over gloo, each holding a block row of the 2x4 mesh (the blocks
    256x128x31: extchunk and the phase_<p>_mesh kernels); then resumed
    from the restart at CONFIG4_RESTART as two processes; then the same
    file in one process (the mesh block, no distributed block).  Gates:
    the two-process snapshots within CONFIG4_TOL of each field's scale of
    the one-process run's (bit-equality reported), the resumed run's last
    restart bit-equal to the uninterrupted run's in every State field,
    the ranks' launches summed to the one-process run's (the block kernels
    only), every store as the JAX package writes it (``blosc_stores``),
    the one-process run's last snapshot and restart read back bit-equal to
    its model (``assert_lossless``), saver.  Each run writes into a
    temporary directory, removed as soon as it is compared; the bytes of
    each snapshot and restart, raw and stored, and each rank's writer and
    encoder seconds are printed.  Returns (the ranks' summed launch
    counts, by rank)."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.core.state import State
    from extpom_tpu_torch.io import zarrstore as zio
    im, jm, kb = CONFIG4
    n, half = CONFIG4_STEPS, CONFIG4_RESTART
    conf = config4_conf()
    mesh = conf["mesh"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        lines, ranks = driver_ranks(conf, tmp, "two")
        two_s = time.perf_counter() - t0
        nums = driver_numbers(lines)
        two = os.path.join(tmp, "two")
        snaps = [f"config4.{k:06d}" for k in range(CONFIG4_PRINT, n + 1,
                                                   CONFIG4_PRINT)]
        rsts = [f"config4.rst.{k:06d}" for k in range(
            CONFIG4_RESTART, n + 1, CONFIG4_RESTART)]
        snap_bytes = [tree_bytes(os.path.join(two, d)) for d in snaps]
        rst_bytes = [tree_bytes(os.path.join(two, d)) for d in rsts]
        written = tree_bytes(two)
        snap_mb, snap_raw_mb = per_store([os.path.join(two, d)
                                          for d in snaps])
        rst_mb, rst_raw_mb = per_store([os.path.join(two, d) for d in rsts])
        stores = [blosc_stores(two)]
        if (len(nums["prints"]) != len(snaps) or nums["machine"]
                != "cuda-extchunk"):
            raise AssertionError(f"config4: {len(nums['prints'])} prints, "
                                 f"external {nums['machine']}")
        saver = float(re.search(r"saver = *([-\d.e+]+)",
                                nums["prints"][-1]).group(1))
        if not abs(saver - 15.0) <= 1e-4:
            raise AssertionError(f"config4: saver {saver}")
        r_lines, r_ranks = driver_ranks(
            {**conf, "nread_rst": 1,
             "read_rst_path": os.path.join(two, rsts[0])}, tmp, "resumed")
        if driver_numbers(r_lines)["prints"] != nums["prints"][-1:]:
            raise AssertionError("config4 resumed: its print differs")
        stores.append(blosc_stores(os.path.join(tmp, "resumed")))
        a_rst = os.path.join(two, rsts[-1])
        b_rst = os.path.join(tmp, "resumed", rsts[-1])
        for f in State.field_names():
            a, b = zio.read_array(a_rst, f), zio.read_array(b_rst, f)
            if not (a.dtype == b.dtype and np.array_equal(a, b)):
                raise AssertionError(f"config4 resumed: restart field {f} "
                                     f"differs")
        if zio._read_attrs(a_rst) != zio._read_attrs(b_rst):
            raise AssertionError("config4 resumed: restart attributes")
        shutil.rmtree(os.path.join(tmp, "resumed"))
        for d in rsts:
            shutil.rmtree(os.path.join(two, d))
        one_conf = {k: v for k, v in conf.items() if k != "distributed"}
        o_lines, o_launches, o_peak, o_model = run_cli(one_conf, tmp, "one")
        o_nums = driver_numbers(o_lines)
        stores.append(blosc_stores(os.path.join(tmp, "one")))
        assert_lossless(os.path.join(tmp, "one", snaps[-1]),
                        os.path.join(tmp, "one", rsts[-1]), o_model,
                        "config4 one process")
        del o_model
        worst, equal = (0.0, "none"), True
        for d in snaps:
            for name in zio.OUTPUT_GRID_VARS + zio.OUTPUT_FIELDS:
                a = zio.read_array(os.path.join(two, d), name)
                b = zio.read_array(os.path.join(tmp, "one", d), name)
                if not (np.isfinite(a).all() and a.shape == b.shape):
                    raise AssertionError(f"config4: {d}/{name}")
                scale = max(float(np.abs(b).max()), 1e-30)
                rel = float(np.abs(a - b).max()) / scale
                equal = equal and np.array_equal(a, b)
                if not rel <= CONFIG4_TOL:
                    raise AssertionError(f"config4: {d}/{name} is {rel:.3e} "
                                         f"of scale off the one-process run")
                if rel >= worst[0]:
                    worst = (rel, f"{d[-6:]}/{name}")
    summed = {k: sum(r["launches"].get(k, 0) for r in ranks)
              for k in kernels.LAUNCHES}
    if summed != o_launches:
        raise AssertionError(f"config4: the ranks' launches {summed} != the "
                             f"one process's {o_launches}")
    block = {"extchunk", *(f"phase_{p}_mesh" for p in PHASES)}
    if {k for k, v in summed.items() if v} != block:
        raise AssertionError(f"config4: kernels launched {summed}")
    raw_all = sum(x["raw"] for x in stores)
    stored_all = sum(x["stored"] for x in stores)
    for line in nums["prints"]:
        print(f"[config4] {line}", flush=True)
    steps = nums["steps"]
    for r, (rk, rr) in enumerate(zip(ranks, r_ranks)):
        hidden = 1.0 - rk["blocked"] / rk["busy"] if rk["busy"] else 0.0
        say("config4", rank=r, steps=steps,
            ms_per_step=f"{rk['wall'] / steps * 1e3:.3f}",
            ms_per_step_not_blocked=(
                f"{(rk['wall'] - rk['blocked']) / steps * 1e3:.3f}"),
            writes=rk["writes"], write_s=f"{rk['busy']:.3f}",
            driver_blocked_s=f"{rk['blocked']:.3f}",
            write_share_hidden=f"{hidden:.3f}",
            encoded_chunks=rk["encoded"], encode_s=f"{rk['encode_s']:.3f}",
            encoded_raw_mb=f"{rk['encoded_raw_mb']:.3f}",
            encoded_mb=f"{rk['encoded_mb']:.3f}",
            resumed_ms_per_step=f"{rr['wall'] / (n - half) * 1e3:.3f}",
            resumed_write_s=f"{rr['busy']:.3f}",
            resumed_encode_s=f"{rr['encode_s']:.3f}",
            launches=json.dumps(rk["launches"], separators=(",", ":")))
    say_driver("config4_one_process", o_nums, im * jm * kb, o_peak, card,
               grid=f"{im}x{jm}x{kb}", mesh=f"{mesh['px']}x{mesh['py']}")
    say("config4", grid=f"{im}x{jm}x{kb}", dtype="float32",
        mesh=f"{mesh['px']}x{mesh['py']}", processes=len(ranks),
        transport="gloo", steps=steps, saver=f"{saver:.7f}",
        snapshots=len(snaps), restarts=len(rsts),
        mb_per_snapshot=f"{sum(snap_bytes) / len(snaps) / 1e6:.3f}",
        raw_mb_per_snapshot=f"{snap_raw_mb:.3f}",
        snapshot_ratio=f"{snap_raw_mb / snap_mb:.3f}",
        mb_per_restart=f"{sum(rst_bytes) / len(rsts) / 1e6:.3f}",
        raw_mb_per_restart=f"{rst_raw_mb:.3f}",
        restart_ratio=f"{rst_raw_mb / rst_mb:.3f}",
        mb_written=f"{written / 1e6:.3f}",
        zarr_arrays_blosc=sum(x["arrays"] for x in stores),
        zarr_chunks_blosc=sum(x["chunks"] for x in stores),
        zarr_ratio=f"{raw_all / stored_all:.3f}",
        lossless=True,
        vs_one_process_max_rel_err=f"{worst[0]:.3e}", worst_field=worst[1],
        tol=CONFIG4_TOL, snapshots_bit_equal=equal,
        resumed_from=half, resumed_restart_bit_equal=True,
        restart_fields_checked=len(State.field_names()),
        launches_equal_one_process=True, two_process_wall_s=f"{two_s:.1f}",
        card=f"'{card}'")
    return summed, {k: [r["launches"].get(k, 0) for r in ranks]
                    for k in summed}


def dispatch_echo(*runs) -> None:
    """The dispatch report of each (configuration, mesh block or None) in
    float32 on the card."""
    from extpom_tpu_torch.core import dispatch
    for cfg, mesh in runs:
        rep = dispatch.dispatch_report(cfg, torch.float32, "cuda", mesh=mesh)
        for line in dispatch.format_report(rep).splitlines():
            print("[dispatch] " + line.strip(), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from extpom_tpu_torch.kernels import build
    from extpom_tpu_torch.native import zcodec

    card = card_line()
    say("card", nvidia_smi=f"'{card}'", torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s = build.build(verbose=True)
    build.library()
    say("build", seconds=f"{build_s:.1f}", lib=build.LIB.name)
    # the Zarr codec (g++), built here so that no timed run builds it
    t0 = time.perf_counter()
    if zcodec.get_lib() is None:
        raise AssertionError(f"{zcodec.SRC.name} did not build")
    say("build", seconds=f"{time.perf_counter() - t0:.1f}",
        lib=zcodec.LIB.name)

    flush = L2Flush()
    tri = tridiag_phase(flush)
    ext_inputs, grid, cfg, phase_args = step_inputs()
    ext = extloop_phase(flush, ext_inputs)
    phs = phases_phase(flush, grid, cfg, phase_args)
    deep_phases_check()
    golden_phase()
    nonsquare_phase()
    launches = slice_phase(card)
    large_launches, large_ops, large_ref, large_tiled = large_phase(card,
                                                                    flush)
    for p, (ms, bound) in large_tiled.items():
        phs[p].update(large_2048_ms=ms, large_2048_bound_ms=bound)
    win = extwin_phase(flush, large_ops)
    large_cfg = large_ops[1]
    del large_ops
    mesh_k, _ = mesh_kernels_phase(flush)
    mesh_launches, mesh_prints = mesh_phase(card)
    large_mesh_launches, win_chunk, large_mesh_tiled, large_mesh_prints = \
        large_mesh_phase(card, flush, large_ref)
    del large_ref
    cli_launches, _ = cli_phase(card)
    cli_zarr_launches, _ = cli_phase(card, "zarr")
    channel_launches, channel_end = channel_phase(card, flush)
    channel_mesh_launches = channel_mesh_phase(card, flush, channel_end)
    del channel_end
    channel_check()
    orl_launches, m = orlanski_phase(card)
    orl_k = orlanski_kernels(m, flush)
    del m
    orl_mesh_launches = orlanski_mesh_phase(card)
    basin_launches, m, kept = basin_phase(card, flush)
    basin_cfg = m.cfg
    basin_k = basin_kernels(m, kept, flush)
    del m, kept
    basin_check()
    mode2_check(card)
    opt_launches, m = options_phase(card)
    del m
    opt_k = options_kernels(flush)
    mpdata_edges_phase()
    opt_mesh_launches, opt_mesh_k = options_mesh_phase(card, flush)
    fr_launches, fr_k, fr_end = file_restore_phase(card, flush)
    frm_launches, frm_k = file_restore_mesh_phase(card, flush, fr_end)
    del fr_end
    ragged_launches = ragged_phase(card)
    options_check()
    file_restore_check()
    tolerance_phase(card)
    diag_phase(card, flush)
    frc = forcing_phase(card, flush)
    # several processes last, with the parent's cached device memory freed:
    # two ranks share the card
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    nccl_refusal_phase()
    dist_launches, dist_by_rank = distributed_phase(
        card, "distributed", distributed_conf(False), SEG_WARM, SEG_TIMED,
        mesh_prints, mesh_launches)
    dist_large_launches, dist_large_by_rank = distributed_phase(
        card, "distributed_large", distributed_conf(True), LARGE_WARM,
        LARGE_TIMED, large_mesh_prints, large_mesh_launches)
    config4_launches, config4_by_rank = config4_phase(card)
    with open(LARGE) as f:
        mesh_block = json.load(f)["mesh"]
    channel_cfg = cfg.replace(dtype="float32", im=CHANNEL[0], jm=CHANNEL[1],
                              kb=CHANNEL[2])
    dispatch_echo((cfg.replace(dtype="float32"), None), (large_cfg, None),
                  (cfg.replace(dtype="float32"), mesh_block),
                  (large_cfg, mesh_block), (channel_cfg, None),
                  (basin_cfg, None),
                  (cfg.replace(dtype="float32", **OPTIONS), None),
                  (channel_cfg.replace(bc_scheme="file", do_restore=True),
                   None), (channel_cfg, mesh_block),
                  (cfg.replace(dtype="float32", im=RAGGED[0], jm=RAGGED[1],
                               kb=RAGGED[2]), mesh_block))
    paths = {"slice_256": launches, "large_2048": large_launches,
             "mesh_256": mesh_launches, "mesh_2048": large_mesh_launches,
             "cli_256": cli_launches, "channel_512": channel_launches,
             "orlanski_256": orl_launches,
             "orlanski_mesh_256": orl_mesh_launches,
             "basin_512": basin_launches, "options_256": opt_launches,
             "options_mesh_256": opt_mesh_launches,
             "file_restore_512": fr_launches,
             "channel_mesh_512": channel_mesh_launches,
             "file_restore_mesh_512": frm_launches, **ragged_launches,
             "distributed_256": dist_launches,
             "distributed_2048": dist_large_launches,
             "cli_zarr_256": cli_zarr_launches,
             "config4_512": config4_launches}
    by_rank = {"distributed_256": dist_by_rank,
               "distributed_2048": dist_large_by_rank,
               "config4_512": config4_by_rank}
    # the new paths' own numbers, under their path's name
    ext.update({f"orlanski_256_{k}": v for k, v in orl_k["extloop"].items()})
    ext.update({f"basin_512_{k}": v for k, v in basin_k["extloop"].items()})
    win.update({f"basin_512_{k}": v for k, v in basin_k["extwin"].items()})
    for p in ("tke", "tracer"):
        phs[p].update({f"orlanski_256_{k}": v for k, v in orl_k[p].items()})
    by_path = lambda k: {p: c[k] for p, c in paths.items()}
    ranks = lambda k: {p: c[k] for p, c in by_rank.items()}
    mesh_k["extwin_chunk"] = win_chunk
    for k in ("extchunk", "extwin_chunk"):
        mesh_k[k].update({f"basin_512_block_{f}": v
                          for f, v in basin_k[k].items()})
    for p, (ms, bound) in large_mesh_tiled.items():
        key = p if p == "extwin_chunk" else f"phase_{p}_mesh"
        mesh_k[key].update(large_2048_ms_per_step=ms,
                           large_2048_bound_ms_per_step=bound)

    kernels_line = {"kernels": [
        dict(name="tridiag", route="cuda",
             source="extpom_tpu_torch/csrc/tridiag.cu",
             replaces="extpom_tpu/pallas/tridiag.py:77",
             launches=launches["tridiag"], on_main_path=False,
             launches_by_path=by_path("tridiag"),
             launches_by_rank=ranks("tridiag"), library_ms=None, **tri),
        dict(name="extloop", route="cuda",
             source="extpom_tpu_torch/csrc/extloop.cu",
             replaces="extpom_tpu/pallas/extloop.py:243",
             launches=launches["extloop"],
             launches_by_path=by_path("extloop"),
             launches_by_rank=ranks("extloop"), library_ms=None, **ext),
        dict(name="extwin", route="cuda",
             source="extpom_tpu_torch/csrc/extwin.cu",
             replaces="extpom_tpu/pallas/extwin.py:112",
             launches=large_launches["extwin"],
             launches_by_path=by_path("extwin"),
             launches_by_rank=ranks("extwin"), library_ms=None, **win),
    ] + [
        dict(name=f"phase_{p}", route="cuda",
             source=f"extpom_tpu_torch/csrc/phase_{p}.cu",
             replaces="extpom_tpu/pallas/phases.py:315",
             launches=launches[f"phase_{p}"],
             launches_by_path=by_path(f"phase_{p}"),
             launches_by_rank=ranks(f"phase_{p}"), library_ms=None,
             **phs[p])
        for p in PHASES] + [
        dict(name="extchunk", route="cuda",
             source="extpom_tpu_torch/csrc/extloop.cu",
             replaces="extpom_tpu/pallas/extloop.py:137",
             launches=mesh_launches["extchunk"],
             launches_by_path=by_path("extchunk"),
             launches_by_rank=ranks("extchunk"), library_ms=None,
             **mesh_k["extchunk"]),
        dict(name="extwin_chunk", route="cuda",
             source="extpom_tpu_torch/csrc/extwin.cu",
             replaces="extpom_tpu/pallas/extwin.py:112",
             launches=large_mesh_launches["extwin_chunk"],
             launches_by_path=by_path("extwin_chunk"),
             launches_by_rank=ranks("extwin_chunk"), library_ms=None,
             **mesh_k["extwin_chunk"]),
    ] + [
        dict(name=f"phase_{p}_mesh", route="cuda",
             source=f"extpom_tpu_torch/csrc/phase_{p}.cu",
             replaces="extpom_tpu/pallas/phases.py:315",
             launches=mesh_launches[f"phase_{p}_mesh"],
             launches_by_path=by_path(f"phase_{p}_mesh"),
             launches_by_rank=ranks(f"phase_{p}_mesh"), library_ms=None,
             **mesh_k[f"phase_{p}_mesh"])
        for p in PHASES] + [
        dict(name="forcing", route="cuda",
             source="extpom_tpu_torch/csrc/forcing.cu",
             replaces="extpom_tpu/forcing/device.py:139",
             launches=channel_launches["forcing"], on_main_path=False,
             launches_by_path=by_path("forcing"),
             launches_by_rank=ranks("forcing"), library_ms=None, **frc)]}
    # the option instantiations of lat, tracer and mom and MPDATA's
    # launches, each counted under its own name (phases.counter); the
    # tracer's is timed on [options] (with MPDATA's launches) and on
    # [file_restore] (restoring), under that path's name
    opt_k["tracer"].update({f"file_restore_512_{k}": v
                            for k, v in fr_k["tracer"].items()})
    option_kernels = (
        ("phase_lat_npg2", "lat", "options_256", opt_k["lat"],
         "extpom_tpu/pallas/phases.py:803"),
        ("phase_tracer_options", "tracer", "options_256", opt_k["tracer"],
         "extpom_tpu/pallas/phases.py:771"),
        ("phase_tracer_mpdata", "mpdata", "options_256", opt_k["mpdata"],
         "extpom_tpu/pallas/phases.py:771"),
        ("phase_mom_file", "mom", "file_restore_512", fr_k["mom"],
         "extpom_tpu/pallas/phases.py:823"),
        ("phase_lat_npg2_mesh", "lat", "options_mesh_256", opt_mesh_k["lat"],
         "extpom_tpu/pallas/phases.py:904"),
        ("phase_tracer_options_mesh", "tracer", "options_mesh_256",
         opt_mesh_k["tracer"], "extpom_tpu/pallas/phases.py:904"),
        ("phase_tracer_mpdata_mesh", "mpdata", "options_mesh_256",
         opt_mesh_k["mpdata"], "extpom_tpu/pallas/phases.py:904"),
        ("phase_mom_file_mesh", "mom", "file_restore_mesh_512",
         frm_k["mom"], "extpom_tpu/pallas/phases.py:904"))
    for name, p, path, entry, replaces in option_kernels:
        kernels_line["kernels"].append(dict(
            name=name, route="cuda",
            source=f"extpom_tpu_torch/csrc/phase_{p}.cu",
            replaces=replaces, launches=paths[path][name],
            launches_by_path=by_path(name),
            launches_by_rank=ranks(name), library_ms=None, **entry))
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(json.loads(sys.argv[2])))
    sys.exit(main())
