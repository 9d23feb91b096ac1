"""Sweep the column tiles of the phase kernels on the card.

    python -m extpom_tpu_torch.tools.phase_sweep [--grid 2048] [--kb 41]
        [--reps 3] [--dtypes float32,float64] [--phases uvw,mom]
        [--tree PATH]

Times one call of ``csrc/phase_{lat,uvw,tke,tracer,mom}.cu`` for each tile
(TI x TJ) that fits a block, uvw's and mom's with and without their levels
kept in shared memory, on the phases' operands of the second step of a
seamount run of GRID x GRID x KB cells in float32 (cast for float64).  Every tile's
result must equal the default tile's bit for bit.  Prints one line per
geometry with the registers, shared bytes and resident blocks per SM the
card gives it, then the fastest per phase and dtype, and the card's name
and power limit.

With ``--tree PATH`` it imports the port from the checkout at PATH instead
and times only its default kernels (a parent commit whose kernel has no
tile), on the card and on the host (the time to issue one call while the card is busy),
for a comparison within one call.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
import sys
import time

import torch

TILES = [(1, 32), (2, 32), (4, 32), (8, 32), (1, 64), (2, 64), (4, 64),
         (1, 128), (2, 128), (1, 256)]
PHASES = ("lat", "uvw", "tke", "tracer", "mom")


def operands(n: int, kb: int) -> tuple:
    """(grid, cfg, {phase: arguments}) of the tiled phases in the second
    step of an n x n x kb float32 seamount run on the card."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.kernels import phases
    m = seamount_model(im=n, jm=n, kb=kb)
    m.run_segment(1)
    calls = {}
    saved = {p: getattr(phases, f"phase_{p}") for p in PHASES}

    def spy(p):
        def wrapper(*a, **k):
            calls[p] = a
            return saved[p](*a, **k)
        return wrapper

    try:
        for p in PHASES:
            setattr(phases, f"phase_{p}", spy(p))
        m.run_segment(1)
    finally:
        for p in PHASES:
            setattr(phases, f"phase_{p}", saved[p])
    g, cfg = calls["tke"][:2]
    return g, cfg, {p: calls[p][2:] for p in PHASES}


def cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype).contiguous()
    return x.__class__(**{k: cast(v, dtype) for k, v in vars(x).items()})


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around each call,
    after a ~1 ms spin that hides the host's enqueue and a 64 MB write that
    flushes the L2."""
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def host_ms(fn, reps: int) -> float:
    """Mean host time in ms to issue one call of ``fn`` (checks, planning,
    allocations, launch) while a ~4 ms spin keeps the card busy."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(8_000_000)
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / reps * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=2048)
    ap.add_argument("--kb", type=int, default=41)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_sweep: no CUDA device")
    if args.tree:   # the port of that checkout, not this one
        for name in [k for k in sys.modules
                     if k.split(".")[0] == "extpom_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, args.tree)
    from extpom_tpu_torch.kernels import phases
    where = f"tree={args.tree}" if args.tree else "tree=."
    g0, cfg0, ops = operands(args.grid, args.kb)
    grid_name = f"{args.grid}x{args.grid}x{args.kb}"
    for dname in args.dtypes.split(","):
        dtype = getattr(torch, dname)
        g = cast(g0, dtype)
        cfg = cfg0.replace(dtype=dname)
        for phase in args.phases.split(","):
            a = [cast(x, dtype) for x in ops[phase]]
            fn = getattr(phases, f"phase_{phase}")
            want = fn(g, cfg, *a)
            if args.tree:
                ms = device_ms(lambda: fn(g, cfg, *a), args.reps)
                issue = host_ms(lambda: fn(g, cfg, *a), 20)
                print(f"[phase_sweep] {where} grid={grid_name} "
                      f"dtype={dname} phase={phase} tile=default "
                      f"ms={ms:.4f} host_ms={issue:.4f}", flush=True)
                continue
            rows = []
            keeps = (False, True) if phase in ("uvw", "mom") else (None,)
            for (ti, tj), keep in itertools.product(TILES, keeps):
                try:
                    tile = phases.column_tile(cfg.kb, dtype, phase, ti, tj,
                                              keep)
                except ValueError:
                    continue
                info = phases.tile_info(phase, dtype, tile)
                if info["blocks_per_sm"] < 1:
                    continue
                run = lambda: fn(g, cfg, *a, tile=tile)
                equal = all(torch.equal(x, y) for x, y in zip(run(), want))
                if not equal:
                    raise AssertionError(f"phase_{phase} {tile} differs from "
                                         f"the default tile")
                ms = device_ms(run, args.reps)
                rows.append((ms, tile))
                print(f"[phase_sweep] {where} grid={grid_name} dtype={dname} "
                      f"phase={phase} tile={ti}x{tj} keep={tile.keep} "
                      f"smem_bytes={tile.smem} "
                      f"registers={info['registers']} "
                      f"spill_bytes={info['spill_bytes']} "
                      f"blocks_per_sm={info['blocks_per_sm']} "
                      f"ms={ms:.4f} equal_to_default={equal}", flush=True)
            for ms, tile in sorted(rows, key=lambda r: r[0])[:3]:
                print(f"[phase_sweep] fastest grid={grid_name} dtype={dname} "
                      f"phase={phase} ms={ms:.4f} {tile}", flush=True)
            del want
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
