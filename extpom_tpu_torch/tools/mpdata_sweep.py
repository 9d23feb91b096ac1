"""Sweep the tiles of MPDATA's kernel on the card.

    python -m extpom_tpu_torch.tools.mpdata_sweep [--grid 256] [--kb 31]
        [--nitera 2] [--reps 20] [--dtypes float32,float64] [--tree PATH]

Times one call of ``kernels/phases.py:mpdata`` (``csrc/phase_mpdata.cu``)
for several threads per block and chunks of levels, on the operands of
the tracer phase of the third step of a GRID x GRID x KB float32 seamount
under nadv=2 (cast for float64), and on those of block (0, 1) of the same
run on a 2x4 mesh.  Every geometry's result must equal ``mpdata_plain``'s
bit for bit.  Prints one line per geometry with the registers, shared
bytes and resident blocks per SM the card gives it, then the card's name
and power limit.

With ``--tree PATH`` it imports the port from the checkout at PATH instead
and times only its default launches (a parent commit whose MPDATA has no
plan), for a comparison within one call; run the file by its path for that
(``python extpom_tpu_torch/tools/mpdata_sweep.py --tree PATH``), so that
``-m`` has not imported this checkout's package first.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

# (threads per block, chunks of levels; None: the planner's)
GEOMETRIES = [(None, 1), (None, 2), (None, 3), (None, 4), (None, 5),
              (512, None), (384, None), (256, None)]
SPIN_CYCLES = 2_000_000


def operands(n: int, kb: int, nitera: int) -> tuple:
    """((grid, cfg, MPDATA's operands), the same on block (0, 1) with its
    offset) of the tracer phase in the third step of an n x n x kb float32
    seamount under nadv=2 on the card, on one device and on a 2x4 mesh."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.kernels import phases
    from extpom_tpu_torch.mesh.shardmap import Mesh
    kw = dict(im=n, jm=n, kb=kb, npg=2, nadv=2, nitera=nitera, sw=0.5)
    out = []
    for mesh in (None, Mesh(2, 4)):
        m = seamount_model(**kw)
        if mesh is not None:
            m.shard(mesh)
        m.run_segment(2)
        calls = []
        saved = phases.phase_tracer

        def spy(*a, **k):
            calls.append((a, k))
            return saved(*a, **k)
        phases.phase_tracer = spy
        try:
            m.run_segment(1)
        finally:
            phases.phase_tracer = saved
        ring = m.cfg.phase_halo
        for a, k in calls:
            off = k.get("off")
            if mesh is None or off == (-ring, n // mesh.py - ring):
                g, cfg, t, tb, s, sb, _, _, u, v, w, _, _, dt, etb, etf = \
                    a[:16]
                out.append((g, cfg, (t, tb, s, sb, u, v, w, dt, etb, etf),
                            off))
                break
    return out


def cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    return x.__class__(**{k: cast(v, dtype) for k, v in vars(x).items()})


def device_ms(fn, reps: int, flush) -> float:
    """Mean device time of one call in ms (CUDA events, a spin and a 64 MB
    L2 flush ahead of each call)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--kb", type=int, default=31)
    ap.add_argument("--nitera", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mpdata_sweep: no CUDA device", file=sys.stderr)
        return 1
    if args.tree:   # the port of that checkout, not this one
        sys.path.insert(0, args.tree)
    from extpom_tpu_torch.kernels import build, phases
    from extpom_tpu_torch.ops.stencil import domain_of
    where = f"tree={args.tree}" if args.tree else "tree=."
    build.library()
    flush = torch.empty(64 * 2 ** 20 // 4, device="cuda")
    cases = operands(args.grid, args.kb, args.nitera)
    for dtype in [getattr(torch, d) for d in args.dtypes.split(",")]:
        for (g, cfg, ops, off), where_ in zip(cases, ("grid", "block")):
            g = cast(g, dtype)
            cfg = cfg.replace(dtype=str(dtype).split(".")[1])
            ops = [x.to(dtype) for x in ops]
            with domain_of(cfg, off):
                want = phases.mpdata_plain(g, cfg, *ops)
            if not hasattr(phases, "mpdata_plan"):
                run = lambda: phases.mpdata(g, cfg, *ops, off=off)
                assert all(torch.equal(a, b) for a, b in zip(run(), want))
                print(f"[mpdata_sweep] {where} on={where_} "
                      f"shape={tuple(ops[0].shape)} dtype={dtype} "
                      f"nitera={cfg.nitera} default "
                      f"ms={device_ms(run, args.reps, flush):.5f}",
                      flush=True)
                continue
            for k, (threads, chunks) in enumerate([(None, None)]
                                                  + GEOMETRIES):
                try:
                    plan = (phases.mpdata_launch_plan(cfg, ops[0],
                                                      off is not None)
                            if k == 0 else
                            phases.mpdata_plan(cfg.nitera, dtype,
                                               *ops[0].shape, threads,
                                               chunks))
                except ValueError:
                    continue
                info = phases.mpdata_info(dtype, plan, off is not None)
                if info["blocks_per_sm"] < 1:
                    continue
                run = lambda: phases.mpdata(g, cfg, *ops, off=off,
                                            plan=plan)
                equal = all(torch.equal(a, b) for a, b in zip(run(), want))
                if not equal:
                    raise AssertionError(f"mpdata_sweep: {plan} differs "
                                         f"from mpdata_plain")
                ms = device_ms(run, args.reps, flush)
                print(f"[mpdata_sweep] {where} on={where_} "
                      f"shape={tuple(ops[0].shape)} dtype={dtype} "
                      f"nitera={cfg.nitera} "
                      f"{'default' if k == 0 else 'tile'}="
                      f"{plan.ti}x{plan.tj} threads={plan.threads} "
                      f"groups={','.join(map(str, plan.groups))} "
                      f"halo={plan.halos[0]} chunks={plan.chunks} "
                      f"blocks={plan.blocks} "
                      f"registers={info['registers']} "
                      f"dynamic_smem={info['dynamic_smem']} "
                      f"blocks_per_sm={info['blocks_per_sm']} "
                      f"spill_bytes={info['spill_bytes']} ms={ms:.5f} "
                      f"bit_equal={equal}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"[mpdata_sweep] card='{card}'", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
