"""Sweep the window kernel's geometry on the card.

    python -m extpom_tpu_torch.tools.extwin_sweep [--grid 2048] [--reps 3]

Times one external loop (``isplit`` substeps) of ``csrc/extwin.cu`` for each
C (substeps per launch), tile and block size, on the external-loop operands
of the third step of a seamount run of GRID x GRID x 5 cells, in float32 and
float64, beside the whole-grid chain ``csrc/extloop.cu`` on the same
operands.  Every geometry's result must equal the chain's bit for bit.
Prints one line per geometry, then the fastest per dtype, and the card's
name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import subprocess

import torch

from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.core import stepper
from extpom_tpu_torch.kernels import extloop, extwin, phases

TILES = [(8, 32), (16, 32), (32, 32), (8, 64), (16, 64), (32, 64)]


def operands(n: int):
    """(grid, cfg, carry, forcing, aux) of the third step of an n x n x 5
    float32 seamount run on the card."""
    m = seamount_model(im=n, jm=n, kb=5)
    m.run_segment(2)
    g, cfg, st = m.grid, m.cfg, m.state
    fc = m.base_forcing.replace(ramp=torch.tensor(
        stepper.ramp_at(cfg, 3, m.period), dtype=st.dtype, device="cuda"))
    lat = phases.phase_lat(g, cfg, st.u, st.v, st.ub, st.vb, st.aam, st.rho,
                           m.rmean, g.h + st.et, fc.ramp)
    out = stepper.mode_interaction(g, cfg, st, *lat)
    c0 = stepper.ExtCarry(st.el, st.elb, st.ua, st.uab, st.va, st.vab,
                          st.etf, out[9], out[10], out[11], out[5], out[6],
                          out[7], out[8])
    return g, cfg, c0, fc, tuple(out[:5])


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("extwin_sweep: no CUDA device")
    base = operands(args.grid)
    for dtype in (torch.float32, torch.float64):
        g, cfg, c0, fc, aux = (cast(base[0], dtype),
                               base[1].replace(dtype=str(dtype)[6:]),
                               stepper.ExtCarry(*(cast(x, dtype)
                                                  for x in base[2])),
                               cast(base[3], dtype),
                               tuple(cast(x, dtype) for x in base[4]))
        item = c0.el.element_size()
        chain = lambda: extloop.run_external_loop(g, cfg, c0, fc, aux)
        want = chain()
        print(f"[sweep] dtype={dtype} chain_ms="
              f"{device_ms(chain, args.reps):.3f}", flush=True)
        rows = []
        for C, (ti, tj), threads in itertools.product(
                (1, 2, 3, 5), TILES, (256, 512)):
            H = extwin.RADIUS * C
            smem = extwin.N_SHARED * (ti + 2 * H) * (tj + 2 * H) * item
            if cfg.isplit % C or smem > extwin.SMEM_BYTES:
                continue
            geo = extwin.Geometry(C, H, ti, tj, threads, smem)
            run = lambda: extwin.run_external_loop_windowed(g, cfg, c0, fc,
                                                            aux, geo=geo)
            equal = all(torch.equal(a, b) for a, b in zip(run(), want))
            if not equal:
                raise AssertionError(f"extwin {geo} differs from the chain")
            ms = device_ms(run, args.reps)
            rows.append((ms, geo))
            print(f"[sweep] dtype={dtype} C={C} H={H} tile={ti}x{tj} "
                  f"threads={threads} smem_bytes={smem} ms={ms:.3f} "
                  f"equal_to_chain={equal}", flush=True)
        for ms, geo in sorted(rows, key=lambda r: r[0])[:5]:
            print(f"[sweep] fastest dtype={dtype} ms={ms:.3f} {geo}",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
