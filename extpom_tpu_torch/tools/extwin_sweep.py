"""Sweep the window kernel's geometry on the card.

    python -m extpom_tpu_torch.tools.extwin_sweep [--grid 2048] [--reps 3]
        [--dtypes float32,float64] [--no-block]

Times one external loop (``isplit`` substeps) of ``csrc/extwin.cu`` for each
C (substeps per launch), tile and block size, on the external-loop operands
of the third step of a seamount run of GRID x GRID x 5 cells, beside the
whole-grid chain ``csrc/extloop.cu`` on the same operands; then the block
variant (``extwin_chunk``) on the first chunk of block (0, 1) of the same
run decomposed 2x4 (a 1084x572 block at 2048x2048), beside ``extchunk``.
Every geometry's result must equal the chain's bit for bit (on a block: on
the block's own cells).  Prints one line per geometry with the registers
and resident blocks per SM the card gives it, then the fastest per dtype
and path, and the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import itertools
import subprocess

import torch

from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.core import stepper
from extpom_tpu_torch.kernels import extloop, extwin, phases
from extpom_tpu_torch.mesh.shardmap import Mesh

TILES = [(8, 32), (16, 32), (32, 32), (8, 64), (16, 64), (32, 64)]
CS = (1, 2, 3, 5)
THREADS = (256, 512)


def operands(n: int):
    """(grid, cfg, carry, forcing, aux) of the third step of an n x n x 5
    float32 seamount run on the card."""
    m = seamount_model(im=n, jm=n, kb=5)
    m.run_segment(2)
    g, cfg, st = m.grid, m.cfg, m.state
    fc = m.base_forcing.replace(ramp=torch.tensor(
        stepper.ramp_at(cfg, 3, m.period), dtype=st.dtype, device="cuda"))
    lat = phases.phase_lat(g, cfg, st.u, st.v, st.ub, st.vb, st.aam, st.rho,
                           m.rmean, g.h + st.et, g.h + st.el, fc.ramp)
    out = stepper.mode_interaction(g, cfg, st, *lat)
    c0 = stepper.ExtCarry(st.el, st.elb, st.ua, st.uab, st.va, st.vab,
                          st.etf, out[9], out[10], out[11], out[5], out[6],
                          out[7], out[8])
    return g, cfg, c0, fc, tuple(out[:5])


def block_operands(n: int):
    """(Blocks, the arguments of ``run_external_chunk_windowed``) of block
    (0, 1)'s first chunk in the third step of an n x n x 5 float32
    seamount run decomposed 2x4 on the card."""
    m = seamount_model(im=n, jm=n, kb=5).shard(Mesh(2, 4))
    m.run_segment(2)
    kept = []
    orig = extwin.run_external_chunk_windowed

    def keep(*a, **k):
        off, shape = a[7], a[2].el.shape
        ring = ((shape[0] - m.blocks.ni) // 2, (shape[1] - m.blocks.nj) // 2)
        if a[6] == 1 and (off[0] + ring[0], off[1] + ring[1]) == (
                0, m.blocks.nj):
            kept.append(a)
        return orig(*a, **k)

    extwin.run_external_chunk_windowed = keep
    try:
        m.run_segment(1)
    finally:
        extwin.run_external_chunk_windowed = orig
    if not kept:
        raise RuntimeError("extwin_sweep: the decomposed run launched no "
                           "window chunk")
    return m.blocks, kept[0]


def cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype).contiguous()
    if isinstance(x, tuple):
        return type(x)(*(cast(y, dtype) for y in x)) if hasattr(
            x, "_fields") else tuple(cast(y, dtype) for y in x)
    if hasattr(x, "__dataclass_fields__") and not hasattr(x, "isplit"):
        return x.__class__(**{k: cast(v, dtype) for k, v in vars(x).items()})
    return x


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


def sweep(tag: str, dtype, n_substeps: int, run, yardstick, equal,
          reps: int) -> None:
    """Time ``run(geo)`` for every geometry that fits ``n_substeps``, after
    holding it bit-equal to ``yardstick()`` with ``equal``."""
    item = torch.finfo(dtype).bits // 8
    want = yardstick()
    print(f"[sweep] {tag} dtype={dtype} chain_ms="
          f"{device_ms(yardstick, reps):.4f}", flush=True)
    rows = []
    for C, (ti, tj), threads in itertools.product(CS, TILES, THREADS):
        if n_substeps % C:
            continue
        try:
            geo = extwin.geometry(C, ti, tj, threads, item)
        except ValueError:
            continue
        info = extwin.window_info(dtype, geo, block=tag == "block")
        if info["blocks_per_sm"] < 1:
            continue
        if not equal(run(geo), want):
            raise AssertionError(f"extwin {tag} {geo} differs from the chain")
        ms = device_ms(lambda: run(geo), reps)
        rows.append((ms, geo))
        print(f"[sweep] {tag} dtype={dtype} C={C} H={geo.H} tile={ti}x{tj} "
              f"threads={threads} smem_bytes={geo.smem} "
              f"registers={info['registers']} "
              f"spill_bytes={info['spill_bytes']} "
              f"blocks_per_sm={info['blocks_per_sm']} ms={ms:.4f} "
              f"equal_to_chain=True", flush=True)
    for ms, geo in sorted(rows, key=lambda r: r[0])[:5]:
        print(f"[sweep] fastest {tag} dtype={dtype} ms={ms:.4f} {geo}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--no-block", action="store_true",
                    help="sweep the whole grid only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("extwin_sweep: no CUDA device")
    dtypes = [getattr(torch, d) for d in args.dtypes.split(",")]
    base = operands(args.grid)
    same = lambda got, want: all(torch.equal(a, b) for a, b in zip(got, want))
    for dtype in dtypes:
        g, cfg, c0, fc, aux = cast(base, dtype)
        cfg = cfg.replace(dtype=str(dtype)[6:])
        sweep("whole", dtype, cfg.isplit,
              lambda geo: extwin.run_external_loop_windowed(
                  g, cfg, c0, fc, aux, geo=geo),
              lambda: extloop.run_external_loop(g, cfg, c0, fc, aux), same,
              args.reps)
    del base, g, c0, fc, aux
    if not args.no_block:
        blocks, chunk = block_operands(args.grid)
        trim = lambda x: blocks.trim(x, ((x.shape[0] - blocks.ni) // 2,
                                         (x.shape[1] - blocks.nj) // 2))
        trimmed = lambda got, want: all(torch.equal(trim(a), trim(b))
                                        for a, b in zip(got, want))
        for dtype in dtypes:
            a = list(cast(tuple(chunk), dtype))
            a[1] = a[1].replace(dtype=str(dtype)[6:])
            print(f"[sweep] block {tuple(a[2].el.shape)} off={a[7]} "
                  f"C={a[5]}", flush=True)
            sweep("block", dtype, a[5],
                  lambda geo: extwin.run_external_chunk_windowed(*a,
                                                                 geo=geo),
                  lambda: extloop.run_external_chunk(*a), trimmed,
                  args.reps)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
