"""Time the Thomas kernel ``csrc/tridiag.cu`` on the card.

    python -m extpom_tpu_torch.tools.tridiag_sweep [--shapes 31x256x256,...]
        [--reps 10] [--dtypes float32,float64] [--tree PATH]

Times one call of ``kernels.tridiag.thomas`` (the proft/profu variant,
k0 = 1, k_last = kb - 2) on seeded operands of each KBxIMxJM shape, with the
2-D operands as (im, jm) arrays and, as profq passes some of them, with cl,
db and mask as 0-d scalars: the device time after a ~1 ms spin and a 64 MB
L2 flush, the wall time of the call (host work included) and the host time
to issue it while the card is busy.  Each result must equal
``thomas_plain``'s bit for bit.  Prints one line per shape, dtype and form
with the bound (the operands read once as the caller keeps them and the
output written once, over 3.35 TB/s), then the card's name and power limit.

With ``--tree PATH`` it imports the port from the checkout at PATH instead
(a parent commit), for a comparison within one call.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

SHAPES = "31x256x256,41x256x256,41x2048x2048"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)


def operands(kb: int, im: int, jm: int, dtype, scalar: bool) -> list:
    """The ten operands of the solve from a seeded generator on the card:
    diagonally dominant coefficients; cl, db and mask as 0-d tensors when
    ``scalar``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    r = lambda shape, s, o: o + s * torch.rand(shape, generator=gen,
                                               device="cuda", dtype=dtype)
    r3 = lambda s=1.0, o=0.0: r((kb, im, jm), s, o)
    r2 = lambda s=1.0, o=0.0: r((im, jm), s, o)
    a, c = -r3(0.5, 0.1), -r3(0.5, 0.1)
    den, rhs = r3(0.2, 1.0), r3(2.0, -1.0)
    ee0, gg0, rb = r2(0.5), r2(1.0), r2(1.0)
    if scalar:
        cl, db, mask = (torch.tensor(x, dtype=dtype, device="cuda")
                        for x in (0.0, 1.0, 1.0))
    else:
        cl, db, mask = a[kb - 2], r2(0.5, -1.5), (r2() > 0.3).to(dtype)
    return [a, c, den, rhs, ee0, gg0, cl, rb, db, mask]


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


def call_ms(fn, reps: int) -> float:
    """Mean time of one call in ms, host work included: CUDA events around
    the call, nothing queued ahead of it."""
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def host_ms(fn, reps: int) -> float:
    """Mean host time in ms to issue one call while a ~4 ms spin keeps the
    card busy."""
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
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tridiag_sweep: no CUDA device")
    if args.tree:   # the port of that checkout, not this one
        for name in [k for k in sys.modules
                     if k.split(".")[0] == "extpom_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, args.tree)
    from extpom_tpu_torch.kernels import tridiag
    where = f"tree={args.tree}" if args.tree else "tree=."
    for shape in args.shapes.split(","):
        kb, im, jm = (int(x) for x in shape.split("x"))
        for dname in args.dtypes.split(","):
            dtype = getattr(torch, dname)
            item = torch.finfo(dtype).bits // 8
            for scalar in (False, True):
                ops = operands(kb, im, jm, dtype, scalar)
                run = lambda: tridiag.thomas(*ops, 1, kb - 2)
                full = [x if i < 4 else torch.broadcast_to(x, (im, jm))
                        for i, x in enumerate(ops)]
                equal = torch.equal(run(), tridiag.thomas_plain(*full, 1,
                                                                kb - 2))
                if not equal:
                    raise AssertionError(f"tridiag {shape} {dname} "
                                         f"scalar={scalar}: not bit-equal")
                nbytes = (sum(x.numel() for x in ops) + kb * im * jm) * item
                print(f"[tridiag_sweep] {where} grid={shape} dtype={dname} "
                      f"scalar_2d={scalar} "
                      f"ms={device_ms(run, args.reps):.5f} "
                      f"call_ms={call_ms(run, args.reps):.5f} "
                      f"host_ms={host_ms(run, 20):.5f} "
                      f"bound_ms={nbytes / HBM_BYTES_PER_S * 1e3:.5f} "
                      f"bit_equal={equal}", flush=True)
                del ops, full
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
