"""Time the external loop ``csrc/extloop.cu`` on the card, split its
device time by kernel, and measure the grid-barrier floor.

    python -m extpom_tpu_torch.tools.extloop_sweep [--grid 256] [--reps 20]
        [--dtypes float32,float64] [--threads 192,512] [--floor] [--graph]
        [--tree PATH] [--no-check]

Times one call of the whole-grid loop (``isplit`` substeps) on the
external-loop operands of the third step of a GRID x GRID x 5 seamount run,
and of ``extchunk`` on the first chunk of block (0, 1) of the same run
decomposed 2x4 (a 188x124 block at 256x256): the device time after a ~1 ms
spin and a 64 MB L2 flush, the host time to issue one call, and each
kernel's device time from the profiler, so that the device time of the
call less the kernels' sum is the time between launches.  Each line of the
persistent kernel also carries its registers, blocks per SM, threads and
grid, and the barrier floor on that grid (an empty persistent kernel that
passes the same barriers) with cooperative_groups' grid sync and with the
hand-written barrier.  Every result must equal the plain loop's bit for
bit, unless ``--no-check`` (a source variant that skips work).

``--threads`` times the kernel at each block size given instead of the
planned one; ``--graph`` captures one call in a CUDA graph and holds the
replay to the eager call; ``--floor`` times the floor alone over 0, 60 and
90 barriers (2 and 3 per substep of a 30-substep loop) on grids of 128 to
1024 threads and up to 1056 blocks.  ``--tree PATH`` imports the port from
the checkout at PATH instead (a parent commit, whose chain it times), for a
comparison within one call.  Prints the card's name and power limit last.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

FLOOR_THREADS = (128, 256, 512, 1024)
FLOOR_BLOCKS = (64, 128, 132, 256, 264, 528, 1056)
FLOOR_BARRIERS = (0, 60, 90)


def operands(n: int, device="cuda"):
    """(grid, cfg, carry, forcing, aux) of the third step of an n x n x 5
    float32 seamount run on ``device``, the arguments of block (0, 1)'s first
    ``run_external_chunk`` call in the same step decomposed 2x4, and that
    run's Blocks."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    from extpom_tpu_torch.core import stepper
    from extpom_tpu_torch.kernels import extloop, phases
    from extpom_tpu_torch.mesh.shardmap import Mesh
    m = seamount_model(im=n, jm=n, kb=5, device=device)
    m.run_segment(2)
    g, cfg, st = m.grid, m.cfg, m.state
    fc = m.base_forcing.replace(ramp=torch.tensor(
        stepper.ramp_at(cfg, 3, m.period), dtype=st.dtype, device=device))
    lat = phases.phase_lat(g, cfg, st.u, st.v, st.ub, st.vb, st.aam, st.rho,
                           m.rmean, g.h + st.et, g.h + st.el, fc.ramp)
    out = stepper.mode_interaction(g, cfg, st, *lat)
    c0 = stepper.ExtCarry(st.el, st.elb, st.ua, st.uab, st.va, st.vab,
                          st.etf, out[9], out[10], out[11], out[5], out[6],
                          out[7], out[8])
    whole = (g, cfg, c0, fc, tuple(out[:5]))

    d = seamount_model(im=n, jm=n, kb=5, device=device).shard(
        Mesh(2, 4, device=device))
    d.run_segment(2)
    kept = []
    orig = extloop.run_external_chunk

    def keep(*a, **k):
        off, shape = a[7], a[2].el.shape
        ring = ((shape[0] - d.blocks.ni) // 2, (shape[1] - d.blocks.nj) // 2)
        if a[6] == 1 and (off[0] + ring[0], off[1] + ring[1]) == (
                0, d.blocks.nj):
            kept.append(a)
        return orig(*a, **k)

    extloop.run_external_chunk = keep
    try:
        d.run_segment(1)
    finally:
        extloop.run_external_chunk = orig
    if not kept:
        raise RuntimeError("extloop_sweep: the decomposed run launched no "
                           "extchunk")
    return whole, kept[0], d.blocks


def cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype).contiguous() if x.is_floating_point() else x
    if isinstance(x, tuple):
        return type(x)(*(cast(y, dtype) for y in x)) if hasattr(
            x, "_fields") else tuple(cast(y, dtype) for y in x)
    if hasattr(x, "isplit"):
        return x.replace(dtype=str(dtype)[6:])
    if hasattr(x, "__dataclass_fields__"):
        return x.__class__(**{k: cast(v, dtype) for k, v in vars(x).items()})
    return x


class Flush:
    """A ~1 ms spin that hides the host's enqueue, then a 64 MB write that
    flushes the L2."""

    def __init__(self):
        self.buf = torch.empty(16 * 2 ** 20, dtype=torch.float32,
                               device="cuda")

    def __call__(self):
        torch.cuda._sleep(2_000_000)
        self.buf.zero_()


def device_ms(fn, reps: int, flush: Flush) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around each call,
    after ``flush``."""
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
    """Mean host time in ms to issue one call of ``fn`` (checks, planning,
    allocations, launches) while a ~4 ms spin keeps the card busy."""
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


def kernel_split(fn, reps: int, flush: Flush) -> dict:
    """{kernel name: (ms per call, launches per call)} of ``fn`` from the
    profiler, each call after ``flush`` (whose kernels are left out); empty
    where the profiler records no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0
                or "spin" in e.key or "Fill" in e.key):
            continue
        out[e.key] = (e.self_device_time_total / 1e3 / reps, e.count / reps)
    return out


def short(name: str) -> str:
    """A kernel's name without its namespace and template arguments."""
    return name.split("<")[0].split("::")[-1]


def time_loop(tag: str, dname: str, where: str, run, plain, reps: int,
              flush: Flush, trim=lambda x: x, check: bool = True) -> None:
    got, want = run(), plain()
    equal = all(torch.equal(trim(a), trim(b)) for a, b in zip(got, want))
    if check and not equal:
        raise AssertionError(f"extloop_sweep: {tag} {dname} is not "
                             f"bit-equal to the plain loop")
    ms = device_ms(run, reps, flush)
    issue = host_ms(run, reps)
    split = kernel_split(run, reps, flush)
    head = (f"[extloop_sweep] {where} path={tag} dtype={dname} "
            f"ms={ms:.4f} host_ms={issue:.4f}")
    if not split:
        print(f"{head} kernels_ms=not_measured bit_equal={equal}", flush=True)
        return
    busy = sum(t for t, _ in split.values())
    parts = " ".join(f"{short(k)}={t:.4f}ms/{c:g}"
                     for k, (t, c) in sorted(split.items()))
    print(f"{head} kernels_ms={busy:.4f} between_ms={ms - busy:.4f} "
          f"launches={sum(c for _, c in split.values()):g} {parts} "
          f"bit_equal={equal}", flush=True)


def floor_sweep(reps: int, flush: Flush) -> None:
    from extpom_tpu_torch.kernels import extloop
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    for threads in FLOOR_THREADS:
        for blocks in FLOOR_BLOCKS:
            if blocks * threads > 2048 * 132:
                continue
            for n in FLOOR_BARRIERS:
                row = []
                for sync, ctr in (("cg", None), ("hand", counter)):
                    ms = device_ms(lambda: extloop.barrier_floor(
                        "cuda", threads, blocks, n, ctr), reps, flush)
                    row.append(f"{sync}_ms={ms:.4f}" + (
                        f" {sync}_us_per_barrier={ms / n * 1e3:.3f}"
                        if n else ""))
                print(f"[barrier_floor] threads={threads} blocks={blocks} "
                      f"barriers={n} " + " ".join(row), flush=True)


def own_floor(extloop, dtype, cells: int, block: bool, nsub: int,
              threads, reps: int, flush: Flush) -> str:
    """What the card gives the kernel at its launch over ``cells`` cells
    (``threads`` per block, or the planned ones), and the barrier floor on
    that grid: ``nsub`` substeps' worth of barriers with
    cooperative_groups' grid sync and with the hand-written barrier."""
    threads, blocks = extloop.plan_grid(dtype, cells, block, threads=threads)
    info = extloop.loop_info(dtype, block, threads)
    n = extloop.BARRIERS * nsub
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    cg = device_ms(lambda: extloop.barrier_floor("cuda", threads, blocks, n),
                   reps, flush)
    hand = device_ms(lambda: extloop.barrier_floor("cuda", threads, blocks, n,
                                                   counter), reps, flush)
    return (f"registers={info['registers']} "
            f"spill_bytes={info['spill_bytes']} "
            f"blocks_per_sm={info['blocks_per_sm']} threads={threads} "
            f"blocks={blocks} barriers={n} floor_cg_ms={cg:.4f} "
            f"floor_hand_ms={hand:.4f}")


def graph_check(tag: str, dname: str, run, reps: int, flush: Flush) -> None:
    """Whether one call captures in a CUDA graph and its replay gives the
    eager call's bits, and the replay's time."""
    want = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = run()
    except RuntimeError as e:
        print(f"[graph] path={tag} dtype={dname} captured=False "
              f"error='{str(e).splitlines()[0]}'", flush=True)
        return
    graph.replay()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(out, want))
    ms = device_ms(graph.replay, reps, flush)
    print(f"[graph] path={tag} dtype={dname} captured=True "
          f"replay_equal={equal} replay_ms={ms:.4f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--tree", default=None)
    ap.add_argument("--floor", action="store_true")
    ap.add_argument("--threads", default="",
                    help="threads per block to sweep, e.g. 192,256,512 "
                    "(default: the planned ones)")
    ap.add_argument("--graph", action="store_true",
                    help="capture one call in a CUDA graph and replay it")
    ap.add_argument("--no-check", action="store_true",
                    help="time a tree whose loop is not bit-equal to the "
                    "plain one (a source variant that skips work)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("extloop_sweep: no CUDA device")
    if args.tree:   # the port of that checkout, not this one
        for name in [k for k in sys.modules
                     if k.split(".")[0] == "extpom_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, args.tree)
    from extpom_tpu_torch.kernels import extloop
    where = f"tree={args.tree}" if args.tree else "tree=."
    persistent = hasattr(extloop, "plan_grid")   # a parent has the chain
    sweep = [int(t) for t in args.threads.split(",") if t] or [None]
    flush = Flush()
    whole, chunk, blocks = operands(args.grid)
    trim = lambda x: blocks.trim(x, ((x.shape[0] - blocks.ni) // 2,
                                     (x.shape[1] - blocks.nj) // 2))
    for dname in args.dtypes.split(","):
        dtype = getattr(torch, dname)
        w = cast(whole, dtype)
        a = cast(chunk, dtype)
        shape = "x".join(map(str, a[2].el.shape))
        kw = lambda t: {"threads": t} if persistent else {}
        paths = ((f"whole_{args.grid}",
                  lambda t: extloop.run_external_loop(*w, **kw(t)),
                  lambda: extloop.run_external_loop_plain(*w),
                  lambda x: x, w[2].el.numel(), False, w[1].isplit),
                 (f"block_{shape}",
                  lambda t: extloop.run_external_chunk(*a, **kw(t)),
                  lambda: extloop.run_external_chunk_plain(*a), trim,
                  a[2].el.numel(), True, a[5]))
        for t in sweep if persistent else [None]:
            for tag, run, plain, tr, cells, block, nsub in paths:
                here = where
                if persistent:
                    here += " " + own_floor(extloop, dtype, cells, block,
                                            nsub, t, args.reps, flush)
                time_loop(tag, dname, here, lambda: run(t), plain, args.reps,
                          flush, tr, not args.no_check)
        if args.graph and persistent:
            for tag, run, *_ in paths:
                graph_check(tag, dname, lambda: run(None), args.reps, flush)
    if args.floor:
        floor_sweep(args.reps, flush)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
