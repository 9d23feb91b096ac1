"""One run of one cell:

    python3 -m pombench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds the cell's model on the card from
its configuration and the seed, warms up with one print segment, then
drives what the run driver (``extpom_tpu_torch/run.py:execute``) drives,
``Model.run_segment`` from print to print with ``Model.stats`` and
``Model.velocity_check`` at each print, until ``--seconds`` have passed, and
stops at the next print.  Then it checks what the window produced
(:mod:`pombench.check`) and prints the result as the last line of standard
output.  With ``--trace 1`` the window is the same, and after it
:data:`TRACED` more print segments run under torch.profiler (after one
that lets the profiler start up and is not read); the line then carries
the per-layer metrics.

It exits with another code than 0, and prints no result, where there is no
card or fewer than the cell asks for, and where JAX or the JAX package has
been loaded by the time the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from pombench.cells import ROOT  # noqa: E402

# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "extpom_tpu")
# the checkout's own build directories: the port builds its kernels under
# build/kernels, at a fixed path in the checkout
CACHES = {"TRITON_CACHE_DIR": ROOT / "build" / "triton",
          "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions"}
# print segments a --trace 1 run reads from the profile
TRACED = 2


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card(device) -> dict:
    import torch
    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1}
    try:
        out["power_limit_w"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i",
             str(device.index or 0)], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit_w"] = None
    return out


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def segment(m, n: int, failed: list, traced: bool) -> dict:
    """One print segment of ``n`` steps and the print's diagnostics, as the
    run driver makes them; appends whether the print failed (a velocity
    over the limit or anything not finite).  Returns the diagnostics."""
    from pombench.trace import span
    with span("segment", traced):
        m.run_segment(n)
    with span("diagnostics", traced):
        s = m.stats()
        vamax, _ = m.velocity_check()
    s["vamax"] = vamax
    failed.append(not (all(math.isfinite(v) for v in s.values())
                       and vamax <= m.cfg.vmaxl))
    return s


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t0: float = T0, log=None, control: bool = False,
             marks=None) -> dict:
    """Run ``cell`` once and return its result: the keys of the last line
    and the compared numbers (``checks``).  With ``control`` also the
    numbers that the control gives, the reference computed in the next
    precision below the configuration's in the program's place
    (``control``; :mod:`pombench.control`)."""
    import torch
    from pombench import check, inputs, program
    from pombench import trace as tr
    from pombench.metrics import reader
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cuda = device.type == "cuda"

    marks = list(marks or []) + [("imports", time.perf_counter())]
    program.load()
    marks.append(("port", time.perf_counter()))
    inp = inputs.make(cell.config, cell.traffic, seed, device)
    sync(device)
    marks.append(("inputs", time.perf_counter()))
    m = program.build(inp, device)
    inp.tb = inp.sb = None                  # the model holds its own
    sync(device)
    marks.append(("model", time.perf_counter()))
    rows = check.start_rows(m.cfg.im)
    c0 = time.perf_counter()
    prog0 = check.start_slabs(program.state_fields(m), rows)
    check_s = time.perf_counter() - c0
    n = m.cfg.iprint
    warm = []
    segment(m, n, warm, False)
    sync(device)
    marks.append(("warm-up", time.perf_counter() - check_s))
    setup_s = marks[-1][1] - t0
    parts = ", ".join(f"{k} {b - a:.3f}" for (_, a), (k, b) in
                      zip([("", t0)] + marks, marks))
    log(f"setup {setup_s:.3f} s ({parts}): {m.cfg.im}x{m.cfg.jm}x{m.cfg.kb}"
        f" {m.cfg.dtype}, a print every {n} steps")

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    failed, seg_s = [], []
    sync(device)
    w0 = time.perf_counter()
    while not failed or time.perf_counter() - w0 < seconds:
        s0 = time.perf_counter()
        stats = segment(m, n, failed, False)
        seg_s.append(time.perf_counter() - s0)
    sync(device)
    window_s = time.perf_counter() - w0
    steps = n * len(failed)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    log(f"window {window_s:.3f} s: {steps} steps in {len(failed)} prints, "
        f"{sum(failed)} failed; each print's seconds "
        + " ".join(f"{x:.4f}" for x in seg_s))
    if traced:
        with tr.profiling(cuda) as prof:
            # the profiler's start-up falls in this segment, which is not
            # read
            stats = segment(m, n, failed, False)
            sync(device)
            with tr.span("window", True):
                p0 = time.perf_counter()
                for _ in range(TRACED):
                    stats = segment(m, n, failed, True)
                sync(device)
                trace_s = time.perf_counter() - p0
        found = sorted(set(found) | set(forbidden_modules()))

    result = {"attempted": len(failed), "failed": sum(failed)}
    nl = {f: getattr(m.cfg, f) for f in m.cfg.__dataclass_fields__}
    if traced:
        trace = tr.read(prof, trace_s, n * TRACED, nl,
                        step_s=window_s / steps)
        del prof
        metrics = {}
        for entry in cell.per_layer:
            v = reader(entry["name"]).read(trace)
            if v is not None:
                metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
        result["metrics"] = metrics
        dev_extra = {"busy_s": trace.busy_s(), "window_s": trace.window_s}
        result["breakdown"] = tr.breakdown(trace)
    else:
        points = m.cfg.im * m.cfg.jm * m.cfg.kb
        e2e = {"gpts_per_s": points * steps / window_s,
               "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        result["metrics"] = {e["name"]: {"value": e2e[e["name"]],
                                         "unit": e["unit"]}
                             for e in cell.end_to_end}
        dev_extra = {}
    result["device"] = {**card(device), "memory_peak_bytes": peak,
                        **dev_extra}

    # the check: one more step through the window's call, from the state
    # the window ended in; then the program is freed and the reference runs
    c0 = time.perf_counter()
    iint = m.iint
    before = program.state_fields(m)
    m.run_segment(1)
    after = program.to_host({k: getattr(m.state, k)
                             for k in check.STEP_FIELDS})
    del m
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    inp = inputs.make(cell.config, cell.traffic, seed, device)
    dtype = check.dtype_of(cell.config)
    want = check.reference_side(inp, device, dtype, before, iint)
    fields = check.field_gaps(before, after, want[2])
    numbers = check.numbers(prog0, want[0], stats, want[1], fields)
    if control:
        got = check.reference_side(inp, device, check.CONTROL[dtype], before,
                                   iint)
        result["control_fields"] = check.field_gaps(before, got[2], want[2])
        result["control"] = check.numbers(got[0], want[0], got[1], want[1],
                                          result["control_fields"])
        del got
    finite = all(bool(torch.isfinite(v).all()) for v in before.values())
    del before, after, inp, want
    result["correct"] = (finite and check.correct(numbers, cell.limits)
                         and result["failed"] == 0)
    result["checks"] = {k: [numbers[k], cell.limits[k]]
                        for k in check.NUMBERS}
    result["checks"]["state_finite"] = [int(finite), 1]
    result["fields"] = fields
    log("step gap of each field: " + ", ".join(
        f"{k} {v:.3g}" for k, v in sorted(fields.items(),
                                          key=lambda x: -x[1])))
    log(f"check {time.perf_counter() - c0:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated(device) / 1e9 if cuda else 0:.3f}"
        f" GB")
    result["forbidden"] = found
    return result


def line(result: dict) -> str:
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks")
    return json.dumps({k: result[k] for k in keys if k in result})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    for k, v in CACHES.items():
        os.environ.setdefault(k, str(v))
    from pombench.cells import resolve
    cell = resolve(a.workload)
    import torch
    marks = [("torch", time.perf_counter())]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    marks.append(("cuda", time.perf_counter()))
    if have < cell.chips:
        print(f"pombench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace),
                      torch.device("cuda", 0), marks=marks)
    if result["forbidden"]:
        print("pombench: loaded by the end of the window: "
              + ", ".join(result["forbidden"]), file=sys.stderr)
        return 3
    for k, (value, limit) in result["checks"].items():
        print(f"check {k} {value!r} limit {limit!r}", file=sys.stderr)
    print(line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
