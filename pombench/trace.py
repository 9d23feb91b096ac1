"""The traced window of a ``--trace 1`` run: torch.profiler over a few print
segments (the span ``pombench.window``), with the benchmark's own spans
around the calls into the port inside it (``pombench.segment``,
``pombench.diagnostics``).  The device's kernels, copies and fills and the
spans are read from the profile in memory; nothing is written to disk.
What the profiler records before the window span (its own start-up) is
left out.

:class:`Trace` is what a per-layer metric's reader (``metrics/<name>.py``)
reads: the device operations and spans of the traced window, its length on
the host's clock, its internal steps, the seconds a step took in the run's
untraced window and the run's namelist.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Optional

SPAN = "pombench."


@dataclasses.dataclass
class Op:
    name: str
    start_us: float
    end_us: float
    kernel: bool          # False for a copy or a fill


@dataclasses.dataclass
class Span:
    name: str             # without the "pombench." prefix
    start_us: float
    end_us: float
    device_us: float      # device time of the kernels launched inside it


@dataclasses.dataclass
class Trace:
    ops: list             # Op, in order of start
    spans: list           # Span
    window_s: float       # the traced window on the host's clock
    steps: int            # internal steps in the traced window
    namelist: dict        # the run's Config fields
    step_s: float         # seconds a step took in the untraced window

    def kernels(self, prefixes) -> list:
        """The kernels whose name contains one of ``prefixes``."""
        return [o for o in self.ops
                if o.kernel and any(p in o.name for p in prefixes)]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        the operations' intervals."""
        return sum(e - s for s, e in union(self.ops)) / 1e6

    def span_device_us(self, name: str) -> float:
        return sum(s.device_us for s in self.spans if s.name == name)


def union(ops) -> list:
    """The union of the operations' intervals, as sorted (start, end)."""
    out = []
    for o in sorted(ops, key=lambda o: o.start_us):
        if out and o.start_us <= out[-1][1]:
            out[-1][1] = max(out[-1][1], o.end_us)
        else:
            out.append([o.start_us, o.end_us])
    return out


@contextlib.contextmanager
def span(name: str, on: bool):
    """A profiler span ``pombench.<name>`` when ``on``."""
    if not on:
        yield
        return
    from torch.profiler import record_function
    with record_function(SPAN + name):
        yield


@contextlib.contextmanager
def profiling(cuda: bool):
    """torch.profiler over the block, with the device's activity where
    ``cuda``; yields the profile."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof


def read(prof, window_s: float, steps: int, namelist: dict,
         step_s: float) -> Trace:
    """The :class:`Trace` of a finished profile, from the profiler's raw
    events inside the span ``window``: a span's device time is that of the
    kernels whose launch on the host (matched by correlation id) fell
    inside it."""
    from torch.autograd import DeviceType
    t0 = prof.profiler.kineto_results.trace_start_ns()
    us = lambda ns: (ns - t0) / 1e3
    ops, raw_spans, launches, kernels = [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = us(e.start_ns()), us(e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(SPAN):        # a span's device-side copy
                continue
            copy = name.startswith(("Memcpy", "Memset"))
            ops.append(Op(name, start, end, not copy))
            kernels.append((e.correlation_id(), e.linked_correlation_id(),
                            end - start))
        elif name.startswith(SPAN):
            raw_spans.append((name[len(SPAN):], start, end))
        elif name.startswith("cu"):          # a runtime call: a launch
            launches[e.correlation_id()] = start
    w0, w1 = next((a, b) for n, a, b in raw_spans if n == "window")
    ops = sorted((o for o in ops if o.start_us >= w0 and o.end_us <= w1),
                 key=lambda o: o.start_us)
    spans = []
    for name, s0, s1 in raw_spans:
        dev = 0.0
        for corr, linked, dur in kernels:
            t = launches.get(corr, launches.get(linked))
            if t is not None and s0 <= t <= s1:
                dev += dur
        spans.append(Span(name, s0, s1, dev))
    return Trace(ops, spans, window_s, steps, namelist, step_s)


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the device, each named by the innermost span the host was in."""
    by_name = defaultdict(float)
    for o in tr.ops:
        by_name[o.name] += (o.end_us - o.start_us) / 1e6
    top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    busy = union(tr.ops)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:10]:
        out.append([host_span(tr.spans, 0.5 * (s + e)), (e - s) / 1e6])
    return {"device_ops": [[n, t] for n, t in top], "idle_gaps": out}


def host_span(spans, t_us: float) -> str:
    """The innermost span open at ``t_us`` ("none" outside every one)."""
    inner: Optional[Span] = None
    for s in spans:
        if s.start_us <= t_us <= s.end_us and (
                inner is None or s.end_us - s.start_us
                < inner.end_us - inner.start_us):
            inner = s
    return "none" if inner is None else inner.name
