"""Tracing (``extpom_tpu/diag/profiling.py``).

* :func:`span` -- a range ``extpom.<name>`` in the profile of the
  enclosed code while ``torch.profiler`` records, and nothing otherwise.
  Its events carry the profiler's timestamps, the clock of the card's
  kernels and copies, so an idle gap of the card falls inside the host
  span that was open across it, and a kernel belongs to the innermost
  span open at its launch (matched by correlation id).  A span is a
  function-scope range, not a user annotation: the profiler makes no
  device-side copy of it, so the card's timeline holds only its kernels,
  copies and fills.
* :func:`host_value` -- the one way the step and the diagnostics read a
  device value to the host, inside the span ``sync``: that span's count is
  the number of reads, its duration the wait; :func:`host_values` reads
  several values of one tensor in one such read.
* :func:`trace` -- a ``torch.profiler`` trace of the enclosed code,
  written as a Chrome trace into a directory.
* :func:`stage_times` -- a finished profile's device time by the path of
  the innermost span open at each operation's launch (``segment/step/tke``),
  with the spans' counts; :func:`span_paths` the spans alone, in order.

The spans the model opens (their names without the prefix): ``segment``
(``Model.run_segment``), ``step`` (each internal step), ``forcing`` (the
step's interpolation of a staged forcing plan, ``forcing/device.py:
forcing_at``, in ``stepper.run_steps`` and in the mesh path's segment,
where it also cuts the forcing to the blocks), the stages ``lat``,
``interaction``, ``external``, ``uvw``, ``tke``, ``tracer`` (with
``mpdata`` inside it under ``nadv=2``) and ``mom``, the diagnostics
``stats`` and ``velocity``, and ``sync``.  ``forcing_stage``
(``Model._device_plan``) is a counter too: one span a staging of the
forcing series on the device, once at the first segment for a whole plan,
once a segment for a windowed one (``segment/forcing_stage``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "extpom."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range ``extpom.<name>`` while a profiler records;
    otherwise one shared null context, so that with no profiler open a span
    allocates nothing, reads no clock and waits for nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    # a range in the scope of a function (a user annotation, as
    # record_function makes, gets a copy on the device's timeline)
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def host_value(t: torch.Tensor):
    """The value of the 0-d tensor ``t`` as a Python float, int or bool (as
    ``float``/``int`` of it give), read inside the span ``sync``: on the
    card the read waits for every kernel queued before it."""
    with span("sync"):
        return t.item()


def host_values(t: torch.Tensor) -> list:
    """The values of the 1-D tensor ``t`` as Python numbers (as
    ``t.tolist()`` gives them), read at once inside one span ``sync``."""
    with span("sync"):
        return t.tolist()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """A ``torch.profiler`` trace of the enclosed code (the card's kernels
    too where there is one, and the model's spans), written as
    ``trace.json`` into ``logdir`` (by default ``extpom_trace`` in the
    temporary directory); yields the profiler, whose ``key_averages()``
    summarise it."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "extpom_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def span_paths(events: Iterable) -> List[Tuple[str, int, int]]:
    """The model's spans among a profile's raw events
    (``prof.profiler.kineto_results.events()``) as (path, start ns, end
    ns), in the order they open: a span's path is the names of the spans
    that enclose it, then its own (``segment/step/tracer/mpdata``)."""
    n = len(PREFIX)
    raw = sorted((e.start_ns(), -e.end_ns(), e.name()[n:]) for e in events
                 if e.name().startswith(PREFIX)
                 and e.device_type() == _autograd_profiler.DeviceType.CPU)
    out, open_ = [], []
    for s, neg_e, name in raw:
        while open_ and open_[-1][0] <= s:
            open_.pop()
        path = f"{open_[-1][1]}/{name}" if open_ else name
        out.append((path, s, -neg_e))
        open_.append((-neg_e, path))
    return out


def attribute(spans, launches, ops) -> Dict[str, dict]:
    """Each operation under the innermost span open at its launch.
    ``spans``: (path, start, end) as :func:`span_paths` gives them;
    ``launches``: {correlation id: time} of the host's runtime calls;
    ``ops``: (name, correlation id, linked correlation id, device us) of
    the device's kernels, copies and fills.  Returns {path: {"spans": how
    many spans have the path, "device_us": the time of the operations
    launched in it, "ops": {name: [count, us]}}}, the path "" for the
    operations launched outside every span or not matched to a launch."""
    out: Dict[str, dict] = {}
    entry = lambda p: out.setdefault(p, {"spans": 0, "device_us": 0.0,
                                         "ops": {}})
    for path, _, _ in spans:
        entry(path)["spans"] += 1
    # one sweep in time: at one time a span opens (0) before a launch (1),
    # and the longer of two spans first
    marks = sorted([(s, 0, -e, path) for path, s, e in spans]
                   + [(t, 1, c, "") for c, t in launches.items()])
    where, open_ = {}, []
    for t, kind, x, path in marks:
        while open_ and open_[-1][0] < t:
            open_.pop()
        if kind == 0:
            open_.append((-x, path))
        else:
            where[x] = open_[-1][1] if open_ else ""
    for name, corr, linked, us in ops:
        e = entry(where.get(corr, where.get(linked, "")))
        e["device_us"] += us
        count = e["ops"].setdefault(name, [0, 0.0])
        count[0] += 1
        count[1] += us
    return out


def stage_times(events: Iterable) -> Dict[str, dict]:
    """:func:`attribute` over a profile's raw events
    (``prof.profiler.kineto_results.events()``, or a part of them): the
    card's operations (a device-side copy of a span left out), the runtime
    calls that launched them (matched by correlation id) and the model's
    spans, all on the profiler's clock."""
    cuda = _autograd_profiler.DeviceType.CUDA
    events = list(events)
    launches, ops = {}, []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not name.startswith(PREFIX):
                ops.append((name, e.correlation_id(),
                            e.linked_correlation_id(), e.duration_ns() / 1e3))
        elif name.startswith("cu"):        # a runtime call: a launch
            launches[e.correlation_id()] = e.start_ns()
    return attribute(span_paths(events), launches, ops)
