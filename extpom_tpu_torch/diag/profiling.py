"""Tracing and phase timing (``extpom_tpu/diag/profiling.py``).

* :class:`PhaseTimer` -- wall timers per phase that wait for the card
  (``torch.cuda.synchronize``) before a phase's clock stops, so that
  queued kernels are charged to the phase that launched them.
* :func:`trace` -- a ``torch.profiler`` trace of the enclosed code,
  written as a Chrome trace into a directory.
* :func:`step_breakdown` -- the seamount step's external-only (mode 2) and
  full (mode 3) costs, and their difference as the internal mode's.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _sync(x) -> None:
    """Wait for the card where ``x`` (a tensor, or anything holding them as
    attributes, e.g. a State) lives on it."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return
    el = getattr(x, "el", None)
    if isinstance(el, torch.Tensor):
        _sync(el)


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the enclosed code as ``name``; with ``sync`` (a tensor or
        a State) wait for its device before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values()) or 1.0
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {t:9.3f} s  {t/n*1e3:9.2f} ms/call "
                         f"x{n:<6d} {100*t/total:5.1f} %")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """A ``torch.profiler`` trace of the enclosed code (the card's kernels
    too where there is one), written as ``trace.json`` into ``logdir`` (by
    default ``extpom_trace`` in the temporary directory); yields the
    profiler, whose ``key_averages()`` summarise it."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "extpom_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def step_breakdown(im: int = 128, jm: Optional[int] = None, kb: int = 21,
                   n: int = 20, device=None, **case_kw) -> Dict[str, float]:
    """Seconds per step of the seamount at (im, jm, kb): the full mode-3
    step, the external-only mode-2 step, and their difference as the
    internal mode's estimate.  Two warm steps each; the card's queue is
    drained before each clock reads."""
    from extpom_tpu_torch.cases.seamount import seamount_model

    jm = im if jm is None else jm
    out = {}
    for label, mode in (("full_step", 3), ("external_only", 2)):
        m = seamount_model(im=im, jm=jm, kb=kb, mode=mode, device=device,
                           **case_kw)
        m.step_once()
        m.step_once()
        _sync(m.state)
        t0 = time.perf_counter()
        for _ in range(n):
            m.step_once()
        _sync(m.state)
        out[label] = (time.perf_counter() - t0) / n
        del m
    out["internal_est"] = out["full_step"] - out["external_only"]
    return out
