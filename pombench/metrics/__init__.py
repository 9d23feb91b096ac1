"""The per-layer metrics, one reader each: ``metrics/<name>.py`` declares
its ``LAYER`` (a module of the port), ``UNIT``, ``MOVES`` (the end-to-end
metric it should move) and ``KERNELS`` (the device kernels it reads, by a
part of their names; empty where it reads none), and ``read(trace)`` takes
the metric from a :class:`pombench.trace.Trace`, or returns None where the
trace holds nothing for it to read."""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    return importlib.import_module(f"pombench.metrics.{name}")


def handwritten() -> tuple:
    """The name parts of the port's hand-written kernels."""
    lines = (HERE / "handwritten_kernels.txt").read_text().splitlines()
    return tuple(x.strip() for x in lines
                 if x.strip() and not x.startswith("#"))
