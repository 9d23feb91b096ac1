"""The comparison that decides ``correct``.

The reference (:mod:`pombench.reference`: plain PyTorch written from the
repository's loop oracle and POM's equations, importing nothing of the
port) cannot follow a whole window at 2048x2048x41, so it follows the
program step by step from the program's own state, and checks the start
and the diagnostics by itself:

- ``start_gap``: the cold start.  The program's initial state on a few
  slabs of rows, saved before its first step, against the reference's cold
  start from the same inputs: each field's widest gap over the field's own
  scale, the largest over the fields.
- ``ext_gap`` and ``int_gap``: one step from the state in which the window
  ended.  The program advances it through the window's own call
  (``Model.run_segment``) at the window's sizes; the reference advances the
  same state with its own grid, edge data, ramp and climatology, and with
  the step's forcing, which it interpolates itself from the case's series
  (:func:`pombench.reference.model.forcing_at`).  For each
  compared field, the widest gap between the two new states over the
  widest change the reference makes in the step; the largest over the
  external mode's fields (``ext_gap``) and over the internal mode's
  (``int_gap``).  Two internal groups have numbers of their own, because
  independent roundings of their step part by a large share of it: the
  velocities u and v (``uv_gap``), whose tendency is the small residual of
  a near-geostrophic balance, and salinity (``s_gap``), which a step moves
  by only tens to hundreds of float32 ulps of S (~15 psu).  So a fault
  that touches a few cells of the other fields stays visible in
  ``int_gap``.
- ``diag_gap``: the program's diagnostics at the window's last print
  against the reference's diagnostics of the same state: the largest
  relative gap.

The reference computes in the configuration's dtype; the control (see
:mod:`pombench.control`) is the same reference in the next lower precision
(:data:`CONTROL`) in the program's place.  A field whose values are not all
finite makes its number infinite.
"""

from __future__ import annotations

import gc
import math

import torch

from pombench import inputs as pin
from pombench.reference import model as ref

# the fields compared after one step: the external mode's (2-D) and the
# internal mode's (3-D)
EXT_FIELDS = ("el", "ua", "va", "et", "egb", "utb", "vtb")
UV_FIELDS = ("u", "v")
INT_FIELDS = ("w", "t", "q2", "q2l", "km", "kh", "rho", "aam")
SAL_FIELDS = ("s",)
STEP_FIELDS = EXT_FIELDS + UV_FIELDS + INT_FIELDS + SAL_FIELDS
# the diagnostics compared: every sum of the print's diagnostics whose value
# is not a difference that cancels (eaver, the mean elevation, is near 0)
STATS = ("vtot", "atot", "mtot", "tsalt", "taver", "saver", "ekin")
NUMBERS = ("start_gap", "ext_gap", "uv_gap", "int_gap", "s_gap",
           "diag_gap")
# the control's precision: the next one below the configuration's (no step
# of the model is a matrix product, so TF32 does not apply)
CONTROL = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


def dtype_of(conf: dict) -> torch.dtype:
    """The dtype the configuration states."""
    return getattr(torch, conf["config"]["dtype"])


def start_rows(im: int) -> tuple:
    """The slabs of rows (slices of i) on which the cold start is compared:
    the west edge and the centre of the domain (the seamount)."""
    n = max(min(32, im // 8), 2)
    c = im // 2
    return (slice(0, n), slice(c - n // 2, c - n // 2 + n))


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


def scale_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| (0 where both are 0)."""
    if not _finite(got):
        return math.inf
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    if scale == 0.0:
        return 0.0 if err == 0.0 else math.inf
    return err / scale


def step_gap(got: torch.Tensor, want: torch.Tensor,
             before: torch.Tensor) -> float:
    """max |got - want| / max |want - before|: the gap of a step's result
    over the change the reference's step makes (0 where neither moved)."""
    if not _finite(got):
        return math.inf
    err = float((got.double() - want.double()).abs().max())
    moved = float((want.double() - before.double()).abs().max())
    if moved == 0.0:
        return 0.0 if err == 0.0 else math.inf
    return err / moved


class Reference:
    """The reference's model of ``inp`` in ``dtype`` on ``device``: its
    constants, grid, cold start, climatology (the initial fields where the
    case gives none), the edge data of its cold start and the case's
    forcing series."""

    def __init__(self, inp: pin.Inputs, device, dtype):
        self.p = p = ref.params(inp.namelist)
        self.g = g = ref.make_grid(inp, dtype, device)
        self.dtype, self.device = dtype, device
        tb, sb, elb, uab, vab = (x.to(device, dtype) for x in
                                 (inp.tb, inp.sb, inp.elb, inp.uab, inp.vab))
        clim = lambda c, f: f if c is None else c.to(device, dtype)
        self.tclim, self.sclim = clim(inp.tclim, tb), clim(inp.sclim, sb)
        self.start, self.rmean = ref.cold_start(p, g, tb, sb, self.tclim,
                                                self.sclim, elb, uab, vab)
        self.fc = ref.edge_data(p, g, tb, sb, elb, uab, vab)
        self.series = inp.series
        self.periods = {n: pin.PERIODS[pin.dataset(n)] for n in inp.series}

    def state(self, fields: dict) -> dict:
        return {k: v.to(self.device, self.dtype) for k, v in fields.items()}

    def step(self, fields: dict, iint: int) -> dict:
        """The state after internal step ``iint + 1`` from ``fields``, under
        that step's forcing."""
        fc = ref.forcing_at(self.p, self.g, self.fc, self.series,
                            self.periods, iint)
        return ref.step(self.p, self.g, self.state(fields), fc, self.rmean,
                        self.tclim, self.sclim, iint)

    def stats(self, fields: dict) -> dict:
        return ref.stats(self.p, self.g, self.state(fields))


def start_slabs(fields: dict, rows) -> dict:
    """Field -> its slabs ``rows`` (slices of i) concatenated along i, on
    the host."""
    return {k: torch.cat([v[..., r, :].cpu() for r in rows], dim=-2)
            for k, v in fields.items()}


def reference_side(inp: pin.Inputs, device, dtype, before: dict,
                   iint: int) -> tuple:
    """What the reference in ``dtype`` makes of the run: (its cold start on
    the slabs of :func:`start_rows`, its diagnostics of ``before``, the
    compared fields of its step from ``before``)."""
    r = Reference(inp, device, dtype)
    start = start_slabs(r.start, start_rows(inp.im))
    r.start = None
    gc.collect()
    stats = r.stats(before)
    st = r.step(before, iint)
    after = {n: st[n] for n in STEP_FIELDS}
    return start, stats, after


def numbers(start: dict, want_start: dict, stats: dict, want_stats: dict,
            fields: dict) -> dict:
    """The compared numbers of a run whose cold start on the slabs and last
    diagnostics read ``start`` and ``stats`` against ``want_*``, and whose
    step gaps are ``fields`` (:func:`field_gaps`).  A field that one side
    has and the other lacks makes ``start_gap`` infinite."""
    gaps = [scale_gap(start[k], want_start[k]) if k in start and
            k in want_start else math.inf
            for k in set(start) | set(want_start)]
    return {"start_gap": max([0.0] + gaps),
            "ext_gap": max(fields[n] for n in EXT_FIELDS),
            "uv_gap": max(fields[n] for n in UV_FIELDS),
            "int_gap": max(fields[n] for n in INT_FIELDS),
            "s_gap": max(fields[n] for n in SAL_FIELDS),
            "diag_gap": diag_gap(stats, want_stats)}


def field_gaps(before: dict, after: dict, want_after: dict) -> dict:
    """Each compared field's :func:`step_gap` after one step."""
    out = {}
    for n in STEP_FIELDS:
        want = want_after[n]
        out[n] = step_gap(after[n].to(want.device), want,
                          before[n].to(want.device, want.dtype))
    return out


def diag_gap(got: dict, want: dict) -> float:
    gaps = []
    for k in STATS:
        if not math.isfinite(got[k]):
            return math.inf
        gaps.append(abs(got[k] - want[k]) / abs(want[k]) if want[k] else
                    (0.0 if got[k] == 0.0 else math.inf))
    return max(gaps)


def correct(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)
