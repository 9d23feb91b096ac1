"""Forcing series staged on the device (``extpom_tpu/forcing/device.py``).

A :class:`DevicePlan` holds each record series of a
:class:`~extpom_tpu_torch.forcing.provider.ForcingProvider` as one
``(nrec, ...)`` tensor on the model's device.  :func:`forcing_at` builds
the Forcing of one internal step from it: the bracketing records are
views of the stack (:func:`picks`), and the linear time interpolation
(bounds_forcing.f:841-865) and the edge profiles' depth integrals run on
the device: on the card in one launch of the hand-written kernel
(``kernels/forcing.py``), on the CPU as plain elementwise kernels
(:func:`forcing_at_plain`, which the kernel equals bit for bit).  The
record index and the interpolation fraction are host arithmetic on the
step number (:func:`t_days_at`, in the model's dtype, as the JAX package
forms them), so no step waits on the device.

On a mesh the Forcing of a step is formed the same way, once on the whole
grid, and then cut to the blocks (``mesh.shardmap.Blocks.host_forcing``).

Within the budget ``cfg.forcing_hbm_mb`` a series is staged whole, once;
beyond it, :func:`make_device_plan` stages the window of records a segment
needs plus one record of margin each side, and the model stages a new
window for every segment (the reference streams one record pair,
bounds_forcing.f:607-613).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.state import Forcing
from extpom_tpu_torch.forcing import provider as prov


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """Staged forcing series: one record stack per variable, with its
    cadence (days per record), time offset in days (``cont_bry``), whether
    it is interpolated (False: piecewise constant) and the global index of
    the stack's first record (0 for a whole series, the window's start for
    a windowed one)."""
    names: Tuple[str, ...]
    cadences: Tuple[float, ...]
    offsets: Tuple[float, ...]
    interp: Tuple[bool, ...]
    stacks: Tuple[torch.Tensor, ...]
    starts: Tuple[int, ...]


def plan_bytes(p: "prov.ForcingProvider") -> int:
    """Bytes of a whole staging of the provider's series."""
    if p.source is None:
        return 0
    itemsize = torch.empty((), dtype=p.cfg.torch_dtype).element_size()
    return sum(p.source.nrec(v) * np.asarray(p.source.read(v, 0)).size
               * itemsize for v in p.source.names())


def make_device_plan(p: "prov.ForcingProvider", dtype=None,
                     budget_bytes: Optional[int] = None,
                     t0_days: Optional[float] = None,
                     t1_days: Optional[float] = None, device=None,
                     ) -> Optional[DevicePlan]:
    """Stage the provider's series on ``device`` (its grid's by default;
    the card for a model built on the host and decomposed onto it).

    When the whole staging exceeds ``budget_bytes`` (default
    ``cfg.forcing_hbm_mb``) and the segment ``[t0_days, t1_days]`` is
    given, each series is windowed: the records covering the segment plus
    one of margin each side.  A window's length depends only on the
    segment's duration."""
    if p.source is None:
        return None
    dtype = dtype or p.cfg.torch_dtype
    device = p.grid.device if device is None else device
    if budget_bytes is None:
        budget_bytes = p.cfg.forcing_hbm_mb * 2 ** 20
    windowed = (plan_bytes(p) > budget_bytes
                and t0_days is not None and t1_days is not None)
    # (name, cadence, offset, interpolated), in the order forcing_at applies
    toff = p.cont_bry_offset * p.tbc
    names = set(p.source.names())
    series = ([(v, p.tsurf_cad, 0.0, True)
               for v in prov.WIND_VARS + prov.HEAT_VARS]
              + [(v, p.twater_cad, 0.0, True) for v in prov.WATER_VARS]
              + [(v, p.tsurf_cad, 0.0, False) for v in prov.SURF_VARS]
              + [(v, p.trst_cad, 0.0, v in names)
                 for v in prov.RESTORE_VARS]
              + [(v, p.tbc, toff, True) for v in prov.BRY_2D + prov.BRY_3D])
    # the default restoring rate, one constant record, where the restoring
    # series come without one (the provider's default_taurstr)
    tau = (("trstr" in names or "srstr" in names)
           and "taurstr" not in names)
    series = [x for x in series if x[0] in names
              or (tau and x[0] == "taurstr")]
    if not series:
        return None
    stacks, starts = [], []
    for v, cad, off, _ in series:
        if v not in names:
            stacks.append(p.default_taurstr().to(device, dtype)[None])
            starts.append(0)
            continue
        nrec = p.source.nrec(v)
        if windowed:
            n0 = max(int(np.floor((t0_days + off) / cad)) - 1, 0)
            nw = int(np.ceil((t1_days - t0_days) / cad)) + 3
            n0 = min(n0, max(nrec - nw, 0))
            recs = [min(n0 + k, nrec - 1) for k in range(min(nw, nrec))]
        else:
            n0, recs = 0, range(nrec)
        stack = np.ascontiguousarray(
            np.stack([np.asarray(p.source.read(v, n)) for n in recs]))
        stacks.append(torch.tensor(stack, dtype=dtype, device=device))
        starts.append(n0)
    names, cadences, offsets, interp = zip(*series)
    return DevicePlan(tuple(names), tuple(float(c) for c in cadences),
                      tuple(float(o) for o in offsets), tuple(interp),
                      tuple(stacks), tuple(starts))


def t_days_at(cfg: Config, iint: int, time0_days: float, dtype):
    """Model time in days of internal step ``iint``, formed in the model's
    dtype (``dtype``, a torch dtype) as the JAX package forms it: in
    float32 the record index at a record boundary then matches its."""
    d = np.float32 if dtype == torch.float32 else np.float64
    return d(cfg.dti) * d(iint) / d(86400.0) + d(time0_days)


class Pick(NamedTuple):
    """One staged series at one time: its bracketing records, views of its
    stack (``f`` None for a piecewise-constant series), and their weights,
    Python floats exact in the stack's dtype."""
    name: str
    b: torch.Tensor
    f: Optional[torch.Tensor]
    w0: float
    w1: float


def picks(plan: DevicePlan, t_days) -> list:
    """The :class:`Pick` of each staged series at model time ``t_days``
    (from :func:`t_days_at`), in the plan's order."""
    d = type(t_days)
    out = []
    for name, cad, off, do_i, stack, start in zip(
            plan.names, plan.cadences, plan.offsets, plan.interp,
            plan.stacks, plan.starts):
        nrec = stack.shape[0]
        x = (t_days + d(off)) / d(cad)
        fl = np.floor(x)
        n = int(fl) - start                  # window-local index
        b = stack[min(max(n, 0), nrec - 1)]
        if do_i:
            frac = x - fl
            out.append(Pick(name, b, stack[min(max(n + 1, 0), nrec - 1)],
                            float(d(1.0) - frac), float(frac)))
        else:
            out.append(Pick(name, b, None, 1.0, 0.0))
    return out


def forcing_at(plan: DevicePlan, base: Forcing, cfg: Config,
               dz: torch.Tensor, t_days) -> Forcing:
    """The Forcing at model time ``t_days`` (from :func:`t_days_at`): each
    staged series at its bracketing records, linearly interpolated; the
    boundary velocity profiles also depth-integrated to their barotropic
    values, in ascending k.  Every tensor it makes is contiguous, of the
    stacks' dtype, on their device; a piecewise-constant series is its
    record; the other fields are ``base``'s own.  Where ``dz`` is on the
    card one launch of ``k_forcing_interp`` (``kernels/forcing.py``) forms
    them all; elsewhere :func:`forcing_at_plain`."""
    ps = picks(plan, t_days)
    if dz.device.type == "cuda":
        from extpom_tpu_torch.kernels import forcing as kforcing
        return base.replace(**kforcing.interpolate(ps, dz, cfg.kbm1))
    return forcing_at_plain(ps, base, cfg, dz)


def forcing_at_plain(ps: list, base: Forcing, cfg: Config,
                     dz: torch.Tensor) -> Forcing:
    """:func:`forcing_at` from the :func:`picks` ``ps`` in plain PyTorch:
    three elementwise kernels a series (``b*w0``, ``f*w1``, their sum) and
    ``2*kbm1 - 1`` an edge profile's integral."""
    upd = {p.name: p.b if p.f is None else p.b * p.w0 + p.f * p.w1
           for p in ps}
    for side in prov.BRY_SIDES:
        un, tn = prov.barotropic_name(side)
        if un in upd:
            prof = upd[un]
            acc = prof[0] * dz[0]
            for k in range(1, cfg.kbm1):
                acc = acc + prof[k] * dz[k]
            upd[tn] = acc
    return base.replace(**upd)
