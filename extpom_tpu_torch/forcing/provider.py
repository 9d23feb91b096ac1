"""Host-side forcing providers (``extpom_tpu/forcing/provider.py``).

The reference refreshes its forcing from files inside the time loop
(``wind``/``heat``/``surface``/``water``/``lateral_bc``,
bounds_forcing.f:593-1020): every record cadence it reads the two
bracketing records and interpolates linearly in time at each step.  Here
the same cadence and interpolation are a function of the step counter,
with a bounded record cache and a prefetch thread in place of the b/f
double buffers.

Sources yield numpy arrays per record index: :class:`ArraySource` serves
in-memory data, ``io.netcdf.NcForcingSource`` NetCDF series,
``io.zarrstore.ZarrSource`` Zarr datasets and
``native.recordio.NativeRecordSource`` directories of ``.efr`` files.

A series name the provider does not know raises ``ValueError`` at
construction.  The interior restoring series ``trstr``/``srstr``/``taurstr``
(``do_restore``) come in 30-day records, interpolated linearly;
``taurstr`` defaults to the constant 1/TRST [1/day] where the source has
none (bounds_forcing.f:1036-1094).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.core.state import Forcing

# record cadences in days (bounds_forcing.f:607 tbc=1/24; :886 twind=0.125;
# :929 theat=0.125; :1000 twater=30; :1033 trst=30)
TBC = 1.0 / 24.0
TSURF = 0.125
TWATER = 30.0
TRST = 30.0

# variable-name groups, matching the reference's dataset contents
WIND_VARS = ("wusurf", "wvsurf")                       # .sfrc wind stress
HEAT_VARS = ("wtsurf", "swrad")                        # .sfrc heat fluxes
SURF_VARS = ("tsurf", "ssurf")                         # .sfrc SST/SSS
WATER_VARS = ("wssurf",)                               # .water freshwater
RESTORE_VARS = ("trstr", "srstr", "taurstr")           # .clim restore series
BRY_SIDES = ("w", "e", "s", "n")
BRY_2D = tuple(f"el{s}" for s in BRY_SIDES)            # zeta.* series
BRY_3D = tuple(f"{v}b{s}" for v in ("t", "s", "u", "v") for s in BRY_SIDES)
KNOWN_VARS = (WIND_VARS + HEAT_VARS + SURF_VARS + WATER_VARS + RESTORE_VARS
              + BRY_2D + BRY_3D)


def check_names(names) -> None:
    """Raise ``ValueError`` for a series the provider does not know (it is
    not dropped)."""
    names = set(names)
    unknown = sorted(names - set(KNOWN_VARS))
    if unknown:
        raise ValueError(f"unknown forcing series {unknown}; known names: "
                         f"{', '.join(KNOWN_VARS)}")


def barotropic_name(side: str) -> tuple:
    """(profile series, depth-integrated Forcing field) of a boundary side:
    ``ub*``/``uab*`` on the west and east, ``vb*``/``vab*`` on the south
    and north (bounds_forcing.f:626-635, 747-756)."""
    v = "u" if side in ("w", "e") else "v"
    return f"{v}b{side}", f"{v}ab{side}"


class ArraySource:
    """In-memory record source: ``data[name]`` has shape (nrec, ...).

    Record indices clamp to the available range, so a short series holds
    its last record."""

    def __init__(self, data: Dict[str, np.ndarray]):
        self.data = data

    def nrec(self, name: str) -> int:
        return self.data[name].shape[0]

    def read(self, name: str, n: int) -> np.ndarray:
        a = self.data[name]
        return a[min(max(n, 0), a.shape[0] - 1)]

    def names(self):
        return self.data.keys()


class MultiSource:
    """Several record sources as one (the surface and lateral series of a
    run come from separate datasets, as the reference's ``.sfrc.nc`` and
    ``.lbry.nc``).  Ownership is resolved once: a name served by two
    sources raises.  ``interp`` delegates to the owner's fused
    interpolation where it has one and returns None otherwise, so that the
    provider's cached path serves that name."""

    def __init__(self, sources: Sequence):
        self.sources = list(sources)
        self._owner: Dict[str, object] = {}
        for s in self.sources:
            for name in s.names():
                if name in self._owner:
                    raise ValueError(
                        f"forcing variable {name!r} provided by both "
                        f"{type(self._owner[name]).__name__} and "
                        f"{type(s).__name__}")
                self._owner[name] = s

    def names(self):
        return self._owner.keys()

    def nrec(self, name: str) -> int:
        return self._owner[name].nrec(name)

    def read(self, name: str, n: int) -> np.ndarray:
        return self._owner[name].read(name, n)

    def interp(self, name: str, x: float):
        itp = getattr(self._owner[name], "interp", None)
        return None if itp is None else itp(name, x)


class ForcingProvider:
    """Builds one time-interpolated :class:`Forcing` per internal step, its
    tensors in the model's dtype on the model's device.

    Series the source does not provide keep their value from ``base`` (the
    edge-seeded forcing of the cold start).  ``cont_bry_offset`` continues
    the lateral record counter across restarts (initialize.f:198,
    bounds_forcing.f:613)."""

    def __init__(self, grid: Grid, cfg: Config, base: Forcing,
                 source=None, bry_cadence_days: float = TBC,
                 surf_cadence_days: float = TSURF,
                 water_cadence_days: float = TWATER,
                 restore_cadence_days: float = TRST,
                 cont_bry_offset: int = 0, prefetch: bool = True):
        if source is not None:
            check_names(source.names())
        self.grid = grid
        self.cfg = cfg
        self.base = base
        self.source = source
        self.tbc = bry_cadence_days
        self.tsurf_cad = surf_cadence_days
        self.twater_cad = water_cadence_days
        self.trst_cad = restore_cadence_days
        self.cont_bry_offset = cont_bry_offset
        self._pool = ThreadPoolExecutor(max_workers=1) if prefetch else None
        self._prefetched: Dict[tuple, object] = {}
        self._cache: Dict[tuple, np.ndarray] = {}
        self._dz = None

    # -- record access with prefetch ------------------------------------
    def _read(self, name: str, n: int) -> np.ndarray:
        key = (name, n)
        if key in self._cache:
            return self._cache[key]
        fut = self._prefetched.pop(key, None)
        rec = fut.result() if fut is not None else self.source.read(name, n)
        self._cache[key] = rec
        if len(self._cache) > 64:            # bounded double-buffer cache
            self._cache.pop(next(iter(self._cache)))
        if self._pool is not None:           # prefetch the next record
            nxt = (name, n + 1)
            if nxt not in self._cache and nxt not in self._prefetched:
                self._prefetched[nxt] = self._pool.submit(
                    self.source.read, name, n + 1)
        return rec

    def _interp(self, name: str, time_days: float, cadence: float):
        """Bracketing records and linear interpolation
        (bounds_forcing.f:841-865: field = (1-frac)*b + frac*f)."""
        x = time_days / cadence
        itp = getattr(self.source, "interp", None)
        if itp is not None:
            rec = itp(name, x)
            if rec is not None:
                return rec
        n = int(np.floor(x))
        frac = x - n
        b = self._read(name, n)
        f = self._read(name, n + 1)
        return (1.0 - frac) * b + frac * f

    def default_taurstr(self) -> torch.Tensor:
        """The restoring rate where the source has no ``taurstr``: 1/trst
        [1/day], one value broadcast over (kb, im, jm)."""
        return torch.full((1, 1, 1), 1.0 / self.trst_cad,
                          dtype=self.cfg.torch_dtype, device=self.grid.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a),
                            dtype=self.cfg.torch_dtype,
                            device=self.grid.device)

    # -- per-step assembly -----------------------------------------------
    def __call__(self, model, iint: int) -> Forcing:
        cfg = self.cfg
        if self.source is None:
            return self.base
        t_days = cfg.dti * iint / 86400.0 + model.time0
        names = set(self.source.names())
        upd = {}
        for v in WIND_VARS + HEAT_VARS:
            if v in names:
                upd[v] = self._tensor(self._interp(v, t_days,
                                                   self.tsurf_cad))
        for v in WATER_VARS:                  # bounds_forcing.f:986-1020
            if v in names:
                upd[v] = self._tensor(self._interp(v, t_days,
                                                   self.twater_cad))
        for v in SURF_VARS:                   # no time interpolation
            if v in names:                    # (bounds_forcing.f:963-983)
                n = int(np.floor(t_days / self.tsurf_cad))
                upd[v] = self._tensor(self._read(v, n))

        # interior restoring series, linearly interpolated; taurstr
        # defaults to the constant 1/trst [1/day] (bounds_forcing.f:1043)
        if "trstr" in names or "srstr" in names:
            for v in RESTORE_VARS:
                if v in names:
                    upd[v] = self._tensor(self._interp(v, t_days,
                                                       self.trst_cad))
            if "taurstr" not in names:
                upd["taurstr"] = self.default_taurstr()

        # lateral boundary series, offset by cont_bry
        toff = self.cont_bry_offset * self.tbc
        bry = {}
        for v in BRY_2D + BRY_3D:
            if v in names:
                bry[v] = self._interp(v, t_days + toff, self.tbc)
                upd[v] = self._tensor(bry[v])

        # depth-integrate boundary velocity profiles to barotropic values
        # (uab* = sum_k ub*(k) dz(k), in ascending k)
        if self._dz is None:
            self._dz = self.grid.dz.cpu().numpy()[:cfg.kbm1]
        for side in BRY_SIDES:
            un, tn = barotropic_name(side)
            if un in bry:
                prof = np.asarray(bry[un])
                acc = prof[0] * self._dz[0]
                for k in range(1, cfg.kbm1):
                    acc = acc + prof[k] * self._dz[k]
                upd[tn] = self._tensor(acc)
        return self.base.replace(**upd) if upd else self.base
