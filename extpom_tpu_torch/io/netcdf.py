"""NetCDF-3 interchange (classic / 64-bit offset, through
``scipy.io.netcdf_file``; ``extpom_tpu/io/netcdf.py``).

The reference's whole I/O surface is NetCDF (io_pnetcdf.F).  This module
reads and writes its layouts:

* :func:`write_output_nc` — a snapshot with the reference's variable names,
  dimension order and scalar diagnostics (write_output_pnetcdf,
  io_pnetcdf.F:57-410), or one more record of an existing output file;
* :func:`zarr_output_to_nc` — a Zarr snapshot dataset
  (``io.zarrstore.write_output``) as such a file (also the module's CLI:
  ``python -m extpom_tpu_torch.io.netcdf SRC [SRC ...] DST.nc``);
* :func:`read_grid_nc` / :func:`read_initial_ts_nc` — a grid and initial
  T/S from reference-format files (io_pnetcdf.F:2084-2264, 2771-2844);
* :func:`write_restart_nc` / :func:`read_restart_nc` — the reference's
  37-variable restart payload (io_pnetcdf.F:1661-2083, 2420-2769) with the
  scalar step counter ``iint``;
* :class:`NcForcingSource` / :func:`write_forcing_series_nc` — forcing
  record series (io_pnetcdf.F:2912-3622).

Layout: horizontal fields are ``(im, jm)`` = (x, y) here and ``(y, x)`` in
C order in the files, so every read and write swaps the trailing axes.
Writers take the port's tensors (on any device) or numpy arrays.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
from scipy.io import netcdf_file

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid, make_grid
from extpom_tpu_torch.core.state import State, FIELDS_2D

# domain_stats key -> the reference's output variable name
# (write_output_pnetcdf, io_pnetcdf.F:72-92; advance.f:669-745)
_STAT_NAMES = {"vtot": "vtot", "atot": "atot", "mtot": "mtot",
               "tsalt": "tsalt", "taver": "tavg", "saver": "savg",
               "eaver": "eavg", "ekin": "ekin"}

_GRID_2D = ("dx", "dy", "east_u", "east_v", "east_e", "east_c",
            "north_u", "north_v", "north_e", "north_c", "rot", "h",
            "fsm", "dum", "dvm")
_FIELDS_2D = ("uab", "vab", "elb")
_FIELDS_3D = ("u", "v", "w", "t", "s", "rho", "km", "kh", "aam")
OUTPUT_FIELDS = _FIELDS_2D + _FIELDS_3D

_UNITS = {"time": "days", "z": "sigma_level", "zz": "sigma_level",
          "dx": "metre", "dy": "metre", "h": "metre", "elb": "metre",
          "uab": "metre/sec", "vab": "metre/sec", "u": "metre/sec",
          "v": "metre/sec", "w": "metre/sec", "t": "K", "s": "PSS",
          "rho": "dimensionless", "km": "m^2/sec", "kh": "m^2/sec",
          "aam": "m^2/sec", "east_e": "degree", "north_e": "degree",
          "rot": "degree"}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _hx(a) -> np.ndarray:
    """(.., im, jm) -> (.., jm, im): swap to the file's (y, x) order."""
    return np.swapaxes(_np(a), -1, -2)


def _var(f, name, dims, data):
    """Create variable ``name`` over ``dims`` holding ``data`` (a record
    variable is written record by record)."""
    a = _np(data)
    v = f.createVariable(name, a.dtype.newbyteorder("="), dims)
    if dims and dims[0] == "time":
        for r in range(a.shape[0]):
            v[r] = a[r]
    else:
        v[...] = a
    if name in _UNITS:
        v.units = _UNITS[name]
    return v


def _create_output(path: str, kb: int, im: int, jm: int, time_days: float,
                   stats, grid_vars: Dict, fields: Dict,
                   extra: Optional[Dict]) -> None:
    f = netcdf_file(path, "w", version=2)   # 64-bit offset
    try:
        f.title = "extpom_tpu_torch output snapshot"
        f.createDimension("time", None)
        f.createDimension("z", kb)
        f.createDimension("y", jm)
        f.createDimension("x", im)
        _var(f, "time", ("time",), np.asarray([time_days], np.float64))
        for key, nc_name in _STAT_NAMES.items():
            if stats and key in stats:
                _var(f, nc_name, ("time",),
                     np.asarray([stats[key]], np.float64))
        for name in ("z", "zz"):
            _var(f, name, ("z",), grid_vars[name])
        for name in _GRID_2D:
            if name in grid_vars:
                _var(f, name, ("y", "x"), _hx(grid_vars[name]))
        for name in _FIELDS_2D:
            _var(f, name, ("time", "y", "x"), _hx(fields[name])[None])
        for name in _FIELDS_3D:
            _var(f, name, ("time", "z", "y", "x"), _hx(fields[name])[None])
        for name, arr in (extra or {}).items():
            a = _np(arr)
            dims = (("time", "z", "y", "x") if a.ndim == 3
                    else ("time", "y", "x"))
            _var(f, name, dims, _hx(a)[None])
    finally:
        f.close()


def write_output_nc(path: str, grid: Grid, cfg: Config, state,
                    time_days: float, stats: Optional[Dict] = None,
                    extra: Optional[Dict] = None,
                    append: bool = False) -> None:
    """One snapshot as a reference-layout file: dimensions ``time``
    (record), ``z`` (kb), ``y`` (jm), ``x`` (im).  ``state`` needs the
    fields of :data:`OUTPUT_FIELDS`.  With ``append`` and an existing
    ``path`` the snapshot is the file's next record (the reference's
    single output stream, io_pnetcdf.F:180-410); the grid is written once,
    when the file is created."""
    if append and os.path.exists(path):
        _append_output_nc(path, state, time_days, stats, extra)
        return
    grid_vars = {n: getattr(grid, n) for n in ("z", "zz") + _GRID_2D}
    _create_output(path, cfg.kb, cfg.im, cfg.jm, time_days, stats,
                   grid_vars, {n: getattr(state, n) for n in OUTPUT_FIELDS},
                   extra)


def _append_output_nc(path: str, state, time_days: float,
                      stats: Optional[Dict], extra: Optional[Dict]) -> None:
    """Write one more record into an existing output file (see
    :func:`write_output_nc` append mode); a record variable the file was
    not created with is left out, as the reference leaves it out."""
    f = netcdf_file(path, "a", version=2)
    try:
        n = f.variables["time"].shape[0]
        f.variables["time"][n] = np.float64(time_days)
        for key, nc_name in _STAT_NAMES.items():
            if stats and key in stats and nc_name in f.variables:
                f.variables[nc_name][n] = np.float64(stats[key])
        for name in OUTPUT_FIELDS:
            f.variables[name][n] = _hx(getattr(state, name))
        for name, arr in (extra or {}).items():
            if name in f.variables:
                f.variables[name][n] = _hx(arr)
    finally:
        f.close()


def zarr_output_to_nc(src: str, dst: str) -> None:
    """Convert a Zarr snapshot dataset (``io.zarrstore.write_output``) to
    the file :func:`write_output_nc` writes."""
    from extpom_tpu_torch.io import zarrstore as zio
    d = zio.read_output(src)
    attrs = d["attrs"]
    kb, im, jm = d["u"].shape
    _create_output(dst, kb, im, jm, attrs.get("time_days", 0.0),
                   attrs.get("stats"), d, d, None)


def _native(a) -> np.ndarray:
    """A copy of a file's (big-endian) array in native byte order."""
    a = np.asarray(a)
    return a.astype(a.dtype.newbyteorder("="))


def _nc_vars(path: str) -> Dict[str, np.ndarray]:
    """Every variable of a NetCDF-3 file as a native array (copies)."""
    f = netcdf_file(path, "r", mmap=False)
    try:
        return {name: _native(v[...]) for name, v in f.variables.items()}
    finally:
        f.close()


def read_grid_nc(path: str, cfg: Config, device) -> Grid:
    """A Grid from a reference-format grid file (read_grid_pnetcdf,
    io_pnetcdf.F:2084-2264): ``z/zz/dx/dy/h/fsm`` and the coordinates and
    rotation under the reference's input names (``lon_rho``/``lat_rho``/
    ``angle``) or this package's output names (``east_e``/``north_e``/
    ``rot``); masks and metrics are derived as the reference derives them.
    A file whose z/zz length is not ``cfg.kb`` raises."""
    v = _nc_vars(path)

    def pick(*names):
        for n in names:
            if n in v:
                return v[n]
        raise KeyError(f"grid file {path} has none of {names}; "
                       f"found {sorted(v)}")

    z = np.asarray(pick("z")).reshape(-1)
    zz = np.asarray(pick("zz")).reshape(-1)
    if z.size != cfg.kb or zz.size != cfg.kb:
        raise ValueError(f"grid file {path} has {z.size} z and {zz.size} zz "
                         f"levels; the configuration has kb={cfg.kb}")
    kw = {}
    try:
        kw = dict(east_e=_hx(pick("east_e", "lon_rho")),
                  north_e=_hx(pick("north_e", "lat_rho")),
                  rot=_hx(pick("rot", "angle")))
    except KeyError:
        pass                            # coordinates are optional
    return make_grid(cfg, z, zz, _hx(pick("dx")), _hx(pick("dy")),
                     _hx(pick("h")), _hx(pick("fsm")), device=device, **kw)


def read_initial_ts_nc(path: str):
    """Initial T/S from a reference-format ``*.init.nc``
    (read_initial_ts_pnetcdf, io_pnetcdf.F:2771-2844: variables ``T`` and
    ``S``, ``(z, y, x)`` or ``(time, z, y, x)``).  Returns numpy
    ``(tb, sb, tclim, sclim)`` shaped ``(k, im, jm)`` on the file's own
    levels; ``tclim``/``sclim`` are tb/sb when the file has no
    ``Tclim``/``Sclim``."""
    v = {k.lower(): a for k, a in _nc_vars(path).items()}

    def field(name):
        a = v.get(name)
        if a is None:
            return None
        if a.ndim == 4:                 # (time, z, y, x): first record
            a = a[0]
        return np.ascontiguousarray(_hx(a))

    tb, sb = field("t"), field("s")
    if tb is None or sb is None:
        raise KeyError(f"{path} lacks T/S variables; found {sorted(v)}")
    tclim, sclim = field("tclim"), field("sclim")
    return (tb, sb, tb if tclim is None else tclim,
            sb if sclim is None else sclim)


# the reference's 37-variable restart payload (write_restart_pnetcdf,
# io_pnetcdf.F:1661-2083); names match State fields one for one
_RESTART_2D = ("wubot", "wvbot", "aam2d", "ua", "uab", "va", "vab",
               "el", "elb", "et", "etb", "egb", "utb", "vtb",
               "adx2d", "ady2d", "advua", "advva")
_RESTART_3D = ("u", "ub", "v", "vb", "w", "t", "tb", "s", "sb", "rho",
               "km", "kh", "kq", "l", "q2", "q2b", "aam", "q2l", "q2lb")
RESTART_FIELDS = _RESTART_2D + _RESTART_3D


def write_restart_nc(path: str, state: State, time_days: float,
                     iint: int, time0: float = 0.0) -> None:
    """A checkpoint in the reference's restart layout: scalar ``time`` (the
    model time in days), the 37 restart variables over ``(z, y, x)``, and
    the scalar step counter ``iint`` that the Fortran reader requires, with
    ``time0`` (the model time at step 0) so a resumed run forms each step's
    time as the uninterrupted run does."""
    f = netcdf_file(path, "w", version=2)
    try:
        kb, im, jm = state.u.shape
        f.createDimension("time", None)
        f.createDimension("z", kb)
        f.createDimension("y", jm)
        f.createDimension("x", im)
        f.createVariable("time", np.dtype(np.float64), ("time",))[0] = \
            np.float64(time_days)
        f.createVariable("iint", np.dtype(np.int32), ())[...] = iint
        f.createVariable("time0", np.dtype(np.float64), ())[...] = time0
        for name in _RESTART_2D:
            a = _hx(getattr(state, name))
            f.createVariable(name, a.dtype.newbyteorder("="),
                             ("y", "x"))[...] = a
        for name in _RESTART_3D:
            a = _hx(getattr(state, name))
            f.createVariable(name, a.dtype.newbyteorder("="),
                             ("z", "y", "x"))[...] = a
    finally:
        f.close()


def read_restart_nc(path: str, cfg: Config, device):
    """Resume from a restart file (read_restart_pnetcdf,
    io_pnetcdf.F:2420-2769).  Returns ``(state, iint, time0)``: the file's
    ``iint`` and ``time0`` where it has them; a file without ``iint`` (the
    reference's own) gives ``iint=0`` and ``time0`` = its ``time``, the
    reference's convention.

    State fields the reference does not checkpoint are seeded as a resumed
    reference run holds them: ``etf`` <- ``et`` (overwritten by the first
    external loop), ``drx2d``/``dry2d`` <- 0 (recomputed every step,
    advance.f:96-141), ``vfluxb``/``vfluxf`` <- 0."""
    v = _nc_vars(path)
    dtype = cfg.torch_dtype
    fields = {}
    for name in RESTART_FIELDS:
        if name not in v:
            raise KeyError(f"restart file {path} lacks {name!r}")
        a = _hx(v[name])
        if a.ndim > (2 if name in FIELDS_2D else 3):
            a = a[0]                      # tolerate a record dim
        fields[name] = torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                    device=device)
    fields["etf"] = fields["et"].clone()
    for name in ("drx2d", "dry2d", "vfluxb", "vfluxf"):
        fields[name] = torch.zeros_like(fields["el"])
    missing = {f.name for f in dataclasses.fields(State)} - set(fields)
    if missing:
        raise KeyError(f"unseeded State fields: {sorted(missing)}")
    time_days = float(np.asarray(v["time"]).reshape(-1)[0])
    if "iint" not in v:
        return State(**fields), 0, time_days
    iint = int(np.asarray(v["iint"]).reshape(-1)[0])
    time0 = (float(np.asarray(v["time0"]).reshape(-1)[0]) if "time0" in v
             else time_days - cfg.dti * iint / 86400.0)
    return State(**fields), iint, time0


class NcForcingSource:
    """Forcing record source over one NetCDF-3 file (the reference's
    surface and lateral series readers, io_pnetcdf.F:2912-3622), with the
    provider's protocol: ``names()``, ``nrec(name)``, ``read(name, n)``
    (record index clamped).  Record variables are those with a leading
    ``time`` dimension; a record whose trailing dimensions are ``(y, x)``
    is swapped to ``(im, jm)``, per-side series pass through.  The whole
    file is read at open."""

    def __init__(self, path: str):
        self.path = path
        f = netcdf_file(path, "r", mmap=False)
        try:
            self._data: Dict[str, np.ndarray] = {}
            for name, v in f.variables.items():
                dims = v.dimensions
                if not dims or dims[0] != "time" or name == "time":
                    continue
                a = _native(v[...])
                if len(dims) >= 3 and dims[-2:] == ("y", "x"):
                    a = np.ascontiguousarray(np.swapaxes(a, -1, -2))
                self._data[name] = a
        finally:
            f.close()

    def names(self):
        return list(self._data)

    def nrec(self, name: str) -> int:
        return self._data[name].shape[0]

    def read(self, name: str, n: int) -> np.ndarray:
        a = self._data[name]
        return a[min(max(n, 0), a.shape[0] - 1)]


def write_forcing_series_nc(path: str, data: Dict[str, np.ndarray],
                            im: int, jm: int, kb: int = 0) -> None:
    """A forcing series file for :class:`NcForcingSource`: each array gets
    a leading ``time`` record dimension; full fields ``(nrec, im, jm)`` are
    stored as ``(time, y, x)``, per-side series with anonymous dims."""
    f = netcdf_file(path, "w", version=2)
    try:
        f.createDimension("time", None)
        f.createDimension("y", jm)
        f.createDimension("x", im)
        if kb:
            f.createDimension("z", kb)
        extra = 0
        for name, arr in data.items():
            a = np.asarray(arr)
            rec = a.shape[1:]
            if rec == (im, jm):
                dims = ("time", "y", "x")
                a = np.swapaxes(a, -1, -2)
            elif kb and rec == (kb, im, jm):
                dims = ("time", "z", "y", "x")
                a = np.swapaxes(a, -1, -2)
            elif len(rec) == 2 and kb and rec[0] == kb:
                n = f"n{extra}"
                f.createDimension(n, rec[1])
                extra += 1
                dims = ("time", "z", n)
            else:
                ds = []
                for s in rec:
                    n = f"n{extra}"
                    f.createDimension(n, s)
                    extra += 1
                    ds.append(n)
                dims = ("time",) + tuple(ds)
            v = f.createVariable(name, a.dtype.newbyteorder("="), dims)
            for r in range(a.shape[0]):
                v[r] = a[r]
    finally:
        f.close()


def main(argv=None) -> int:
    import sys
    import types
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("usage: python -m extpom_tpu_torch.io.netcdf "
              "<output.zarr-dir> [more.zarr-dirs ...] <out.nc>\n"
              "Several snapshot dirs merge into one record stream "
              "(the reference's single output file).")
        return 2
    srcs, dst = argv[:-1], argv[-1]
    zarr_output_to_nc(srcs[0], dst)
    if len(srcs) > 1:
        from extpom_tpu_torch.io import zarrstore as zio
        for src in srcs[1:]:
            d = zio.read_output(src)
            attrs = d["attrs"]
            _append_output_nc(
                dst, types.SimpleNamespace(**{n: d[n] for n in OUTPUT_FIELDS}),
                attrs.get("time_days", 0.0), attrs.get("stats"), None)
    print(f"wrote {dst} ({len(srcs)} records, "
          f"{os.path.getsize(dst)} bytes)")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
