"""Chunked Zarr datasets (``extpom_tpu/io/zarrstore.py``) on the port's own
Zarr v2 store (``io/zarr.py``), which tensorstore and the JAX package read
as their own and which reads theirs.

The reference's datasets — grid, initial T/S, forcing series, restart,
output (io_pnetcdf.F) — as Zarr arrays, one directory per dataset with an
``attrs.json``:

* :func:`write_restart` / :func:`read_restart` — every State field and the
  step counter: a bit-seamless checkpoint (io_pnetcdf.F:1661-2083);
* :func:`write_output` / :func:`read_output` — a snapshot with the grid,
  the prognostic fields and the scalar diagnostics (io_pnetcdf.F:57-410);
* :func:`write_grid` / :func:`read_grid`, :func:`write_initial_ts` /
  :func:`read_initial_ts`;
* :func:`write_aux` — the full-state debug dump (io_pnetcdf.F:413-1658);
* :class:`ZarrSource` / :func:`write_forcing_series` — forcing record
  series (io_pnetcdf.F:2912-3622).

Every array is written as the JAX package writes it through tensorstore:
blosc-lz4 chunks under tensorstore's default ``.zarray``
(``zarr.BLOSC``); raw stores are read too.

Under several processes (``mesh/distributed.py``) the writes are
cooperative, as the JAX package's ``_write_array_multihost`` and the
reference's per-rank hyperslab puts (io_pnetcdf.F:272-275): a decomposed
array (``distributed.Slabs``) is created by rank 0, all ranks wait, each
writes its own blocks' chunks (a chunk of the store is a block, and each
chunk file is written whole, so no two ranks write one file), and all
ranks wait again; an array every rank holds whole (the grid) and the
attributes are written by rank 0.  The waits are on the I/O group, never
on the group of the step's exchange, so the writer thread may run them.
:func:`read_restart` reads each rank's hyperslabs into its blocks.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid, make_grid
from extpom_tpu_torch.core.state import State
from extpom_tpu_torch.io import zarr
from extpom_tpu_torch.io.netcdf import OUTPUT_FIELDS
from extpom_tpu_torch.mesh import distributed


def _numpy(a) -> np.ndarray:
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def write_array(root: str, name: str, arr,
                chunks: Optional[tuple] = None) -> None:
    """Write one array (a tensor on any device, or numpy) as
    ``root/name``, chunked by horizontal tiles of at most 256; a
    ``distributed.Slabs`` cooperatively (:func:`_write_slabs`).  Under
    several processes an array that every rank holds whole is written by
    rank 0."""
    if isinstance(arr, distributed.Slabs):
        _write_slabs(root, name, arr)
        return
    if distributed.rank() != 0:
        return
    a = _numpy(arr)
    if chunks is None:
        chunks = tuple(min(s, 256) for s in a.shape) if a.ndim else (1,)
    if a.ndim == 0:
        a = a[None]
        chunks = (1,)
    zarr.Array.create(os.path.join(root, name), a.shape, a.dtype,
                      chunks).write(a)


def _write_slabs(root: str, name: str, arr: "distributed.Slabs") -> None:
    """Cooperative write of a decomposed array: rank 0 creates the store
    (a chunk per block), all ranks wait, each writes its pieces, and all
    ranks wait again.  A piece must be exactly one chunk (an edge chunk:
    its cells inside the array), so that each chunk file has one
    writer."""
    path = os.path.join(root, name)
    if distributed.rank() == 0:
        zarr.Array.create(path, arr.shape, arr.dtype, arr.chunks)
    distributed.process_barrier(f"zarr-create:{name}")
    z = zarr.Array(path)
    for ((i0, i1), (j0, j1)), piece in arr.pieces.items():
        z.write_chunk(z.chunk_index((..., slice(i0, i1), slice(j0, j1))),
                      _numpy(piece))
    distributed.process_barrier(f"zarr-written:{name}")


def read_array(root: str, name: str) -> np.ndarray:
    return zarr.Array(os.path.join(root, name)).read()


def _write_attrs(root: str, attrs: Dict) -> None:
    """``attrs.json`` of a dataset, by rank 0; under several processes the
    ranks then wait for it, so that a dataset is whole when they go on."""
    if distributed.rank() == 0:
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "attrs.json"), "w") as f:
            json.dump(attrs, f)
    distributed.process_barrier("zarr-attrs")


def _read_attrs(root: str) -> Dict:
    with open(os.path.join(root, "attrs.json")) as f:
        return json.load(f)


def _tensor(a, cfg: Config, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=cfg.torch_dtype, device=device)


# -- restart (io_pnetcdf.F:1661-2083 / 2420-2769) --------------------------

def write_restart(path: str, state: State, iint: int,
                  time0: float = 0.0) -> None:
    """Checkpoint every State field and the step counter: bit-seamless,
    since State carries every leapfrog time level and the closure state."""
    for f in dataclasses.fields(State):
        write_array(path, f.name, getattr(state, f.name))
    _write_attrs(path, {"iint": int(iint), "time0": float(time0),
                        "format": "extpom_tpu.restart.v1"})


def read_restart(path: str, cfg: Config, device, blocks=None):
    """Returns (state, iint, time0), the state in cfg's dtype on
    ``device``.  With ``blocks`` (``mesh.shardmap.Blocks``, under several
    processes) each block's hyperslab of every field is read into it
    instead (``Blocks.load_state``) and the state returned is None."""
    attrs = _read_attrs(path)
    if blocks is not None:
        arrays = {f: zarr.Array(os.path.join(path, f))
                  for f in State.field_names()}
        blocks.load_state(lambda f, i, j: arrays[f][..., i[0]:i[1],
                                                    j[0]:j[1]])
        return None, attrs["iint"], attrs["time0"]
    fields = {f.name: _tensor(read_array(path, f.name), cfg, device)
              for f in dataclasses.fields(State)}
    return State(**fields), attrs["iint"], attrs["time0"]


# -- output snapshots (io_pnetcdf.F:57-410) --------------------------------

OUTPUT_GRID_VARS = ("z", "zz", "dx", "dy", "east_e", "north_e", "east_c",
                    "north_c", "east_u", "north_u", "east_v", "north_v",
                    "rot", "h", "fsm", "dum", "dvm")


def write_output(path: str, grid: Grid, cfg: Config, state,
                 time_days: float, stats: Optional[Dict] = None,
                 extra: Optional[Dict] = None) -> None:
    """One snapshot dataset: grid, prognostic fields and the diagnostics of
    ``stats``; ``extra`` adds derived fields (``wr`` under calc_wr)."""
    for name in OUTPUT_GRID_VARS:
        write_array(path, name, getattr(grid, name))
    for name in OUTPUT_FIELDS:
        write_array(path, name, getattr(state, name))
    for name, arr in (extra or {}).items():
        write_array(path, name, arr)
    attrs = {"time_days": float(time_days), "tbias": cfg.tbias,
             "sbias": cfg.sbias, "format": "extpom_tpu.output.v1"}
    if stats:
        attrs["stats"] = {k: float(v) for k, v in stats.items()}
    _write_attrs(path, attrs)


def read_output(path: str) -> Dict[str, np.ndarray]:
    out = {name: read_array(path, name)
           for name in OUTPUT_GRID_VARS + OUTPUT_FIELDS}
    out["attrs"] = _read_attrs(path)
    return out


# -- grid and initial conditions (io_pnetcdf.F:2084-2264, 2771-2844) --------

GRID_VARS = ("z", "zz", "dx", "dy", "east_e", "north_e", "rot", "h", "fsm")


def write_grid(path: str, grid: Grid) -> None:
    """The primary grid variables; masks, metrics and cbc are derived again
    on read, as read_grid_pnetcdf derives dum/dvm from fsm."""
    for name in GRID_VARS:
        write_array(path, name, getattr(grid, name))
    _write_attrs(path, {"format": "extpom_tpu.grid.v1"})


def read_grid(path: str, cfg: Config, device) -> Grid:
    v = {name: read_array(path, name) for name in GRID_VARS}
    return make_grid(cfg, v["z"], v["zz"], v["dx"], v["dy"], v["h"],
                     v["fsm"], east_e=v["east_e"], north_e=v["north_e"],
                     rot=v["rot"], device=device)


def write_initial_ts(path: str, tb, sb, tclim=None, sclim=None) -> None:
    write_array(path, "tb", tb)
    write_array(path, "sb", sb)
    if tclim is not None:
        write_array(path, "tclim", tclim)
    if sclim is not None:
        write_array(path, "sclim", sclim)
    _write_attrs(path, {"format": "extpom_tpu.init.v1",
                        "has_clim": tclim is not None})


def read_initial_ts(path: str):
    """Numpy (tb, sb, tclim, sclim); tclim/sclim are tb/sb without a
    climatology."""
    attrs = _read_attrs(path)
    tb = read_array(path, "tb")
    sb = read_array(path, "sb")
    if attrs.get("has_clim"):
        return tb, sb, read_array(path, "tclim"), read_array(path, "sclim")
    return tb, sb, tb, sb


def write_aux(path: str, grid: Grid, cfg: Config, state: State,
              time_days: float = 0.0, extra: Optional[Dict] = None) -> None:
    """Full-state debug dump (the write_aux_pnetcdf equivalent,
    io_pnetcdf.F:413-1658): every State field, all time levels, the grid
    fields of a snapshot and any derived arrays in ``extra``, each through
    :func:`write_array`."""
    for f in dataclasses.fields(State):
        write_array(path, f.name, getattr(state, f.name))
    for name in OUTPUT_GRID_VARS:
        write_array(path, name, getattr(grid, name))
    for name, arr in (extra or {}).items():
        write_array(path, name, arr)
    _write_attrs(path, {"time_days": float(time_days),
                        "format": "extpom_tpu.aux.v1"})


# -- forcing record source (the .sfrc/.lbry series readers) ----------------

class ZarrSource:
    """Record source over a Zarr dataset directory: each variable has a
    leading record dimension; ``read(name, n)`` fetches one record (the
    index clamped to the series)."""

    def __init__(self, root: str):
        self.root = root
        self._arrays: Dict[str, zarr.Array] = {}
        self._names = [d for d in os.listdir(root)
                       if os.path.isdir(os.path.join(root, d))]

    def names(self):
        return list(self._names)

    def _array(self, name: str) -> zarr.Array:
        a = self._arrays.get(name)
        if a is None:
            a = self._arrays[name] = zarr.Array(os.path.join(self.root, name))
        return a

    def nrec(self, name: str) -> int:
        return self._array(name).shape[0]

    def read(self, name: str, n: int) -> np.ndarray:
        a = self._array(name)
        return a[min(max(n, 0), a.shape[0] - 1)]


def write_forcing_series(root: str, data: Dict[str, np.ndarray]) -> None:
    """A forcing series dataset for :class:`ZarrSource` (record dimension
    leading, one chunk per record)."""
    for name, arr in data.items():
        a = np.asarray(arr)
        write_array(root, name, a, chunks=(1,) + a.shape[1:])
