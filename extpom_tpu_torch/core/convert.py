"""Carry a model across from the JAX package: its ``Grid``/``State``/
``Forcing`` arrive as dicts of numpy arrays (``np.asarray`` of each field
on the JAX side), so this package never sees a JAX object."""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.core.state import Forcing, State


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                       dtype=dtype)


def _fields(cls, src: Mapping[str, np.ndarray], device, dtype) -> dict:
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [n for n in names if n not in src]
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {missing}")
    return {n: _tensor(src[n], device, dtype) for n in names}


def from_numpy(cfg: Config, grid: Mapping, state: Mapping,
               forcing: Mapping, rmean, tclim, sclim, device,
               dtype=None):
    """Returns the port's (grid, state, forcing, rmean, tclim, sclim)."""
    dtype = cfg.torch_dtype if dtype is None else dtype
    t = lambda a: _tensor(a, device, dtype)
    return (Grid(**_fields(Grid, grid, device, dtype)),
            State(**_fields(State, state, device, dtype)),
            Forcing(**_fields(Forcing, forcing, device, dtype)),
            t(rmean), t(tclim), t(sclim))


def plan_from_numpy(names, cadences, offsets, interp, stacks, starts,
                    device, dtype):
    """A ``forcing.device.DevicePlan`` from the fields of the JAX
    package's (its record stacks as numpy arrays, its window starts as
    ints), so that both packages interpolate the same records."""
    from extpom_tpu_torch.forcing.device import DevicePlan
    return DevicePlan(tuple(names), tuple(float(c) for c in cadences),
                      tuple(float(o) for o in offsets),
                      tuple(bool(i) for i in interp),
                      tuple(_tensor(s, device, dtype) for s in stacks),
                      tuple(int(s) for s in starts))


def model_from_numpy(cfg: Config, grid: Mapping, state: Mapping,
                     forcing: Mapping, rmean, tclim, sclim, device,
                     iint: int = 0, dtype=None):
    """The port's Model resumed from the JAX model's dicts (see
    :func:`from_numpy`): every grid field (cbc and cor included), the State
    and the base Forcing (a case's wind in ``wusurf`` included), so that
    both models step from the same arrays."""
    from extpom_tpu_torch.core.model import Model
    g, st, fc, rm, tc, sc = from_numpy(cfg, grid, state, forcing, rmean,
                                       tclim, sclim, device, dtype)
    return Model(g, cfg, state=st, rmean=rm, tclim=tc, sclim=sc,
                 base_forcing=fc, iint=iint)
