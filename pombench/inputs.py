"""The inputs of a run, made by the benchmark from its configuration file and
``--seed`` and handed alike to the port and to the reference: the grid's
metrics as host arrays, and the initial elevation, depth-mean velocities,
temperature and salinity made on the device.

A configuration names its ``case``; the case is the module
``pombench/cases/<case>.py``, whose ``make(conf, seed, device, dtype)``
returns the :class:`Inputs`.  The seed draws what the case draws (for the
seamount, the phases of a smooth perturbation of the initial temperature
and salinity, the same modes and amplitudes for every seed, so every seed
does the same work); geometry and options do not depend on it.

A forced case also gives its climatology (``tclim``, ``sclim``; the
initial fields where it gives none) and forcing series (``series``: name
-> a ``(nrec, ...)`` float64 host array, one record per period of its
dataset, named as bounds_forcing.f's datasets name them, :data:`SERIES`),
each dataset's records the period of bounds_forcing.f apart
(:data:`PERIODS`).  The port stages them through its
``ForcingProvider`` (:mod:`pombench.program`); the reference interpolates
them itself (:func:`pombench.reference.model.forcing_at`).
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    im: int
    jm: int
    kb: int
    namelist: dict           # the Config fields of the run
    z: np.ndarray            # (kb,) sigma levels
    zz: np.ndarray           # (kb,) mid-layers
    dx: np.ndarray           # (im, jm) metrics, float64 on the host
    dy: np.ndarray
    h: np.ndarray
    fsm: np.ndarray
    cor: np.ndarray
    tb: torch.Tensor         # (kb, im, jm) on the device, in the run's dtype
    sb: torch.Tensor
    elb: torch.Tensor        # (im, jm)
    uab: torch.Tensor
    vab: torch.Tensor
    series: dict = dataclasses.field(default_factory=dict)
    tclim: Optional[torch.Tensor] = None   # (kb, im, jm) like tb
    sclim: Optional[torch.Tensor] = None


# the series a case may give, by the dataset of bounds_forcing.f that holds
# them: the lateral records (lateral_bc, :593-868), the surface records
# (wind, heat and surface, :871-983) and the interior restoring records
# (restore_interior, :1023-1121).  The water series stays out: advance.f:89
# leaves water uncalled.  The depth-mean edge velocities uab*/vab* are no
# series: they are formed from the ub*/vb* profiles (:626-635).
SIDES = ("w", "e", "s", "n")
SERIES = {
    "lbry": tuple(f"el{s}" for s in SIDES)
    + tuple(f"{v}b{s}" for v in "tsuv" for s in SIDES),
    "sfrc": ("wusurf", "wvsurf", "wtsurf", "swrad", "tsurf", "ssurf"),
    "clim": ("trstr", "srstr", "taurstr"),
}
# each dataset's record period in days (bounds_forcing.f:607 tbc, :886
# twind, :929 theat, :1033 trst)
PERIODS = {"lbry": 1.0 / 24.0, "sfrc": 0.125, "clim": 30.0}


def dataset(name: str) -> str:
    """The dataset of :data:`SERIES` that holds the series ``name``."""
    for d, names in SERIES.items():
        if name in names:
            return d
    raise ValueError(f"no forcing series {name!r}: a case gives "
                     f"{', '.join(n for v in SERIES.values() for n in v)}")


def rng(seed: int) -> np.random.Generator:
    """The generator of a run's draws: any whole number is a seed."""
    return np.random.default_rng(seed % 2 ** 64)


def sigma_levels(kb: int, stretched: bool) -> tuple:
    """Sigma levels z and mid-layers zz: tanh-stretched toward the surface
    (POM's seamount) or uniform."""
    if stretched:
        s = np.linspace(0.0, 1.0, kb)
        c = np.tanh(2.0)
        z = -(np.tanh(2.0 * s) + s * (1.0 - c)) / (c + (1.0 - c))
        z[0], z[-1] = 0.0, -1.0
    else:
        z = -np.linspace(0.0, 1.0, kb)
    zz = np.zeros(kb)
    zz[:-1] = 0.5 * (z[:-1] + z[1:])
    zz[-1] = 2.0 * zz[-2] - zz[-3]
    return z, zz


def pattern(im: int, jm: int, modes, phases, device) -> torch.Tensor:
    """A smooth (im, jm) field in [-1, 1]: the mean of cosines of the given
    integer wavenumbers (along i, along j) at the drawn phases, float64."""
    x = torch.arange(im, dtype=torch.float64, device=device)[:, None] / im
    y = torch.arange(jm, dtype=torch.float64, device=device)[None, :] / jm
    p = torch.zeros((im, jm), dtype=torch.float64, device=device)
    for (a, b), ph in zip(modes, phases):
        p += torch.cos(2.0 * math.pi * (a * x + b * y) + float(ph))
    return p / len(modes)


def perturbed(base: torch.Tensor, zz, amp: float, pat: torch.Tensor,
              dtype) -> torch.Tensor:
    """(kb, im, jm) field: ``base`` plus ``amp`` times the pattern,
    weighted (1 + zz) so that it fades toward the bottom; the bottom level
    repeats the one above, as POM's initial fields do."""
    w = torch.as_tensor(1.0 + zz, dtype=torch.float64,
                        device=pat.device)[:, None, None]
    f = (base + amp * w * pat[None]).to(dtype)
    f[-1] = f[-2]
    return f.contiguous()


def namelist(conf: dict) -> dict:
    """The Config fields of a configuration: its ``config`` block and the
    case's sizes and biases."""
    a = conf["case_args"]
    return dict(conf["config"], im=a["im"], jm=a["jm"], kb=a["kb"],
                tbias=a["tbias"], sbias=a["sbias"])


def make(conf: dict, traffic: dict, seed: int, device) -> Inputs:
    """The inputs of configuration ``conf`` under ``traffic``'s namelist
    overrides for ``seed``, the fields on ``device`` in the run's dtype."""
    dtype = getattr(torch, conf["config"]["dtype"])
    case = importlib.import_module(f"pombench.cases.{conf['case']}")
    inp = case.make(conf, seed, device, dtype)
    inp.namelist.update(traffic.get("namelist", {}))
    return inp
