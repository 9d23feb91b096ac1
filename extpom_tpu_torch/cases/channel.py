"""Idealized channel with open east/west ends (``extpom_tpu/cases/channel.py``;
BASELINE config 3).

A zonal channel: solid north/south walls (land rows of ``fsm``), open west
and east ends driven by a boundary-elevation record series through the
lateral boundary conditions, as the reference feeds them from its
``.lbry.nc`` series (bounds_forcing.f:593-868).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from extpom_tpu_torch.cases.seamount import resolve_device
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid, make_grid, sigma_levels
from extpom_tpu_torch.forcing.provider import (ArraySource, ForcingProvider,
                                               TBC)


def channel_case(im: int = 97, jm: int = 33, kb: int = 16,
                 dx0: float = 5000.0, depth: float = 100.0,
                 lat: float = 45.0, tide_amp: float = 0.5,
                 tide_period_days: float = 0.517525,   # M2
                 n_days: float = 2.0, tbias: float = 10.0,
                 sbias: float = 20.0, device=None,
                 **cfg_kw) -> Tuple[Config, Grid, dict, ArraySource]:
    """Build (cfg, grid, ics, bry_source) on ``device`` (the card unless
    given).  ``bry_source`` holds ``elw``/``ele`` records at the lateral
    cadence: a tidal elevation at the west end, zero at the east."""
    device = resolve_device(device)
    cfg_kw.setdefault("mode", 3)
    cfg_kw.setdefault("bc_scheme", "extpom")
    cfg_kw.setdefault("dte", 6.0)
    cfg_kw.setdefault("isplit", 30)
    cfg_kw.setdefault("lramp", False)
    cfg = Config(im=im, jm=jm, kb=kb, tbias=tbias, sbias=sbias, **cfg_kw)

    z, zz = sigma_levels(kb)
    dx = np.full((im, jm), dx0)
    h = np.full((im, jm), depth)
    fsm = np.ones((im, jm))
    fsm[:, 0] = 0.0          # solid south wall
    fsm[:, -1] = 0.0         # solid north wall
    cor = np.full((im, jm), 2.0 * 7.29e-5 * np.sin(np.deg2rad(lat)))
    grid = make_grid(cfg, z, zz, dx, dx, h, fsm, cor=cor, device=device)

    # weakly stratified T, uniform S
    tb = np.ones((kb, im, jm)) * (
        10.0 + 5.0 * np.exp(zz[:, None, None] * depth / 50.0) - tbias)
    tb[-1] = tb[-2]
    sb = np.full((kb, im, jm), 35.0 - sbias)
    ics = dict(tb=tb, sb=sb, tclim=tb.copy(), sclim=sb.copy(),
               elb=np.zeros((im, jm)), uab=np.zeros((im, jm)),
               vab=np.zeros((im, jm)))

    # west-end tidal elevation record series at the lateral cadence
    nrec = int(np.ceil(n_days / TBC)) + 2
    t_rec = np.arange(nrec) * TBC
    elw = (tide_amp * np.sin(2.0 * np.pi * t_rec / tide_period_days)
           [:, None] * np.ones((nrec, jm)))
    ele = np.zeros((nrec, jm))
    return cfg, grid, ics, ArraySource({"elw": elw, "ele": ele})


def channel_model(device: Optional[str] = None, **kw):
    """A ready-to-run tidal channel Model, on the card unless ``device``
    says otherwise."""
    from extpom_tpu_torch.core.model import Model
    cfg, grid, ics, bry = channel_case(device=device, **kw)
    m = Model(grid, cfg, tb=ics["tb"], sb=ics["sb"], tclim=ics["tclim"],
              sclim=ics["sclim"], elb=ics["elb"], uab=ics["uab"],
              vab=ics["vab"])
    m.forcing_fn = ForcingProvider(grid, cfg, m.base_forcing, bry)
    return m
