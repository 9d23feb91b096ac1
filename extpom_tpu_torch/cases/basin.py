"""Wind-driven basin case (``extpom_tpu/cases/basin.py``): a closed
rectangular basin on a beta plane under a zonal wind of uniform negative
curl, whose anticyclonic gyre intensifies against the western wall
(Stommel 1948, Munk 1950).  Mode 2 (external only) with Orlanski edges by
default; the closed ring of land makes the masks rule the edges anyway.

The wind enters through the surface momentum flux ``wusurf`` with the
reference's sign convention (wusurf = -tau_x / rho: advance.f:280 adds
``+ (wusurf - wubot) * aru`` into a tendency applied with an overall
minus)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from extpom_tpu_torch.cases.seamount import resolve_device
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid, make_grid, sigma_levels


def basin_case(im: int = 51, jm: int = 51, kb: int = 5,
               length: float = 1.0e6, depth: float = 500.0,
               f0: float = 5.0e-5, beta: float = 2.0e-11, tau0: float = 0.1,
               tbias: float = 10.0, sbias: float = 35.0, device=None,
               **cfg_kw) -> Tuple[Config, Grid, dict, np.ndarray]:
    """Build (cfg, grid, ics, wusurf): ``length`` is the basin's side in m,
    ``tau0`` the wind-stress amplitude in N/m^2, and ``wusurf`` the (im, jm)
    kinematic surface momentum flux of tau_x(y) = -tau0 cos(pi y / L)."""
    device = resolve_device(device)
    cfg_kw.setdefault("mode", 2)
    cfg_kw.setdefault("bc_scheme", "orlanski")
    cfg_kw.setdefault("dte", 60.0)
    cfg_kw.setdefault("isplit", 10)
    cfg_kw.setdefault("lramp", False)
    cfg = Config(im=im, jm=jm, kb=kb, **cfg_kw)

    dx0 = length / (im - 2)
    z, zz = sigma_levels(kb)
    fsm = np.ones((im, jm))
    fsm[0, :] = fsm[-1, :] = fsm[:, 0] = fsm[:, -1] = 0.0   # closed ring
    y = (np.arange(jm) - 1.0)[None, :] * dx0                # from s. wall
    cor = f0 + beta * np.broadcast_to(y, (im, jm))
    grid = make_grid(cfg, z, zz, np.full((im, jm), dx0),
                     np.full((im, jm), dx0), np.full((im, jm), depth), fsm,
                     cor=cor, device=device)

    rho0 = 1025.0
    wusurf = (tau0 / rho0) * np.cos(np.pi * y / length) * np.ones((im, 1))
    wusurf = wusurf * grid.dum.cpu().numpy()     # no stress through walls

    tb = np.full((kb, im, jm), tbias)
    sb = np.full((kb, im, jm), sbias)
    ics = dict(tb=tb, sb=sb, tclim=tb, sclim=sb)
    return cfg, grid, ics, wusurf


def basin_model(device: Optional[str] = None, **kw):
    """A ready-to-run Model of the basin, on the card unless ``device``
    says otherwise, with the wind in ``base_forcing.wusurf``."""
    from extpom_tpu_torch.core.model import Model
    cfg, grid, ics, wusurf = basin_case(device=device, **kw)
    m = Model(grid, cfg, tb=ics["tb"], sb=ics["sb"], tclim=ics["tclim"],
              sclim=ics["sclim"])
    m.base_forcing = m.base_forcing.replace(
        wusurf=torch.as_tensor(wusurf, dtype=grid.dtype, device=grid.device))
    return m
