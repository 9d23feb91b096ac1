"""Seamount test case (``extpom_tpu/cases/seamount.py``): a stratified
f-plane basin with a Gaussian seamount, uniform zonal inflow and open
boundaries."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid, make_grid, sigma_levels


def resolve_device(device) -> torch.device:
    """``None`` means the card: raise when there is no CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def seamount_case(im: int = 65, jm: int = 49, kb: int = 21,
                  dx0: float = 8000.0, depth: float = 4500.0,
                  delh: float = 0.9, ra: float = 25000.0, lat: float = 45.0,
                  vel: float = 0.2, tbias: float = 10.0, sbias: float = 20.0,
                  stretched: bool = True, device=None,
                  **cfg_kw) -> Tuple[Config, Grid, dict]:
    """Build (cfg, grid, ics); ``ics`` holds numpy arrays tb, sb, tclim,
    sclim (kb, im, jm) and elb, uab, vab (im, jm)."""
    device = resolve_device(device)
    cfg_kw.setdefault("mode", 3)
    cfg_kw.setdefault("bc_scheme", "extpom")
    cfg_kw.setdefault("dte", 6.0)
    cfg_kw.setdefault("isplit", 30)
    cfg_kw.setdefault("lramp", True)
    cfg = Config(im=im, jm=jm, kb=kb, tbias=tbias, sbias=sbias, **cfg_kw)

    z, zz = sigma_levels(kb, kl1=6 if stretched else None)
    dx = np.full((im, jm), dx0)
    dy = np.full((im, jm), dx0)
    x = (np.arange(im) - (im - 1) / 2.0)[:, None] * dx0
    y = (np.arange(jm) - (jm - 1) / 2.0)[None, :] * dx0
    h = depth * (1.0 - delh * np.exp(-(x ** 2 + y ** 2) / ra ** 2))
    h[0, :] = h[1, :]
    h[-1, :] = h[-2, :]
    h[:, 0] = h[:, 1]
    h[:, -1] = h[:, -2]
    fsm = np.ones((im, jm))
    cor = np.full((im, jm), 2.0 * 7.29e-5 * np.sin(np.deg2rad(lat)))
    grid = make_grid(cfg, z, zz, dx, dy, h, fsm, cor=cor, device=device)

    tb = 5.0 + 15.0 * np.exp(zz[:, None, None] * h[None] / 1000.0) - tbias
    tb = np.broadcast_to(tb, (kb, im, jm)).copy()
    tb[-1] = tb[-2]
    sb = np.full((kb, im, jm), 35.0 - sbias)
    uab = np.full((im, jm), vel)
    vab = np.zeros((im, jm))
    elb = np.zeros((im, jm))
    ics = dict(tb=tb, sb=sb, tclim=tb.copy(), sclim=sb.copy(),
               elb=elb, uab=uab, vab=vab)
    return cfg, grid, ics


def seamount_model(device: Optional[str] = None, **kw):
    """A ready-to-run Model of the seamount case, on the card unless
    ``device`` says otherwise."""
    from extpom_tpu_torch.core.model import Model
    cfg, grid, ics = seamount_case(device=device, **kw)
    return Model(grid, cfg, tb=ics["tb"], sb=ics["sb"],
                 tclim=ics["tclim"], sclim=ics["sclim"],
                 elb=ics["elb"], uab=ics["uab"], vab=ics["vab"])
