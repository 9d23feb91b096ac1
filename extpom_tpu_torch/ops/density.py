"""Equation of state (``extpom_tpu/ops/density.py``; solver.f:1162-1209)."""

from __future__ import annotations

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.ops.stencil import set_k


def dens(grid: Grid, cfg: Config, s: torch.Tensor,
         t: torch.Tensor) -> torch.Tensor:
    """(density - 1000) / rhoref on layers 0..kb-2; layer kb-1 is 0.
    ``s``/``t`` are anomalies (bias removed), shape (kb, im, jm)."""
    tr = t + cfg.tbias
    sr = s + cfg.sbias
    tr2 = tr * tr
    tr3 = tr2 * tr
    tr4 = tr3 * tr

    p = cfg.grav * cfg.rhoref * (-grid.zz3 * grid.h) * 1.0e-5

    rhor = (-0.157406 + 6.793952e-2 * tr - 9.095290e-3 * tr2
            + 1.001685e-4 * tr3 - 1.120083e-6 * tr4 + 6.536332e-9 * tr4 * tr)
    rhor = rhor + ((0.824493 - 4.0899e-3 * tr + 7.6438e-5 * tr2
                    - 8.2467e-7 * tr3 + 5.3875e-9 * tr4) * sr
                   + (-5.72466e-3 + 1.0227e-4 * tr - 1.6546e-6 * tr2)
                   * torch.abs(sr) ** 1.5
                   + 4.8314e-4 * sr * sr)

    cr = 1449.1 + 0.0821 * p + 4.55 * tr - 0.045 * tr2 + 1.34 * (sr - 35.0)
    rhor = rhor + 1.0e5 * p / (cr * cr) * (1.0 - 2.0 * p / (cr * cr))

    rho = rhor / cfg.rhoref * grid.fsm
    return set_k(rho, -1, 0.0)
