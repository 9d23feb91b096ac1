"""Momentum advection (``extpom_tpu/ops/momentum.py``): horizontal terms
``advct`` (solver.f:201-408) and the u/v updates ``advu``/``advv``
(solver.f:734-845).  3-D arrays are (kb, im, jm)."""

from __future__ import annotations

from typing import Tuple

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.ops.stencil import sft, sfk, put, s_


def advct(grid: Grid, cfg: Config, u: torch.Tensor, v: torch.Tensor,
          ub: torch.Tensor, vb: torch.Tensor, aam: torch.Tensor,
          dt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Horizontal advection + diffusion of momentum -> (advx, advy)."""
    dx, dy = grid.dx, grid.dy
    KM1 = slice(0, cfg.kbm1)
    z3 = torch.zeros_like(u)

    dx4 = dx + sft(dx, -1, 0) + sft(dx, 0, -1) + sft(dx, -1, -1)
    dy4 = dy + sft(dy, -1, 0) + sft(dy, 0, -1) + sft(dy, -1, -1)
    dt4 = dt + sft(dt, -1, 0) + sft(dt, 0, -1) + sft(dt, -1, -1)
    aam4 = aam + sft(aam, -1, 0) + sft(aam, 0, -1) + sft(aam, -1, -1)
    dtaam = 0.25 * dt4 * aam4

    curv = put(z3, (0.25 * ((sft(v, 0, 1) + v) * (sft(dy, 1, 0) - sft(dy, -1, 0))
                 - (sft(u, 1, 0) + u) * (sft(dx, 0, 1) - sft(dx, 0, -1)))
         / (dx * dy)), *s_[KM1, 1:-1, 1:-1])

    # ---- x-component ----
    xflux = put(z3, (0.125 * ((sft(dt, 1, 0) + dt) * sft(u, 1, 0)
                  + (dt + sft(dt, -1, 0)) * u)
         * (sft(u, 1, 0) + u)), *s_[KM1, 1:-1, :])
    yflux = put(z3, (0.125 * ((dt + sft(dt, 0, -1)) * v
                  + (sft(dt, -1, 0) + sft(dt, -1, -1)) * sft(v, -1, 0))
         * (u + sft(u, 0, -1))), *s_[KM1, 1:, 1:])
    xflux = put(xflux, (dy * (xflux - dt * aam * 2.0 * (sft(ub, 1, 0) - ub) / dx)), *s_[KM1, 1:-1, 1:])
    yflux = put(yflux, (0.25 * dx4 * (yflux
                       - dtaam * ((ub - sft(ub, 0, -1)) / dy4
                                  + (vb - sft(vb, -1, 0)) / dx4))), *s_[KM1, 1:-1, 1:])

    advx = put(z3, (xflux - sft(xflux, -1, 0) + sft(yflux, 0, 1) - yflux), *s_[KM1, 1:-1, 1:-1])
    advx = put(advx, (advx - grid.aru * 0.25
         * (curv * dt * (sft(v, 0, 1) + v)
            + sft(curv, -1, 0) * sft(dt, -1, 0)
            * (sft(v, -1, 1) + sft(v, -1, 0)))), *s_[KM1, 2:-1, 1:-1])

    # ---- y-component ----
    xflux = put(z3, (0.125 * ((dt + sft(dt, -1, 0)) * u
                  + (sft(dt, 0, -1) + sft(dt, -1, -1)) * sft(u, 0, -1))
         * (v + sft(v, -1, 0))), *s_[KM1, 1:, 1:])
    yflux = put(z3, (0.125 * ((sft(dt, 0, 1) + dt) * sft(v, 0, 1)
                  + (dt + sft(dt, 0, -1)) * v)
         * (sft(v, 0, 1) + v)), *s_[KM1, :, 1:-1])
    xflux = put(xflux, (0.25 * dy4 * (xflux
                       - dtaam * ((ub - sft(ub, 0, -1)) / dy4
                                  + (vb - sft(vb, -1, 0)) / dx4))), *s_[KM1, 1:, 1:-1])
    yflux = put(yflux, (dx * (yflux - dt * aam * 2.0 * (sft(vb, 0, 1) - vb) / dy)), *s_[KM1, 1:, 1:-1])

    advy = put(z3, (sft(xflux, 1, 0) - xflux + yflux - sft(yflux, 0, -1)), *s_[KM1, 1:-1, 1:-1])
    advy = put(advy, (advy + grid.arv * 0.25
         * (curv * dt * (sft(u, 1, 0) + u)
            + sft(curv, 0, -1) * sft(dt, 0, -1)
            * (sft(u, 1, -1) + sft(u, 0, -1)))), *s_[KM1, 1:-1, 2:-1])
    return advx, advy


def advu(grid: Grid, cfg: Config, u, ub, v, w, advx, drhox, dt,
         egf, egb, e_atmos, etb, etf) -> torch.Tensor:
    """Full u-momentum tendency + leapfrog step -> uf."""
    h, dy, aru, cor = grid.h, grid.dy, grid.aru, grid.cor
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)
    z3 = torch.zeros_like(u)

    # vertical advection kept apart so the combine reads the k+1 value
    # before it is overwritten, like the ascending-k Fortran loop
    vadv = put(z3, (0.25 * (w + sft(w, -1, 0)) * (u + sfk(u, -1))), *s_[1:kbm1, 1:, :])

    uf = put(z3, (advx
         + (vadv - sfk(vadv, 1)) * aru / grid.dz3
         - aru * 0.25 * (cor * dt * (sft(v, 0, 1) + v)
                         + sft(cor, -1, 0) * sft(dt, -1, 0)
                         * (sft(v, -1, 1) + sft(v, -1, 0)))
         + cfg.grav * 0.125 * (dt + sft(dt, -1, 0))
         * (egf - sft(egf, -1, 0) + egb - sft(egb, -1, 0)
            + (e_atmos - sft(e_atmos, -1, 0)) * 2.0)
         * (dy + sft(dy, -1, 0))
         + drhox), *s_[KM1, 1:-1, 1:-1])
    # outside the combine region uf holds the raw vertical advection
    uf = put(uf, vadv, *s_[1:kbm1, :, 0:1])
    uf = put(uf, vadv, *s_[1:kbm1, :, -1:])
    uf = put(uf, vadv, *s_[1:kbm1, -1:, 1:-1])

    uf = put(uf, (((h + etb + sft(h, -1, 0) + sft(etb, -1, 0)) * aru * ub
          - 2.0 * cfg.dti2 * uf)
         / ((h + etf + sft(h, -1, 0) + sft(etf, -1, 0)) * aru)), *s_[KM1, 1:-1, 1:-1])
    return uf


def advv(grid: Grid, cfg: Config, v, vb, u, w, advy, drhoy, dt,
         egf, egb, e_atmos, etb, etf) -> torch.Tensor:
    """Full v-momentum tendency + leapfrog step -> vf."""
    h, dx, arv, cor = grid.h, grid.dx, grid.arv, grid.cor
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)
    z3 = torch.zeros_like(v)

    vadv = put(z3, (0.25 * (w + sft(w, 0, -1)) * (v + sfk(v, -1))), *s_[1:kbm1, :, 1:])

    vf = put(z3, (advy
         + (vadv - sfk(vadv, 1)) * arv / grid.dz3
         + arv * 0.25 * (cor * dt * (sft(u, 1, 0) + u)
                         + sft(cor, 0, -1) * sft(dt, 0, -1)
                         * (sft(u, 1, -1) + sft(u, 0, -1)))
         + cfg.grav * 0.125 * (dt + sft(dt, 0, -1))
         * (egf - sft(egf, 0, -1) + egb - sft(egb, 0, -1)
            + (e_atmos - sft(e_atmos, 0, -1)) * 2.0)
         * (dx + sft(dx, 0, -1))
         + drhoy), *s_[KM1, 1:-1, 1:-1])
    vf = put(vf, vadv, *s_[1:kbm1, 0:1, :])
    vf = put(vf, vadv, *s_[1:kbm1, -1:, :])
    vf = put(vf, vadv, *s_[1:kbm1, 1:-1, -1:])

    vf = put(vf, (((h + etb + sft(h, 0, -1) + sft(etb, 0, -1)) * arv * vb
          - 2.0 * cfg.dti2 * vf)
         / ((h + etf + sft(h, 0, -1) + sft(etf, 0, -1)) * arv)), *s_[KM1, 1:-1, 1:-1])
    return vf
