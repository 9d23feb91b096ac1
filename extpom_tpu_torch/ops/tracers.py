"""Tracer and turbulence-quantity advection (``extpom_tpu/ops/tracers.py``):
``advq`` (solver.f:411-477) and the central scheme ``advt1``
(solver.f:480-574).  MPDATA (``nadv=2``) is not ported yet."""

from __future__ import annotations

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.ops.stencil import sft, sfk, put, set_k, s_


def advq(grid: Grid, cfg: Config, qb, q, u, v, w, aam, dt, etb,
         etf) -> torch.Tensor:
    """Advect a turbulence quantity (q2 or q2l) -> qf."""
    h, dx, dy, art = grid.h, grid.dx, grid.dy, grid.art
    K2 = slice(1, cfg.kbm1)
    z3 = torch.zeros_like(q)

    xflux = put(z3, (0.125 * (q + sft(q, -1, 0)) * (dt + sft(dt, -1, 0))
         * (u + sfk(u, -1))), *s_[K2, 1:, 1:])
    yflux = put(z3, (0.125 * (q + sft(q, 0, -1)) * (dt + sft(dt, 0, -1))
         * (v + sfk(v, -1))), *s_[K2, 1:, 1:])
    xflux = put(xflux, (0.5 * (dy + sft(dy, -1, 0))
         * (xflux
            - 0.25 * (aam + sft(aam, -1, 0) + sfk(aam, -1)
                      + sfk(sft(aam, -1, 0), -1))
            * (h + sft(h, -1, 0)) * (qb - sft(qb, -1, 0)) * grid.dum
            / (dx + sft(dx, -1, 0)))), *s_[K2, 1:, 1:])
    yflux = put(yflux, (0.5 * (dx + sft(dx, 0, -1))
         * (yflux
            - 0.25 * (aam + sft(aam, 0, -1) + sfk(aam, -1)
                      + sfk(sft(aam, 0, -1), -1))
            * (h + sft(h, 0, -1)) * (qb - sft(qb, 0, -1)) * grid.dvm
            / (dy + sft(dy, 0, -1)))), *s_[K2, 1:, 1:])

    qf = put(z3, (((sfk(w, -1) * sfk(q, -1) - sfk(w, 1) * sfk(q, 1)) * art
          / (grid.dz3 + sfk(grid.dz3, -1))
          + sft(xflux, 1, 0) - xflux + sft(yflux, 0, 1) - yflux)), *s_[K2, 1:-1, 1:-1])
    qf = put(qf, (((h + etb) * art * qb - cfg.dti2 * qf) / ((h + etf) * art)), *s_[K2, 1:-1, 1:-1])
    return qf


def _horizontal_diff_fluxes(grid: Grid, cfg: Config, fbmc: torch.Tensor,
                            aam: torch.Tensor):
    """Climatology-deviation diffusive fluxes; fbmc = fb - fclim."""
    h, dx, dy = grid.h, grid.dx, grid.dy
    xdif = (-0.5 * (aam + sft(aam, -1, 0)) * (h + sft(h, -1, 0)) * cfg.tprni
            * (fbmc - sft(fbmc, -1, 0)) * grid.dum / (dx + sft(dx, -1, 0)))
    ydif = (-0.5 * (aam + sft(aam, 0, -1)) * (h + sft(h, 0, -1)) * cfg.tprni
            * (fbmc - sft(fbmc, 0, -1)) * grid.dvm / (dy + sft(dy, 0, -1)))
    return xdif, ydif


def advt1(grid: Grid, cfg: Config, fb, f, fclim, u, v, w, aam, dt, etb,
          etf) -> torch.Tensor:
    """Central-difference tracer step -> ff."""
    h, dx, dy, art = grid.h, grid.dx, grid.dy, grid.art
    kbm1 = cfg.kbm1
    KM1 = slice(0, kbm1)
    z3 = torch.zeros_like(f)

    # ghost bottom layer (solver.f:495-496)
    f = set_k(f, -1, f[cfg.kb - 2])
    fb = set_k(fb, -1, fb[cfg.kb - 2])

    xflux = put(z3, (0.25 * (dt + sft(dt, -1, 0)) * (f + sft(f, -1, 0)) * u), *s_[KM1, 1:, 1:])
    yflux = put(z3, (0.25 * (dt + sft(dt, 0, -1)) * (f + sft(f, 0, -1)) * v), *s_[KM1, 1:, 1:])

    xdif, ydif = _horizontal_diff_fluxes(grid, cfg, fb - fclim, aam)
    xflux = put(xflux, (0.5 * (dy + sft(dy, -1, 0)) * (xflux + xdif)), *s_[KM1, 1:, 1:])
    yflux = put(yflux, (0.5 * (dx + sft(dx, 0, -1)) * (yflux + ydif)), *s_[KM1, 1:, 1:])

    zflux = put(z3, f[0] * w[0] * art, *s_[0, 1:-1, 1:-1])
    zflux = put(zflux, (0.5 * (sfk(f, -1) + f) * w * art), *s_[1:kbm1, 1:-1, 1:-1])

    ff = put(z3, (sft(xflux, 1, 0) - xflux + sft(yflux, 0, 1) - yflux
         + (zflux - sfk(zflux, 1)) / grid.dz3), *s_[KM1, 1:-1, 1:-1])
    ff = put(ff, ((fb * (h + etb) * art - cfg.dti2 * ff) / ((h + etf) * art)), *s_[KM1, 1:-1, 1:-1])
    return ff
