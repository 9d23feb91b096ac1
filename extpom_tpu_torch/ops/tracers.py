"""Tracer and turbulence-quantity advection (``extpom_tpu/ops/tracers.py``):
``advq`` (solver.f:411-477), the central scheme ``advt1``
(solver.f:480-574) and, for ``nadv=2``, Smolarkiewicz's MPDATA ``advt2``
(solver.f:577-731) with its antidiffusive velocities ``smol_adif``
(solver.f:1880-1967).

MPDATA's work array ``ff`` starts as ``fb`` (the reference leaves stale
scratch there): the interior is overwritten by every iteration, and the
edge columns and the ghost level keep ``fb`` times ``fsm`` per iteration."""

from __future__ import annotations

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.diag.profiling import span
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


MPDATA_VALUE_MIN = 1.0e-9
MPDATA_EPSILON = 1.0e-14


def smol_adif(grid: Grid, cfg: Config, xmassflux, ymassflux, zwflux, ff,
              dt):
    """MPDATA antidiffusive velocities -> (xmassflux, ymassflux, zwflux,
    ff * fsm); values outside the recomputed regions pass through."""
    value_min, epsilon = MPDATA_VALUE_MIN, MPDATA_EPSILON
    KM1 = slice(0, cfg.kbm1)

    ff = ff * grid.fsm

    # x, region i 1.., j 1..jm-2
    udx = torch.abs(xmassflux)
    u2dt = (cfg.dti2 * xmassflux * xmassflux * 2.0
            / (grid.aru * (sft(dt, -1, 0) + dt)))
    molx = (ff - sft(ff, -1, 0)) / (sft(ff, -1, 0) + ff + epsilon)
    xm_new = torch.where((udx < u2dt) | (ff < value_min)
                         | (sft(ff, -1, 0) < value_min),
                         0.0, (udx - u2dt) * molx * cfg.sw)
    xmassflux = put(xmassflux, xm_new, *s_[KM1, 1:, 1:-1])

    # y, region i 1..im-2, j 1..
    vdy = torch.abs(ymassflux)
    v2dt = (cfg.dti2 * ymassflux * ymassflux * 2.0
            / (grid.arv * (sft(dt, 0, -1) + dt)))
    moly = (ff - sft(ff, 0, -1)) / (sft(ff, 0, -1) + ff + epsilon)
    ym_new = torch.where((vdy < v2dt) | (ff < value_min)
                         | (sft(ff, 0, -1) < value_min),
                         0.0, (vdy - v2dt) * moly * cfg.sw)
    ymassflux = put(ymassflux, ym_new, *s_[KM1, 1:-1, 1:])

    # z, region k 1..kbm1-1 of the interior
    wdz = torch.abs(zwflux)
    w2dt = cfg.dti2 * zwflux * zwflux / sfk(grid.dzz3, -1) / dt
    molz = (sfk(ff, -1) - ff) / (ff + sfk(ff, -1) + epsilon)
    zw_new = torch.where((wdz < w2dt) | (ff < value_min)
                         | (sfk(ff, -1) < value_min),
                         0.0, (wdz - w2dt) * molz * cfg.sw)
    zwflux = put(zwflux, zw_new, *s_[1:cfg.kbm1, 1:-1, 1:-1])
    return xmassflux, ymassflux, zwflux, ff


def mass_fluxes(grid: Grid, cfg: Config, u, v, dt):
    """MPDATA's initial horizontal mass fluxes (solver.f:602-616)."""
    dx, dy = grid.dx, grid.dy
    KM1 = slice(0, cfg.kbm1)
    z3 = torch.zeros_like(u)
    xm = put(z3, (0.25 * (sft(dy, -1, 0) + dy) * (sft(dt, -1, 0) + dt) * u),
             *s_[KM1, 1:, 1:-1])
    ym = put(z3, (0.25 * (sft(dx, 0, -1) + dx) * (sft(dt, 0, -1) + dt) * v),
             *s_[KM1, 1:-1, 1:])
    return xm, ym


def mpdata_upwind(grid: Grid, cfg: Config, fbmem, f, xm, ym, zw, eta, etf,
                  first: bool):
    """One MPDATA upstream step (solver.f:625-677) -> the new interior of
    ff, with ``fbmem`` elsewhere; the surface flux ``w[0] f[0] art`` in the
    first iteration only (``zw`` is then ``w``)."""
    h, art = grid.h, grid.art
    KM1 = slice(0, cfg.kbm1)
    z3 = torch.zeros_like(fbmem)
    xflux = put(z3, (0.5 * ((xm + torch.abs(xm)) * sft(fbmem, -1, 0)
                            + (xm - torch.abs(xm)) * fbmem)),
                *s_[KM1, 1:, 1:])
    yflux = put(z3, (0.5 * ((ym + torch.abs(ym)) * sft(fbmem, 0, -1)
                            + (ym - torch.abs(ym)) * fbmem)),
                *s_[KM1, 1:, 1:])
    zflux = z3
    if first:
        zflux = put(zflux, zw[0] * f[0] * art, *s_[0, 1:-1, 1:-1])
    zflux = put(zflux, (0.5 * ((zw + torch.abs(zw)) * fbmem
                               + (zw - torch.abs(zw)) * sfk(fbmem, -1))
                        * art), *s_[1:cfg.kbm1, 1:-1, 1:-1])
    ff_new = (sft(xflux, 1, 0) - xflux + sft(yflux, 0, 1) - yflux
              + (zflux - sfk(zflux, 1)) / grid.dz3)
    ff_new = ((fbmem * (h + eta) * art - cfg.dti2 * ff_new)
              / ((h + etf) * art))
    return put(fbmem, ff_new, *s_[KM1, 1:-1, 1:-1])


def mpdata_diffusion(grid: Grid, cfg: Config, ff, fb, fclim, aam, etf):
    """MPDATA's closing climatology-deviation diffusion
    (solver.f:691-726); ``fb`` carries its ghost bottom layer."""
    h, dx, dy, art = grid.h, grid.dx, grid.dy, grid.art
    KM1 = slice(0, cfg.kbm1)
    z3 = torch.zeros_like(ff)
    aamx = 0.5 * (aam + sft(aam, -1, 0))
    aamy = 0.5 * (aam + sft(aam, 0, -1))
    fbmc = fb - fclim
    xflux = put(z3, (-aamx * (h + sft(h, -1, 0)) * cfg.tprni
                     * (fbmc - sft(fbmc, -1, 0)) * grid.dum
                     * (dy + sft(dy, -1, 0)) * 0.5 / (dx + sft(dx, -1, 0))),
                *s_[KM1, 1:, 1:])
    yflux = put(z3, (-aamy * (h + sft(h, 0, -1)) * cfg.tprni
                     * (fbmc - sft(fbmc, 0, -1)) * grid.dvm
                     * (dx + sft(dx, 0, -1)) * 0.5 / (dy + sft(dy, 0, -1))),
                *s_[KM1, 1:, 1:])
    return put(ff, (ff - cfg.dti2 * (sft(xflux, 1, 0) - xflux
                                     + sft(yflux, 0, 1) - yflux)
                    / ((h + etf) * art)), *s_[KM1, 1:-1, 1:-1])


def mpdata_steps(grid: Grid, cfg: Config, fb, f, u, v, w, dt, etb, etf):
    """advt2's ``cfg.nitera`` upstream steps, each followed by the
    antidiffusive velocities -> (ff after the last step's fsm mask, fb with
    its ghost bottom layer)."""
    xm, ym = mass_fluxes(grid, cfg, u, v, dt)
    fb = set_k(fb, -1, fb[cfg.kb - 2])   # solver.f:618
    eta, zw, ff = etb, w, fb
    for itera in range(cfg.nitera):
        ff = mpdata_upwind(grid, cfg, ff, f, xm, ym, zw, eta, etf,
                           itera == 0)
        xm, ym, zw, ff = smol_adif(grid, cfg, xm, ym, zw, ff, dt)
        eta = etf
    return ff, fb


def advt2(grid: Grid, cfg: Config, fb, f, fclim, u, v, w, aam, dt, etb,
          etf) -> torch.Tensor:
    """Smolarkiewicz MPDATA upstream tracer step -> ff: the upstream steps
    (:func:`mpdata_steps`), then the climatology-deviation diffusion."""
    with span("mpdata"):
        ff, fb = mpdata_steps(grid, cfg, fb, f, u, v, w, dt, etb, etf)
    return mpdata_diffusion(grid, cfg, ff, fb, fclim, aam, etf)
