"""Baroclinic pressure gradient (``extpom_tpu/ops/pressure.py``): the
2nd-order ``baropg`` (solver.f:848-940) and the 4th-order McCalpin
``baropg_mcc`` of ``npg=2`` (solver.f:943-1159)."""

from __future__ import annotations

from typing import Tuple

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.ops.stencil import sft, sfk, put, set_k, s_


def _cumk(inc: torch.Tensor) -> torch.Tensor:
    """drho[k] = sum_{k'<=k} inc[k'] along the leading axis, summed in the
    reference's ascending-k order (solver.f:864-878)."""
    rows = [inc[0]]
    for k in range(1, inc.shape[0]):
        rows.append(rows[-1] + inc[k])
    return torch.stack(rows, dim=0)


def baropg(grid: Grid, cfg: Config, rho: torch.Tensor, rmean: torch.Tensor,
           dt: torch.Tensor, ramp) -> Tuple[torch.Tensor, torch.Tensor]:
    """2nd-order baroclinic pressure gradient -> (drhox, drhoy)."""
    dx, dy = grid.dx, grid.dy
    zz = grid.zz3
    KM1 = slice(0, cfg.kbm1)
    rr = rho - rmean
    z3 = torch.zeros_like(rho)

    def component(shift, mask, dperp):
        drr = rr - shift(rr)
        srr = rr + shift(rr)
        dts = dt + shift(dt)
        dtd = dt - shift(dt)
        inc0 = 0.5 * cfg.grav * (-zz[0]) * dts * drr[0]
        inck = (cfg.grav * 0.25 * (sfk(zz, -1) - zz) * dts
                * (drr + sfk(drr, -1))
                + cfg.grav * 0.25 * (sfk(zz, -1) + zz) * dtd
                * (srr - sfk(srr, -1)))
        dr = _cumk(set_k(inck, 0, inc0))
        dr = 0.25 * dts * dr * mask * (dperp + shift(dperp))
        return put(z3, dr, *s_[KM1, 1:-1, 1:-1])

    drhox = component(lambda a: sft(a, -1, 0), grid.dum, dy)
    drhoy = component(lambda a: sft(a, 0, -1), grid.dvm, dx)

    drhox = put(drhox, drhox * ramp, *s_[:, 1:-1, 1:-1])
    drhoy = put(drhoy, drhoy * ramp, *s_[:, 1:-1, 1:-1])
    return drhox, drhoy


def baropg_mcc(grid: Grid, cfg: Config, rho: torch.Tensor,
               rmean: torch.Tensor, d: torch.Tensor, dt: torch.Tensor,
               ramp) -> Tuple[torch.Tensor, torch.Tensor]:
    """4th-order McCalpin baroclinic pressure gradient -> (drhox, drhoy),
    with the 4th-order corrections on the physical-edge regions (i 2..im-2
    for x, j 2..jm-2 for y)."""
    zz, dzz = grid.zz3, grid.dzz3
    KM1 = slice(0, cfg.kbm1)
    rr = rho - rmean
    z3 = torch.zeros_like(rho)

    def component(shift, shift_p, mask, dperp, corr_region):
        """shift reads the upstream point (i-1 / j-1), shift_p the
        downstream one (i+1 / j+1)."""
        drho = (rr - shift(rr)) * mask
        rhou = 0.5 * (rr + shift(rr)) * mask
        ddx = (d - shift(d)) * mask
        d4 = 0.5 * (d + shift(d)) * mask

        # the corrections; shift(shift(.)) reaches i-2 / j-2
        mp = shift_p(mask)
        mm = shift(mask)
        drho_c = drho - (1.0 / 24.0) * (
            mp * (shift_p(rr) - rr) - 2.0 * (rr - shift(rr))
            + mm * (shift(rr) - shift(shift(rr))))
        rhou_c = rhou + (1.0 / 16.0) * (
            mp * (rr - shift_p(rr)) + mm * (shift(rr) - shift(shift(rr))))
        ddx_c = ddx - (1.0 / 24.0) * (
            mp * (shift_p(d) - d) - 2.0 * (d - shift(d))
            + mm * (shift(d) - shift(shift(d))))
        d4_c = d4 + (1.0 / 16.0) * (
            mp * (d - shift_p(d)) + mm * (shift(d) - shift(shift(d))))

        ks, isl, jsl = corr_region
        drho = put(drho, drho_c, *s_[ks, isl, jsl])
        rhou = put(rhou, rhou_c, *s_[ks, isl, jsl])
        ddx = put(ddx, ddx_c, *s_[isl, jsl])
        d4 = put(d4, d4_c, *s_[isl, jsl])

        # the vertical integral (solver.f:1023-1040)
        inc0 = cfg.grav * (-zz[0]) * d4 * drho[0]
        inck = (cfg.grav * 0.5 * sfk(dzz, -1) * d4 * (sfk(drho, -1) + drho)
                + cfg.grav * 0.5 * (sfk(zz, -1) + zz) * ddx
                * (rhou - sfk(rhou, -1)))
        dr = _cumk(set_k(inck, 0, inc0))
        dr = 0.25 * (dt + shift(dt)) * dr * mask * (dperp + shift(dperp))
        return put(z3, dr, *s_[KM1, 1:-1, 1:-1])

    drhox = component(lambda a: sft(a, -1, 0), lambda a: sft(a, 1, 0),
                      grid.dum, grid.dy, (KM1, slice(2, -1), slice(None)))
    drhoy = component(lambda a: sft(a, 0, -1), lambda a: sft(a, 0, 1),
                      grid.dvm, grid.dx, (KM1, slice(None), slice(2, -1)))

    drhox = put(drhox, drhox * ramp, *s_[:, 1:-1, 1:-1])
    drhoy = put(drhoy, drhoy * ramp, *s_[:, 1:-1, 1:-1])
    return drhox, drhoy
