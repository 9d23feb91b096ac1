"""Baroclinic pressure gradient, 2nd-order (``extpom_tpu/ops/pressure.py``
``baropg``; solver.f:848-940).  ``npg=2`` (McCalpin) is not ported yet."""

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
