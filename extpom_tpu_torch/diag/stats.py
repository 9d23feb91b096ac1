"""Global diagnostics and the blow-up guard (``extpom_tpu/diag/stats.py``;
advance.f:611-756)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.core.state import State


def _csum(x: torch.Tensor) -> torch.Tensor:
    """Compensated pairwise sum (a log2(N)-level TwoSum tree carrying an
    error channel): ~double-length totals in any float dtype."""
    x = x.reshape(-1)
    n = x.shape[0]
    if n == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    p = 1 << max(n - 1, 1).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros(p - n)])
    s, c = x, torch.zeros_like(x)
    while s.shape[0] > 1:
        a, b = s[0::2], s[1::2]
        t = a + b
        e = (a - (t - b)) + (b - (t - a))
        s = t
        c = c[0::2] + c[1::2] + e
    return s[0] + c[0]


def domain_stats(grid: Grid, cfg: Config, st: State) -> Dict[str, torch.Tensor]:
    """vtot, atot, mtot, tsalt, taver, saver, eaver, ekin; sums cover the
    interior plus the four edges without the corners (advance.f:669-745),
    accumulated in float64, over the active region of a padded grid."""
    kbm1 = cfg.kbm1
    ia, ja = cfg.active
    wide = lambda a: a[..., :ia, :ja].to(torch.float64)
    darea = wide(grid.dx) * wide(grid.dy) * wide(grid.fsm)

    def edge_sum(a2d):
        return _csum(torch.cat([
            a2d[1:-1, 1:-1].reshape(-1),
            a2d[0, 1:-1], a2d[-1, 1:-1], a2d[1:-1, 0], a2d[1:-1, -1]]))

    atot = edge_sum(darea)
    eavg = edge_sum(wide(st.et) * darea)
    eavg = torch.where(atot != 0, eavg / atot, 0.0)

    dt2 = wide(grid.h) + wide(st.et)
    dvol = darea[None] * dt2[None] * grid.dz3[:kbm1].to(torch.float64)

    def edge_sum3(a3d):
        return _csum(torch.cat([
            a3d[:, 1:-1, 1:-1].reshape(-1),
            a3d[:, 0, 1:-1].reshape(-1), a3d[:, -1, 1:-1].reshape(-1),
            a3d[:, 1:-1, 0].reshape(-1), a3d[:, 1:-1, -1].reshape(-1)]))

    vtot = edge_sum3(dvol)
    dmass = dvol * (wide(st.rho)[:kbm1] * cfg.rhoref + 1000.0)
    mtot = _csum(dmass[:, 1:-1, 1:-1])
    tavg = edge_sum3(wide(st.tb)[:kbm1] * dvol)
    stot = edge_sum3(wide(st.sb)[:kbm1] * dvol)
    tavg = torch.where(vtot != 0, tavg / vtot, 0.0)
    savg = torch.where(vtot != 0, stot / vtot, 0.0)

    ke = dmass * (wide(st.u)[:kbm1] ** 2 + wide(st.v)[:kbm1] ** 2)
    ekin = _csum(torch.cat([
        (0.5 * ke[:, 1:-1, 1:-1]).reshape(-1),
        ke[:, -1, 1:-1].reshape(-1), ke[:, 1:-1, -1].reshape(-1)]))

    return dict(vtot=vtot, atot=atot, mtot=mtot, tsalt=stot,
                taver=tavg, saver=savg, eaver=eavg, ekin=ekin)


def cfl_min(grid: Grid, cfg: Config) -> torch.Tensor:
    """Minimum external-mode CFL time step over water points
    (parallel_mpi.f:488-502): 0.5 / sqrt(1/dx^2 + 1/dy^2) / sqrt(g h)."""
    tps = (0.5 / torch.sqrt(1.0 / grid.dx ** 2 + 1.0 / grid.dy ** 2)
           / torch.sqrt(cfg.grav * torch.clamp(grid.h, min=1.0e-12)))
    big = torch.full((), 1.0e30, dtype=tps.dtype, device=tps.device)
    return torch.min(torch.where(grid.fsm > 0, tps, big))


def check_velocity(cfg: Config, vaf: torch.Tensor
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Blow-up detector: (max |vaf|, (i, j) of the max) over the active
    region."""
    ia, ja = cfg.active
    a = torch.abs(vaf[..., :ia, :ja])
    k = torch.argmax(a)
    return torch.max(a), (k // a.shape[1], k % a.shape[1])
