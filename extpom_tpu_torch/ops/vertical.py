"""Implicit vertical solvers (``extpom_tpu/ops/vertical.py``):
``proft`` (solver.f:1541-1683), ``profu``/``profv`` (solver.f:1686-1877)
and the Mellor-Yamada 2.5 closure ``profq`` (solver.f:1212-1538).  They
are the plain versions the phase kernels of ``kernels.phases`` are held
against, so each Thomas solve is ``kernels.tridiag.thomas_plain``."""

from __future__ import annotations

from typing import Tuple

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.kernels.tridiag import thomas_plain
from extpom_tpu_torch.ops.stencil import sft, sfk, put, set_i, set_j, set_k, s_

# Paulson & Simpson (1977) irradiance parameters by Jerlov type
_R_JERLOV = (0.58, 0.62, 0.67, 0.77, 0.78)
_AD1_JERLOV = (0.35, 0.60, 1.0, 1.5, 1.4)
_AD2_JERLOV = (23.0, 20.0, 17.0, 14.0, 7.9)

# constants of the Mellor-Yamada 2.5 closure (profq)
MY_A1, MY_B1, MY_A2, MY_B2, MY_C1 = 0.92, 16.6, 0.74, 10.1, 0.08
MY_E1, MY_E2 = 1.8, 1.33
MY_SEF = 1.0
MY_CBCNST, MY_SURFL, MY_SHIW = 100.0, 2.0e5, 0.0


def proft(grid: Grid, cfg: Config, f, wfsurf, fsurf, nbc: int, kh, etf,
          swrad) -> torch.Tensor:
    """Implicit vertical diffusion of a tracer; layers 0..kb-2 are solved,
    the kb-1 ghost layer passes through."""
    h = grid.h
    dz, dzz = grid.dz3, grid.dzz3
    kbm1, kbm2 = cfg.kbm1, cfg.kbm2
    dh = h + etf
    z3 = torch.zeros_like(f)

    kdif = kh + cfg.umol
    a = put(z3, (-cfg.dti2 * sfk(kdif, 1) / (dz * dzz * dh * dh)), *s_[:kbm2])
    c = put(z3, (-cfg.dti2 * kdif / (dz * sfk(dzz, -1) * dh * dh)), *s_[1:kbm1])

    if nbc in (2, 4):
        r = _R_JERLOV[cfg.ntp - 1]
        ad1 = _AD1_JERLOV[cfg.ntp - 1]
        ad2 = _AD2_JERLOV[cfg.ntp - 1]
        rad = put(z3, (swrad * (r * torch.exp(grid.z3 * dh / ad1)
                      + (1.0 - r) * torch.exp(grid.z3 * dh / ad2))), *s_[:kbm1])
    else:
        rad = z3

    if nbc == 1:
        ee0 = a[0] / (a[0] - 1.0)
        gg0 = (cfg.dti2 * wfsurf / (dz[0] * dh) - f[0]) / (a[0] - 1.0)
    elif nbc == 2:
        ee0 = a[0] / (a[0] - 1.0)
        gg0 = (cfg.dti2 * (wfsurf + rad[0] - rad[1]) / (dz[0] * dh)
               - f[0]) / (a[0] - 1.0)
    elif nbc in (3, 4):
        ee0 = torch.zeros_like(h)
        gg0 = fsurf
    else:
        raise ValueError(f"invalid nbc {nbc}")

    den = torch.ones_like(f)
    rhs = -f + cfg.dti2 * (rad - sfk(rad, 1)) / (dh * dz)
    rb = (-f[kbm2]
          + cfg.dti2 * (rad[kbm2] - rad[kbm1]) / (dh * dz[kbm2]))
    sol = thomas_plain(a, c, den, rhs, ee0, gg0, cl=c[kbm2], rb=rb,
                       db=-torch.ones_like(h), mask=torch.ones_like(h), k0=1,
                       k_last=kbm2)
    return torch.cat([sol[:kbm1], f[kbm1:]], dim=0)


def _profuv_solve(cfg: Config, grid: Grid, cm, dh, wsurf, fin, ub_bot,
                  vb_bot, cbc2, mask):
    """Shared solve of profu/profv: coefficients, surface BC, implicit
    quadratic bottom friction.  Returns (solution stack, tps)."""
    dz, dzz = grid.dz3, grid.dzz3
    kbm1, kbm2 = cfg.kbm1, cfg.kbm2
    z3 = torch.zeros_like(fin)
    kdif = cm + cfg.umol
    a = put(z3, (-cfg.dti2 * sfk(kdif, 1)
                          / (dz * dzz * dh * dh)), *s_[:kbm2])
    c = put(z3, (-cfg.dti2 * kdif
                           / (dz * sfk(dzz, -1) * dh * dh)), *s_[1:kbm1])
    ee0 = a[0] / (a[0] - 1.0)
    gg0 = (-cfg.dti2 * wsurf / (-dz[0] * dh) - fin[0]) / (a[0] - 1.0)
    tps = cbc2 * torch.sqrt(ub_bot ** 2 + vb_bot ** 2)
    db = tps * cfg.dti2 / (-grid.dz[kbm2] * dh) - 1.0
    sol = thomas_plain(a, c, torch.ones_like(fin), -fin, ee0, gg0,
                       cl=c[kbm2], rb=-fin[kbm2], db=db, mask=mask, k0=1,
                       k_last=kbm2)
    return sol, tps


def profu(grid: Grid, cfg: Config, uf, ub, vb, km, etf,
          wusurf) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vertical diffusion of u + implicit bottom friction -> (uf, wubot)."""
    h = grid.h
    kbm1 = cfg.kbm1
    dh = torch.ones_like(h)
    dh = put(dh, (0.5 * (h + etf + sft(h, -1, 0) + sft(etf, -1, 0))), *s_[1:, 1:])
    cm = torch.zeros_like(km)
    cm = put(cm, (0.5 * (km + sft(km, -1, 0))), *s_[:, 1:, 1:])

    sol, tps = _profuv_solve(
        cfg, grid, cm, dh, wusurf, uf,
        ub_bot=ub[kbm1 - 1],
        vb_bot=(0.25 * (vb + sft(vb, 0, 1) + sft(vb, -1, 0)
                        + sft(vb, -1, 1)))[kbm1 - 1],
        cbc2=0.5 * (grid.cbc + sft(grid.cbc, -1, 0)), mask=grid.dum)
    # edge columns keep the incoming values (solver.f:1750-1770)
    uf = put(uf, torch.cat([sol[:kbm1], uf[kbm1:]], dim=0),
             *s_[:kbm1, 1:-1, 1:-1])
    wubot = put(torch.zeros_like(h), -tps * uf[kbm1 - 1], *s_[1:-1, 1:-1])
    return uf, wubot


def profv(grid: Grid, cfg: Config, vf, ub, vb, km, etf,
          wvsurf) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vertical diffusion of v + implicit bottom friction -> (vf, wvbot)."""
    h = grid.h
    kbm1 = cfg.kbm1
    dh = torch.ones_like(h)
    dh = put(dh, (0.5 * (h + etf + sft(h, 0, -1) + sft(etf, 0, -1))), *s_[1:, 1:])
    cm = torch.zeros_like(km)
    cm = put(cm, (0.5 * (km + sft(km, 0, -1))), *s_[:, 1:, 1:])

    sol, tps = _profuv_solve(
        cfg, grid, cm, dh, wvsurf, vf,
        ub_bot=(0.25 * (ub + sft(ub, 1, 0) + sft(ub, 0, -1)
                        + sft(ub, 1, -1)))[kbm1 - 1],
        vb_bot=vb[kbm1 - 1],
        cbc2=0.5 * (grid.cbc + sft(grid.cbc, 0, -1)), mask=grid.dvm)
    vf = put(vf, torch.cat([sol[:kbm1], vf[kbm1:]], dim=0),
             *s_[:kbm1, 1:-1, 1:-1])
    wvbot = put(torch.zeros_like(h), -tps * vf[kbm1 - 1], *s_[1:-1, 1:-1])
    return vf, wvbot


def profq(grid: Grid, cfg: Config, q2f, q2lf, q2, q2b, q2lb, u, v, t, s,
          rho, km, kh, kq, etf, wusurf, wvsurf, wubot, wvbot):
    """Mellor-Yamada 2.5 closure.  Returns (q2f, q2lf, km, kh, kq, l,
    q2b_abs, q2lb_abs); the last two are the |.|-rectified time-(n-1)
    fields the reference mutates in place (solver.f:1325-1326).  Every
    level of the length scale l is recomputed, so the old l is not an
    operand."""
    h = grid.h
    dz, dzz, z, zz = grid.dz3, grid.dzz3, grid.z3, grid.zz3
    kb, kbm1 = cfg.kb, cfg.kbm1
    K2 = slice(1, kbm1)
    z3 = torch.zeros_like(q2)

    a1, b1, a2, b2, c1 = MY_A1, MY_B1, MY_A2, MY_B2, MY_C1
    e1, e2 = MY_E1, MY_E2
    sef = MY_SEF
    cbcnst, surfl, shiw = MY_CBCNST, MY_SURFL, MY_SHIW

    dh = h + etf

    a = put(z3, (-cfg.dti2 * (sfk(kq, 1) + kq + 2.0 * cfg.umol) * 0.5
                       / (sfk(dzz, -1) * dz * dh * dh)), *s_[K2])
    c = put(z3, (-cfg.dti2 * (sfk(kq, -1) + kq + 2.0 * cfg.umol) * 0.5
                       / (sfk(dzz, -1) * sfk(dz, -1) * dh * dh)), *s_[K2])

    const1 = (b1 ** (2.0 / 3.0)) * sef

    z2 = torch.zeros_like(h)
    utau2 = put(z2, torch.sqrt((0.5 * (wusurf + sft(wusurf, 1, 0))) ** 2
                 + (0.5 * (wvsurf + sft(wvsurf, 0, 1))) ** 2), *s_[:-1, :-1])
    q2f = put(q2f,
              torch.sqrt((0.5 * (wubot + sft(wubot, 1, 0))) ** 2
                         + (0.5 * (wvbot + sft(wvbot, 0, 1))) ** 2) * const1,
              *s_[kb - 1, :-1, :-1])

    ee0 = torch.zeros_like(h)
    gg0 = (15.8 * cbcnst) ** (2.0 / 3.0) * utau2
    l0 = surfl * utau2 / cfg.grav

    # speed of sound; pressure in decibars
    tp = t + cfg.tbias
    sp = s + cfg.sbias
    p = cfg.grav * cfg.rhoref * (-zz * h) * 1.0e-4
    cc = 1449.1 + 0.00821 * p + 4.55 * tp - 0.045 * tp ** 2 \
        + 1.34 * (sp - 35.0)
    cc = cc / torch.sqrt((1.0 - 0.01642 * p / cc)
                         * (1.0 - 0.40 * p / cc ** 2))
    cc = put(z3, cc, *s_[:kbm1])

    q2b = put(q2b, torch.abs(q2b), *s_[K2])
    q2lb = put(q2lb, torch.abs(q2lb), *s_[K2])

    boygr = put(z3, (cfg.grav * (sfk(rho, -1) - rho) / (sfk(dzz, -1) * h)
         + (cfg.grav ** 2) * 2.0 / (sfk(cc, -1) ** 2 + cc ** 2)), *s_[K2])

    l_mid = torch.abs(q2lb / torch.where(q2b == 0, 1.0, q2b))
    l_mid = torch.where(z > -0.5, torch.maximum(l_mid, cfg.kappa * l0), l_mid)
    l = put(z3, l_mid, *s_[K2])
    l = set_k(l, 0, cfg.kappa * l0)
    l = set_k(l, kb - 1, 0.0)
    gh = put(z3, torch.clamp(
        (l ** 2) * boygr / torch.where(q2b == 0, 1.0, q2b), max=0.028),
        *s_[K2])

    prod = put(z3, (km * 0.25 * sef
         * ((u - sfk(u, -1) + sft(u, 1, 0) - sfk(sft(u, 1, 0), -1)) ** 2
            + (v - sfk(v, -1) + sft(v, 0, 1) - sfk(sft(v, 0, 1), -1)) ** 2)
         / (sfk(dzz, -1) * dh) ** 2
         - shiw * km * boygr
         + kh * boygr), *s_[K2, 1:-1, 1:-1])

    stf = torch.ones_like(q2)
    dtef = torch.sqrt(torch.abs(q2b)) * stf / (b1 * l + cfg.small)

    # ---- q2 solve (solver.f:1394-1413) ----
    den = 2.0 * cfg.dti2 * dtef + 1.0
    rhs = -2.0 * cfg.dti2 * prod - q2f
    ones2 = torch.ones_like(h)
    q2f = thomas_plain(a, c, den, rhs, ee0, gg0, cl=torch.zeros_like(h),
                       rb=q2f[kb - 1], db=ones2, mask=ones2, k0=1,
                       k_last=kb - 1)

    # ---- q2l solve (solver.f:1415-1455) ----
    q2lf = set_k(set_k(q2lf, 0, 0.0), kb - 1, 0.0)
    ee1 = torch.zeros_like(h)
    gg1 = -cfg.kappa * z[1] * dh * q2[1]
    q2lf = set_k(q2lf, kb - 2,
                 cfg.kappa * (1.0 + z[kbm1 - 1]) * dh * q2[kbm1 - 1])
    dzk = torch.abs(z - z[0])
    dzkb = torch.abs(z - z[kb - 1])
    wallfac = torch.where(
        (dzk > 0) & (dzkb > 0),
        1.0 + e2 * ((1.0 / torch.where(dzk == 0, 1.0, dzk)
                     + 1.0 / torch.where(dzkb == 0, 1.0, dzkb))
                    * l / (dh * cfg.kappa)) ** 2,
        1.0)
    dtef2 = put(z3, (dtef * wallfac), *s_[K2])
    den2 = cfg.dti2 * dtef2 + 1.0
    rhs2 = cfg.dti2 * (-prod * l * e1) - q2lf
    # back substitution down to k=1; k=0 stays 0
    q2l_low = thomas_plain(a, c, den2, rhs2, ee1, gg1,
                           cl=torch.zeros_like(h), rb=q2lf[kb - 1], db=ones2,
                           mask=ones2, k0=2, k_last=kb - 1)
    q2lf = put(q2lf, q2l_low, *s_[1:kb - 1])

    q2f = put(q2f, torch.abs(q2f), *s_[K2])
    q2lf = put(q2lf, torch.abs(q2lf), *s_[K2])

    # ---- stability functions and mixing coefficients ----
    coef4 = 18.0 * a1 * a1 + 9.0 * a1 * a2
    coef5 = 9.0 * a1 * a2
    coef1 = a2 * (1.0 - 6.0 * a1 / b1 * stf)
    coef2 = 3.0 * a2 * b2 / stf + 18.0 * a1 * a2
    coef3 = a1 * (1.0 - 3.0 * c1 - 6.0 * a1 / b1 * stf)
    sh = coef1 / (1.0 - coef2 * gh)
    sm = (coef3 + sh * coef4 * gh) / (1.0 - coef5 * gh)

    kn = l * torch.sqrt(torch.abs(q2))
    kq = (kn * 0.41 * sh + kq) * 0.5
    km = (kn * sm + km) * 0.5
    kh = (kn * sh + kh) * 0.5

    # boundary copies in the reference's order N, S, E, W (solver.f:1510-1529)
    def edges(arr):
        arr = set_j(arr, -1, sft(arr, 0, -1))
        arr = set_j(arr, 0, sft(arr, 0, 1))
        arr = set_i(arr, -1, sft(arr, -1, 0))
        return set_i(arr, 0, sft(arr, 1, 0))

    km = edges(km) * grid.fsm
    kh = edges(kh) * grid.fsm
    kq = edges(kq) * grid.fsm
    return q2f, q2lf, km, kh, kq, l, q2b, q2lb
