"""Open lateral boundary conditions, file-driven set
(``extpom_tpu/bc/bcond.py``; bounds_forcing.f:6-328): the ones the extpom
scheme runs, ``bc_el`` (idx 1), ``bc_vel2d`` (idx 2), ``bc_ts`` (idx 4) and
``bc_turb`` (idx 6), and ``bc_vel3d`` (idx 3), which only the ``file``
scheme runs.

Each edge write commits row/column ``i`` of a full-array expression built
from zero-filled :func:`sft` reads.  The order of the side writes matches
the reference: at a corner the side written last wins.
"""

from __future__ import annotations

from typing import Tuple

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.core.state import Forcing
from extpom_tpu_torch.ops.stencil import sft, sfk, put, set_i, set_j, s_


def _bj(a1d: torch.Tensor) -> torch.Tensor:
    """Broadcast a (jm,) or (kb, jm) boundary series along the i axis."""
    return a1d[..., None, :]


def _bi(a1d: torch.Tensor) -> torch.Tensor:
    """Broadcast an (im,) or (kb, im) boundary series along the j axis."""
    return a1d[..., :, None]


def _smooth_j(a: torch.Tensor) -> torch.Tensor:
    """Tangential 1-2-1 average along j."""
    return 0.25 * sft(a, 0, -1) + 0.5 * a + 0.25 * sft(a, 0, 1)


def _smooth_i(a: torch.Tensor) -> torch.Tensor:
    return 0.25 * sft(a, -1, 0) + 0.5 * a + 0.25 * sft(a, 1, 0)


def bc_el(grid: Grid, cfg: Config, elf: torch.Tensor,
          fc: Forcing) -> torch.Tensor:
    """idx=1: zero-gradient elevation at the open edges, written west,
    east, south, north (so the corners take the north/south copies)."""
    elf = set_i(elf, 0, sft(elf, 1, 0))
    elf = set_i(elf, -1, sft(elf, -1, 0))
    elf = set_j(elf, 0, sft(elf, 0, 1))
    elf = set_j(elf, -1, sft(elf, 0, -1))
    return elf * grid.fsm


def bc_vel2d(grid: Grid, cfg: Config, uaf, vaf, el, d, fc: Forcing,
             ramp) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx=2: Flather-type radiation of the depth-mean velocity.  Row 1 is
    written before row 0 copies it (and column 1 before column 0)."""
    g = cfg.grav
    J = slice(1, -1)
    I = slice(1, -1)
    # west: committed row i=1 reads d/el at itself
    uaf = set_i(uaf, 1, ramp * (
        _bj(fc.uabw) - cfg.rfw * torch.sqrt(g / d) * (el - _bj(fc.elw))),
        j=J)
    uaf = set_i(uaf, 0, sft(uaf, 1, 0), j=J)
    vaf = set_i(vaf, 0, _bj(fc.vabw), j=J)
    # east: row im-1 reads d/el one row inside
    uaf = set_i(uaf, -1, ramp * (
        _bj(fc.uabe) + cfg.rfe * torch.sqrt(g / sft(d, -1, 0))
        * (sft(el, -1, 0) - _bj(fc.ele))), j=J)
    vaf = set_i(vaf, -1, _bj(fc.vabe), j=J)
    # south
    vaf = set_j(vaf, 1, ramp * (
        _bi(fc.vabs) - cfg.rfs * torch.sqrt(g / d) * (el - _bi(fc.els))),
        i=I)
    vaf = set_j(vaf, 0, sft(vaf, 0, 1), i=I)
    uaf = set_j(uaf, 0, _bi(fc.uabs), i=I)
    # north
    vaf = set_j(vaf, -1, ramp * (
        _bi(fc.vabn) + cfg.rfn * torch.sqrt(g / sft(d, 0, -1))
        * (sft(el, 0, -1) - _bi(fc.eln))), i=I)
    uaf = set_j(uaf, -1, _bi(fc.uabn), i=I)
    return uaf * grid.dum, vaf * grid.dvm


def bc_vel3d(grid: Grid, cfg: Config, uf, vf, u, v, d,
             fc: Forcing) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx=3: internal velocity, a depth-weighted blend of the old
    velocity one cell in and the boundary profile, each smoothed 1-2-1
    along the edge, on levels k < kbm1, then the dum/dvm mask
    (bounds_forcing.f:85-149; ``grid.hmax`` is the reference's
    ``maxval(d)``).  Written east, west, south, north."""
    K = slice(0, cfg.kbm1)
    J = slice(1, -1)
    I = slice(1, -1)
    hmax = grid.hmax
    # east: the edge row reads u one row in
    ga = torch.sqrt(d / hmax)
    uf = set_i(uf, -1, ga * _smooth_j(sft(u, -1, 0))
               + (1.0 - ga) * _smooth_j(_bj(fc.ube)), j=J, k=K)
    vf = set_i(vf, -1, _bj(fc.vbe), j=J, k=K)
    # west: the u-face at i=1 reads d at i=0 and u at i=2
    ga_w = torch.sqrt(sft(d, -1, 0) / hmax)
    uf = set_i(uf, 1, ga_w * _smooth_j(sft(u, 1, 0))
               + (1.0 - ga_w) * _smooth_j(_bj(fc.ubw)), j=J, k=K)
    uf = set_i(uf, 0, sft(uf, 1, 0), j=J, k=K)
    vf = set_i(vf, 0, _bj(fc.vbw), j=J, k=K)
    # south: the v-face at j=1 reads d at j=0 and v at j=2
    ga_s = torch.sqrt(sft(d, 0, -1) / hmax)
    vf = set_j(vf, 1, ga_s * _smooth_i(sft(v, 0, 1))
               + (1.0 - ga_s) * _smooth_i(_bi(fc.vbs)), i=I, k=K)
    vf = set_j(vf, 0, sft(vf, 0, 1), i=I, k=K)
    uf = set_j(uf, 0, _bi(fc.ubs), i=I, k=K)
    # north
    ga_n = torch.sqrt(d / hmax)
    vf = set_j(vf, -1, ga_n * _smooth_i(sft(v, 0, -1))
               + (1.0 - ga_n) * _smooth_i(_bi(fc.vbn)), i=I, k=K)
    uf = set_j(uf, -1, _bi(fc.ubn), i=I, k=K)
    return uf * grid.dum, vf * grid.dvm


def bc_ts(grid: Grid, cfg: Config, uf, vf, t, s, u, v, w, dt,
          fc: Forcing) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx=4: T/S advective open boundary with the vertical-advection
    correction on outflow.  ``uf``/``vf`` hold the new T/S fields."""
    kbm1 = cfg.kbm1
    K = slice(0, kbm1)
    zz3 = grid.zz3
    kidx = torch.arange(cfg.kb, device=t.device)[:, None, None]
    kmask = ((kidx > 0) & (kidx < kbm1 - 1)).to(t.dtype)
    dzz2 = sfk(zz3, -1) - sfk(zz3, 1)
    dzz2 = torch.where(dzz2 == 0, 1.0, dzz2)

    def wm_corr(w_in, dt_in, f_in):
        wm = 0.5 * (w_in + sfk(w_in, 1)) * cfg.dti / (dzz2 * dt_in)
        return kmask * wm * (sfk(f_in, -1) - sfk(f_in, 1))

    def side(f_edge, f_in, fb_ext, u1, w_in, dt_in, out_is_le):
        if out_is_le:   # east/north: inflow when u1 <= 0
            inflow = u1 <= 0.0
            f_inf = f_edge - u1 * (fb_ext - f_edge)
            f_out = f_edge - u1 * (f_edge - f_in) - wm_corr(w_in, dt_in, f_in)
        else:           # west/south
            inflow = u1 >= 0.0
            f_inf = f_edge - u1 * (f_edge - fb_ext)
            f_out = f_edge - u1 * (f_in - f_edge) - wm_corr(w_in, dt_in, f_in)
        return torch.where(inflow, f_inf, f_out)

    # east, full j range: edge row reads u at itself, t/w/dt at im-2
    u1e = 2.0 * u * cfg.dti / (grid.dx + sft(grid.dx, -1, 0))
    uf = set_i(uf, -1, side(t, sft(t, -1, 0), _bj(fc.tbe), u1e,
                            sft(w, -1, 0), sft(dt, -1, 0), True), k=K)
    vf = set_i(vf, -1, side(s, sft(s, -1, 0), _bj(fc.sbe), u1e,
                            sft(w, -1, 0), sft(dt, -1, 0), True), k=K)
    # west: edge row 0 reads u/t/w/dt at row 1
    u1w = 2.0 * sft(u, 1, 0) * cfg.dti / (grid.dx + sft(grid.dx, 1, 0))
    uf = set_i(uf, 0, side(t, sft(t, 1, 0), _bj(fc.tbw), u1w,
                           sft(w, 1, 0), sft(dt, 1, 0), False), k=K)
    vf = set_i(vf, 0, side(s, sft(s, 1, 0), _bj(fc.sbw), u1w,
                           sft(w, 1, 0), sft(dt, 1, 0), False), k=K)
    # south, full i range
    u1s = 2.0 * sft(v, 0, 1) * cfg.dti / (grid.dy + sft(grid.dy, 0, 1))
    uf = set_j(uf, 0, side(t, sft(t, 0, 1), _bi(fc.tbs), u1s,
                           sft(w, 0, 1), sft(dt, 0, 1), False), k=K)
    vf = set_j(vf, 0, side(s, sft(s, 0, 1), _bi(fc.sbs), u1s,
                           sft(w, 0, 1), sft(dt, 0, 1), False), k=K)
    # north
    u1n = 2.0 * v * cfg.dti / (grid.dy + sft(grid.dy, 0, -1))
    uf = set_j(uf, -1, side(t, sft(t, 0, -1), _bi(fc.tbn), u1n,
                            sft(w, 0, -1), sft(dt, 0, -1), True), k=K)
    vf = set_j(vf, -1, side(s, sft(s, 0, -1), _bi(fc.sbn), u1n,
                            sft(w, 0, -1), sft(dt, 0, -1), True), k=K)

    uf = put(uf, uf * grid.fsm, *s_[K])
    vf = put(vf, vf * grid.fsm, *s_[K])
    return uf, vf


def bc_turb(grid: Grid, cfg: Config, uf, vf, q2, q2l, u,
            v) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx=6: q2/q2l upstream open boundary toward ``small``, all kb
    levels."""
    small = cfg.small

    def side(f_edge, f_in, u1, out_is_le):
        if out_is_le:
            inflow = u1 <= 0.0
            f_inf = f_edge - u1 * (small - f_edge)
            f_out = f_edge - u1 * (f_edge - f_in)
        else:
            inflow = u1 >= 0.0
            f_inf = f_edge - u1 * (f_edge - small)
            f_out = f_edge - u1 * (f_in - f_edge)
        return torch.where(inflow, f_inf, f_out)

    u1w = 2.0 * sft(u, 1, 0) * cfg.dti / (grid.dx + sft(grid.dx, 1, 0))
    uf = set_i(uf, 0, side(q2, sft(q2, 1, 0), u1w, False))
    vf = set_i(vf, 0, side(q2l, sft(q2l, 1, 0), u1w, False))
    u1e = 2.0 * u * cfg.dti / (grid.dx + sft(grid.dx, -1, 0))
    uf = set_i(uf, -1, side(q2, sft(q2, -1, 0), u1e, True))
    vf = set_i(vf, -1, side(q2l, sft(q2l, -1, 0), u1e, True))
    u1s = 2.0 * sft(v, 0, 1) * cfg.dti / (grid.dy + sft(grid.dy, 0, 1))
    uf = set_j(uf, 0, side(q2, sft(q2, 0, 1), u1s, False))
    vf = set_j(vf, 0, side(q2l, sft(q2l, 0, 1), u1s, False))
    u1n = 2.0 * v * cfg.dti / (grid.dy + sft(grid.dy, 0, -1))
    uf = set_j(uf, -1, side(q2, sft(q2, 0, -1), u1n, True))
    vf = set_j(vf, -1, side(q2l, sft(q2l, 0, -1), u1n, True))

    uf = uf * grid.fsm + 1.0e-10
    vf = vf * grid.fsm + 1.0e-10
    return uf, vf
