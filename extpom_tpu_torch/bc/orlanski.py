"""Orlanski radiation open boundaries (``extpom_tpu/bc/orlanski.py``;
bounds_forcing.f:331-590): elevation ``orl_el`` (idx 1), depth-mean
velocity ``orl_vel2d`` (idx 2), internal velocity ``orl_vel3d`` (idx 3),
T/S ``orl_ts`` (idx 4), the w mask ``orl_w`` (idx 5) and q2/q2l
``orl_turb`` (idx 6).  The extpom scheme runs idx 3 and 5; the
``orlanski`` scheme runs all six.  ``orl_el`` and ``orl_ts`` keep the
reference's two documented deviations: zero-gradient north and south rows.

The phase speed cl = (fb_b - ff_b) / (ff_b + fb_b - 2 f_i), clamped to
[0, 1], is evaluated one row inside the boundary."""

from __future__ import annotations

from typing import Tuple

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.ops.stencil import sft, put, set_i, set_j, s_


def _cl(ff_b, fb_b, f_i):
    denom = ff_b + fb_b - 2.0 * f_i
    denom = torch.where(denom == 0.0, 0.01, denom)
    return torch.clamp((fb_b - ff_b) / denom, 0.0, 1.0)


def orl_el(grid: Grid, cfg: Config, elf: torch.Tensor) -> torch.Tensor:
    """idx=1: zero-gradient elevation on all four sides, written west,
    east, south, north, then masked by fsm."""
    elf = set_i(elf, 0, sft(elf, 1, 0))
    elf = set_i(elf, -1, sft(elf, -1, 0))
    elf = set_j(elf, 0, sft(elf, 0, 1))
    elf = set_j(elf, -1, sft(elf, 0, -1))
    return elf * grid.fsm


def _orl_uv(uaf, vaf, ua, uab, va, vab, J, I, k=slice(None)):
    """Orlanski radiation of a (u-like, v-like) pair."""
    # east: row im-1 reads uaf/uab one row in and ua two rows in
    cl = _cl(sft(uaf, -1, 0), sft(uab, -1, 0), sft(ua, -2, 0))
    uaf = set_i(uaf, -1,
                (uab * (1.0 - cl) + 2.0 * cl * sft(ua, -1, 0)) / (1.0 + cl),
                j=J, k=k)
    vaf = set_i(vaf, -1, 0.0, j=J, k=k)
    # west (u-face at 1)
    cl = _cl(sft(uaf, 1, 0), sft(uab, 1, 0), sft(ua, 2, 0))
    uaf = set_i(uaf, 1,
                (uab * (1.0 - cl) + 2.0 * cl * sft(ua, 1, 0)) / (1.0 + cl),
                j=J, k=k)
    uaf = set_i(uaf, 0, sft(uaf, 1, 0), j=J, k=k)
    vaf = set_i(vaf, 0, 0.0, j=J, k=k)
    # south (v-face at 1)
    cl = _cl(sft(vaf, 0, 1), sft(vab, 0, 1), sft(va, 0, 2))
    vaf = set_j(vaf, 1,
                (vab * (1.0 - cl) + 2.0 * cl * sft(va, 0, 1)) / (1.0 + cl),
                i=I, k=k)
    vaf = set_j(vaf, 0, sft(vaf, 0, 1), i=I, k=k)
    uaf = set_j(uaf, 0, 0.0, i=I, k=k)
    # north
    cl = _cl(sft(vaf, 0, -1), sft(vab, 0, -1), sft(va, 0, -2))
    vaf = set_j(vaf, -1,
                (vab * (1.0 - cl) + 2.0 * cl * sft(va, 0, -1)) / (1.0 + cl),
                i=I, k=k)
    uaf = set_j(uaf, -1, 0.0, i=I, k=k)
    return uaf, vaf


def orl_vel2d(grid: Grid, cfg: Config, uaf, vaf, ua, uab, va,
              vab) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx=2: external velocity Orlanski radiation."""
    uaf, vaf = _orl_uv(uaf, vaf, ua, uab, va, vab,
                       J=slice(1, -1), I=slice(1, -1))
    return uaf * grid.dum, vaf * grid.dvm


def orl_vel3d(grid: Grid, cfg: Config, uf, vf, u, ub, v,
              vb) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx=3: internal velocity Orlanski radiation."""
    K = slice(0, cfg.kbm1)
    uf, vf = _orl_uv(uf, vf, u, ub, v, vb,
                     J=slice(1, -1), I=slice(1, -1), k=K)
    uf = put(uf, uf * grid.dum, *s_[K])
    vf = put(vf, vf * grid.dvm, *s_[K])
    return uf, vf


def orl_ts(grid: Grid, cfg: Config, uf, vf, t, tb, s, sb, ub,
           fc) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx=4: T/S radiation at the east and west edges, clamped to the
    boundary profile where the phase speed vanishes and the flow enters;
    then zero-gradient north and south rows (corners included, from the
    east/west values just written) and the fsm mask, on k < kbm1.
    ``uf``/``vf`` hold the new T/S fields after proft."""
    K = slice(0, cfg.kbm1)

    def side_ew(ff, f, fb, d_in, ubc, fb_ext, inflow_ge):
        """d_in = +1 (west: inner rows i+1, i+2) or -1 (east)."""
        cl = _cl(sft(ff, d_in, 0), sft(fb, d_in, 0), sft(f, 2 * d_in, 0))
        new = (fb * (1.0 - cl) + 2.0 * cl * sft(f, d_in, 0)) / (1.0 + cl)
        if inflow_ge:   # west: inflow when ub >= 0
            clamp = (cl == 0.0) & (ubc >= 0.0)
        else:           # east: inflow when ub <= 0
            clamp = (cl == 0.0) & (ubc <= 0.0)
        return torch.where(clamp, fb_ext, new)

    # east: the edge row's own ub; west: ub one row in
    tfe = side_ew(uf, t, tb, -1, ub, fc.tbe[:, None, :], False)
    sfe = side_ew(vf, s, sb, -1, ub, fc.sbe[:, None, :], False)
    uf = set_i(uf, -1, tfe, k=K)
    vf = set_i(vf, -1, sfe, k=K)
    ubw = sft(ub, 1, 0)
    tfw = side_ew(uf, t, tb, 1, ubw, fc.tbw[:, None, :], True)
    sfw = side_ew(vf, s, sb, 1, ubw, fc.sbw[:, None, :], True)
    uf = set_i(uf, 0, tfw, k=K)
    vf = set_i(vf, 0, sfw, k=K)

    uf = set_j(uf, 0, sft(uf, 0, 1), k=K)
    uf = set_j(uf, -1, sft(uf, 0, -1), k=K)
    vf = set_j(vf, 0, sft(vf, 0, 1), k=K)
    vf = set_j(vf, -1, sft(vf, 0, -1), k=K)

    uf = put(uf, uf * grid.fsm, *s_[K])
    vf = put(vf, vf * grid.fsm, *s_[K])
    return uf, vf


def orl_w(grid: Grid, cfg: Config, w: torch.Tensor) -> torch.Tensor:
    """idx=5: w mask."""
    return put(w, w * grid.fsm, *s_[:cfg.kbm1])


def orl_turb(grid: Grid, cfg: Config, uf,
             vf) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx=6: q2/q2l: the west and east edges clamped to 1e-10 at every
    level, then the fsm mask; the south and north rows keep profq's
    values."""
    uf = set_i(set_i(uf, 0, 1.0e-10), -1, 1.0e-10)
    vf = set_i(set_i(vf, 0, 1.0e-10), -1, 1.0e-10)
    return uf * grid.fsm, vf * grid.fsm
