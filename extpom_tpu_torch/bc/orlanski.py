"""Orlanski radiation open boundaries (``extpom_tpu/bc/orlanski.py``;
bounds_forcing.f:331-590): the two the extpom scheme runs, internal velocity
``orl_vel3d`` (idx 3) and the w mask ``orl_w`` (idx 5).  ``orl_el``,
``orl_vel2d``, ``orl_ts`` and ``orl_turb`` (the ``orlanski`` scheme) are not
ported yet.

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


def orl_vel3d(grid: Grid, cfg: Config, uf, vf, u, ub, v,
              vb) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx=3: internal velocity Orlanski radiation."""
    K = slice(0, cfg.kbm1)
    uf, vf = _orl_uv(uf, vf, u, ub, v, vb,
                     J=slice(1, -1), I=slice(1, -1), k=K)
    uf = put(uf, uf * grid.dum, *s_[K])
    vf = put(vf, vf * grid.dvm, *s_[K])
    return uf, vf


def orl_w(grid: Grid, cfg: Config, w: torch.Tensor) -> torch.Tensor:
    """idx=5: w mask."""
    return put(w, w * grid.fsm, *s_[:cfg.kbm1])
