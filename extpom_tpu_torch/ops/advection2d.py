"""External-mode advection and diffusion (``extpom_tpu/ops/advection2d.py``
``advave``; solver.f:6-121).  The mode-2 bottom-stress and curvature
branch (solver.f:123-193) is not ported yet."""

from __future__ import annotations

from typing import Tuple

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.ops.stencil import sft, put


def advave(grid: Grid, cfg: Config, d, ua, va, uab, vab, aam2d, wubot,
           wvbot, em=None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (advua, advva, wubot, wvbot); wubot/wvbot pass through
    (they change only in mode 2).  ``em`` carries the loop-invariant
    metrics of ``core.stepper.ext_precompute``."""
    if cfg.mode == 2:
        raise NotImplementedError("advave for mode=2 is not ported yet")
    dx, dy = grid.dx, grid.dy
    z = torch.zeros_like(d)
    if em is None:
        from extpom_tpu_torch.core.stepper import ext_precompute
        em = ext_precompute(grid)
    dx4, dy4 = em.dx4, em.dy4

    # ---- u advection & diffusion (solver.f:16-70) ----
    fluxua = put(z, 0.125 * ((sft(d, 1, 0) + d) * sft(ua, 1, 0)
                             + (d + sft(d, -1, 0)) * ua)
                 * (sft(ua, 1, 0) + ua),
                 slice(1, -1), slice(1, None))
    fluxva = put(z, 0.125 * ((d + sft(d, 0, -1)) * va
                             + (sft(d, -1, 0) + sft(d, -1, -1)) * sft(va, -1, 0))
                 * (ua + sft(ua, 0, -1)),
                 slice(1, None), slice(1, None))
    fluxua = put(fluxua,
                 fluxua - d * 2.0 * aam2d * (sft(uab, 1, 0) - uab) * em.rdx,
                 slice(1, -1), slice(1, None))
    # tps is reused by the v-part below, as in the reference
    tps = put(z, 0.25 * (d + sft(d, -1, 0) + sft(d, 0, -1) + sft(d, -1, -1))
              * (aam2d + sft(aam2d, 0, -1) + sft(aam2d, -1, 0)
                 + sft(aam2d, -1, -1))
              * ((uab - sft(uab, 0, -1)) * em.rdy4
                 + (vab - sft(vab, -1, 0)) * em.rdx4),
              slice(1, None), slice(1, None))
    fluxua = put(fluxua, fluxua * dy, slice(1, None), slice(1, None))
    fluxva = put(fluxva, (fluxva - tps) * 0.25 * dx4,
                 slice(1, None), slice(1, None))

    advua = put(z, fluxua - sft(fluxua, -1, 0) + sft(fluxva, 0, 1) - fluxva,
                slice(1, -1), slice(1, -1))

    # ---- v advection & diffusion (solver.f:72-121) ----
    fluxua = put(z, 0.125 * ((d + sft(d, -1, 0)) * ua
                             + (sft(d, 0, -1) + sft(d, -1, -1)) * sft(ua, 0, -1))
                 * (sft(va, -1, 0) + va),
                 slice(1, None), slice(1, None))
    fluxva = put(z, 0.125 * ((sft(d, 0, 1) + d) * sft(va, 0, 1)
                             + (d + sft(d, 0, -1)) * va)
                 * (sft(va, 0, 1) + va),
                 slice(1, None), slice(1, -1))
    fluxva = put(fluxva,
                 fluxva - d * 2.0 * aam2d * (sft(vab, 0, 1) - vab) * em.rdy,
                 slice(1, None), slice(1, -1))
    fluxva = put(fluxva, fluxva * dx, slice(1, None), slice(1, None))
    fluxua = put(fluxua, (fluxua - tps) * 0.25 * dy4,
                 slice(1, None), slice(1, None))

    advva = put(z, sft(fluxua, 1, 0) - fluxua + fluxva - sft(fluxva, 0, -1),
                slice(1, -1), slice(1, -1))
    return advua, advva, wubot, wvbot
