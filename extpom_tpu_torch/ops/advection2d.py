"""External-mode advection and diffusion (``extpom_tpu/ops/advection2d.py``
``advave``; solver.f:6-193), with the mode-2 depth-mean bottom stress and
curvature terms."""

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
    outside mode 2, where they are the bottom stress of the depth-mean flow
    (solver.f:123-143).  ``em`` carries the loop-invariant metrics of
    ``core.stepper.ext_precompute``."""
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

    if cfg.mode == 2:
        cbc = grid.cbc
        # depth-mean bottom stress (solver.f:125-143)
        wubot = put(wubot,
                    -0.5 * (cbc + sft(cbc, -1, 0))
                    * torch.sqrt(uab ** 2
                                 + (0.25 * (vab + sft(vab, 0, 1)
                                            + sft(vab, -1, 0)
                                            + sft(vab, -1, 1))) ** 2) * uab,
                    slice(1, -1), slice(1, -1))
        wvbot = put(wvbot,
                    -0.5 * (cbc + sft(cbc, 0, -1))
                    * torch.sqrt(vab ** 2
                                 + (0.25 * (uab + sft(uab, 1, 0)
                                            + sft(uab, 0, -1)
                                            + sft(uab, 1, -1))) ** 2) * vab,
                    slice(1, -1), slice(1, -1))
        # curvature terms (solver.f:145-193); advua's range starts at
        # global i = 2 and advva's at global j = 2
        curv2d = put(z, 0.25 * ((sft(va, 0, 1) + va)
                                * (sft(dy, 1, 0) - sft(dy, -1, 0))
                                - (sft(ua, 1, 0) + ua)
                                * (sft(dx, 0, 1) - sft(dx, 0, -1)))
                     * em.rart,
                     slice(1, -1), slice(1, -1))
        advua = put(advua,
                    advua - grid.aru * 0.25
                    * (curv2d * d * (sft(va, 0, 1) + va)
                       + sft(curv2d, -1, 0) * sft(d, -1, 0)
                       * (sft(va, -1, 1) + sft(va, -1, 0))),
                    slice(2, -1), slice(1, -1))
        advva = put(advva,
                    advva + grid.arv * 0.25
                    * (curv2d * d * (sft(ua, 1, 0) + ua)
                       + sft(curv2d, 0, -1) * sft(d, 0, -1)
                       * (sft(ua, 1, -1) + sft(ua, 0, -1))),
                    slice(1, -1), slice(2, -1))
    return advua, advva, wubot, wvbot
