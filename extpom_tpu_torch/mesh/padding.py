"""Pad-and-mask support for grids that do not divide the mesh
(``extpom_tpu/mesh/padding.py``).

The reference shrinks its edge tiles (parallel_mpi.f:88-105); equal blocks
need the grid padded instead: every horizontal array grows to the next
multiple of the mesh extents, the pad cells are land (0; 1 for the metrics
in denominators), and the stencil layer resolves every region bound, edge
write and ``row``/``col`` read against the ACTIVE extents
(``Config.im_act``/``jm_act``, ``ops.stencil.domain_of``).  No committed
cell reads a pad cell, so a padded run equals the unpadded one on the
active region.

On the card the whole-grid kernels take the array's extents as the
domain's, so a padded model runs the decomposed step's block kernels
(``stepper.mesh_step``), on one device as a 1x1 mesh whose padded axes carry
a ring (:func:`ring_axes`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.core.state import State, Forcing

# grid metrics that sit in denominators: pad cells and rings beyond the
# physical domain hold 1 so that the arithmetic there stays finite (the
# values are never committed)
_GRID_PAD_ONE = frozenset({"dx", "dy", "h", "art", "aru", "arv"})
# which horizontal axis each per-side forcing series follows
FORCING_J_SERIES = frozenset({"elw", "ele", "uabw", "uabe", "vabw", "vabe",
                              "tbw", "tbe", "sbw", "sbe", "ubw", "ube",
                              "vbw", "vbe"})
FORCING_I_SERIES = frozenset({"els", "eln", "vabs", "vabn", "uabs", "uabn",
                              "tbs", "tbn", "sbs", "sbn", "vbs", "vbn",
                              "ubs", "ubn"})

# the reference serves its forcing records at the active extents and pads
# only the base forcing: its forced padded run fails, so the port's raises
FORCED_PADDED = ("time-varying forcing on a padded grid: the JAX package's "
                 "staged and host-assembled records are not padded")


def padded_dims(im: int, jm: int, px: int, py: int) -> Tuple[int, int]:
    """(im, jm) rounded up to multiples of (px, py)."""
    return -(-im // px) * px, -(-jm // py) * py


def ring_axes(cfg: Config, px: int, py: int) -> Tuple[bool, bool]:
    """Whether the blocks of a (px, py) mesh carry a ring along i and j: on
    a split axis, and on a padded one (the block kernels skip the cells
    next to an array edge that is not the domain's)."""
    ia, ja = cfg.active
    return px > 1 or ia != cfg.im, py > 1 or ja != cfg.jm


def _pad_hv(a: torch.Tensor, imp: int, jmp: int, fill: float) -> torch.Tensor:
    """A 2-D/3-D tensor with its trailing (im, jm) axes padded to (imp,
    jmp) with ``fill``."""
    out = a.new_full(a.shape[:-2] + (imp, jmp), fill)
    out[..., :a.shape[-2], :a.shape[-1]] = a
    return out


def _pad_1d(a: torch.Tensor, n: int) -> torch.Tensor:
    """A per-side series (.., m) padded with 0 to (.., n)."""
    out = a.new_zeros(a.shape[:-1] + (n,))
    out[..., :a.shape[-1]] = a
    return out


def pad_grid(grid: Grid, cfg: Config, imp: int, jmp: int) -> Grid:
    out = {}
    for f in dataclasses.fields(Grid):
        a = getattr(grid, f.name)
        if a.dim() >= 2 and a.shape[-2:] == (cfg.im, cfg.jm):
            a = _pad_hv(a, imp, jmp, 1.0 if f.name in _GRID_PAD_ONE else 0.0)
        out[f.name] = a
    return Grid(**out)


def _pad_tree(obj, im: int, jm: int, imp: int, jmp: int) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        a = getattr(obj, f.name)
        if a.dim() >= 2 and a.shape[-2:] == (im, jm):
            a = _pad_hv(a, imp, jmp, 0.0)
        elif f.name in FORCING_J_SERIES and a.shape[-1] == jm:
            a = _pad_1d(a, jmp)
        elif f.name in FORCING_I_SERIES and a.shape[-1] == im:
            a = _pad_1d(a, imp)
        out[f.name] = a
    return out


def pad_state(st, cfg: Config, imp: int, jmp: int):
    """A State (or the ``ColdInputs`` of a deferred cold start) padded."""
    return type(st)(**_pad_tree(st, cfg.im, cfg.jm, imp, jmp))


def pad_forcing(fc: Forcing, cfg: Config, imp: int, jmp: int) -> Forcing:
    return Forcing(**_pad_tree(fc, cfg.im, cfg.jm, imp, jmp))


def unpad(a, cfg: Config):
    """The active region of a padded (.., im, jm) tensor (a State: of each
    field); anything else as it is."""
    if isinstance(a, State):
        return State(**{f: unpad(getattr(a, f), cfg)
                        for f in State.field_names()})
    ia, ja = cfg.active
    if isinstance(a, torch.Tensor) and a.dim() >= 2:
        return a[..., :ia, :ja]
    return a


def pad_model(m, px: int, py: int) -> None:
    """Pad a :class:`~extpom_tpu_torch.core.model.Model` in place so that
    its arrays divide a (px, py) mesh; nothing where they already do.  A
    model with a forcing_fn raises: the reference pads no staged or
    host-assembled series, so its forced padded run fails."""
    cfg = m.cfg
    if cfg.im_act is not None or cfg.jm_act is not None:
        raise ValueError("model is already padded")
    if m.blocks is not None:
        raise ValueError("pad the model before it is decomposed")
    imp, jmp = padded_dims(cfg.im, cfg.jm, px, py)
    if (imp, jmp) == (cfg.im, cfg.jm):
        return
    if m.forcing_fn is not None:
        raise NotImplementedError(FORCED_PADDED)
    m.grid = pad_grid(m.grid, cfg, imp, jmp)
    m.state = pad_state(m.state, cfg, imp, jmp)
    m.base_forcing = pad_forcing(m.base_forcing, cfg, imp, jmp)
    for name in ("rmean", "tclim", "sclim"):
        a = getattr(m, name)
        if a is not None and a.dim() >= 2 and a.shape[-2:] == (cfg.im, cfg.jm):
            setattr(m, name, _pad_hv(a, imp, jmp, 0.0))
    m.cfg = cfg.replace(im=imp, jm=jmp, im_act=cfg.im, jm_act=cfg.jm)
    m.reset_plans()
