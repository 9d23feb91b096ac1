"""The decomposed (shard-local) step (``extpom_tpu/mesh/shardmap.py``).

The JAX package traces one SPMD program per shard and turns every shifted
read into a ``lax.ppermute``.  Here one process drives all the blocks of a
px x py :class:`Mesh` and runs the step stage by stage
(``core.stepper.mesh_step``): for each stage and each block it grows the
stage's inputs by a ring of the neighbours' current values
(``mesh.extchunk._ring_extend``), runs the stage on the extended block
under a ``DomainCtx`` that carries the block's global offset, and trims the
ring.  Outputs are new tensors, so the blocks of a stage may run in any
order, and only one block's extended operands are live at a time.

Every block lives on one device in this slice; blocks on several devices,
and processes that each own some blocks, are the next.
"""

from __future__ import annotations

import dataclasses

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.core.state import State, Forcing
from extpom_tpu_torch.mesh import extchunk
from extpom_tpu_torch.mesh.extchunk import _ring_extend, _ring_extend_1d
from extpom_tpu_torch.mesh.padding import (_GRID_PAD_ONE, FORCING_I_SERIES,
                                           FORCING_J_SERIES)
from extpom_tpu_torch.ops import stencil


class Mesh:
    """A px x py decomposition: blocks (bi, bj), bi along i ('x') and bj
    along j ('y'), and the device of each (``devices``, row-major; by
    default all on ``device``, the card unless it says otherwise)."""

    def __init__(self, px: int, py: int, device=None, devices=None):
        from extpom_tpu_torch.cases.seamount import resolve_device
        if px < 1 or py < 1:
            raise ValueError(f"invalid mesh {px}x{py}")
        if devices is None:
            devices = [resolve_device(device)] * (px * py)
        devices = [torch.device(d) for d in devices]
        if len(devices) != px * py:
            raise ValueError(f"mesh {px}x{py} needs {px * py} devices, got "
                             f"{len(devices)}")
        self.px, self.py, self.devices = px, py, devices

    @property
    def device(self) -> torch.device:
        """The one device that holds every block."""
        if len({(d.type, d.index or 0) for d in self.devices}) > 1:
            raise NotImplementedError("blocks on several devices: next slice")
        return self.devices[0]


def _local_ctx(cfg: Config, goff) -> stencil.DomainCtx:
    """The DomainCtx of an extended block whose cell (0, 0) is global
    ``goff``: the stages of ``stepper.mesh_step`` that run plain PyTorch
    on a block run under it (the block wrappers of ``kernels/`` build the
    same from their ``off``)."""
    return stencil.DomainCtx(cfg.im, cfg.jm, *goff)


def _split(a: torch.Tensor, b, ni: int, nj: int) -> torch.Tensor:
    return a[..., b[0] * ni:(b[0] + 1) * ni,
             b[1] * nj:(b[1] + 1) * nj].contiguous()


class Blocks:
    """A model decomposed over a :class:`Mesh`: per block (bi, bj) its local
    grid, state, forcing and climatology (``shard_args``), the ring
    exchange (:meth:`ext`, :meth:`trim`) and the extended static operands,
    built once per ring width (:meth:`grid_ext`, :meth:`fc_ext`,
    :meth:`clim_ext`)."""

    def __init__(self, mesh: Mesh, cfg: Config, grid: Grid, st: State,
                 fc: Forcing, rmean, tclim, sclim):
        px, py = mesh.px, mesh.py
        if cfg.im % px or cfg.jm % py:
            raise NotImplementedError(
                f"grid {cfg.im}x{cfg.jm} does not divide mesh {px}x{py}: "
                f"padding ragged grids is not ported yet")
        device = mesh.device
        self.px, self.py = px, py
        self.ni, self.nj = cfg.im // px, cfg.jm // py
        # every ring the step will read must fit a block: the phases', the
        # interaction's and (extchunk._chunk raises) the external loop's;
        # the phase kernels need a ring as wide as the cells they skip
        from extpom_tpu_torch.core.stepper import INTERACTION_RADIUS
        from extpom_tpu_torch.kernels.phases import MESH_MARGIN
        if cfg.phase_halo < MESH_MARGIN:
            raise ValueError(f"phase_halo {cfg.phase_halo} < {MESH_MARGIN}, "
                             f"the cells the block phase kernels skip next "
                             f"to a split edge")
        for width in (cfg.phase_halo, INTERACTION_RADIUS):
            h = self.ring(width)
            if h[0] > self.ni or h[1] > self.nj:
                raise ValueError(f"a ring of {h} cells is wider than the "
                                 f"({self.ni}, {self.nj}) blocks it would "
                                 f"be read from")
        # MPDATA's upstream steps widen the tracer phase's reach by a cell
        # each: the ring must cover it
        from extpom_tpu_torch.kernels.phases import mpdata_radius
        if cfg.nadv == 2 and mpdata_radius(cfg) > cfg.phase_halo:
            raise ValueError(f"nadv=2 with nitera={cfg.nitera} reads "
                             f"{mpdata_radius(cfg)} cells, more than the "
                             f"phase ring of {cfg.phase_halo}")
        extchunk._chunk(cfg, px, py, self.ni, self.nj)
        self.ids = [(bi, bj) for bi in range(px) for bj in range(py)]
        to = lambda a: a.to(device)
        self.grid = {b: self._cut(grid, b, to) for b in self.ids}
        self.state = {b: self._cut(st, b, to) for b in self.ids}
        self.fc = {b: self._cut(fc, b, to) for b in self.ids}
        self.clim = {b: tuple(to(_split(a, b, self.ni, self.nj))
                              for a in (rmean, tclim, sclim))
                     for b in self.ids}
        self._cache: dict = {}

    def _cut(self, obj, b, to):
        """Block ``b`` of a Grid, State or Forcing: fields over (im, jm)
        and per-side series cut to the block, the rest shared."""
        im, jm = self.ni * self.px, self.nj * self.py
        out = {}
        for f in dataclasses.fields(obj):
            a = getattr(obj, f.name)
            if f.name in FORCING_J_SERIES:
                a = a[..., b[1] * self.nj:(b[1] + 1) * self.nj].contiguous()
            elif f.name in FORCING_I_SERIES:
                a = a[..., b[0] * self.ni:(b[0] + 1) * self.ni].contiguous()
            elif a.dim() >= 2 and a.shape[-2:] == (im, jm):
                a = _split(a, b, self.ni, self.nj)
            out[f.name] = to(a)
        return type(obj)(**out)

    # -- the ring -----------------------------------------------------------

    def ext(self, vals: dict, b, h, fill: float = 0.0) -> torch.Tensor:
        """Block ``b``'s tensor of ``vals`` grown by a ring of ``h`` =
        (hx, hy) cells of its neighbours'."""
        return _ring_extend(vals, b, h[0], h[1], fill)

    def trim(self, a: torch.Tensor, h) -> torch.Tensor:
        """The block's own cells of an extended tensor."""
        hx, hy = h
        if not (hx or hy):
            return a
        return a[..., hx:hx + self.ni, hy:hy + self.nj].contiguous()

    def goff(self, b, h) -> tuple:
        """Global (i, j) of cell (0, 0) of block ``b`` extended by ``h``."""
        return (b[0] * self.ni - h[0], b[1] * self.nj - h[1])

    def ring(self, width: int) -> tuple:
        """A ring of ``width`` cells on the split axes, none on the
        others."""
        return (width if self.px > 1 else 0, width if self.py > 1 else 0)

    def field(self, name: str) -> dict:
        """Block -> the state field ``name``."""
        return {b: getattr(self.state[b], name) for b in self.ids}

    def _static(self, key, build):
        if key not in self._cache:
            self._cache[key] = {b: build(b) for b in self.ids}
        return self._cache[key]

    def grid_ext(self, b, h) -> Grid:
        """Block ``b``'s grid extended by ``h`` (1 beyond the domain for
        the metrics in denominators)."""
        def build(q):
            g = self.grid[q]
            out = {}
            for f in dataclasses.fields(Grid):
                a = getattr(g, f.name)
                if a.dim() >= 2 and a.shape[-2:] == (self.ni, self.nj):
                    a = self.ext({p: getattr(self.grid[p], f.name)
                                  for p in self.ids}, q, h,
                                 1.0 if f.name in _GRID_PAD_ONE else 0.0)
                out[f.name] = a
            return Grid(**out)
        return self._static(("grid", h), build)[b]

    def fc_ext(self, b, h) -> Forcing:
        """Block ``b``'s forcing extended by ``h``: 2-D and 3-D fields by
        the ring, per-side series along their axis."""
        def build(q):
            out = {}
            for f in dataclasses.fields(Forcing):
                vals = {p: getattr(self.fc[p], f.name) for p in self.ids}
                a = vals[q]
                if f.name in FORCING_J_SERIES:
                    a = _ring_extend_1d(vals, q, h[1], "y")
                elif f.name in FORCING_I_SERIES:
                    a = _ring_extend_1d(vals, q, h[0], "x")
                elif a.dim() >= 2 and a.shape[-2:] == (self.ni, self.nj):
                    a = self.ext(vals, q, h)
                out[f.name] = a
            return Forcing(**out)
        return self._static(("fc", h), build)[b]

    def clim_ext(self, b, h) -> tuple:
        """Block ``b``'s (rmean, tclim, sclim) extended by ``h``."""
        def build(q):
            return tuple(self.ext({p: self.clim[p][k] for p in self.ids},
                                  q, h) for k in range(3))
        return self._static(("clim", h), build)[b]


def shard_args(mesh: Mesh, cfg: Config, grid: Grid, st: State, fc: Forcing,
               rmean, tclim, sclim) -> Blocks:
    """The blocks of (grid, state, forcing, climatology) on ``mesh``."""
    return Blocks(mesh, cfg, grid, st, fc, rmean, tclim, sclim)


def gather(blocks: Blocks, vals: dict) -> torch.Tensor:
    """The global tensor of a per-block dict of (.., ni, nj) tensors."""
    return torch.cat([torch.cat([vals[(bi, bj)] for bj in range(blocks.py)],
                                dim=-1) for bi in range(blocks.px)], dim=-2)


def gather_state(blocks: Blocks) -> State:
    return State(**{f: gather(blocks, blocks.field(f))
                    for f in State.field_names()})


def make_shardmap_run(blocks: Blocks, cfg: Config, period_days: float,
                      time0_days: float = 0.0):
    """A segment runner over ``blocks``: ``run(iint0, n_steps, first)``
    advances every block ``n_steps`` internal steps from step ``iint0``
    (``stepper.run_steps``'s contract on blocks); the first step of a cold
    start (``first``) skips the internal 3-D block."""
    from extpom_tpu_torch.core import stepper

    def run(iint0: int, n_steps: int, first: bool = False) -> None:
        el = blocks.state[blocks.ids[0]].el
        for n in range(n_steps):
            ramp = torch.full((), stepper.ramp_at(cfg, iint0 + 1 + n,
                                                  period_days, time0_days),
                              dtype=el.dtype, device=el.device)
            stepper.mesh_step(blocks, cfg, ramp, first=first and n == 0)

    return run
