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

The forcing of a step reaches the blocks as a :class:`BlockForcing`,
which ``stepper.mesh_step`` hands to every stage: the static forcing, or a
Forcing of the whole grid (host-assembled, or interpolated once per step
from a staged plan) whose changed fields are cut to each block at the ring
a stage reads them.  A grid that does not divide the mesh is padded first
(``mesh/padding.py``, ``Model.shard``).

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
                                           FORCING_J_SERIES, ring_axes)


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


def _split(a: torch.Tensor, b, ni: int, nj: int) -> torch.Tensor:
    return a[..., b[0] * ni:(b[0] + 1) * ni,
             b[1] * nj:(b[1] + 1) * nj].contiguous()


def _window(a: torch.Tensor, lo: int, n: int, h: int, axis: int,
            fill: float) -> torch.Tensor:
    """Cells ``lo - h`` .. ``lo + n + h`` of ``a`` along ``axis``, ``fill``
    beyond its ends."""
    size = a.shape[axis]
    if h == 0 or (lo - h >= 0 and lo + n + h <= size):
        return a.narrow(axis, lo - h, n + 2 * h)
    shape = list(a.shape)
    shape[axis] = n + 2 * h
    out = a.new_full(shape, fill)
    a0, a1 = max(lo - h, 0), min(lo + n + h, size)
    out.narrow(axis, a0 - (lo - h), a1 - a0).copy_(a.narrow(axis, a0,
                                                            a1 - a0))
    return out


class BlockForcing:
    """The forcing of one step on the blocks, with its ``ramp``:
    ``make(b, h, names)`` builds block ``b``'s Forcing grown by the ring
    ``h``, for a stage that reads the fields ``names`` (all where None);
    :meth:`ext` keeps each for the step and sets the ramp."""

    def __init__(self, make, ramp: torch.Tensor):
        self._make, self.ramp, self._memo = make, ramp, {}

    def ext(self, b, h, names=None) -> Forcing:
        key = (b, tuple(h), names)
        if key not in self._memo:
            self._memo[key] = self._make(b, tuple(h), names).replace(
                ramp=self.ramp)
        return self._memo[key]


class Blocks:
    """A model decomposed over a :class:`Mesh`: per block (bi, bj) its local
    grid, state, forcing and climatology (``shard_args``), the ring
    exchange (:meth:`ext`, :meth:`trim`), the extended static operands,
    built once per ring width (:meth:`grid_ext`, :meth:`fc_ext`,
    :meth:`clim_ext`), and the forcing of a step on the blocks
    (:meth:`static_forcing`, :meth:`host_forcing`).

    A padded grid (``mesh/padding.py``) decomposes like any other; its
    blocks carry a ring along each padded axis too, so that a padded model
    on one device is a 1x1 mesh of blocks whose kernels skip no active
    cell (``padding.ring_axes``)."""

    def __init__(self, mesh: Mesh, cfg: Config, grid: Grid, st: State,
                 fc: Forcing, rmean, tclim, sclim):
        px, py = mesh.px, mesh.py
        if cfg.im % px or cfg.jm % py:
            raise ValueError(f"grid {cfg.im}x{cfg.jm} does not divide mesh "
                             f"{px}x{py}: pad it first "
                             f"(padding.pad_model, Model.shard)")
        device = mesh.device
        self.cfg = cfg
        self.px, self.py = px, py
        self.ni, self.nj = cfg.im // px, cfg.jm // py
        self.axes = ring_axes(cfg, px, py)
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
        self.base = fc
        self.fc = {b: self._cut(fc, b, to) for b in self.ids}
        self.clim = {b: tuple(to(_split(a, b, self.ni, self.nj))
                              for a in (rmean, tclim, sclim))
                     for b in self.ids}
        self._cache: dict = {}

    def window(self, name: str, a: torch.Tensor, b, h,
               fill: float = 0.0) -> torch.Tensor:
        """Block ``b``'s cells of the global tensor ``a`` grown by the ring
        ``h`` (``fill`` beyond the array), contiguous: a field over (..,
        im, jm) on both axes, the per-side series ``name`` along its axis
        (``FORCING_J_SERIES``/``FORCING_I_SERIES``), anything else as it
        is.  The ring holds what :meth:`ext` gives from the blocks' own
        cells."""
        im, jm = self.ni * self.px, self.nj * self.py
        if name in FORCING_J_SERIES:
            a = _window(a, b[1] * self.nj, self.nj, h[1], -1, fill)
        elif name in FORCING_I_SERIES:
            a = _window(a, b[0] * self.ni, self.ni, h[0], -1, fill)
        elif a.dim() >= 2 and a.shape[-2:] == (im, jm):
            a = _window(_window(a, b[0] * self.ni, self.ni, h[0], -2, fill),
                        b[1] * self.nj, self.nj, h[1], -1, fill)
        else:
            return a
        return a.contiguous()

    def _cut(self, obj, b, to):
        """Block ``b`` of a Grid, State or Forcing: fields over (im, jm)
        and per-side series cut to the block, the rest shared."""
        return type(obj)(**{f.name: to(self.window(f.name,
                                                   getattr(obj, f.name), b,
                                                   (0, 0)))
                            for f in dataclasses.fields(obj)})

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
        """A ring of ``width`` cells on the split and the padded axes, none
        on the others."""
        return (width if self.axes[0] else 0, width if self.axes[1] else 0)

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
        """Block ``b``'s static forcing ``fc`` extended by ``h``: 2-D and
        3-D fields by the ring, per-side series along their axis; built
        once per ring width."""
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

    # -- the forcing of a step ----------------------------------------------

    def static_forcing(self, ramp: torch.Tensor) -> BlockForcing:
        """The static forcing on the blocks, with the step's ``ramp``."""
        return BlockForcing(lambda b, h, names: self.fc_ext(b, h), ramp)

    def host_forcing(self, fc: Forcing) -> BlockForcing:
        """A Forcing of the whole grid (host-assembled by ``Model.run``, or
        ``forcing.device.forcing_at`` of a staged plan) on the blocks: each
        field that is not the static forcing's own tensor (``base``) is
        cut to the block and grown by the ring a stage reads it at, the
        rest come from :meth:`fc_ext`.  A changed field that the stage does
        not name is None, so that a reader missing from the stage's list
        fails instead of reading the static value."""
        changed = [f.name for f in dataclasses.fields(Forcing)
                   if f.name != "ramp"
                   and getattr(fc, f.name) is not getattr(self.base, f.name)]

        def make(b, h, names):
            return self.fc_ext(b, h).replace(**{
                n: (self.window(n, getattr(fc, n), b, h)
                    if names is None or n in names else None)
                for n in changed})
        return BlockForcing(make, fc.ramp)


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
    """A segment runner over ``blocks``: ``run(iint0, n_steps, first,
    plan)`` advances every block ``n_steps`` internal steps from step
    ``iint0`` (``stepper.run_steps``'s contract on blocks); the first step
    of a cold start (``first``) skips the internal 3-D block.  With a
    staged ``forcing.device.DevicePlan`` each step's forcing is
    interpolated from it once, on the whole grid, at the time
    ``forcing.device.t_days_at`` gives as on one device, and cut to the
    blocks (:meth:`Blocks.host_forcing`); otherwise the static forcing
    holds."""
    from extpom_tpu_torch.core import stepper
    from extpom_tpu_torch.forcing import device as fdev

    def run(iint0: int, n_steps: int, first: bool = False,
            plan=None) -> None:
        el = blocks.state[blocks.ids[0]].el
        for n in range(n_steps):
            i = iint0 + 1 + n
            ramp = torch.full((), stepper.ramp_at(cfg, i, period_days,
                                                  time0_days),
                              dtype=el.dtype, device=el.device)
            if plan is None:
                fc = blocks.static_forcing(ramp)
            else:
                fc = blocks.host_forcing(fdev.forcing_at(
                    plan, blocks.base, cfg, blocks.grid[blocks.ids[0]].dz,
                    fdev.t_days_at(cfg, i, time0_days, el.dtype)).replace(
                        ramp=ramp))
            stepper.mesh_step(blocks, cfg, fc, first=first and n == 0)

    return run
