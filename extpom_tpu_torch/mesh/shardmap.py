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

Several processes run one decomposed model (``mesh/distributed.py``):
each owns a contiguous run of the blocks on its one device (``Mesh``
knows each block's rank), and the ring of a stage comes from the other
ranks' blocks by one exchange per stage (:meth:`Blocks.ext_all`,
``extchunk.ring_extend_all``).  Blocks on several devices in one process
are not supported: a process has one card, and a mesh spans cards by its
processes.
"""

from __future__ import annotations

import dataclasses
import types
from collections.abc import Mapping

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.core.state import State, Forcing
from extpom_tpu_torch.diag.profiling import span
from extpom_tpu_torch.mesh import extchunk
from extpom_tpu_torch.mesh.distributed import Slabs
from extpom_tpu_torch.mesh.extchunk import _ring_extend, _ring_extend_1d
from extpom_tpu_torch.mesh.padding import (_GRID_PAD_ONE, FORCING_I_SERIES,
                                           FORCING_J_SERIES, ring_axes)


class Mesh:
    """A px x py decomposition: blocks (bi, bj), bi along i ('x') and bj
    along j ('y'), the device of each (``devices``, row-major; by default
    all on ``device``: the card unless it says otherwise, under several
    processes the rank's device) and the rank that owns each
    (``owner``; ``owned``, this process's blocks, row-major:
    ``distributed.owned_blocks``)."""

    def __init__(self, px: int, py: int, device=None, devices=None):
        from extpom_tpu_torch.cases.seamount import resolve_device
        from extpom_tpu_torch.mesh import distributed
        if px < 1 or py < 1:
            raise ValueError(f"invalid mesh {px}x{py}")
        procs = distributed.procs()
        if devices is None:
            if device is None and procs.world > 1:
                device = procs.device
            devices = [resolve_device(device)] * (px * py)
        devices = [torch.device(d) for d in devices]
        if len(devices) != px * py:
            raise ValueError(f"mesh {px}x{py} needs {px * py} devices, got "
                             f"{len(devices)}")
        self.px, self.py, self.devices = px, py, devices
        self.rank, self.world = procs.rank, procs.world
        self.owner = distributed.owner_map(px, py, self.world)
        self.owned = distributed.owned_blocks(px, py, self.rank, self.world)

    @property
    def device(self) -> torch.device:
        """The one device that holds this process's blocks."""
        mine = [self.devices[bi * self.py + bj] for bi, bj in self.owned]
        if len({(d.type, d.index or 0) for d in mine}) > 1:
            raise NotImplementedError(
                "blocks on several devices in one process: run one process "
                "per card (torchrun, mesh/distributed.py)")
        return mine[0]


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


class _Ring(Mapping):
    """Block -> the block's tensor of ``vals`` grown by the ring ``h``,
    formed when it is read (``_ring_extend``, ``_ring_extend_1d`` for a
    per-side series along ``axis``): the ring of one process."""

    def __init__(self, vals: dict, h, fill: float, axis):
        self.vals, self.h, self.fill, self.axis = vals, h, fill, axis

    def __getitem__(self, b) -> torch.Tensor:
        if self.axis is None:
            return _ring_extend(self.vals, b, self.h[0], self.h[1],
                                self.fill)
        return _ring_extend_1d(self.vals, b,
                               self.h[0 if self.axis == "x" else 1],
                               self.axis)

    def __iter__(self):
        return iter(self.vals)

    def __len__(self) -> int:
        return len(self.vals)


class Blocks:
    """A model decomposed over a :class:`Mesh`: per block (bi, bj) of this
    process (``ids``, row-major; ``owner``: every block's rank) its local
    grid, state, forcing and climatology (``shard_args``), the ring
    exchange (:meth:`ext`, :meth:`ext_all`, :meth:`trim`), the extended
    static operands, built once per ring width (:meth:`grid_ext`,
    :meth:`fc_ext`, :meth:`clim_ext`), and the forcing of a step on the
    blocks (:meth:`static_forcing`, :meth:`host_forcing`).

    The global arrays it is given may lie on another device than the
    mesh's (a model built on the host and decomposed onto the card): each
    block is cut from them and moved.  With ``cold`` the state is a
    deferred cold start's inputs (``core.model.ColdInputs``), and the cold
    start runs on each block on the mesh's device (:meth:`_cold_block`),
    so that the blocks hold what a model built on that device holds, bit
    for bit.

    A padded grid (``mesh/padding.py``) decomposes like any other; its
    blocks carry a ring along each padded axis too, so that a padded model
    on one device is a 1x1 mesh of blocks whose kernels skip no active
    cell (``padding.ring_axes``)."""

    def __init__(self, mesh: Mesh, cfg: Config, grid: Grid, st: State,
                 fc: Forcing, rmean, tclim, sclim, cold: bool = False):
        px, py = mesh.px, mesh.py
        if cfg.im % px or cfg.jm % py:
            raise ValueError(f"grid {cfg.im}x{cfg.jm} does not divide mesh "
                             f"{px}x{py}: pad it first "
                             f"(padding.pad_model, Model.shard)")
        self.device = device = mesh.device
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
        self.ids = list(mesh.owned)
        self.owner, self.rank, self.world = mesh.owner, mesh.rank, mesh.world
        to = lambda a: a.to(device)
        self.grid = {b: self._cut(grid, b, to) for b in self.ids}
        self.base = fc
        self.fc = {b: self._cut(fc, b, to) for b in self.ids}
        clim = (tclim, sclim)
        if cold:
            self.state, rm = {}, {}
            for b in self.ids:
                self.state[b], rm[b] = self._cold_block(grid, st, clim, b)
        else:
            self.state = {b: self._cut(st, b, to) for b in self.ids}
            rm = {b: to(_split(rmean, b, self.ni, self.nj)) for b in self.ids}
        self.clim = {b: (rm[b],) + tuple(to(_split(a, b, self.ni, self.nj))
                                         for a in clim)
                     for b in self.ids}
        self._cache: dict = {}

    def _cold_block(self, grid: Grid, st, clim, b) -> tuple:
        """Block ``b``'s (state, rmean) of a cold start on the mesh's
        device, from the cold start's own inputs in ``st`` (a
        ``core.model.ColdInputs``: tb, sb, elb, uab, vab, ub, vb) and
        ``clim`` (tclim, sclim) and the grid, each cut with the ring that
        the pressure gradient reads (one cell on a split or padded axis)
        and moved; the regions are the global ones (``domain_of``), the
        ring is trimmed, and the pad cells of a padded grid hold 0, as
        ``padding.pad_model`` leaves them after a whole-grid cold start."""
        from extpom_tpu_torch.core.model import cold_start
        from extpom_tpu_torch.ops.stencil import domain_of
        h = self.ring(1)
        cut = lambda name, a, fill=0.0: self.window(name, a, b, h, fill).to(
            self.device)
        g = Grid(**{f.name: cut(f.name, getattr(grid, f.name),
                                1.0 if f.name in _GRID_PAD_ONE else 0.0)
                    for f in dataclasses.fields(Grid)})
        ics = {k: cut(k, getattr(st, k))
               for k in ("tb", "sb", "elb", "uab", "vab", "ub", "vb")}
        with domain_of(self.cfg, self.goff(b, h)):
            s, rmean = cold_start(g, self.cfg, ics["tb"], ics["sb"],
                                  *(cut("", a) for a in clim), ics["elb"],
                                  ics["uab"], ics["vab"], ics["ub"],
                                  ics["vb"])
        (i0, i1), (j0, j1) = self.active_span(b)

        def own(a):
            a = self.trim(a, h)
            if (i1 - i0, j1 - j0) != (self.ni, self.nj):
                keep = torch.zeros_like(a)
                keep[..., :i1 - i0, :j1 - j0] = a[..., :i1 - i0, :j1 - j0]
                a = keep
            return a
        return (State(**{f: own(getattr(s, f)) for f in State.field_names()}),
                own(rmean))

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
        (hx, hy) cells of its neighbours' (one process)."""
        return _ring_extend(vals, b, h[0], h[1], fill)

    def ext_all(self, fields: list, h, fills=0.0, axes=None) -> list:
        """Every field of ``fields`` (each a dict: block -> tensor, or
        None) grown by the ring ``h`` on every block of this process, in
        one exchange with the other ranks (``extchunk.ring_extend_all``);
        ``fills`` and ``axes`` as there.  One process reads its own blocks:
        each mapping then extends a block when it is read, as :meth:`ext`
        does, so that one block's extended operands are live at a time.
        Every rank must make the same calls in the same order; a None
        field stays None."""
        nf = len(fields)
        fills = list(fills) if isinstance(fills, (list, tuple)) else \
            [fills] * nf
        axes = [None] * nf if axes is None else list(axes)
        live = [k for k, f in enumerate(fields) if f is not None]
        out = [None] * nf
        if self.world == 1:
            for k in live:
                out[k] = _Ring(fields[k], h, fills[k], axes[k])
            return out
        got = extchunk.ring_extend_all(
            [fields[k] for k in live], h, self.owner, self.rank,
            [fills[k] for k in live], [axes[k] for k in live])
        for k, g in zip(live, got):
            out[k] = g
        return out

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

    def _static(self, key, names, get, h, make, fills=0.0, axes=None):
        """Block -> ``make(b, {name: extended tensor})`` of ``key``, built
        once: the fields ``names`` (``get(b, name)`` on each block) grown
        by ``h`` in one exchange.  Every rank builds the same keys in the
        same order (the step reads them in one order on every rank)."""
        if key not in self._cache:
            ext = self.ext_all([{b: get(b, n) for b in self.ids}
                                for n in names], h, fills, axes)
            self._cache[key] = {b: make(b, {n: e[b]
                                            for n, e in zip(names, ext)})
                                for b in self.ids}
        return self._cache[key]

    def grid_ext(self, b, h) -> Grid:
        """Block ``b``'s grid extended by ``h`` (1 beyond the domain for
        the metrics in denominators)."""
        g0 = self.grid[self.ids[0]]
        names = [f.name for f in dataclasses.fields(Grid)
                 if getattr(g0, f.name).dim() >= 2
                 and getattr(g0, f.name).shape[-2:] == (self.ni, self.nj)]
        return self._static(
            ("grid", h), names, lambda q, n: getattr(self.grid[q], n), h,
            lambda q, e: dataclasses.replace(self.grid[q], **e),
            [1.0 if n in _GRID_PAD_ONE else 0.0 for n in names])[b]

    def fc_ext(self, b, h) -> Forcing:
        """Block ``b``'s static forcing ``fc`` extended by ``h``: 2-D and
        3-D fields by the ring, per-side series along their axis; built
        once per ring width."""
        f0 = self.fc[self.ids[0]]
        names, axes = [], []
        for f in dataclasses.fields(Forcing):
            a = getattr(f0, f.name)
            axis = ("y" if f.name in FORCING_J_SERIES else
                    "x" if f.name in FORCING_I_SERIES else None)
            if axis or (a.dim() >= 2 and a.shape[-2:] == (self.ni, self.nj)):
                names.append(f.name)
                axes.append(axis)
        return self._static(
            ("fc", h), names, lambda q, n: getattr(self.fc[q], n), h,
            lambda q, e: self.fc[q].replace(**e), 0.0, axes)[b]

    def clim_ext(self, b, h) -> tuple:
        """Block ``b``'s (rmean, tclim, sclim) extended by ``h``."""
        return self._static(("clim", h), (0, 1, 2),
                            lambda q, k: self.clim[q][k], h,
                            lambda q, e: (e[0], e[1], e[2]))[b]

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
                n: (self.window(n, getattr(fc, n), b, h).to(self.device)
                    if names is None or n in names else None)
                for n in changed})
        return BlockForcing(make, fc.ramp)

    # -- several processes: what each rank writes and reads ----------------

    def slabs(self, vals: dict) -> Slabs:
        """This process's hyperslabs of the global array whose blocks are
        ``vals`` (block -> (.., ni, nj) tensor), on the active region of a
        padded grid; a chunk of the array is a block, so that each chunk
        is written by one rank."""
        ia, ja = self.cfg.active
        a0 = vals[self.ids[0]]
        lead = tuple(a0.shape[:-2])
        pieces = {}
        for b in self.ids:
            (i0, i1), (j0, j1) = self.active_span(b)
            if i1 > i0 and j1 > j0:
                pieces[((i0, i1), (j0, j1))] = vals[b][..., :i1 - i0,
                                                       :j1 - j0]
        return Slabs(lead + (ia, ja), str(a0.dtype).replace("torch.", ""),
                     lead + (min(self.ni, ia), min(self.nj, ja)), pieces)

    def state_slabs(self, names=None) -> types.SimpleNamespace:
        """The State fields ``names`` (every one by default) as
        :meth:`slabs`: a restart or a snapshot of this process's blocks for
        the cooperative writes of ``io.zarrstore``."""
        return types.SimpleNamespace(**{
            n: self.slabs(self.field(n))
            for n in (State.field_names() if names is None else names)})

    def active_span(self, b) -> tuple:
        """((i0, i1), (j0, j1)): the global cells of block ``b`` that lie in
        the active region (empty where it is all padding)."""
        ia, ja = self.cfg.active
        i0, j0 = b[0] * self.ni, b[1] * self.nj
        return ((i0, max(i0, min(i0 + self.ni, ia))),
                (j0, max(j0, min(j0 + self.nj, ja))))

    def load_state(self, read) -> None:
        """Replace every block's state by what ``read(name, (i0, i1), (j0,
        j1))`` gives (the hyperslab of a State field on the active region,
        as numpy); pad cells hold 0, as ``padding.pad_state`` leaves
        them."""
        for b in self.ids:
            (i0, i1), (j0, j1) = self.active_span(b)
            fields = {}
            for name in State.field_names():
                a = torch.zeros_like(getattr(self.state[b], name))
                if i1 > i0 and j1 > j0:
                    a[..., :i1 - i0, :j1 - j0] = torch.as_tensor(
                        read(name, (i0, i1), (j0, j1)), dtype=a.dtype)
                fields[name] = a
            self.state[b] = State(**fields)


def shard_args(mesh: Mesh, cfg: Config, grid: Grid, st: State, fc: Forcing,
               rmean, tclim, sclim, cold: bool = False) -> Blocks:
    """The blocks of (grid, state, forcing, climatology) on ``mesh``."""
    return Blocks(mesh, cfg, grid, st, fc, rmean, tclim, sclim, cold)


def one_process(blocks: Blocks, what: str) -> None:
    """Raise for ``what`` under several processes: each holds only its
    blocks."""
    if blocks.world > 1:
        raise RuntimeError(
            f"{what} under several processes: each holds only its blocks "
            f"(a whole state is ~14 GB at 2048x2048x41 f32, and the JAX "
            f"driver never gathers one either); use the block forms of "
            f"diag.stats and the cooperative writes of io.zarrstore")


def gather(blocks: Blocks, vals: dict) -> torch.Tensor:
    """The global tensor of a per-block dict of (.., ni, nj) tensors (one
    process)."""
    one_process(blocks, "a gather")
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
            with span("step"):
                i = iint0 + 1 + n
                ramp = torch.full((), stepper.ramp_at(cfg, i, period_days,
                                                      time0_days),
                                  dtype=el.dtype, device=el.device)
                if plan is None:
                    fc = blocks.static_forcing(ramp)
                else:
                    with span("forcing"):
                        fc = blocks.host_forcing(fdev.forcing_at(
                            plan, blocks.base, cfg,
                            blocks.grid[blocks.ids[0]].dz,
                            fdev.t_days_at(cfg, i, time0_days,
                                           el.dtype)).replace(ramp=ramp))
                stepper.mesh_step(blocks, cfg, fc, first=first and n == 0)

    return run
