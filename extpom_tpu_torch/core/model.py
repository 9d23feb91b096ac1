"""High-level model driver (``extpom_tpu/core/model.py``): cold start, the
time loop, print-interval diagnostics and the blow-up guard, on one device
or decomposed over a mesh (:meth:`Model.shard`, which pads a grid that does
not divide it), with time-varying forcing from a ``forcing_fn`` (a
``forcing.provider.ForcingProvider``: staged on the device for
:meth:`Model.run_segment`, cut to the blocks on a mesh; assembled on the
host per step for :meth:`Model.step_once` and :meth:`Model.run`).

A padded model (``mesh.padding.pad_model``) keeps its padded global state
in ``state`` on one device and runs the decomposed step on a 1x1 mesh of
blocks; a padded model with a forcing_fn raises ``NotImplementedError``, as
the reference cannot run one."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.core.state import State, Forcing, zero_state, zero_forcing
from extpom_tpu_torch.core import stepper
from extpom_tpu_torch.ops import density, pressure
from extpom_tpu_torch.diag import stats as diag_stats
from extpom_tpu_torch.diag.profiling import host_value, host_values, span


def _as(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous tensor of ``like``'s dtype and device (an
    initial field read from a file may be a strided view; the kernels take
    contiguous operands)."""
    return torch.as_tensor(x, dtype=like.dtype,
                           device=like.device).contiguous()


def cold_start(grid: Grid, cfg: Config, tb, sb, tclim, sclim, elb=None,
               uab=None, vab=None, ub=None, vb=None):
    """Initial State + rmean, as ``initial_conditions`` + ``update_initial``
    (initialize.f:392-521).  Returns (state, rmean)."""
    h = grid.h
    st = zero_state(cfg, device=h.device, dtype=h.dtype, shape=h.shape)
    z2 = torch.zeros_like(h)
    elb = z2 if elb is None else _as(elb, h)
    uab = z2 if uab is None else _as(uab, h)
    vab = z2 if vab is None else _as(vab, h)
    tb, sb, tclim, sclim = (_as(x, h) for x in (tb, sb, tclim, sclim))

    rmean = density.dens(grid, cfg, sclim, tclim)
    rho = density.dens(grid, cfg, sb, tb)

    et = elb
    dt2 = h + et
    # MY-2.5 seeds (initialize.f:481-494)
    l0 = torch.broadcast_to(0.1 * dt2, (cfg.kb,) + h.shape).contiguous()
    q2b = torch.full_like(l0, cfg.small)
    q2lb = l0 * q2b
    kh = l0 * torch.sqrt(q2b)
    aam = torch.full_like(l0, cfg.aam_init)
    u0 = torch.zeros_like(l0) if ub is None else _as(ub, h)
    v0 = torch.zeros_like(l0) if vb is None else _as(vb, h)

    st = st.replace(
        el=elb, elb=elb, et=et, etb=et, etf=et,
        ua=uab, uab=uab, va=vab, vab=vab,
        utb=uab * dt2, vtb=vab * dt2,
        t=tb, tb=tb, s=sb, sb=sb, rho=rho,
        u=u0, ub=u0, v=v0, vb=v0,
        l=l0, q2=q2b, q2b=q2b, q2l=q2lb, q2lb=q2lb,
        kh=kh, km=kh, kq=kh, aam=aam,
    )
    ramp = torch.ones((), dtype=h.dtype, device=h.device)
    if cfg.npg == 1:
        drhox, drhoy = pressure.baropg(grid, cfg, rho, rmean, dt2, ramp)
    else:
        drhox, drhoy = pressure.baropg_mcc(grid, cfg, rho, rmean, h + elb,
                                           dt2, ramp)
    dz3 = grid.dz3[:cfg.kbm1]
    st = st.replace(drx2d=torch.sum(drhox[:cfg.kbm1] * dz3, dim=0),
                    dry2d=torch.sum(drhoy[:cfg.kbm1] * dz3, dim=0))
    return st, rmean


def edge_forcing(fc: Forcing, tb, sb, elb, uab, vab, ub, vb) -> Forcing:
    """Open-boundary data from the initial edge columns (initialize.f:
    437-460, plus the elevation/velocity edges the reference reads from its
    .lbry file).  Slices are made contiguous: the kernels take them as
    flat series."""
    c = lambda a: a.contiguous()
    return fc.replace(
        tbe=c(tb[:, -1, :]), tbw=c(tb[:, 0, :]), sbe=c(sb[:, -1, :]),
        sbw=c(sb[:, 0, :]), tbn=c(tb[:, :, -1]), tbs=c(tb[:, :, 0]),
        sbn=c(sb[:, :, -1]), sbs=c(sb[:, :, 0]),
        tsurf=c(tb[0]), ssurf=c(sb[0]),
        elw=c(elb[0, :]), ele=c(elb[-1, :]), els=c(elb[:, 0]),
        eln=c(elb[:, -1]),
        uabw=c(uab[1, :]), uabe=c(uab[-1, :]), vabs=c(vab[:, 1]),
        vabn=c(vab[:, -1]),
        uabs=c(uab[:, 0]), uabn=c(uab[:, -1]), vabw=c(vab[0, :]),
        vabe=c(vab[-1, :]),
        ubw=c(ub[:, 1, :]), ube=c(ub[:, -1, :]), vbw=c(vb[:, 0, :]),
        vbe=c(vb[:, -1, :]),
        vbs=c(vb[:, :, 1]), vbn=c(vb[:, :, -1]), ubs=c(ub[:, :, 0]),
        ubn=c(ub[:, :, -1]))


@dataclasses.dataclass
class ColdInputs:
    """The fields a cold start is computed from (:func:`cold_start`'s
    arguments but the climatology), as the state of a model whose cold
    start runs on its blocks (``Model(defer=True)``).  ``ub`` and ``vb``
    default to zeros that take no memory."""
    tb: torch.Tensor
    sb: torch.Tensor
    elb: torch.Tensor
    uab: torch.Tensor
    vab: torch.Tensor
    ub: torch.Tensor
    vb: torch.Tensor


def cold_inputs(grid: Grid, cfg: Config, tb, sb, elb=None, uab=None,
                vab=None, ub=None, vb=None) -> ColdInputs:
    """:class:`ColdInputs` in the grid's dtype on its device."""
    h = grid.h
    z2 = torch.zeros((), dtype=h.dtype, device=h.device).expand(h.shape)
    z3 = z2.expand((cfg.kb,) + h.shape)
    f = lambda x, z: z if x is None else _as(x, h)
    return ColdInputs(_as(tb, h), _as(sb, h), f(elb, z2), f(uab, z2),
                      f(vab, z2), f(ub, z3), f(vb, z3))


class Model:
    """Owns (grid, cfg, state, climatology) and drives the time loop.  The
    forcing is the static edge-seeded forcing of the cold start
    (``base_forcing``) unless ``forcing_fn(model, iint)`` is set.

    A model resumed from a carried-across state (``core.convert``) passes
    ``state``, ``rmean``, ``tclim``, ``sclim``, ``base_forcing`` and
    ``iint`` instead of the initial fields ``tb``/``sb``.

    With ``defer`` the cold start waits for :meth:`shard`, which runs it on
    each block on the mesh's device: a model built on the host for a
    process that owns a few blocks of a large grid holds no global state,
    on the host or the card (``state`` holds the :class:`ColdInputs` until
    then)."""

    def __init__(self, grid: Grid, cfg: Config, tb=None, sb=None, tclim=None,
                 sclim=None, elb=None, uab=None, vab=None, ub=None, vb=None,
                 state: Optional[State] = None, rmean=None,
                 base_forcing: Optional[Forcing] = None, iint: int = 0,
                 defer: bool = False):
        cfg.validate()
        self.grid = grid
        self.cfg = cfg
        tclim = tb if tclim is None else tclim
        sclim = sb if sclim is None else sclim
        if state is None and defer:
            state = cold_inputs(grid, cfg, tb, sb, elb, uab, vab, ub, vb)
        elif state is None:
            state, rmean = cold_start(grid, cfg, tb, sb, tclim, sclim,
                                      elb=elb, uab=uab, vab=vab, ub=ub, vb=vb)
        elif rmean is None or tclim is None or sclim is None:
            raise ValueError("a resumed Model needs rmean, tclim and sclim")
        self.state, self.rmean = state, rmean
        self.tclim = _as(tclim, grid.h)
        self.sclim = _as(sclim, grid.h)
        if base_forcing is None:
            st = self.state
            base_forcing = edge_forcing(
                zero_forcing(cfg, grid.device, grid.dtype,
                             with_restore=cfg.do_restore),
                st.tb, st.sb, st.elb, st.uab, st.vab, st.ub, st.vb)
        self.base_forcing = base_forcing
        self.iint = iint       # completed internal steps
        self.time0 = 0.0
        self.mesh = None       # set by shard()
        self.blocks = None     # the decomposed model, on a mesh of > 1 block
        self.forcing_fn: Optional[Callable] = None
        self.reset_plans()
        try:
            self.period = grid.inertial_period_days()
        except ValueError:
            self.period = math.inf

    def reset_plans(self) -> None:
        """Forget what was built for the arrays as they were: the staged
        plan and the 1x1 blocks of a padded model (``padding.pad_model``
        calls it)."""
        self._plan = None          # (provider, whole staged plan)
        self._plan_bytes = None    # (provider, its whole staging's bytes)
        self._solo = None          # the 1x1 Blocks of a padded model

    @property
    def time_days(self) -> float:
        return self.cfg.dti * self.iint / 86400.0 + self.time0

    def _period(self) -> float:
        return self.period if math.isfinite(self.period) else 1.0

    def ramp_value(self, iint: int) -> float:
        """Inertial ramp factor of internal step ``iint`` (advance.f:62-75),
        as :meth:`run_segment` forms it."""
        return stepper.ramp_at(self.cfg, iint, self._period(), self.time0)

    def forcing_at(self, iint: int) -> Forcing:
        """The Forcing of internal step ``iint``, assembled on the host by
        ``forcing_fn`` (``base_forcing`` without one), with its ramp."""
        fc = (self.forcing_fn(self, iint) if self.forcing_fn is not None
              else self.base_forcing)
        return fc.replace(ramp=torch.full(
            (), self.ramp_value(iint), dtype=self.grid.dtype,
            device=self.device))

    def compute_wr(self) -> torch.Tensor:
        """Physical (z-coordinate) vertical velocity ``wr`` of the current
        state (realvertvl, solver.f:2024-2067), computed on demand at output
        time from the post-step time levels."""
        from extpom_tpu_torch.ops import continuity
        from extpom_tpu_torch.ops.stencil import domain_of
        st = self.gathered_state()
        with domain_of(self.cfg):
            return continuity.realvertvl(self.grid, self.cfg, st.w, st.u,
                                         st.v, self.grid.h + st.et, st.et,
                                         st.etf, st.etb)

    def wr_blocks(self) -> dict:
        """Block -> ``wr`` (:meth:`compute_wr`) of this process's blocks on a
        mesh: realvertvl on each block grown by a ring of
        ``stepper.INTERACTION_RADIUS`` cells (it reads one), the ring
        trimmed."""
        from extpom_tpu_torch.ops import continuity
        from extpom_tpu_torch.ops.stencil import domain_of
        bl = self.blocks
        h = bl.ring(stepper.INTERACTION_RADIUS)
        ext = bl.ext_all([bl.field(n) for n in ("w", "u", "v", "et", "etf",
                                                 "etb")], h)
        out = {}
        for b in bl.ids:
            g = bl.grid_ext(b, h)
            w, u, v, et, etf, etb = (e[b] for e in ext)
            with domain_of(self.cfg, bl.goff(b, h)):
                out[b] = bl.trim(continuity.realvertvl(
                    g, self.cfg, w, u, v, g.h + et, et, etf, etb), h)
        return out

    def _check_forcing(self) -> None:
        from extpom_tpu_torch.mesh import padding
        if self.forcing_fn is not None and self.cfg.is_padded:
            raise NotImplementedError(padding.FORCED_PADDED)

    def _step_blocks(self):
        """The blocks the step runs on: the mesh's, the 1x1 blocks of a
        padded model on one device (holding ``state``), or None."""
        if self.blocks is not None:
            return self.blocks
        if isinstance(self.state, ColdInputs):
            raise RuntimeError("the cold start of this model runs on its "
                               "blocks (defer=True): Model.shard it first")
        from extpom_tpu_torch.mesh import shardmap
        if not self.cfg.is_padded:
            return None
        if self._solo is None:
            self._solo = shardmap.shard_args(
                shardmap.Mesh(1, 1, devices=[self.grid.device]), self.cfg,
                self.grid, self.state, self.base_forcing, self.rmean,
                self.tclim, self.sclim)
        self._solo.state[(0, 0)] = self.state
        return self._solo

    @property
    def device(self) -> torch.device:
        """The device the step runs on: the mesh's on a mesh (a model built
        on the host and decomposed onto the card keeps its global arrays on
        the host), else the grid's."""
        return self.mesh.device if self.blocks is not None else \
            self.grid.device

    @property
    def world(self) -> int:
        """The processes that share the decomposed model (1 without
        one)."""
        return self.blocks.world if self.blocks is not None else 1

    def shard(self, mesh, mode: str = "shardmap") -> "Model":
        """Decompose the model over ``mesh`` (``mesh.shardmap.Mesh``; the
        distribute_mpi analogue, parallel_mpi.f:34-122): the state, grid,
        forcing and climatology become px x py local blocks, and
        :meth:`run_segment` runs the decomposed step
        (``stepper.mesh_step``).  A grid that does not divide the mesh is
        padded first (``mesh.padding.pad_model``).  A 1x1 mesh keeps the
        single-device path.  After it ``state`` is None:
        :meth:`gathered_state` assembles the global (padded) state from the
        blocks.

        Under several processes (``mesh/distributed.py``) this process
        keeps only its own blocks.  A model built on the host may be
        decomposed onto the card: each block is cut from the host arrays
        and moved, so that no process holds the global state on the card.
        A model built with ``defer`` cold-starts each block there
        (``Blocks``), bit-equal to a model built on the card."""
        from extpom_tpu_torch.mesh import shardmap
        if mode != "shardmap":
            raise NotImplementedError(f"parallel mode {mode!r} is not "
                                      f"ported; the port has 'shardmap'")
        if self.blocks is not None:
            raise ValueError("the model is already decomposed")
        device, own = mesh.device, self.grid.device
        same = device == own or (device.type == own.type == "cuda" and (
            device.index or 0) == (own.index or 0))
        deferred = isinstance(self.state, ColdInputs)
        if not same and own.type != "cpu":
            raise ValueError(f"the mesh is on {device}, the model on {own}: "
                             f"build the model there or on the host")
        if (not same or deferred) and mesh.px * mesh.py == 1:
            raise ValueError("a 1x1 mesh runs the model where it was built: "
                             "build it on the mesh's device, without defer")
        if self.cfg.im % mesh.px or self.cfg.jm % mesh.py:
            from extpom_tpu_torch.mesh import padding
            padding.pad_model(self, mesh.px, mesh.py)
        self.mesh = mesh
        if mesh.px * mesh.py > 1:
            self.blocks = shardmap.shard_args(
                mesh, self.cfg, self.grid, self.state, self.base_forcing,
                self.rmean, self.tclim, self.sclim, cold=deferred)
            self.state = None
            self._solo = None
        return self

    def gathered_state(self) -> State:
        """The global state: ``state`` itself on one device, assembled from
        the blocks on a mesh; padded where the grid is (the active region
        is ``mesh.padding.unpad`` of it).  Under several processes it
        raises: each holds only its blocks."""
        if self.blocks is None:
            return self.state
        from extpom_tpu_torch.mesh import shardmap
        return shardmap.gather_state(self.blocks)

    def stats(self, st: Optional[State] = None) -> dict:
        """``diag.stats.domain_stats`` of the current state (or of the
        gathered ``st``) as floats; under several processes from each
        rank's blocks (``domain_stats_blocks``)."""
        with span("stats"):
            if self.world > 1:     # host tensors, read in the block form
                s = diag_stats.domain_stats_blocks(self.blocks, self.cfg)
                return {k: float(v) for k, v in s.items()}
            s = diag_stats.domain_stats(
                self.grid, self.cfg,
                self.gathered_state() if st is None else st)
            # one read of the eight values
            return dict(zip(s, host_values(torch.stack(list(s.values())))))

    def velocity_check(self, st: Optional[State] = None) -> tuple:
        """(max |va| as a float, (i, j) of it) of the current state (or of
        the gathered ``st``; ``diag.stats.check_velocity``), under several
        processes from each rank's blocks (``check_velocity_blocks``)."""
        with span("velocity"):
            if self.world > 1:     # read on the host in the block form
                vamax, ij = diag_stats.check_velocity_blocks(
                    self.blocks, self.cfg)
                return float(vamax), ij
            vamax, (i, j) = diag_stats.check_velocity(
                self.cfg, (self.gathered_state() if st is None else st).va)
            return host_value(vamax), (host_value(i), host_value(j))

    def _device_plan(self, t0_days=None, t1_days=None):
        """The staged forcing series of a ``ForcingProvider`` forcing_fn
        (``forcing.device``), or None.  Within ``cfg.forcing_hbm_mb`` the
        whole series is staged once and kept; beyond it the records of
        ``[t0_days, t1_days]`` are staged anew for each call."""
        from extpom_tpu_torch.forcing import device as fdev
        from extpom_tpu_torch.forcing.provider import ForcingProvider
        p = self.forcing_fn
        if not isinstance(p, ForcingProvider):
            return None
        budget = self.cfg.forcing_hbm_mb * 2 ** 20
        # plan_bytes reads record 0 of every series: once per provider
        if self._plan_bytes is None or self._plan_bytes[0] is not p:
            self._plan_bytes = (p, fdev.plan_bytes(p))
        if self._plan_bytes[1] > budget and t0_days is not None:
            with span("forcing_stage"):
                return fdev.make_device_plan(p, budget_bytes=budget,
                                             t0_days=t0_days,
                                             t1_days=t1_days,
                                             device=self.device)
        if self._plan is None or self._plan[0] is not p:
            with span("forcing_stage"):
                self._plan = (p, fdev.make_device_plan(p, device=self.device))
        return self._plan[1]

    def run_segment(self, n_steps: int) -> Optional[State]:
        """Advance ``n_steps`` internal steps (``stepper.run_steps``, or on
        a mesh the decomposed step); returns ``state``.  On a mesh that is
        None: the segment gathers nothing (a gather copies a whole State,
        ~14 GB at 2048x2048x41 f32), so call :meth:`gathered_state` for the
        global state.  A ``ForcingProvider`` forcing_fn is staged on the
        device and interpolated at every step (on a mesh, on the whole grid,
        then cut to the blocks); any other forcing_fn needs :meth:`run`."""
        from extpom_tpu_torch.forcing.provider import ForcingProvider
        if not (self.forcing_fn is None
                or isinstance(self.forcing_fn, ForcingProvider)):
            raise ValueError("run_segment needs a ForcingProvider-backed "
                             "forcing_fn (or none); use run() for "
                             "arbitrary per-step forcing")
        self._check_forcing()
        period = self._period()
        t0 = self.time_days
        with span("segment"):
            plan = self._device_plan(t0,
                                     t0 + n_steps * self.cfg.dti / 86400.0)
            blocks = self._step_blocks()
            if blocks is not None:
                from extpom_tpu_torch.mesh import shardmap
                shardmap.make_shardmap_run(blocks, self.cfg, period,
                                           self.time0)(
                    self.iint, n_steps, first=(self.iint == 0), plan=plan)
                if blocks is self._solo:
                    self.state = blocks.state[(0, 0)]
            else:
                self.state = stepper.run_steps(
                    self.grid, self.cfg, self.state, self.base_forcing,
                    self.rmean, self.tclim, self.sclim, self.iint, n_steps,
                    period, self.time0, first=(self.iint == 0), plan=plan)
        self.iint += n_steps
        return self.state

    def step_once(self) -> Optional[State]:
        """One internal step; with a forcing_fn its Forcing is assembled on
        the host (:meth:`forcing_at`), on a mesh then cut to the blocks
        (the JAX package's ``Model._shard_fc``)."""
        if self.forcing_fn is None:
            return self.run_segment(1)
        self._check_forcing()
        if self.blocks is not None:
            stepper.mesh_step(
                self.blocks, self.cfg,
                self.blocks.host_forcing(self.forcing_at(self.iint + 1)),
                first=(self.iint == 0))
            self.iint += 1
            return self.state
        self.state = stepper.step(self.grid, self.cfg, self.state,
                                  self.forcing_at(self.iint + 1), self.rmean,
                                  self.tclim, self.sclim,
                                  first=(self.iint == 0))
        self.iint += 1
        return self.state

    def run(self, n_steps: Optional[int] = None,
            log: Optional[Callable[[str], None]] = None,
            check_interval: Optional[int] = None) -> Optional[State]:
        """Run the time loop with the print-interval diagnostics; raises
        ``FloatingPointError`` when |va| > vmaxl (advance.f:611-641).
        Returns the State, on a mesh the gathered one (one more gather at
        the end); under several processes None (each holds only its blocks,
        and the diagnostics come from their block forms)."""
        cfg = self.cfg
        n = cfg.iend if n_steps is None else n_steps
        for _ in range(n):
            self.step_once()
            if check_interval is not None:
                iprint = check_interval
            elif self.iint >= cfg.iswtch:
                iprint = cfg.iprint2
            else:
                iprint = cfg.iprint
            if self.iint % iprint == 0 or self.iint == n:
                st = self.gathered_state() if self.world == 1 else None
                vamax, (i, j) = self.velocity_check(st)
                if not np.isfinite(vamax) or vamax > cfg.vmaxl:
                    lon = float(self.grid.east_e[i, j])
                    lat = float(self.grid.north_e[i, j])
                    raise FloatingPointError(
                        f"velocity condition violated: vamax={vamax:.3e} "
                        f"at (i,j)=({i},{j}) lon/lat=({lon:.4f},{lat:.4f}),"
                        f" iint={self.iint}")
                if log is not None:
                    s = self.stats(st)
                    log(f"time={self.time_days:9.4f} iint={self.iint:8d} "
                        f"vtot={s['vtot']:.7e} eaver={s['eaver']:.7e} "
                        f"taver={s['taver']:.7e} saver={s['saver']:.7e} "
                        f"ekin={s['ekin']:.7e}")
        return self.gathered_state() if self.world == 1 else None
