"""Mode-split leapfrog time stepping (``extpom_tpu/core/stepper.py``).

One :func:`step` advances the model by one internal step ``dti``, as
``advance`` does (advance.f:6-59):

    lateral terms -> mode_interaction -> isplit x external substep
    -> internal phases uvw, tke, tracer, mom

The isplit external substeps run in ``kernels.extloop.run_external_loop``
(one persistent CUDA kernel per step on the card) or, on the card for grids
whose external working set exceeds its L2, in
``kernels.extwin.run_external_loop_windowed`` (isplit/C window launches);
the phases lat, uvw, tke, tracer and mom run in ``kernels.phases`` (one CUDA
kernel chain each on the card).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.core.state import State, Forcing
from extpom_tpu_torch.diag.profiling import span
from extpom_tpu_torch.kernels import phases
from extpom_tpu_torch.ops.stencil import domain_of, sft, put
from extpom_tpu_torch.ops import advection2d
from extpom_tpu_torch.bc import bcond as bcf
from extpom_tpu_torch.bc import orlanski as bco


INTERACTION_RADIUS = 2


def mode_interaction(grid: Grid, cfg: Config, st: State, aam, advx, advy,
                     drhox, drhoy):
    """Vertical integrals feeding the external mode (advance.f:144-202).
    Returns (adx2d, ady2d, drx2d, dry2d, aam2d, advua, advva, wubot, wvbot,
    egf, utf, vtf).  Mode 2 has no 3-D terms: the 2-D terms are the
    state's, and advave runs at every substep instead."""
    if cfg.mode == 2:
        egf, utf, vtf = averages(grid, cfg, st.el, st.ua, st.va)
        return (st.adx2d, st.ady2d, st.drx2d, st.dry2d, st.aam2d, st.advua,
                st.advva, st.wubot, st.wvbot, egf, utf, vtf)
    adx2d, ady2d, drx2d, dry2d, aam2d = depth_integrals(
        grid, cfg, aam, advx, advy, drhox, drhoy)
    advua, advva, wubot, wvbot, egf, utf, vtf = interaction_2d(
        grid, cfg, st.el, st.ua, st.va, st.uab, st.vab, aam2d, st.wubot,
        st.wvbot)
    return (adx2d - advua, ady2d - advva, drx2d, dry2d, aam2d, advua, advva,
            wubot, wvbot, egf, utf, vtf)


def depth_integrals(grid: Grid, cfg: Config, aam, advx, advy, drhox, drhoy):
    """The pointwise part of ``mode_interaction``: (adx2d, ady2d, drx2d,
    dry2d, aam2d) before advave's terms come off adx2d and ady2d.  On the
    CPU the depth sums run in ascending k, so that a block's sums are the
    whole grid's bit for bit: torch.sum there takes 8 cells of a level at a
    time and the cells left at the end of the plane in another order, which
    moves with the plane's size."""
    dz3 = grid.dz3[:cfg.kbm1]
    if advx.is_cuda:
        return tuple(torch.sum(x[:cfg.kbm1] * dz3, dim=0)
                     for x in (advx, advy, drhox, drhoy, aam))
    return tuple(phases._depth_sum(x, dz3, cfg.kbm1)
                 for x in (advx, advy, drhox, drhoy, aam))


def interaction_2d(grid: Grid, cfg: Config, el, ua, va, uab, vab, aam2d,
                   wubot, wvbot):
    """The stencil part of ``mode_interaction``: (advua, advva, wubot,
    wvbot, egf, utf, vtf).  A value at (i, j) reads the inputs at most
    :data:`INTERACTION_RADIUS` cells away (advave reads d at i-2)."""
    d = grid.h + el
    advua, advva, wubot, wvbot = advection2d.advave(
        grid, cfg, d, ua, va, uab, vab, aam2d, wubot, wvbot)
    return (advua, advva, wubot, wvbot) + averages(grid, cfg, el, ua, va)


def averages(grid: Grid, cfg: Config, el, ua, va):
    """The seeds of the dti averages of the external loop: (egf, utf,
    vtf)."""
    d = grid.h + el
    egf = el * cfg.ispi
    z2 = torch.zeros_like(d)
    utf = put(z2, ua * (d + sft(d, -1, 0)) * cfg.isp2i,
              slice(1, None), slice(None))
    vtf = put(z2, va * (d + sft(d, 0, -1)) * cfg.isp2i,
              slice(None), slice(1, None))
    return egf, utf, vtf


def ext_precompute(grid) -> SimpleNamespace:
    """Loop-invariant metrics of the external mode, computed once per step
    instead of once per substep."""
    dx, dy, h, cor, art = grid.dx, grid.dy, grid.h, grid.cor, grid.art
    one = torch.ones((), dtype=dx.dtype, device=dx.device)
    dx4 = dx + sft(dx, -1, 0) + sft(dx, 0, -1) + sft(dx, -1, -1)
    dy4 = dy + sft(dy, -1, 0) + sft(dy, 0, -1) + sft(dy, -1, -1)
    return SimpleNamespace(
        dyu=dy + sft(dy, -1, 0),
        dxv=dx + sft(dx, 0, -1),
        hu=h + sft(h, -1, 0),
        hv=h + sft(h, 0, -1),
        corw=sft(cor, -1, 0),
        cors=sft(cor, 0, -1),
        rart=one / art,
        rdx=one / dx,
        rdy=one / dy,
        dx4=dx4,
        dy4=dy4,
        rdx4=one / torch.where(dx4 == 0, one, dx4),
        rdy4=one / torch.where(dy4 == 0, one, dy4),
    )


class ExtCarry(NamedTuple):
    """External-mode carry; field order is ``CARRY_FIELDS`` of the TPU
    kernel (``extpom_tpu/pallas/extloop.py:48``) and of ``csrc/extloop.cu``."""
    el: torch.Tensor
    elb: torch.Tensor
    ua: torch.Tensor
    uab: torch.Tensor
    va: torch.Tensor
    vab: torch.Tensor
    etf: torch.Tensor
    egf: torch.Tensor
    utf: torch.Tensor
    vtf: torch.Tensor
    advua: torch.Tensor
    advva: torch.Tensor
    wubot: torch.Tensor
    wvbot: torch.Tensor


def mode_external_substep(grid: Grid, cfg: Config, c: ExtCarry, iext: int,
                          fc: Forcing, aux, em=None) -> ExtCarry:
    """One external (2-D) leapfrog substep (advance.f:205-353); ``iext`` is
    the 1-based substep counter, ``aux`` = (adx2d, ady2d, drx2d, dry2d,
    aam2d)."""
    orl = cfg.bc_scheme == "orlanski"
    (adx2d, ady2d, drx2d, dry2d, aam2d) = aux
    if em is None:
        em = ext_precompute(grid)
    h, aru, arv, cor = grid.h, grid.aru, grid.arv, grid.cor
    d = h + c.el
    z2 = torch.zeros_like(d)

    # free surface (advance.f:211-229)
    fluxua = put(z2, 0.25 * (d + sft(d, -1, 0)) * em.dyu * c.ua,
                 slice(1, None), slice(1, None))
    fluxva = put(z2, 0.25 * (d + sft(d, 0, -1)) * em.dxv * c.va,
                 slice(1, None), slice(1, None))
    elf = put(z2, c.elb + cfg.dte2 * (
        -(sft(fluxua, 1, 0) - fluxua + sft(fluxva, 0, 1) - fluxva) * em.rart
        - fc.vflux),
        slice(1, -1), slice(1, -1))
    elf = bco.orl_el(grid, cfg, elf) if orl else bcf.bc_el(grid, cfg, elf, fc)

    # external advection terms every ispadv substeps (advance.f:235)
    if iext % cfg.ispadv == 0:
        advua, advva, wubot, wvbot = advection2d.advave(
            grid, cfg, d, c.ua, c.va, c.uab, c.vab, aam2d,
            c.wubot, c.wvbot, em=em)
    else:
        advua, advva, wubot, wvbot = c.advua, c.advva, c.wubot, c.wvbot

    # depth-mean momentum (advance.f:237-288)
    alpha = cfg.alpha
    uaf = put(z2,
              adx2d + advua
              - aru * 0.25 * (cor * d * (sft(c.va, 0, 1) + c.va)
                              + em.corw * sft(d, -1, 0)
                              * (sft(c.va, -1, 1) + sft(c.va, -1, 0)))
              + 0.25 * cfg.grav * em.dyu * (d + sft(d, -1, 0))
              * ((1.0 - 2.0 * alpha) * (c.el - sft(c.el, -1, 0))
                 + alpha * (c.elb - sft(c.elb, -1, 0)
                            + elf - sft(elf, -1, 0))
                 + fc.e_atmos - sft(fc.e_atmos, -1, 0))
              + drx2d + aru * (fc.wusurf - wubot),
              slice(1, None), slice(1, -1))
    uaf = put(z2,
              ((em.hu + c.elb + sft(c.elb, -1, 0)) * aru * c.uab
               - 4.0 * cfg.dte * uaf)
              / ((em.hu + elf + sft(elf, -1, 0)) * aru),
              slice(1, None), slice(1, -1))

    vaf = put(z2,
              ady2d + advva
              + arv * 0.25 * (cor * d * (sft(c.ua, 1, 0) + c.ua)
                              + em.cors * sft(d, 0, -1)
                              * (sft(c.ua, 1, -1) + sft(c.ua, 0, -1)))
              + 0.25 * cfg.grav * em.dxv * (d + sft(d, 0, -1))
              * ((1.0 - 2.0 * alpha) * (c.el - sft(c.el, 0, -1))
                 + alpha * (c.elb - sft(c.elb, 0, -1)
                            + elf - sft(elf, 0, -1))
                 + fc.e_atmos - sft(fc.e_atmos, 0, -1))
              + dry2d + arv * (fc.wvsurf - wvbot),
              slice(1, -1), slice(1, None))
    vaf = put(z2,
              ((em.hv + c.elb + sft(c.elb, 0, -1)) * arv * c.vab
               - 4.0 * cfg.dte * vaf)
              / ((em.hv + elf + sft(elf, 0, -1)) * arv),
              slice(1, -1), slice(1, None))

    if orl:
        uaf, vaf = bco.orl_vel2d(grid, cfg, uaf, vaf, c.ua, c.uab, c.va,
                                 c.vab)
    else:
        uaf, vaf = bcf.bc_vel2d(grid, cfg, uaf, vaf, c.el, d, fc, fc.ramp)

    # etf tail averaging over the last three substeps (advance.f:295-318)
    isplit = cfg.isplit
    etf = c.etf
    if iext == isplit - 2:
        etf = 0.25 * cfg.smoth * elf
    elif iext == isplit - 1:
        etf = c.etf + 0.5 * (1.0 - 0.5 * cfg.smoth) * elf
    elif iext == isplit:
        etf = (c.etf + 0.5 * elf) * grid.fsm

    # Asselin filter + time level rotation (advance.f:321-330)
    ua = c.ua + 0.5 * cfg.smoth * (c.uab - 2.0 * c.ua + uaf)
    va = c.va + 0.5 * cfg.smoth * (c.vab - 2.0 * c.va + vaf)
    el = c.el + 0.5 * cfg.smoth * (c.elb - 2.0 * c.el + elf)
    elb = el
    el = elf
    d = h + el
    uab = ua
    ua = uaf
    vab = va
    va = vaf

    # dti-average accumulators, skipped on the final substep
    # (advance.f:332-350)
    not_last = 1.0 if iext != isplit else 0.0
    egf = c.egf + not_last * el * cfg.ispi
    utf = put(c.utf, c.utf + not_last * ua * (d + sft(d, -1, 0)) * cfg.isp2i,
              slice(1, None), slice(None))
    vtf = put(c.vtf, c.vtf + not_last * va * (d + sft(d, 0, -1)) * cfg.isp2i,
              slice(None), slice(1, None))

    return ExtCarry(el=el, elb=elb, ua=ua, uab=uab, va=va, vab=vab,
                    etf=etf, egf=egf, utf=utf, vtf=vtf,
                    advua=advua, advva=advva, wubot=wubot, wvbot=wvbot)


def mode_internal(grid: Grid, cfg: Config, st: State, fc: Forcing,
                  c: ExtCarry, aam, advx, advy, drhox, drhoy, tclim, sclim,
                  first: bool) -> State:
    """Internal (3-D) mode update (advance.f:356-537); the first step of a
    cold start skips the 3-D block, as the reference does (advance.f:362),
    and mode 2 skips it at every step, keeping the final copies."""
    h = grid.h
    etf = c.etf
    u, ub, v, vb, w = st.u, st.ub, st.v, st.vb, st.w
    t, tb, s, sb, rho = st.t, st.tb, st.s, st.sb, st.rho
    q2, q2b, q2l, q2lb = st.q2, st.q2b, st.q2l, st.q2lb
    km, kh, kq, l = st.km, st.kh, st.kq, st.l
    wubot, wvbot = c.wubot, c.wvbot

    if not first and cfg.mode != 2:
        with span("uvw"):
            dt = h + st.et
            u, v, w = phases.phase_uvw(grid, cfg, u, v, w, dt, st.utb,
                                       st.vtb, c.utf, c.vtf, st.etb, etf,
                                       st.vfluxb, fc.vflux)
        with span("tke"):
            (q2, q2b, q2l, q2lb, km, kh, kq, l) = phases.phase_tke(
                grid, cfg, q2, q2b, q2l, q2lb, u, v, w, aam, t, s, rho,
                km, kh, kq, dt, st.etb, etf, wubot, wvbot, fc)
        if cfg.mode != 4:
            with span("tracer"):
                t, tb, s, sb, rho = phases.phase_tracer(
                    grid, cfg, t, tb, s, sb, tclim, sclim, u, v, w,
                    aam, kh, dt, st.etb, etf, fc, ub=ub)
        with span("mom"):
            u, ub, v, vb, wubot, wvbot = phases.phase_mom(
                grid, cfg, u, ub, v, vb, w, advx, advy, drhox, drhoy,
                km, dt, c.egf, st.egb, st.etb, etf,
                h + c.el if phases.reads_depth("mom", cfg) else None, fc)

    return st.replace(
        u=u, ub=ub, v=v, vb=vb, w=w, t=t, tb=tb, s=s, sb=sb, rho=rho,
        q2=q2, q2b=q2b, q2l=q2l, q2lb=q2lb, km=km, kh=kh, kq=kq, l=l,
        aam=aam,
        el=c.el, elb=c.elb, ua=c.ua, uab=c.uab, va=c.va, vab=c.vab,
        egb=c.egf,
        etb=st.et, et=etf, etf=etf,
        utb=c.utf, vtb=c.vtf,
        vfluxb=fc.vflux, vfluxf=fc.vflux,
        advua=c.advua, advva=c.advva, wubot=wubot, wvbot=wvbot,
    )


def step(grid: Grid, cfg: Config, st: State, fc: Forcing, rmean, tclim,
         sclim, first: bool = False) -> State:
    """Advance one internal time step (advance.f:6-59).  A padded grid
    raises, as the whole-grid kernels do: it runs :func:`mesh_step` on a
    1x1 mesh of blocks (``Model``)."""
    from extpom_tpu_torch.kernels import extloop, extwin
    if cfg.is_padded:
        raise NotImplementedError("stepper.step on a padded grid: a padded "
                                  "model runs mesh_step (Model.run_segment)")
    if cfg.mode == 2:   # no 3-D terms (advance.f:21 skips them)
        aam, advx, advy, drhox, drhoy = st.aam, None, None, None, None
    else:
        with span("lat"):
            aam, advx, advy, drhox, drhoy = phases.phase_lat(
                grid, cfg, st.u, st.v, st.ub, st.vb, st.aam, st.rho, rmean,
                grid.h + st.et,
                grid.h + st.el if phases.reads_depth("lat", cfg) else None,
                fc.ramp)

    with span("interaction"):
        (adx2d, ady2d, drx2d, dry2d, aam2d, advua, advva, wubot, wvbot,
         egf, utf, vtf) = mode_interaction(grid, cfg, st, aam, advx, advy,
                                           drhox, drhoy)
        carry0 = ExtCarry(el=st.el, elb=st.elb, ua=st.ua, uab=st.uab,
                          va=st.va, vab=st.vab, etf=st.etf, egf=egf,
                          utf=utf, vtf=vtf, advua=advua, advva=advva,
                          wubot=wubot, wvbot=wvbot)
        aux = (adx2d, ady2d, drx2d, dry2d, aam2d)
    el = carry0.el
    with span("external"):
        if el.is_cuda and extwin.use_windowed(
                cfg.im, cfg.jm, el.element_size(),
                extwin.l2_bytes(el.device)):
            carry = extwin.run_external_loop_windowed(grid, cfg, carry0, fc,
                                                      aux)
        else:
            carry = extloop.run_external_loop(grid, cfg, carry0, fc, aux)

    st = mode_internal(grid, cfg, st, fc, carry, aam, advx, advy,
                       drhox, drhoy, tclim, sclim, first)
    return st.replace(adx2d=adx2d, ady2d=ady2d, drx2d=drx2d, dry2d=dry2d,
                      aam2d=aam2d)


def mesh_step(blocks, cfg: Config, fc, first: bool = False) -> None:
    """One internal step of every block of ``blocks``
    (``mesh.shardmap.Blocks``), in the stages of :func:`step`: lat,
    mode_interaction, the external loop, uvw, tke, tracer, mom.  Each stage
    first grows all of its ring operands on every block by a ring of the
    neighbours' current values, in one exchange (``Blocks.ext_all``):
    ``cfg.phase_halo`` cells for the phases, :data:`INTERACTION_RADIUS`
    for mode_interaction, C x ext_halo_sub for a chunk of C external
    substeps (``mesh.extchunk``); then it runs the blocks and trims the
    ring.  ``fc`` is the step's forcing on the blocks, with its ramp
    (``mesh.shardmap.BlockForcing``), read by each stage at its ring.
    Under several processes every rank makes the same exchanges in the
    same order: only operands that the configuration drops are None, and
    then on every rank.  Updates ``blocks.state`` in place of the old
    states."""
    from extpom_tpu_torch.mesh.extchunk import run_external_loop_chunked
    ramp = fc.ramp
    ids = blocks.ids
    hp = blocks.ring(cfg.phase_halo)
    hm = blocks.ring(INTERACTION_RADIUS)
    st = blocks.state
    trim = lambda outs, h=hp: [blocks.trim(x, h) for x in outs]
    dt = {b: blocks.grid[b].h + st[b].et for b in ids}
    d = ({b: blocks.grid[b].h + st[b].el for b in ids}
         if phases.reads_depth("lat", cfg) else None)
    forcing = lambda b: fc.ext(b, hp, phases.PHASE_FORCING)

    def stage(fn, operands, **kw) -> dict:
        """Phase ``fn`` on every block, block -> its trimmed outputs.  The
        ``operands`` (then the keywords ``kw``) are state field names or
        per-block dicts, grown by the phase ring in one exchange; a
        callable is called with the block (static or forcing operands); a
        None stays None."""
        vals = list(operands) + list(kw.values())
        ring = [None if x is None or callable(x) else
                (blocks.field(x) if isinstance(x, str) else x) for x in vals]
        ext = blocks.ext_all(ring, hp)
        n = len(operands)

        def run(b):
            # a block's extended operands die with this call, before the
            # next block's are formed
            args = [x(b) if callable(x) else None if e is None else e[b]
                    for x, e in zip(vals, ext)]
            return trim(fn(blocks.grid_ext(b, hp), cfg, *args[:n],
                           off=blocks.goff(b, hp), **dict(zip(kw, args[n:]))))
        with span(fn.__name__.removeprefix("phase_")):
            return {b: run(b) for b in ids}

    m2 = cfg.mode == 2
    lat = {}
    if not m2:      # mode 2 has no 3-D terms
        lat = stage(phases.phase_lat,
                    ("u", "v", "ub", "vb", "aam", "rho",
                     lambda b: blocks.clim_ext(b, hp)[0], dt, d,
                     lambda b: ramp))
    aam = {b: st[b].aam if m2 else lat[b][0] for b in ids}

    # mode_interaction: depth integrals in place, advave on the ring; in
    # mode 2 the 2-D terms are the state's and only the averages run
    if m2:
        ints = {b: (st[b].adx2d, st[b].ady2d, st[b].drx2d, st[b].dry2d,
                    st[b].aam2d) for b in ids}
    else:
        ints = {b: depth_integrals(blocks.grid[b], cfg, *lat[b])
                for b in ids}
    aam2d = {b: ints[b][4] for b in ids}
    names = ("el", "ua", "va") + (() if m2 else ("uab", "vab"))
    ext = blocks.ext_all([blocks.field(k) for k in names]
                         + ([] if m2 else [aam2d]), hm)
    carry, aux = {}, {}
    for b in ids:
        s = st[b]
        with domain_of(cfg, blocks.goff(b, hm)):
            g = blocks.grid_ext(b, hm)
            if m2:
                out = averages(g, cfg, *(e[b] for e in ext))
            else:
                out = interaction_2d(g, cfg, *(e[b] for e in ext), None,
                                     None)
                out = out[:2] + out[4:]
        out = trim(out, hm)
        adx2d, ady2d, drx2d, dry2d, _ = ints[b]
        if m2:
            egf, utf, vtf = out
            advua, advva = s.advua, s.advva
            aux[b] = ints[b]
        else:
            advua, advva, egf, utf, vtf = out
            aux[b] = (adx2d - advua, ady2d - advva, drx2d, dry2d, aam2d[b])
        carry[b] = ExtCarry(el=s.el, elb=s.elb, ua=s.ua, uab=s.uab, va=s.va,
                            vab=s.vab, etf=s.etf, egf=egf, utf=utf, vtf=vtf,
                            advua=advua, advva=advva, wubot=s.wubot,
                            wvbot=s.wvbot)
    del ext
    carry = run_external_loop_chunked(blocks, cfg, carry, aux, fc)

    new = {b: dict(u=st[b].u, ub=st[b].ub, v=st[b].v, vb=st[b].vb,
                   w=st[b].w, t=st[b].t, tb=st[b].tb, s=st[b].s,
                   sb=st[b].sb, rho=st[b].rho, q2=st[b].q2, q2b=st[b].q2b,
                   q2l=st[b].q2l, q2lb=st[b].q2lb, km=st[b].km,
                   kh=st[b].kh, kq=st[b].kq, l=st[b].l,
                   wubot=carry[b].wubot, wvbot=carry[b].wvbot)
           for b in ids}
    if not first and not m2:
        cget = lambda k: {b: getattr(carry[b], k) for b in ids}
        nget = lambda k: {b: new[b][k] for b in ids}

        def merge(names, outs):
            """Merge a stage's outputs once every block has run it."""
            for b in ids:
                new[b].update(zip(names, outs[b]))

        merge(("u", "v", "w"), stage(
            phases.phase_uvw,
            ("u", "v", "w", dt, "utb", "vtb", cget("utf"), cget("vtf"),
             "etb", cget("etf"), "vfluxb", lambda b: forcing(b).vflux)))
        merge(("q2", "q2b", "q2l", "q2lb", "km", "kh", "kq", "l"), stage(
            phases.phase_tke,
            ("q2", "q2b", "q2l", "q2lb", nget("u"), nget("v"), nget("w"),
             aam, "t", "s", "rho", "km", "kh", "kq", dt, "etb", cget("etf"),
             cget("wubot"), cget("wvbot"), forcing)))
        if cfg.mode != 4:
            merge(("t", "tb", "s", "sb", "rho"), stage(
                phases.phase_tracer,
                ("t", "tb", "s", "sb", lambda b: blocks.clim_ext(b, hp)[1],
                 lambda b: blocks.clim_ext(b, hp)[2], nget("u"), nget("v"),
                 nget("w"), aam, nget("kh"), dt, "etb", cget("etf"),
                 forcing), ub="ub"))
        lat_out = lambda k: {b: lat[b][k] for b in ids}
        dn = ({b: blocks.grid[b].h + carry[b].el for b in ids}
              if phases.reads_depth("mom", cfg) else None)
        merge(("u", "ub", "v", "vb", "wubot", "wvbot"), stage(
            phases.phase_mom,
            (nget("u"), "ub", nget("v"), "vb", nget("w"), lat_out(1),
             lat_out(2), lat_out(3), lat_out(4), nget("km"), dt,
             cget("egf"), "egb", "etb", cget("etf"), dn, forcing)))

    vflux = {b: fc.ext(b, (0, 0), ("vflux",)).vflux for b in ids}
    for b in ids:
        s, c = st[b], carry[b]
        blocks.state[b] = s.replace(
            **new[b], aam=aam[b],
            el=c.el, elb=c.elb, ua=c.ua, uab=c.uab, va=c.va, vab=c.vab,
            egb=c.egf, etb=s.et, et=c.etf, etf=c.etf, utb=c.utf, vtb=c.vtf,
            vfluxb=vflux[b], vfluxf=vflux[b],
            advua=c.advua, advva=c.advva,
            adx2d=aux[b][0], ady2d=aux[b][1], drx2d=aux[b][2],
            dry2d=aux[b][3], aam2d=aux[b][4])


def ramp_at(cfg: Config, iint: int, period_days: float,
            time0_days: float = 0.0) -> float:
    """Inertial ramp factor of internal step ``iint`` (advance.f:62-75)."""
    if not cfg.lramp:
        return 1.0
    t_days = cfg.dti * iint / 86400.0 + time0_days
    return min(t_days / period_days, 1.0)


def run_steps(grid: Grid, cfg: Config, st: State, fc: Forcing, rmean,
              tclim, sclim, iint0: int, n_steps: int, period_days: float,
              time0_days: float = 0.0, first: bool = False,
              plan=None) -> State:
    """Advance ``n_steps`` internal steps; the first step of a cold start
    (``first``) skips the internal 3-D block.  With a staged
    ``forcing.device.DevicePlan`` the forcing of each step is interpolated
    from it on the device; otherwise ``fc`` is held constant."""
    from extpom_tpu_torch.forcing import device as fdev
    for n in range(n_steps):
        with span("step"):
            i = iint0 + 1 + n
            ramp = torch.full((), ramp_at(cfg, i, period_days, time0_days),
                              dtype=st.dtype, device=st.el.device)
            fc_i = fc
            if plan is not None:
                with span("forcing"):
                    fc_i = fdev.forcing_at(
                        plan, fc, cfg, grid.dz,
                        fdev.t_days_at(cfg, i, time0_days, st.dtype))
            st = step(grid, cfg, st, fc_i.replace(ramp=ramp), rmean, tclim,
                      sclim, first=first and n == 0)
    return st
