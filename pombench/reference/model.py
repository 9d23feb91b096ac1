"""The plain reference's model: its namelist constants, grid, cold start,
open-boundary data, one internal step and the conservation diagnostics.

The step composes :mod:`pombench.reference.kernels` as POM's advance.f
orders them (advance.f:6-537): the lateral terms (advct, the pressure
gradient, Smagorinsky's viscosity), the vertical integrals that feed the
external mode, ``isplit`` external substeps (``mode_external_substep_ref``
of the loop oracle) and the internal mode (``mode_internal_ref`` of the
loop oracle: continuity, turbulence, tracers, momentum, the Asselin filters
with their depth-mean corrections).  The grid, the cold start, the edge
data and the diagnostics follow initialize.f, bounds_forcing.f and
advance.f:669-745.  Nothing here imports the port.

A forced configuration's step reads the forcing of its time
(:func:`forcing_at`: get_time and the record interpolation of
bounds_forcing.f:841-865, in float64 host time), and may take the ``file``
edges (bcond(3), bounds_forcing.f:85-149, in place of Orlanski's) and the
interior restoring (restore_interior, bounds_forcing.f:1023-1121).

A state is a dict of field name -> tensor, in the reference's own dtype.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from pombench.reference import kernels as K

# POM's namelist constants as the configurations leave them (the run's
# ``config`` block overrides any of them)
NAMELIST = dict(
    mode=3, nadv=1, nitera=1, sw=0.5, npg=1, dte=6.0, isplit=30,
    lramp=False, rhoref=1025.0, tbias=0.0, sbias=0.0, grav=9.806,
    kappa=0.4, z0b=0.01, cbcmin=0.0025, cbcmax=1.0, horcon=0.1, tprni=0.1,
    umol=2.0e-5, vmaxl=100.0, ntp=2, nbct=1, nbcs=1, ispadv=1, smoth=0.10,
    alpha=0.0, aam_init=0.0, small=1.0e-9, bc_scheme="extpom", rfe=1.0,
    rfw=1.0, rfn=1.0, rfs=1.0, do_restore=False, dtype="float32")

# the State's fields: two-dimensional, then three-dimensional
FIELDS_2D = ("el", "elb", "et", "etb", "etf", "ua", "uab", "va", "vab",
             "utb", "vtb", "egb", "adx2d", "ady2d", "advua", "advva",
             "aam2d", "drx2d", "dry2d", "wubot", "wvbot", "vfluxb",
             "vfluxf")
FIELDS_3D = ("u", "ub", "v", "vb", "w", "t", "tb", "s", "sb", "rho", "q2",
             "q2b", "q2l", "q2lb", "km", "kh", "kq", "l", "aam")


def params(namelist: dict) -> SimpleNamespace:
    """The run's constants: :data:`NAMELIST` under ``namelist``, with the
    derived time steps (initialize.f:177-191)."""
    p = dict(NAMELIST)
    p.update(namelist)
    p = SimpleNamespace(**p)
    if p.mode != 3 or p.bc_scheme not in EDGES:
        raise NotImplementedError(
            f"the reference steps mode 3 with the {' or the '.join(EDGES)} "
            f"edges, with or without interior restoring; the configuration "
            f"asks for mode {p.mode} with the {p.bc_scheme!r} edges")
    p.kbm1 = p.kb - 1
    p.dti = p.dte * float(p.isplit)
    p.dte2 = 2.0 * p.dte
    p.dti2 = 2.0 * p.dti
    p.ispi = 1.0 / float(p.isplit)
    p.isp2i = 1.0 / (2.0 * float(p.isplit))
    return p


# the edges of the internal velocity the reference steps: Orlanski's
# (bcondorl(3), the extpom scheme) or the file's profiles (bcond(3))
EDGES = ("extpom", "file")


def make_grid(inp, dtype, device) -> SimpleNamespace:
    """The grid of the benchmark's inputs: levels, metrics, areas, masks
    and the bottom drag coefficient (initialize.f:317-389)."""
    p = params(inp.namelist)
    z = np.asarray(inp.z, np.float64)
    zz = np.asarray(inp.zz, np.float64)
    dz = np.append(z[:-1] - z[1:], 0.0)
    dzz = np.append(zz[:-1] - zz[1:], 0.0)
    dx, dy, h, fsm = (np.asarray(a, np.float64)
                      for a in (inp.dx, inp.dy, inp.h, inp.fsm))
    aru = np.ones_like(dx)
    arv = np.ones_like(dx)
    aru[1:, 1:] = 0.25 * (dx[1:, 1:] + dx[:-1, 1:]) * (dy[1:, 1:]
                                                        + dy[:-1, 1:])
    arv[1:, 1:] = 0.25 * (dx[1:, 1:] + dx[1:, :-1]) * (dy[1:, 1:]
                                                        + dy[1:, :-1])
    aru[0, :], arv[0, :] = aru[1, :], arv[1, :]
    aru[:, 0], arv[:, 0] = aru[:, 1], arv[:, 1]
    wet = (fsm != 0.0).astype(np.float64)
    dum, dvm = fsm.copy(), fsm.copy()
    dum[1:, :] *= wet[:-1, :]
    dvm[:, 1:] *= wet[:, :-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        cbc = (p.kappa / np.log((1.0 + zz[-2]) * h / p.z0b)) ** 2
    cbc = np.clip(np.where(np.isnan(cbc), p.cbcmax, cbc), p.cbcmin, p.cbcmax)
    cor = np.broadcast_to(np.asarray(inp.cor, np.float64), h.shape)
    dev = lambda a: torch.as_tensor(np.array(a, np.float64), device=device
                                    ).to(dtype)
    # the deepest wet depth, bcond(3)'s hmax: bounds_forcing.f:90 takes
    # maxval(d) of its rank's tile at each call; the whole grid's, fixed
    # once, does not hang on the decomposition (VALIDATION.md's deliberate
    # deviation 3, the intended semantics)
    hmax = np.max(h * fsm) if np.any(fsm > 0) else np.max(h)
    g = SimpleNamespace(z=dev(z), zz=dev(zz), dz=dev(dz), dzz=dev(dzz),
                        dx=dev(dx), dy=dev(dy), h=dev(h), fsm=dev(fsm),
                        dum=dev(dum), dvm=dev(dvm), cor=dev(cor),
                        art=dev(dx * dy), aru=dev(aru), arv=dev(arv),
                        cbc=dev(cbc), hmax=dev(hmax), dz64=dz)
    c = cor[cor.shape[0] // 2, cor.shape[1] // 2]
    # the inertial period at the centre, the ramp's length (1 day on the
    # equator)
    g.period_days = 2.0 * math.pi / abs(c) / 86400.0 if c else 1.0
    return g


def ramp_at(p, g, iint: int) -> float:
    """The inertial ramp of internal step ``iint`` (advance.f:62-75)."""
    if not p.lramp:
        return 1.0
    return min(p.dti * iint / 86400.0 / g.period_days, 1.0)


def _depth_sum(x, dz, kbm1):
    """sum over k < kbm1 of x[k] dz[k]."""
    return (x[:kbm1] * K.lv(dz, 0, kbm1)).sum(0)


def _pressure(p, g, rho, rmean, dt, d, ramp):
    if p.npg == 1:
        return K.baropg(rho, rmean, dt, g.dum, g.dvm, g.dx, g.dy, g.zz,
                        p.grav, ramp, p.kbm1)
    return K.baropg_mcc(rho, rmean, d, dt, g.dum, g.dvm, g.dx, g.dy, g.zz,
                        g.dzz, p.grav, ramp, p.kbm1)


def cold_start(p, g, tb, sb, tclim, sclim, elb, uab, vab) -> tuple:
    """The initial state and rmean (initialize.f:392-521): the fields at
    rest below the initial elevation and depth-mean velocity, the
    turbulence seeded at ``small`` with a length of a tenth of the depth,
    and the depth-integrated pressure gradient of the initial density
    against the climatology's -> (state, rmean)."""
    h = g.h
    z2 = torch.zeros_like(h)
    z3 = torch.zeros((p.kb,) + tuple(h.shape), dtype=h.dtype,
                     device=h.device)
    st = {f: z2.clone() for f in FIELDS_2D}
    st.update({f: z3.clone() for f in FIELDS_3D})
    rmean = K.dens(sclim, tclim, g.zz, h, g.fsm, p.tbias, p.sbias, p.grav,
                   p.rhoref)
    rho = K.dens(sb, tb, g.zz, h, g.fsm, p.tbias, p.sbias, p.grav, p.rhoref)
    dt = h + elb
    l0 = (0.1 * dt).expand_as(z3).clone()
    q2 = torch.full_like(z3, p.small)
    kh = l0 * math.sqrt(p.small)
    st.update(el=elb, elb=elb, et=elb, etb=elb, etf=elb, ua=uab, uab=uab,
              va=vab, vab=vab, utb=uab * dt, vtb=vab * dt, t=tb, tb=tb,
              s=sb, sb=sb, rho=rho, l=l0, q2=q2, q2b=q2, q2l=l0 * p.small,
              q2lb=l0 * p.small, kh=kh, km=kh, kq=kh,
              aam=torch.full_like(z3, p.aam_init))
    drhox, drhoy = _pressure(p, g, rho, rmean, dt, h + elb, 1.0)
    st.update(drx2d=_depth_sum(drhox, g.dz, p.kbm1),
              dry2d=_depth_sum(drhoy, g.dz, p.kbm1))
    return st, rmean


def edge_data(p, g, tb, sb, elb, uab, vab) -> dict:
    """The forcing of a case without surface fluxes: every surface field
    zero, and the open edges' profiles and values from the initial fields
    (initialize.f:437-460): T and S on each side's outer row or column,
    the velocity profiles of each side (those of the cold start's ub and
    vb, which are zero), the elevation and the depth-mean velocities as
    the lateral data of the reference's .lbry file reads them."""
    z2 = torch.zeros_like(g.h)
    fc = {f: z2 for f in ("vflux", "wusurf", "wvsurf", "wtsurf", "wssurf",
                          "swrad", "e_atmos")}
    fc.update(tsurf=tb[0], ssurf=sb[0])
    for name, f in (("t", tb), ("s", sb)):
        fc.update({f"{name}be": f[:, -1, :], f"{name}bw": f[:, 0, :],
                   f"{name}bn": f[:, :, -1], f"{name}bs": f[:, :, 0]})
    zj, zi = torch.zeros_like(tb[:, 0, :]), torch.zeros_like(tb[:, :, 0])
    fc.update({f"{v}b{side}": zj if side in "we" else zi
               for v in "uv" for side in "wesn"})
    fc.update(elw=elb[0, :], ele=elb[-1, :], els=elb[:, 0], eln=elb[:, -1],
              uabw=uab[1, :], uabe=uab[-1, :], vabw=vab[0, :],
              vabe=vab[-1, :], vabs=vab[:, 1], vabn=vab[:, -1],
              uabs=uab[:, 0], uabn=uab[:, -1])
    return fc


# the surface series that bounds_forcing.f's surface (:963-983) holds for
# a whole record, not interpolated in time
HELD = ("tsurf", "ssurf")
# the edge profile whose depth integral is each side's depth-mean normal
# velocity (bounds_forcing.f:626-635)
NORMAL = {"ubw": "uabw", "ube": "uabe", "vbs": "vabs", "vbn": "vabn"}


def record_pair(t_days: float, days: float, nrec: int) -> tuple:
    """The records bracketing model time ``t_days`` in a series of ``nrec``
    records ``days`` apart, and the fraction of the way from the first to
    the second (bounds_forcing.f:841-865) -> (b, f, frac).  Past either end
    the index holds the end record, as the port's sources clamp a read
    (VALIDATION.md, deviation 2)."""
    x = t_days / days
    n = math.floor(x)
    clamp = lambda i: min(max(i, 0), nrec - 1)
    return clamp(n), clamp(n + 1), x - n


def forcing_at(p, g, base: dict, series: dict, cadences: dict,
               iint: int) -> dict:
    """The forcing of the step from ``iint`` to ``iint + 1``: ``base`` (the
    edge data of the cold start) with each series of ``series`` (name ->
    ``(nrec, ...)`` float64 host array, records ``cadences[name]`` days
    apart) at the step's model time, get_time's dti * (iint + 1) / 86400
    days, in float64 on the host.  Each record pair is interpolated
    linearly in float64, but for SST and SSS, which hold their record
    (:data:`HELD`); a normal velocity profile's pair is depth-integrated
    first (sum over k < kbm1 of profile * dz, bounds_forcing.f:626-635)
    into the side's depth-mean velocity, which is interpolated with it.
    Where restoring series come without ``taurstr``, the rate is 1/trst
    [1/day], the restoring records' period (bounds_forcing.f:1043)."""
    if p.do_restore and not {"trstr", "srstr"} <= set(series):
        raise ValueError("restoring reads the trstr and srstr series "
                         "(restore_interior, bounds_forcing.f:1023-1121): "
                         "the case gives neither or one")
    if not series:
        return base
    t_days = p.dti * (iint + 1) / 86400.0
    dev = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                    device=g.h.device)
    fc = dict(base)
    for name, recs in series.items():
        nb, nf, frac = record_pair(t_days, cadences[name], recs.shape[0])
        pair = [(name, recs[nb], recs[nf])]
        if name in NORMAL:
            dz = g.dz64[:p.kbm1]
            pair.append((NORMAL[name], np.tensordot(dz, recs[nb][:p.kbm1], 1),
                         np.tensordot(dz, recs[nf][:p.kbm1], 1)))
        for n, b, f in pair:
            b = dev(b)
            if n not in HELD:
                b = (1.0 - frac) * b + frac * dev(f)
            fc[n] = b.to(g.h.dtype)
    if p.do_restore and "taurstr" not in series:
        fc["taurstr"] = torch.full((1, 1, 1), 1.0 / cadences["trstr"],
                                   dtype=g.h.dtype, device=g.h.device)
    return fc


def smagorinsky(p, g, u, v, aam0):
    """Smagorinsky's horizontal viscosity from the current velocities on
    the interior of levels k < kbm1, the rest as it was
    (advance.f:96-141)."""
    U, V = u[:p.kbm1], v[:p.kbm1]
    c = lambda a, di=0, dj=0: K.at(a, K.IN, K.IN, di, dj)
    dx, dy = c(g.dx), c(g.dy)
    shear = (0.25 * (c(U, 0, 1) + c(U, 1, 1) - c(U, 0, -1) - c(U, 1, -1))
             / dy
             + 0.25 * (c(V, 1, 0) + c(V, 1, 1) - c(V, -1, 0) - c(V, -1, 1))
             / dx)
    aam = aam0.clone()
    K.put(aam[:p.kbm1], K.IN, K.IN, p.horcon * dx * dy * torch.sqrt(
        ((c(U, 1, 0) - c(U)) / dx) ** 2 + ((c(V, 0, 1) - c(V)) / dy) ** 2
        + 0.5 * shear ** 2))
    return aam


def external_substep(p, g, c: dict, aux: dict, fc: dict, iext: int,
                     ramp) -> dict:
    """mode_external_substep_ref: one leapfrog substep of the elevation and
    the depth-mean velocities (advance.f:205-353), with the averages that
    feed the internal mode."""
    h, dx, dy, art, aru, arv, cor = (g.h, g.dx, g.dy, g.art, g.aru, g.arv,
                                     g.cor)
    at, put, IN, F1 = K.at, K.put, K.IN, K.FROM1
    d = h + c["el"]
    r = (F1, F1)
    fluxua = torch.zeros_like(d)
    fluxva = torch.zeros_like(d)
    put(fluxua, *r, 0.25 * (at(d, *r) + at(d, *r, -1, 0))
        * (at(dy, *r) + at(dy, *r, -1, 0)) * at(c["ua"], *r))
    put(fluxva, *r, 0.25 * (at(d, *r) + at(d, *r, 0, -1))
        * (at(dx, *r) + at(dx, *r, 0, -1)) * at(c["va"], *r))
    elf = torch.zeros_like(d)
    put(elf, IN, IN, at(c["elb"], IN, IN) + p.dte2 * (
        -(at(fluxua, IN, IN, 1, 0) - at(fluxua, IN, IN)
          + at(fluxva, IN, IN, 0, 1) - at(fluxva, IN, IN))
        / at(art, IN, IN) - at(fc["vflux"], IN, IN)))
    elf = K.bcond_el(elf, g.fsm)
    advua, advva, wubot, wvbot = c["advua"], c["advva"], c["wubot"], \
        c["wvbot"]
    if iext % p.ispadv == 0:
        advua, advva, wubot, wvbot = K.advave(
            d, c["ua"], c["va"], c["uab"], c["vab"], aux["aam2d"], wubot,
            wvbot, g.cbc, dx, dy, aru, arv, p.mode)
    el, elb, ua, uab, va, vab = (c[k] for k in ("el", "elb", "ua", "uab",
                                                "va", "vab"))
    alpha = p.alpha
    faces = []
    for (ri, rj, di, dj, adv2, dr2, metric, area, vel, velb, other,
         sign, wsurf, wbot) in (
            (F1, IN, 1, 0, aux["adx2d"] + advua, aux["drx2d"], dy, aru, ua,
             uab, va, -1.0, fc["wusurf"], wubot),
            (IN, F1, 0, 1, aux["ady2d"] + advva, aux["dry2d"], dx, arv, va,
             vab, ua, 1.0, fc["wvsurf"], wvbot)):
        s = lambda a, x=0, y=0: at(a, ri, rj, x, y)
        m = lambda a: s(a, -di, -dj)
        tend = (s(adv2)
                + sign * s(area) * 0.25 * (
                    s(cor) * s(d) * (s(other, dj, di) + s(other))
                    + m(cor) * m(d) * (s(other, dj - di, di - dj)
                                       + m(other)))
                + 0.25 * p.grav * (s(metric) + m(metric)) * (s(d) + m(d))
                * ((1.0 - 2.0 * alpha) * (s(el) - m(el))
                   + alpha * (s(elb) - m(elb) + s(elf) - m(elf))
                   + s(fc["e_atmos"]) - m(fc["e_atmos"]))
                + s(dr2) + s(area) * (s(wsurf) - s(wbot)))
        new = torch.zeros_like(d)
        put(new, ri, rj,
            ((s(h) + s(elb) + m(h) + m(elb)) * s(area) * s(velb)
             - 4.0 * p.dte * tend)
            / ((s(h) + s(elf) + m(h) + m(elf)) * s(area)))
        faces.append(new)
    uaf, vaf = K.bcond_vel2d(faces[0], faces[1], el, d, fc, g.dum, g.dvm,
                             p.grav, ramp, p.rfe, p.rfw, p.rfn, p.rfs)
    etf = c["etf"]
    if iext == p.isplit - 2:
        etf = 0.25 * p.smoth * elf
    elif iext == p.isplit - 1:
        etf = etf + 0.5 * (1.0 - 0.5 * p.smoth) * elf
    elif iext == p.isplit:
        etf = (etf + 0.5 * elf) * g.fsm
    ua_f = ua + 0.5 * p.smoth * (uab - 2.0 * ua + uaf)
    va_f = va + 0.5 * p.smoth * (vab - 2.0 * va + vaf)
    el_f = el + 0.5 * p.smoth * (elb - 2.0 * el + elf)
    out = dict(el=elf, elb=el_f, ua=uaf, uab=ua_f, va=vaf, vab=va_f,
               etf=etf, egf=c["egf"], utf=c["utf"], vtf=c["vtf"],
               advua=advua, advva=advva, wubot=wubot, wvbot=wvbot)
    if iext != p.isplit:
        d = h + elf
        out["egf"] = c["egf"] + elf * p.ispi
        utf, vtf = c["utf"].clone(), c["vtf"].clone()
        utf[1:, :] += uaf[1:, :] * (d[1:, :] + d[:-1, :]) * p.isp2i
        vtf[:, 1:] += vaf[:, 1:] * (d[:, 1:] + d[:, :-1]) * p.isp2i
        out.update(utf=utf, vtf=vtf)
    return out


def internal(p, g, st: dict, carry: dict, lat: dict, fc: dict, tclim,
             sclim) -> dict:
    """mode_internal_ref: the internal mode (advance.f:356-537), with
    MPDATA's tracer step where ``nadv`` is 2, the interior restoring where
    ``do_restore`` is set, and the internal velocity's edges of the extpom
    scheme (Orlanski's) or of the file scheme (bcond(3))."""
    kb, kbm1 = p.kb, p.kbm1
    dz, h = g.dz, g.h
    dt = h + st["et"]
    etf = carry["etf"]
    aam = lat["aam"]
    u, ub, v, vb = st["u"].clone(), st["ub"], st["v"].clone(), st["vb"]
    t, tb, s, sb = st["t"], st["tb"], st["s"], st["sb"]
    q2, q2b, q2l, q2lb = st["q2"], st["q2b"], st["q2l"], st["q2lb"]
    km, kh, kq, l, rho = st["km"], st["kh"], st["kq"], st["l"], st["rho"]

    # depth-mean adjustment (advance.f:364-393)
    tps = _depth_sum(u, dz, kbm1)
    un = (u - tps) + (st["utb"] + carry["utf"]) / (dt + torch.roll(dt, 1, 0))
    u[:kbm1, 1:, :] = un[:kbm1, 1:, :]
    tps = _depth_sum(v, dz, kbm1)
    vn = (v - tps) + (st["vtb"] + carry["vtf"]) / (dt + torch.roll(dt, 1, 1))
    v[:kbm1, :, 1:] = vn[:kbm1, :, 1:]
    del un, vn

    # continuity (advance.f:396-398)
    w = K.vertvl(st["w"], u, v, dt, etf, st["etb"], st["vfluxb"],
                 fc["vflux"], g.dx, g.dy, dz, p.dti2, kbm1)
    w[:kbm1] = w[:kbm1] * g.fsm

    # turbulence (advance.f:406-421)
    adv_q = lambda qb_, q_: K.advq(qb_, q_, u, v, w, aam, dt, st["etb"], etf,
                                   h, g.dum, g.dvm, g.dx, g.dy, g.art, dz,
                                   p.dti2, kbm1)
    q2f, q2lf = adv_q(q2b, q2), adv_q(q2lb, q2l)
    q2f, q2lf, km, kh, kq, l, q2b, q2lb = K.profq(
        q2f, q2lf, q2, q2b, q2lb, u, v, t, s, rho, km, kh, kq, l, etf,
        fc["wusurf"], fc["wvsurf"], carry["wubot"], carry["wvbot"], h,
        g.fsm, g.z, g.zz, dz, g.dzz, p.dti2, p.umol, p.grav, p.kappa,
        p.tbias, p.sbias, p.rhoref, p.small, kb)
    q2f, q2lf = K.bcond_turb(q2f, q2lf, q2, q2l, u, v, g.dx, g.dy, g.fsm,
                             p.dti, p.small)
    q2_a = q2 + 0.5 * p.smoth * (q2f + q2b - 2.0 * q2)
    q2l_a = q2l + 0.5 * p.smoth * (q2lf + q2lb - 2.0 * q2l)
    q2b, q2, q2lb, q2l = q2_a, q2f, q2l_a, q2lf
    del q2_a, q2l_a

    # tracers (advance.f:424-456)
    def advect(fb_, f_, clim):
        if p.nadv == 1:
            return K.advt1(fb_, f_, clim, u, v, w, aam, dt, st["etb"], etf,
                           h, g.dum, g.dvm, g.dx, g.dy, g.art, dz, p.dti2,
                           p.tprni, kbm1)
        return K.advt2(fb_, f_, clim, u, v, w, aam, dt, st["etb"], etf, h,
                       g.dum, g.dvm, g.fsm, g.dx, g.dy, g.art, g.aru, g.arv,
                       dz, g.dzz, p.dti2, p.tprni, p.sw, p.nitera, kbm1)
    diffuse = lambda f_, flux, surf, nbc: K.proft(
        f_, flux, surf, nbc, kh, etf, fc["swrad"], h, g.z, dz, g.dzz,
        p.dti2, p.umol, p.ntp, kb)
    tf = diffuse(advect(tb, t, tclim), fc["wtsurf"], fc["tsurf"], p.nbct)
    sf = diffuse(advect(sb, s, sclim), fc["wssurf"], fc["ssurf"], p.nbcs)
    tf, sf = K.bcond_ts(tf, sf, t, s, u, v, w, dt, fc, g.dx, g.dy, g.zz,
                        g.fsm, p.dti, kbm1)
    tb = t + 0.5 * p.smoth * (tf + tb - 2.0 * t)
    sb = s + 0.5 * p.smoth * (sf + sb - 2.0 * s)
    t, s = tf, sf
    if p.do_restore:               # advance.f:424-456, before dens
        t, tb, s, sb = K.restore_interior(t, tb, s, sb, fc["trstr"],
                                          fc["srstr"], fc["taurstr"], g.fsm,
                                          p.dti, kbm1)
    rho = K.dens(s, t, g.zz, h, g.fsm, p.tbias, p.sbias, p.grav, p.rhoref)

    # momentum (advance.f:459-521)
    uf = K.advu(u, ub, v, w, lat["advx"], lat["drhox"], dt, carry["egf"],
                st["egb"], fc["e_atmos"], st["etb"], etf, h, g.dy, g.aru,
                g.cor, dz, p.grav, p.dti2, kbm1)
    vf = K.advv(v, vb, u, w, lat["advy"], lat["drhoy"], dt, carry["egf"],
                st["egb"], fc["e_atmos"], st["etb"], etf, h, g.dx, g.arv,
                g.cor, dz, p.grav, p.dti2, kbm1)
    uf, wubot = K.profu(uf, ub, vb, km, etf, fc["wusurf"], h, g.cbc, g.dum,
                        dz, g.dzz, p.dti2, p.umol, kb)
    vf, wvbot = K.profv(vf, ub, vb, km, etf, fc["wvsurf"], h, g.cbc, g.dvm,
                        dz, g.dzz, p.dti2, p.umol, kb)
    if p.bc_scheme == "file":
        # d: the depth under the external mode's last elevation
        uf, vf = K.bcond_vel3d(uf, vf, u, v, h + carry["el"], fc, g.hmax,
                               g.dum, g.dvm, kbm1)
    else:
        uf, vf = K.bcondorl_vel3d(uf, vf, u, ub, v, vb, g.dum, g.dvm,
                                  kbm1)
    tps = _depth_sum(uf + ub - 2.0 * u, dz, kbm1)
    ub = u + 0.5 * p.smoth * (uf + ub - 2.0 * u - tps)
    tps = _depth_sum(vf + vb - 2.0 * v, dz, kbm1)
    vb = v + 0.5 * p.smoth * (vf + vb - 2.0 * v - tps)
    return dict(u=uf, ub=ub, v=vf, vb=vb, w=w, t=t, tb=tb, s=s, sb=sb,
                rho=rho, q2=q2, q2b=q2b, q2l=q2l, q2lb=q2lb, km=km, kh=kh,
                kq=kq, l=l, wubot=wubot, wvbot=wvbot)


def step(p, g, st: dict, fc: dict, rmean, tclim, sclim, iint: int) -> dict:
    """The state after internal step ``iint + 1`` from ``st``, the state
    after step ``iint`` (> 0: the first step of a cold start, which skips
    the internal mode, is not followed here)."""
    if iint < 1:
        raise ValueError("the reference follows steps after the first")
    ramp = ramp_at(p, g, iint + 1)
    h, kbm1 = g.h, p.kbm1
    dt = h + st["et"]
    # the lateral terms (advance.f:96-141)
    advx, advy = K.advct(st["u"], st["v"], st["ub"], st["vb"], st["aam"],
                         dt, g.dx, g.dy, g.aru, g.arv, kbm1)
    drhox, drhoy = _pressure(p, g, st["rho"], rmean, dt, h + st["el"], ramp)
    aam = smagorinsky(p, g, st["u"], st["v"], st["aam"])
    lat = dict(aam=aam, advx=advx, advy=advy, drhox=drhox, drhoy=drhoy)
    # what the external mode reads of the internal one (advance.f:144-202)
    aux = {k: _depth_sum(x, g.dz, kbm1) for k, x in (
        ("adx2d", advx), ("ady2d", advy), ("drx2d", drhox),
        ("dry2d", drhoy), ("aam2d", aam))}
    d = h + st["el"]
    advua, advva, wubot, wvbot = K.advave(
        d, st["ua"], st["va"], st["uab"], st["vab"], aux["aam2d"],
        st["wubot"], st["wvbot"], g.cbc, g.dx, g.dy, g.aru, g.arv, p.mode)
    aux["adx2d"] = aux["adx2d"] - advua
    aux["ady2d"] = aux["ady2d"] - advva
    utf = torch.zeros_like(d)
    vtf = torch.zeros_like(d)
    utf[1:, :] = st["ua"][1:, :] * (d[1:, :] + d[:-1, :]) * p.isp2i
    vtf[:, 1:] = st["va"][:, 1:] * (d[:, 1:] + d[:, :-1]) * p.isp2i
    c = dict(el=st["el"], elb=st["elb"], ua=st["ua"], uab=st["uab"],
             va=st["va"], vab=st["vab"], etf=st["etf"],
             egf=st["el"] * p.ispi, utf=utf, vtf=vtf, advua=advua,
             advva=advva, wubot=wubot, wvbot=wvbot)
    for iext in range(1, p.isplit + 1):
        c = external_substep(p, g, c, aux, fc, iext, ramp)
    new = internal(p, g, st, c, lat, fc, tclim, sclim)
    new.update(aam=aam, el=c["el"], elb=c["elb"], ua=c["ua"], uab=c["uab"],
               va=c["va"], vab=c["vab"], egb=c["egf"], etb=st["et"],
               et=c["etf"], etf=c["etf"], utb=c["utf"], vtb=c["vtf"],
               vfluxb=fc["vflux"], vfluxf=fc["vflux"], advua=c["advua"],
               advva=c["advva"], **aux)
    return new


def stats(p, g, st: dict) -> dict:
    """The run's conservation diagnostics of ``st`` in float64
    (advance.f:669-745): the volume ``vtot``, area ``atot`` and mass
    ``mtot``, the salt ``tsalt``, the mean temperature ``taver`` and
    salinity ``saver`` and the kinetic energy ``ekin``.  The area and
    volume sums take every cell but the four corners, the mass the
    interior, the energy half the interior and the east and north edges."""
    f64 = lambda a: a.to(torch.float64)
    corners = torch.ones_like(f64(g.h))
    for i, j in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        corners[i, j] = 0.0
    area = f64(g.dx) * f64(g.dy) * f64(g.fsm)
    et = f64(st["et"])
    atot = (area * corners).sum()
    vol = area * (f64(g.h) + et) * f64(g.dz[:p.kbm1])[:, None, None]
    vtot = (vol * corners).sum()
    mass = vol * (f64(st["rho"][:p.kbm1]) * p.rhoref + 1000.0)
    tsalt = (f64(st["sb"][:p.kbm1]) * vol * corners).sum()
    theat = (f64(st["tb"][:p.kbm1]) * vol * corners).sum()
    ke = mass * (f64(st["u"][:p.kbm1]) ** 2 + f64(st["v"][:p.kbm1]) ** 2)
    ekin = (0.5 * ke[:, 1:-1, 1:-1].sum() + ke[:, -1, 1:-1].sum()
            + ke[:, 1:-1, -1].sum())
    out = dict(vtot=vtot, atot=atot, mtot=mass[:, 1:-1, 1:-1].sum(),
               tsalt=tsalt, taver=theat / vtot, saver=tsalt / vtot,
               ekin=ekin)
    return {k: float(v) for k, v in out.items()}
