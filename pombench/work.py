"""The yardstick: the operations and compulsory bytes of a step and of its
kernels, counted from the grid's shape, the dtype and the options alone
(nothing here knows how a kernel is written), and the chip's peaks.

A bound is the least time the chip could take: the larger of the flops over
the peak float rate and the bytes over the peak memory rate.  Bytes count
each field a call must read once and each field it must write once.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB (data sheet; dense, without sparsity): float
# operations outside the tensor cores and HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "float64": 8}

# flops per point and external substep (core/stepper.py's
# mode_external_substep: depth 1, fluxes 8, elf 8, bc_el 1, advave 71, uaf 38,
# vaf 38, masks 2, the tail, Asselin and the accumulators 32)
EXT_FLOPS = 199
# flops per grid point (column level) of each internal phase (lat: advct
# ~220, baropg ~40, Smagorinsky ~20; uvw ~20; tke: advq ~60 per field, profq
# ~170, edges and Asselin ~10; tracer: ~120 per tracer and ~45 for the
# equation of state; mom: ~50 per component, ~20 for the edges and Asselin)
PHASE_FLOPS = {"lat": 280, "uvw": 20, "tke": 300, "tracer": 285, "mom": 120}
# ... that McCalpin's pressure gradient adds to lat (npg=2)
MCC_FLOPS = 60
# flops per point of MPDATA (T and S): each upstream step, each
# antidiffusion between two steps
MPDATA_FLOPS = {"upwind": 110, "adif": 90}

# the fields each phase reads and writes, by shape: 3-D (kb, im, jm), 2-D
# (im, jm), profiles along a side ((kb, jm) or (kb, im)), levels (kb,).
# Grid metrics count as 2-D reads; the forcing fields a phase reads count
# with it.
PHASE_FIELDS = {
    # u v ub vb aam rho rmean -> aam advx advy drhox drhoy; dt; dx dy aru
    # arv dum dvm; zz dzz
    "lat": dict(r3=7, w3=5, r2=1 + 6, rk=2),
    # u v (w on the edge columns) -> u v w; dt utb vtb utf vtf etb etf
    # vfluxb vflux; dx dy fsm; dz
    "uvw": dict(r3=2, w3=3, r2=9 + 3, rk=1, edge_w=1),
    # q2 q2b q2l q2lb u v w aam t s rho km kh kq -> q2 q2b q2l q2lb km kh
    # kq l; dt etb etf wubot wvbot wusurf wvsurf; h dx dy art dum dvm fsm;
    # z zz dz dzz
    "tke": dict(r3=14, w3=8, r2=7 + 7, rk=4),
    # t tb s sb tclim sclim u v w aam kh -> t tb s sb rho; dt etb etf wtsurf
    # tsurf wssurf ssurf swrad; h dx dy art dum dvm fsm; the edge profiles of
    # t and s on the four sides; z zz dz dzz
    "tracer": dict(r3=11, w3=5, r2=8 + 7, rside=4, rk=4),
    # u ub v vb w advx advy drhox drhoy km -> u ub v vb; dt egf egb etb etf
    # e_atmos wusurf wvsurf -> wubot wvbot; h dx dy aru arv cor cbc dum dvm;
    # dz dzz
    "mom": dict(r3=10, w3=4, r2=8 + 9, w2=2, rk=2),
}
# the whole step's compulsory traffic: the State's 19 3-D fields and 23
# 2-D fields read and written once, the 3-D climatology and rmean read, the
# 11 2-D grid metrics (h dx dy fsm dum dvm cor art aru arv cbc) and 9 2-D
# surface forcing fields read, the levels (z zz dz dzz)
STEP_FIELDS = dict(r3=19 + 3, w3=19, r2=23 + 11 + 9, w2=23, rk=4)


def _bytes(f: dict, im: int, jm: int, kb: int, item: int) -> int:
    n3, n2 = kb * im * jm, im * jm
    edge = kb * (2 * im + 2 * jm - 4)        # the columns on the edges
    side = kb * (im + jm)                     # a profile on each side pair
    elems = ((f.get("r3", 0) + f.get("w3", 0)) * n3
             + (f.get("r2", 0) + f.get("w2", 0)) * n2
             + f.get("edge_w", 0) * edge + f.get("rside", 0) * side
             + f.get("rk", 0) * kb)
    return elems * item


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def mpdata_flops(nitera: int) -> int:
    return (MPDATA_FLOPS["upwind"] * nitera
            + MPDATA_FLOPS["adif"] * (nitera - 1))


def mpdata_work(im: int, jm: int, kb: int, dtype: str, nitera: int) -> tuple:
    """(flops, bytes) of MPDATA's steps of T and S: tb, sb, u, v, w read and
    the fields of T and S written (kb levels each), the surfaces of t and s
    and ten 2-D fields read, the levels; the fields between the steps are
    the call's own."""
    n3, n2 = kb * im * jm, im * jm
    nbytes = (7 * n3 + 12 * n2 + 2 * kb) * ITEMSIZE[dtype]
    return mpdata_flops(nitera) * n3, nbytes


def phase_work(phase: str, im: int, jm: int, kb: int, dtype: str,
               nadv: int = 1, nitera: int = 1, npg: int = 1) -> tuple:
    """(flops, bytes) of one call of ``phase``; the tracer phase under
    MPDATA (``nadv`` 2) with its steps and aru, arv read, lat under
    McCalpin (``npg`` 2) with its flops and d and dzz read."""
    f = dict(PHASE_FIELDS[phase])
    flops = PHASE_FLOPS[phase]
    if phase == "lat" and npg == 2:
        flops += MCC_FLOPS
        f["r2"] += 1
    nbytes = _bytes(f, im, jm, kb, ITEMSIZE[dtype])
    if phase == "tracer" and nadv == 2:
        flops += mpdata_flops(nitera)
        nbytes += 2 * im * jm * ITEMSIZE[dtype]
    return flops * kb * im * jm, nbytes


def ext_work(im: int, jm: int, isplit: int, dtype: str) -> tuple:
    """(flops, bytes) of the isplit external substeps of a step: the
    operations of each substep, and the loop's 2-D operands (34 read, 14
    carried and written) and its edge series once."""
    n = im * jm
    nbytes = ((34 + 14) * n + 6 * jm + 6 * im + 1) * ITEMSIZE[dtype]
    return EXT_FLOPS * isplit * n, nbytes


PHASES = ("lat", "uvw", "tke", "tracer", "mom")


def step_work(im: int, jm: int, kb: int, dtype: str, isplit: int = 30,
              nadv: int = 1, nitera: int = 1, npg: int = 1) -> tuple:
    """(flops, bytes) of one internal step: the external substeps' and the
    five phases' operations, and the step's compulsory traffic
    (:data:`STEP_FIELDS`)."""
    flops = ext_work(im, jm, isplit, dtype)[0] + sum(
        phase_work(p, im, jm, kb, dtype, nadv, nitera, npg)[0]
        for p in PHASES)
    f = dict(STEP_FIELDS)
    return flops, _bytes(f, im, jm, kb, ITEMSIZE[dtype])


def shape_of(namelist: dict) -> dict:
    """The keyword arguments of the counts above from a run's namelist."""
    return dict(im=namelist["im"], jm=namelist["jm"], kb=namelist["kb"],
                dtype=namelist["dtype"])


def options_of(namelist: dict) -> dict:
    return dict(nadv=namelist.get("nadv", 1),
                nitera=namelist.get("nitera", 1),
                npg=namelist.get("npg", 1))
