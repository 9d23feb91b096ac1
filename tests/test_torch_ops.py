"""The PyTorch port's main-path ops against the JAX package's, in float64 on
the CPU, on seamount grids with fields drawn from a numpy seed.

Each op gets the same inputs in both packages and must agree to 1e-12
times the scale of its output (max |JAX output|, at least 1)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extpom_tpu.cases.seamount import seamount_case as jx_case
from extpom_tpu.core.model import edge_forcing as jx_edge_forcing
from extpom_tpu.core.state import zero_forcing as jx_zero_forcing
from extpom_tpu.ops import (advection2d as jx_adv2d, continuity as jx_cont,
                            density as jx_dens, momentum as jx_mom,
                            pressure as jx_pres, stencil as jx_st,
                            tracers as jx_trc, vertical as jx_vert)
from extpom_tpu.bc import bcond as jx_bcf, orlanski as jx_bco

from extpom_tpu_torch.cases.seamount import seamount_case as pt_case
from extpom_tpu_torch.core.convert import from_numpy
from extpom_tpu_torch.core.grid import Grid as PtGrid
from extpom_tpu_torch.core.state import Forcing as PtForcing
from extpom_tpu_torch.ops import (advection2d as pt_adv2d,
                                  continuity as pt_cont, density as pt_dens,
                                  momentum as pt_mom, pressure as pt_pres,
                                  stencil as pt_st, tracers as pt_trc,
                                  vertical as pt_vert)
from extpom_tpu_torch.bc import bcond as pt_bcf, orlanski as pt_bco

torch.set_num_threads(1)

IM, JM, KB = 17, 19, 7
ATOL = 1e-12


@pytest.fixture(scope="module")
def case():
    kw = dict(im=IM, jm=JM, kb=KB, dtype="float64")
    jcfg, jgrid, ics = jx_case(**kw)
    pcfg, pgrid, _ = pt_case(device="cpu", **kw)
    rng = np.random.default_rng(11)
    n3 = lambda s, o=0.0: o + s * rng.standard_normal((KB, IM, JM))
    u3 = lambda s, o=0.0: o + s * rng.random((KB, IM, JM))
    n2 = lambda s, o=0.0: o + s * rng.standard_normal((IM, JM))
    h = np.asarray(jgrid.h)
    f = dict(
        u=n3(0.1), v=n3(0.1), ub=n3(0.1), vb=n3(0.1), w=n3(1e-4),
        t=ics["tb"] + n3(0.1), tb=ics["tb"] + n3(0.1),
        s=ics["sb"] + n3(0.01), sb=ics["sb"] + n3(0.01),
        tclim=ics["tclim"], sclim=ics["sclim"],
        aam=u3(10.0, 100.0), km=u3(1e-3, 1e-3), kh=u3(1e-3, 1e-3),
        kq=u3(1e-3, 1e-3), q2=u3(1e-4, 1e-4), q2b=u3(1e-4, 1e-4),
        q2l=u3(1e-4, 1e-4), q2lb=u3(1e-4, 1e-4), l=u3(1.0, 1.0),
        advx=n3(1e-2), advy=n3(1e-2), drhox=n3(1e-2), drhoy=n3(1e-2),
        inc=n3(1.0),
        el=n2(0.01), et=n2(0.01), etb=n2(0.01), etf=n2(0.01),
        ua=n2(0.1), va=n2(0.1), uab=n2(0.1), vab=n2(0.1),
        egf=n2(0.01), egb=n2(0.01), e_atmos=n2(1e-3), aam2d=u3(10.0, 100.0)[0],
        wubot=n2(1e-4), wvbot=n2(1e-4), wusurf=n2(1e-4), wvsurf=n2(1e-4),
        wtsurf=n2(1e-5), swrad=n2(1e-5), vfluxb=n2(1e-6), vfluxf=n2(1e-6),
        elf=n2(0.01), uaf=n2(0.1), vaf=n2(0.1))
    f["dt"] = h + f["et"]
    f["d"] = h + f["el"]
    f["rho"] = np.asarray(jx_dens.dens(jgrid, jcfg, jnp.asarray(f["s"]),
                                       jnp.asarray(f["t"])))
    f["rmean"] = np.asarray(jx_dens.dens(jgrid, jcfg, jnp.asarray(f["sclim"]),
                                         jnp.asarray(f["tclim"])))
    f["fbmc"] = f["tb"] - f["tclim"]
    # boundary series: the cold start's edge forcing, carried across
    j = {k: jnp.asarray(v) for k, v in f.items()}
    jfc = jx_edge_forcing(jx_zero_forcing(jgrid, jcfg), j["tb"], j["sb"],
                          j["el"], j["uab"], j["vab"], j["ub"], j["vb"])
    jfc = jfc.replace(uabw=jfc.uabw + 0.05, vabn=jfc.vabn - 0.02)
    pfc = PtForcing(**{k.name: torch.from_numpy(
        np.array(getattr(jfc, k.name))) for k in dataclasses.fields(PtForcing)})
    return dict(jcfg=jcfg, jgrid=jgrid, pcfg=pcfg, pgrid=pgrid, f=f,
                jfc=jfc, pfc=pfc)


def _compare(got, want, what):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * scale,
                                   err_msg=f"{what} output {k}")


def _pt_profq(grid, cfg, *args):
    """The port's profq on the JAX op's operands: it does not take the old
    length scale l (the 14th), which it never reads."""
    return pt_vert.profq(grid, cfg, *args[:13], *args[14:])


# (id, JAX op, port op, argument names, keyword arguments); "FC" is the
# Forcing, "RAMP" the ramp scalar
OPS = [
    ("dens", jx_dens.dens, pt_dens.dens, ("s", "t"), {}),
    ("baropg", jx_pres.baropg, pt_pres.baropg,
     ("rho", "rmean", "dt", "RAMP"), {}),
    ("advct", jx_mom.advct, pt_mom.advct,
     ("u", "v", "ub", "vb", "aam", "dt"), {}),
    ("advu", jx_mom.advu, pt_mom.advu,
     ("u", "ub", "v", "w", "advx", "drhox", "dt", "egf", "egb", "e_atmos",
      "etb", "etf"), {}),
    ("advv", jx_mom.advv, pt_mom.advv,
     ("v", "vb", "u", "w", "advy", "drhoy", "dt", "egf", "egb", "e_atmos",
      "etb", "etf"), {}),
    ("advq", jx_trc.advq, pt_trc.advq,
     ("q2b", "q2", "u", "v", "w", "aam", "dt", "etb", "etf"), {}),
    ("advt1", jx_trc.advt1, pt_trc.advt1,
     ("tb", "t", "tclim", "u", "v", "w", "aam", "dt", "etb", "etf"), {}),
    ("horizontal_diff_fluxes", jx_trc._horizontal_diff_fluxes,
     pt_trc._horizontal_diff_fluxes, ("fbmc", "aam"), {}),
    ("vertvl", jx_cont.vertvl, pt_cont.vertvl,
     ("w", "u", "v", "dt", "etf", "etb", "vfluxb", "vfluxf"), {}),
    ("advave", jx_adv2d.advave, pt_adv2d.advave,
     ("d", "ua", "va", "uab", "vab", "aam2d", "wubot", "wvbot"), {}),
    ("proft_nbc1", jx_vert.proft, pt_vert.proft,
     ("t", "wtsurf", "tb", "NBC", "kh", "etf", "swrad"), {"nbc": 1}),
    ("proft_nbc2", jx_vert.proft, pt_vert.proft,
     ("t", "wtsurf", "tb", "NBC", "kh", "etf", "swrad"), {"nbc": 2}),
    ("proft_nbc3", jx_vert.proft, pt_vert.proft,
     ("s", "wtsurf", "wtsurf", "NBC", "kh", "etf", "swrad"), {"nbc": 3}),
    ("profu", jx_vert.profu, pt_vert.profu,
     ("u", "ub", "vb", "km", "etf", "wusurf"), {}),
    ("profv", jx_vert.profv, pt_vert.profv,
     ("v", "ub", "vb", "km", "etf", "wvsurf"), {}),
    ("profq", jx_vert.profq, _pt_profq,
     ("q2", "q2l", "q2", "q2b", "q2lb", "u", "v", "t", "s", "rho", "km",
      "kh", "kq", "l", "etf", "wusurf", "wvsurf", "wubot", "wvbot"), {}),
    ("bc_el", jx_bcf.bc_el, pt_bcf.bc_el, ("elf", "FC"), {}),
    ("bc_vel2d", jx_bcf.bc_vel2d, pt_bcf.bc_vel2d,
     ("uaf", "vaf", "el", "d", "FC", "RAMP"), {}),
    ("bc_ts", jx_bcf.bc_ts, pt_bcf.bc_ts,
     ("t", "s", "tb", "sb", "u", "v", "w", "dt", "FC"), {}),
    ("bc_turb", jx_bcf.bc_turb, pt_bcf.bc_turb,
     ("q2", "q2l", "q2b", "q2lb", "u", "v"), {}),
    ("orl_vel3d", jx_bco.orl_vel3d, pt_bco.orl_vel3d,
     ("u", "v", "ub", "vb", "w", "advx"), {}),
    ("orl_w", jx_bco.orl_w, pt_bco.orl_w, ("w",), {}),
]


@pytest.mark.parametrize("name,jx_op,pt_op,args,kw", OPS,
                         ids=[o[0] for o in OPS])
def test_op_matches_jax(case, name, jx_op, pt_op, args, kw):
    f = case["f"]
    ramp = 0.7

    def jarg(a):
        if a == "FC":
            return case["jfc"]
        if a == "RAMP":
            return jnp.asarray(ramp)
        if a == "NBC":
            return kw["nbc"]
        return jnp.asarray(f[a])

    def parg(a):
        if a == "FC":
            return case["pfc"]
        if a == "RAMP":
            return torch.tensor(ramp, dtype=torch.float64)
        if a == "NBC":
            return kw["nbc"]
        return torch.from_numpy(np.array(f[a]))

    jcfg, jgrid = case["jcfg"], case["jgrid"]
    jargs = [jarg(a) for a in args]
    static = [i for i, a in enumerate(args) if a in ("FC", "NBC")]

    def call(*dyn):
        full = list(jargs)
        it = iter(dyn)
        for i in range(len(full)):
            if i not in static:
                full[i] = next(it)
        return jx_op(jgrid, jcfg, *full)

    want = jax.jit(call)(*[a for i, a in enumerate(jargs) if i not in static])
    got = pt_op(case["pgrid"], case["pcfg"], *[parg(a) for a in args])
    _compare(got, want, name)


def test_cumk_matches_jax(case):
    inc = case["f"]["inc"]
    _compare(pt_pres._cumk(torch.from_numpy(inc)),
             jx_pres._cumk(jnp.asarray(inc)), "_cumk")


def test_grid_matches_jax(case):
    jgrid, pgrid = case["jgrid"], case["pgrid"]
    for fld in dataclasses.fields(PtGrid):
        np.testing.assert_allclose(
            getattr(pgrid, fld.name).numpy(),
            np.asarray(getattr(jgrid, fld.name)), rtol=1e-15, atol=0,
            err_msg=fld.name)


def test_from_numpy_round_trip(case):
    jgrid = case["jgrid"]
    gd = {fld.name: np.asarray(getattr(jgrid, fld.name))
          for fld in dataclasses.fields(PtGrid)}
    f = case["f"]
    from extpom_tpu_torch.core.state import State as PtState, FIELDS_2D
    sd = {n: (f["el"] if n in FIELDS_2D else f["u"]) + k
          for k, n in enumerate(PtState.field_names())}
    fd = {fld.name: np.asarray(getattr(case["jfc"], fld.name))
          for fld in dataclasses.fields(PtForcing)}
    grid, st, fc, rmean, tclim, sclim = from_numpy(
        case["pcfg"], gd, sd, fd, f["rmean"], f["tclim"], f["sclim"],
        device="cpu")
    assert np.array_equal(grid.h.numpy(), gd["h"])
    assert np.array_equal(st.q2.numpy(), sd["q2"])
    assert np.array_equal(fc.uabw.numpy(), fd["uabw"])
    assert rmean.dtype == torch.float64 and rmean.shape == (KB, IM, JM)


SHIFTS = [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, -1), (-2, 0),
          (0, 2)]


@pytest.mark.parametrize("di,dj", SHIFTS)
def test_sft_zero_fill_matches_jax(di, dj):
    """sft reads 0 outside the array (never a clamped edge value)."""
    a = np.random.default_rng(3).standard_normal((3, 6, 7))
    got = pt_st.sft(torch.from_numpy(a), di, dj).numpy()
    np.testing.assert_array_equal(got, np.asarray(jx_st.sft(
        jnp.asarray(a), di, dj)))
    np.testing.assert_array_equal(pt_st.sfk(torch.from_numpy(a), -1).numpy(),
                                  np.asarray(jx_st.sfk(jnp.asarray(a), -1)))


REGIONS = [
    jx_st.s_[1:, 1:-1],            # put region of uaf (Fortran 2..im, 2..jmm1)
    jx_st.s_[1:-1, 1:],
    jx_st.s_[1:-1, 1:-1],
    jx_st.s_[0:3, 1:, :],          # leading k range on a 3-D base
    jx_st.s_[0, 1:-1, 1:-1],
]


@pytest.mark.parametrize("region", REGIONS, ids=range(len(REGIONS)))
def test_put_regions_match_jax(region):
    """put commits only on its region; an off-by-one shows at the edges."""
    rng = np.random.default_rng(4)
    shape = (6, 7) if len(region) == 2 else (4, 6, 7)
    base, expr = rng.standard_normal(shape), rng.standard_normal(shape)
    got = pt_st.put(torch.from_numpy(base), torch.from_numpy(expr), *region)
    want = jx_st.put(jnp.asarray(base), jnp.asarray(expr), *region)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["i0", "i-1", "j0", "j-1", "k"])
def test_edge_writers_match_jax(which):
    rng = np.random.default_rng(6)
    base = rng.standard_normal((4, 6, 7))
    full = rng.standard_normal((4, 6, 7))
    J, K = slice(1, -1), slice(0, 3)
    pb, pf = torch.from_numpy(base), torch.from_numpy(full)
    jb, jf = jnp.asarray(base), jnp.asarray(full)
    if which == "k":
        got = pt_st.set_k(pb, 2, pf[0])
        want = jx_st.set_k(jb, 2, jf[0])
    elif which.startswith("i"):
        i = int(which[1:])
        got = pt_st.set_i(pb, i, pf, j=J, k=K)
        want = jx_st.set_i(jb, i, jf, j=J, k=K)
    else:
        j = int(which[1:])
        got = pt_st.set_j(pb, j, pf[:, :, :1], i=J)
        want = jx_st.set_j(jb, j, jf[:, :, :1], i=J)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
