"""The port's plain internal phases (kernels/phases.py ``*_plain``, what the
CUDA phase kernels csrc/phase_*.cu are held against on the card) against the
JAX package's fused phase kernel (extpom_tpu/pallas/phases.py, in interpret
mode as tests/test_phases.py runs it), at 32x48x7 in float64: atol 1e-12 of
max(1, max |JAX output|).

The inputs are a seamount state after two JAX steps, carried across with
core.convert.from_numpy, plus seeded numpy perturbations; these make both
branches of bc_ts and bc_turb (inflow and outflow) and both ends of
orl_vel3d's phase-speed clamp occur, which the tests check."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extpom_tpu.cases.seamount import seamount_model as jx_model
from extpom_tpu.ops import stencil as jx_stencil
from extpom_tpu.pallas import phases as jx_phases

from extpom_tpu_torch import kernels
from extpom_tpu_torch.bc import orlanski as pt_bco
from extpom_tpu_torch.cases.seamount import seamount_case as pt_case
from extpom_tpu_torch.core.convert import from_numpy
from extpom_tpu_torch.core.grid import Grid as PtGrid
from extpom_tpu_torch.core.state import Forcing as PtForcing, State as PtState
from extpom_tpu_torch.kernels import phases, tridiag
from extpom_tpu_torch.ops import momentum as pt_mom, vertical as pt_vert

torch.set_num_threads(1)

IM, JM, KB = 32, 48, 7
KW = dict(im=IM, jm=JM, kb=KB, dtype="float64", isplit=6)
ATOL = 1e-12

# each port phase's operands after (grid, cfg), by name; "FC" is the
# Forcing, "RAMP" its ramp
ARGS = {
    "lat": ("u", "v", "ub", "vb", "aam", "rho", "rmean", "dt", "d", "RAMP"),
    "uvw": ("u", "v", "w", "dt", "utb", "vtb", "utf", "vtf", "etb", "etf",
            "vfluxb", "vflux"),
    "tke": ("q2", "q2b", "q2l", "q2lb", "u", "v", "w", "aam", "t", "s", "rho",
            "km", "kh", "kq", "dt", "etb", "etf", "wubot", "wvbot", "FC"),
    "tracer": ("t", "tb", "s", "sb", "tclim", "sclim", "u", "v", "w", "aam",
               "kh", "dt", "etb", "etf", "FC"),
    "mom": ("u", "ub", "v", "vb", "w", "advx", "advy", "drhox", "drhoy", "km",
            "dt", "egf", "egb", "etb", "etf", "d", "FC"),
}
# the JAX runner's operands of each phase: those of the port and the ones
# no kernel of the port reads (tracer's ub, tke's old l)
JX_ARGS = {
    "lat": ("u", "v", "ub", "vb", "aam", "rho", "rmean", "dt", "d"),
    "uvw": ARGS["uvw"],
    "tke": ("q2", "q2b", "q2l", "q2lb", "u", "v", "w", "aam", "t", "s", "rho",
            "km", "kh", "kq", "l", "dt", "etb", "etf", "wubot", "wvbot"),
    "tracer": ("t", "tb", "s", "sb", "tclim", "sclim", "u", "ub", "v", "w",
               "aam", "kh", "dt", "etb", "etf"),
    "mom": ARGS["mom"][:-1],
}


def _np(obj, cls):
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(cls)}


def _make_case(kw, phases_used):
    """Operands of every phase after two JAX steps of a seamount run of
    ``kw``, perturbed, on both sides."""
    KB, IM, JM = kw["kb"], kw["im"], kw["jm"]
    m = jx_model(donate=False, pallas_ext="off", pallas_phases="off", **kw)
    m.step_once()
    m.step_once()
    jcfg = m.cfg.replace(pallas_phases="on", phase_block=8, phase_halo=8)
    # the runner falls back to the XLA phase where a window does not fit:
    # make sure each phase compared goes through the Pallas kernel
    assert set(phases_used) <= set(jx_phases.feasible_phases(jcfg))

    rng = np.random.default_rng(17)
    n3 = lambda s: s * rng.standard_normal((KB, IM, JM))
    n2 = lambda s: s * rng.standard_normal((IM, JM))
    st = _np(m.state, PtState)
    fc = _np(m.forcing_at(3), PtForcing)
    gd = _np(m.grid, PtGrid)
    for name, scale in (("u", 0.05), ("ub", 0.05), ("v", 0.05), ("vb", 0.05),
                        ("w", 1e-5), ("t", 0.1), ("tb", 0.1), ("s", 0.01),
                        ("sb", 0.01), ("aam", 10.0)):
        st[name] = st[name] + n3(scale)
    for name in ("km", "kh"):
        st[name] = st[name] + np.abs(n3(1e-3))
    st["aam"] = np.abs(st["aam"])
    for name, scale in (("wusurf", 1e-4), ("wvsurf", 1e-4), ("wtsurf", 1e-5),
                        ("wssurf", 1e-6), ("swrad", 1e-5), ("vflux", 1e-6),
                        ("e_atmos", 1e-3)):
        fc[name] = fc[name] + n2(scale)
    h = gd["h"]
    f = dict(st)
    f.update(dt=h + st["et"], d=h + st["el"], utf=st["utb"] + n2(1.0),
             vtf=st["vtb"] + n2(1.0), etf=st["et"] + n2(1e-3),
             egf=st["egb"] + n2(1e-3), vflux=fc["vflux"],
             advx=n3(1e-3), advy=n3(1e-3), drhox=n3(1e-3), drhoy=n3(1e-3),
             rmean=np.array(m.rmean), tclim=np.array(m.tclim),
             sclim=np.array(m.sclim))
    # tke: turbulence fields off the cold start's uniform values, with
    # negative q2b/q2lb for the rectification, and a bottom stress
    for name in ("q2", "q2l"):
        f[name] = f[name] + np.abs(n3(1e-6))
    for name in ("q2b", "q2lb"):
        f[name] = f[name] + n3(1e-6)
    f.update(kq=f["kq"] + np.abs(n3(1e-3)), wubot=n2(1e-5), wvbot=n2(1e-5))

    pcfg, _, _ = pt_case(device="cpu", **kw)
    pgrid, _, pfc, _, _, _ = from_numpy(pcfg, gd, st, fc, f["rmean"],
                                        f["tclim"], f["sclim"], device="cpu")
    jfc = m.forcing_at(3).replace(**{k: jnp.asarray(v) for k, v in fc.items()})
    return dict(jcfg=jcfg, jgrid=m.grid, jfc=jfc, pcfg=pcfg, pgrid=pgrid,
                pfc=pfc, f=f)


@pytest.fixture(scope="module")
def case():
    return _make_case(KW, ARGS)


# config5's depth, where the card's tile kernels hold their level ring,
# ee/gg rows and (uvw, mom) kept levels for 41 levels, on a small grid
DEEP_KW = dict(im=24, jm=16, kb=41, dtype="float64", isplit=6)
TILED = ["lat", "uvw", "tke", "tracer", "mom"]


@pytest.fixture(scope="module")
def deep_case():
    return _make_case(DEEP_KW, TILED)


def _pt_args(case, phase):
    out = []
    for a in ARGS[phase]:
        if a == "FC":
            out.append(case["pfc"])
        elif a == "RAMP":
            out.append(case["pfc"].ramp)
        else:
            out.append(torch.from_numpy(np.array(case["f"][a])))
    return out


def _jax_phase(case, phase):
    """The phase through the JAX runner (Pallas kernel, interpret mode)."""
    names = [a for a in JX_ARGS[phase] if a not in ("FC", "RAMP")]
    jcfg, jgrid, jfc = case["jcfg"], case["jgrid"], case["jfc"]

    def call(*vals):
        with jx_stencil.domain_of(jcfg):
            return getattr(jx_phases.runner(jgrid, jcfg, jfc), phase)(*vals)

    return jax.jit(call)(*[jnp.asarray(case["f"][a]) for a in names])


def _compare(got, want, what):
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (what, k)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL * scale,
                                   err_msg=f"{what} output {k}")


PLAIN = {p: getattr(phases, f"phase_{p}_plain") for p in ARGS}
WRAPPER = {p: getattr(phases, f"phase_{p}") for p in ARGS}


# the seamount's surface conditions (nbct=1, nbcs=1), then the shortwave
# (exp) and prescribed-value branches of proft
CASES = [("lat", {}), ("uvw", {}), ("tke", {}), ("tracer", {}),
         ("tracer", dict(nbct=2, nbcs=3)), ("mom", {})]


@pytest.mark.parametrize("phase,kw", CASES,
                         ids=["lat", "uvw", "tke", "tracer", "tracer-nbc2-3",
                              "mom"])
def test_plain_phase_matches_jax_kernel(case, phase, kw):
    case = dict(case, jcfg=case["jcfg"].replace(**kw),
                pcfg=case["pcfg"].replace(**kw))
    args = _pt_args(case, phase)
    got = PLAIN[phase](case["pgrid"], case["pcfg"], *args)
    _compare(got, _jax_phase(case, phase), f"{phase} {kw}")


@pytest.mark.parametrize("phase", TILED)
def test_plain_phase_matches_jax_kernel_kb41(deep_case, phase):
    """At kb = 41 the plain phases of the tile kernels, which the card holds
    those kernels to at that depth, agree with the JAX Pallas phase
    kernel."""
    args = _pt_args(deep_case, phase)
    got = PLAIN[phase](deep_case["pgrid"], deep_case["pcfg"], *args)
    _compare(got, _jax_phase(deep_case, phase), f"{phase} kb=41")


@pytest.mark.parametrize("phase", list(ARGS))
def test_wrapper_on_cpu_is_the_plain_phase(case, phase):
    """A CPU tensor goes to the plain version and launches nothing."""
    args = _pt_args(case, phase)
    before = dict(kernels.LAUNCHES)
    got = WRAPPER[phase](case["pgrid"], case["pcfg"], *args)
    assert kernels.LAUNCHES == before
    want = PLAIN[phase](case["pgrid"], case["pcfg"], *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_plain_phases_call_no_kernel_wrapper(case, monkeypatch):
    """The plain phases solve with thomas_plain and call no kernel wrapper,
    so on the card they would launch no hand-written kernel either."""
    def refuse(*a, **k):
        raise AssertionError("a plain phase called a kernel wrapper")
    monkeypatch.setattr(tridiag, "thomas", refuse)
    monkeypatch.setattr(phases, "_launch", refuse)
    for phase in ARGS:
        PLAIN[phase](case["pgrid"], case["pcfg"], *_pt_args(case, phase))


def test_inputs_cover_both_boundary_branches(case):
    """bc_ts sees inflow and outflow on each side, and orl_vel3d's phase
    speed is clamped at 0 and at 1 and falls in between."""
    f, cfg, grid = case["f"], case["pcfg"], case["pgrid"]
    K = slice(0, cfg.kbm1)
    for u1 in (f["u"][K, 1, :], f["u"][K, -1, :], f["v"][K, :, 1],
               f["v"][K, :, -1]):
        assert (u1 > 0).any() and (u1 < 0).any()
    a = {k: torch.from_numpy(np.array(f[k])) for k in
         ("u", "ub", "v", "w", "advx", "drhox", "dt", "egf", "egb", "etb",
          "etf", "km", "vb")}
    uf = pt_mom.advu(grid, cfg, a["u"], a["ub"], a["v"], a["w"], a["advx"],
                     a["drhox"], a["dt"], a["egf"], a["egb"],
                     case["pfc"].e_atmos, a["etb"], a["etf"])
    uf, _ = pt_vert.profu(grid, cfg, uf, a["ub"], a["vb"], a["km"], a["etf"],
                          case["pfc"].wusurf)
    # east edge: uf/ub one row in, u two rows in; the raw ratio before the
    # clamp
    ff, fb, fi = uf[K, -2, 1:-1], a["ub"][K, -2, 1:-1], a["u"][K, -3, 1:-1]
    denom = ff + fb - 2.0 * fi
    raw = (fb - ff) / torch.where(denom == 0.0, 0.01, denom)
    assert (raw < 0).any() and (raw > 1).any()
    assert ((raw > 0) & (raw < 1)).any()
    assert torch.equal(pt_bco._cl(ff, fb, fi), raw.clamp(0.0, 1.0))


def test_first_step_runs_lat_only(monkeypatch):
    """A cold start's first step runs the lat phase and skips the internal
    block; the next one runs all of them."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    calls = []
    for name in WRAPPER.values():
        monkeypatch.setattr(phases, name.__name__,
                            lambda *a, _f=name, **k: calls.append(
                                _f.__name__) or _f(*a, **k))
    m = seamount_model(device="cpu", im=9, jm=11, kb=5, dtype="float64")
    m.run_segment(1)
    assert calls == ["phase_lat"]
    m.run_segment(1)
    assert calls[1:] == ["phase_lat", "phase_uvw", "phase_tke",
                         "phase_tracer", "phase_mom"]
