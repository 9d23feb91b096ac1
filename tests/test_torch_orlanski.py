"""The port's ``orlanski`` boundary scheme and mode 2 against the JAX
package, in float64 on the CPU.

* Ops: ``orl_el``, ``orl_vel2d``, ``orl_ts``, ``orl_turb`` and advave's
  mode-2 branch on a square seamount grid and on a non-square basin grid
  (a closed land ring), with fields drawn from a numpy seed: 1e-12 of each
  output's scale (max |JAX output|, at least 1).
* Steps: ``mode_external_substep`` under each option over a whole external
  loop, and the plain tke and tracer phases under ``orlanski`` against the
  JAX stepper's phases: 1e-12 of scale.
* Models: the 33x33x11 orlanski seamount for 8 steps against the JAX Model
  (1e-10, saver within 1e-5 of 15), and the same scheme decomposed over a
  2x4 mesh against the single-device port (bit-equal).
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extpom_tpu.bc import orlanski as jx_bco
from extpom_tpu.cases.basin import basin_case as jx_basin
from extpom_tpu.cases.seamount import seamount_case as jx_seamount
from extpom_tpu.cases.seamount import seamount_model as jx_model
from extpom_tpu.core import stepper as jx_stepper
from extpom_tpu.ops import advection2d as jx_adv2d
from extpom_tpu.ops import stencil as jx_stencil

from extpom_tpu_torch.bc import orlanski as pt_bco
from extpom_tpu_torch.cases.seamount import seamount_model as pt_model
from extpom_tpu_torch.core import stepper
from extpom_tpu_torch.core.config import Config as PtConfig
from extpom_tpu_torch.core.grid import Grid as PtGrid
from extpom_tpu_torch.core.state import Forcing as PtForcing
from extpom_tpu_torch.diag import stats
from extpom_tpu_torch.kernels import phases
from extpom_tpu_torch.mesh.shardmap import Mesh
from extpom_tpu_torch.ops import advection2d as pt_adv2d

from test_torch_phases import KW as PHASE_KW, _compare, _make_case, _pt_args

torch.set_num_threads(1)

ATOL = 1e-12
GRIDS = {"seamount-17x17": ("seamount", 17, 17, 6),
         "basin-19x13": ("basin", 19, 13, 6)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol, what):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (what, k)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol * scale,
                                   err_msg=f"{what} output {k}")


@pytest.fixture(scope="module", params=list(GRIDS), ids=list(GRIDS))
def ops(request):
    """A JAX grid and its copy in the port, and seeded fields."""
    case, im, jm, kb = GRIDS[request.param]
    kw = dict(im=im, jm=jm, kb=kb, dtype="float64")
    if case == "seamount":
        jcfg, jgrid, _ = jx_seamount(**kw)
    else:
        jcfg, jgrid, _, _ = jx_basin(**kw)
    rng = np.random.default_rng(31)
    # metrics that vary, so that advave's curvature terms do not vanish
    jgrid = dataclasses.replace(jgrid, **{
        k: jnp.asarray(np.asarray(getattr(jgrid, k))
                       * (1.0 + 0.1 * rng.random((im, jm))))
        for k in ("dx", "dy")})
    pgrid = PtGrid(**{f.name: _t(getattr(jgrid, f.name))
                      for f in dataclasses.fields(PtGrid)})
    pcfg = PtConfig(**{f.name: getattr(jcfg, f.name)
                       for f in dataclasses.fields(PtConfig)})
    n3 = lambda s, o=0.0: o + s * rng.standard_normal((kb, im, jm))
    n2 = lambda s, o=0.0: o + s * rng.standard_normal((im, jm))
    n1 = lambda n, s, o: o + s * rng.standard_normal((kb, n))
    f = dict(elf=n2(0.01), uaf=n2(0.1), vaf=n2(0.1), ua=n2(0.1), uab=n2(0.1),
             va=n2(0.1), vab=n2(0.1), d=np.asarray(jgrid.h) + n2(0.01),
             aam2d=np.abs(n2(10.0, 100.0)), wubot=n2(1e-4), wvbot=n2(1e-4),
             tf=n3(0.1, 10.0), sf=n3(0.01, 35.0), t=n3(0.1, 10.0),
             tb=n3(0.1, 10.0), s=n3(0.01, 35.0), sb=n3(0.01, 35.0),
             ub=n3(0.1), q2f=np.abs(n3(1e-4)), q2lf=np.abs(n3(1e-4)),
             tbe=n1(jm, 0.1, 10.0), tbw=n1(jm, 0.1, 10.0),
             sbe=n1(jm, 0.01, 35.0), sbw=n1(jm, 0.01, 35.0))
    # orl_ts's phase speed vanishes, and the inflow clamp applies, on some
    # edge cells: copy the old fields there so that fb - ff is 0
    f["tf"][:, 1, ::2] = f["tb"][:, 1, ::2]
    f["tf"][:, -2, ::3] = f["tb"][:, -2, ::3]
    return dict(jcfg=jcfg, jgrid=jgrid, pcfg=pcfg, pgrid=pgrid, f=f)


def _series(f, conv):
    return SimpleNamespace(**{k: conv(f[k])
                              for k in ("tbe", "tbw", "sbe", "sbw")})


OPS = {
    "orl_el": (jx_bco.orl_el, pt_bco.orl_el, ("elf",)),
    "orl_vel2d": (jx_bco.orl_vel2d, pt_bco.orl_vel2d,
                  ("uaf", "vaf", "ua", "uab", "va", "vab")),
    "orl_ts": (jx_bco.orl_ts, pt_bco.orl_ts,
               ("tf", "sf", "t", "tb", "s", "sb", "ub", "FC")),
    "orl_turb": (jx_bco.orl_turb, pt_bco.orl_turb, ("q2f", "q2lf")),
}


@pytest.mark.parametrize("name", list(OPS))
def test_orlanski_op_matches_jax(ops, name):
    jx_fn, pt_fn, names = OPS[name]
    f = ops["f"]
    jargs = [_series(f, jnp.asarray) if n == "FC" else jnp.asarray(f[n])
             for n in names]
    pargs = [_series(f, _t) if n == "FC" else _t(f[n]) for n in names]
    with jx_stencil.domain_of(ops["jcfg"]):
        want = jx_fn(ops["jgrid"], ops["jcfg"], *jargs)
    got = pt_fn(ops["pgrid"], ops["pcfg"], *pargs)
    _close(got, want, ATOL, name)


def test_orl_ts_meets_both_branches(ops):
    """The clamp to the boundary series and the radiated value both occur
    on each of the east and west edges."""
    f, cfg, grid = ops["f"], ops["pcfg"], ops["pgrid"]
    K = slice(0, cfg.kbm1)
    tf, t, tb = _t(f["tf"]), _t(f["t"]), _t(f["tb"])
    for inner, far in ((1, 2), (-2, -3)):
        cl = pt_bco._cl(tf[K, inner], tb[K, inner], t[K, far])
        assert (cl == 0).any() and (cl > 0).any()


def test_advave_mode2_matches_jax(ops):
    names = ("d", "ua", "va", "uab", "vab", "aam2d", "wubot", "wvbot")
    f = ops["f"]
    jcfg, pcfg = ops["jcfg"].replace(mode=2), ops["pcfg"].replace(mode=2)
    with jx_stencil.domain_of(jcfg):
        want = jx_adv2d.advave(ops["jgrid"], jcfg,
                               *[jnp.asarray(f[n]) for n in names])
    got = pt_adv2d.advave(ops["pgrid"], pcfg, *[_t(f[n]) for n in names])
    _close(got, want, ATOL, "advave mode 2")
    # the branch changes what mode 3 gives
    got3 = pt_adv2d.advave(ops["pgrid"], pcfg.replace(mode=3),
                           *[_t(f[n]) for n in names])
    assert not torch.equal(got[0], got3[0])
    assert not torch.equal(got[2], got3[2])


SUB_KW = dict(im=20, jm=27, kb=5, dtype="float64", isplit=6)


@pytest.fixture(scope="module")
def substep():
    """A seamount carry with seeded noise, and step-constant terms."""
    m = jx_model(donate=False, **SUB_KW)
    st = m.state
    fc = m.forcing_at(1).replace(ramp=jnp.asarray(0.8))
    rng = np.random.default_rng(41)
    noise = lambda s: jnp.asarray(s * rng.standard_normal(st.el.shape))
    c0 = jx_stepper.ExtCarry(
        el=st.el + noise(0.01), elb=st.elb + noise(0.01),
        ua=st.ua + noise(0.05), uab=st.uab + noise(0.05),
        va=st.va + noise(0.05), vab=st.vab + noise(0.05),
        etf=st.etf + noise(0.01), egf=noise(0.01), utf=noise(1.0),
        vtf=noise(1.0), advua=noise(1e-3), advva=noise(1e-3),
        wubot=noise(1e-5), wvbot=noise(1e-5))
    fc = fc.replace(vflux=noise(1e-6), e_atmos=noise(1e-3),
                    wusurf=noise(1e-4), wvsurf=noise(1e-4))
    aux = (noise(1e-3), noise(1e-3), noise(1e-4), noise(1e-4),
           jnp.abs(noise(10.0)) + 100.0)
    pcfg = pt_model(device="cpu", **SUB_KW).cfg
    pgrid = PtGrid(**{f.name: _t(getattr(m.grid, f.name))
                      for f in dataclasses.fields(PtGrid)})
    pfc = PtForcing(**{f.name: _t(getattr(fc, f.name))
                       for f in dataclasses.fields(PtForcing)})
    return dict(jcfg=m.cfg, jgrid=m.grid, jfc=fc, c0=c0, aux=aux, pcfg=pcfg,
                pgrid=pgrid, pfc=pfc)


@pytest.mark.parametrize("kw", [dict(bc_scheme="orlanski"), dict(mode=2),
                                dict(mode=2, bc_scheme="orlanski")],
                         ids=["orlanski", "mode2", "mode2-orlanski"])
def test_external_substeps_match_jax(substep, kw):
    """All isplit substeps of the external loop, one substep at a time."""
    jcfg, pcfg = substep["jcfg"].replace(**kw), substep["pcfg"].replace(**kw)
    jc, pc = substep["c0"], stepper.ExtCarry(*(_t(x) for x in substep["c0"]))
    paux = tuple(_t(x) for x in substep["aux"])
    for iext in range(1, jcfg.isplit + 1):
        with jx_stencil.domain_of(jcfg):
            jc = jx_stepper.mode_external_substep(
                substep["jgrid"], jcfg, jc, jnp.asarray(iext), substep["jfc"],
                substep["aux"])
        pc = stepper.mode_external_substep(substep["pgrid"], pcfg, pc, iext,
                                           substep["pfc"], paux)
        _close(tuple(pc), tuple(jc), ATOL, f"{kw} substep {iext}")


@pytest.fixture(scope="module")
def phase_case():
    return _make_case(PHASE_KW, ())


# the JAX stepper's operands of each phase after (grid, cfg)
JX_PHASE = {
    "tke": ("q2", "q2b", "q2l", "q2lb", "u", "v", "w", "aam", "t", "s",
            "rho", "km", "kh", "kq", "l", "dt", "etb", "etf", "wubot",
            "wvbot"),
    "tracer": ("t", "tb", "s", "sb", "tclim", "sclim", "u", "ub", "v", "w",
               "aam", "kh", "dt", "etb", "etf"),
}


@pytest.mark.parametrize("phase", ["tke", "tracer"])
def test_plain_phase_orlanski_matches_jax_stepper(phase_case, phase):
    """The plain phases under orlanski (orl_turb, orl_ts) against the JAX
    stepper's phase_tke/phase_tracer on the same operands."""
    jcfg = phase_case["jcfg"].replace(bc_scheme="orlanski")
    pcfg = phase_case["pcfg"].replace(bc_scheme="orlanski")
    f = phase_case["f"]
    with jx_stencil.domain_of(jcfg):
        want = getattr(jx_stepper, f"phase_{phase}")(
            phase_case["jgrid"], jcfg, *[jnp.asarray(f[a])
                                         for a in JX_PHASE[phase]],
            phase_case["jfc"])
    args = _pt_args(phase_case, phase)
    kw = {"ub": _t(f["ub"])} if phase == "tracer" else {}
    got = getattr(phases, f"phase_{phase}")(phase_case["pgrid"], pcfg, *args,
                                            **kw)
    _compare(got, want, f"{phase} orlanski")
    # the scheme changes the edges
    base = getattr(phases, f"phase_{phase}")(phase_case["pgrid"],
                                             phase_case["pcfg"], *args)
    assert not torch.equal(got[0], base[0])


def test_tracer_orlanski_needs_ub(phase_case):
    pcfg = phase_case["pcfg"].replace(bc_scheme="orlanski")
    with pytest.raises(ValueError):
        phases.phase_tracer(phase_case["pgrid"], pcfg,
                            *_pt_args(phase_case, "tracer"))


MODEL_KW = dict(im=33, jm=33, kb=11, dtype="float64", bc_scheme="orlanski")
MODEL_STEPS = 8
FIELDS = ("el", "ua", "va", "u", "v", "w", "t", "s", "q2", "q2l", "km",
          "wubot")


def test_orlanski_seamount_matches_jax_model():
    jm = jx_model(donate=False, **MODEL_KW)
    for _ in range(MODEL_STEPS):
        jm.step_once()
    m = pt_model(device="cpu", **MODEL_KW)
    m.run_segment(MODEL_STEPS)
    for name in FIELDS:
        want = np.asarray(getattr(jm.state, name))
        got = getattr(m.state, name).numpy()
        tol = 1e-10 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=name)
    s = stats.domain_stats(m.grid, m.cfg, m.state)
    assert abs(float(s["saver"]) - 15.0) < 1e-5
    assert all(np.isfinite(float(v)) for v in s.values())


def test_orlanski_mesh_matches_single_device():
    """The orlanski seamount on a 2x4 mesh: every block decides its
    Orlanski edges by global index, so the gathered state is the
    single-device one, bit for bit."""
    kw = dict(im=32, jm=64, kb=7, isplit=6, dtype="float64", device="cpu",
              bc_scheme="orlanski")
    want = pt_model(**kw).run(n_steps=3)
    got = pt_model(**kw).shard(Mesh(2, 4, device="cpu")).run(n_steps=3)
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
