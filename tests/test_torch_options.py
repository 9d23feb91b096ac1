"""The options the port's phases run since the tracer, lat and mom kernels
take them: McCalpin's pressure gradient (``npg=2``), MPDATA tracer
advection (``nadv=2``), interior restoring (``do_restore``) and the
``file`` scheme's ``bc_vel3d``.  On the CPU, in float64, on a non-square
grid, from numpy seeds:

* each new op of the port against the JAX package's within 1e-12 of
  max(1, max |JAX|), and against the loop-based NumPy oracle
  tests/reference/pom_ref.py at the JAX tests' tolerances (1e-10, 1e-8);
* the plain lat, tracer and mom phases under the options against
  ``extpom_tpu.core.stepper.phase_*``;
* mirrors of the JAX package's feature tests of the options;
* the staged (device-plan) restoring run against the per-step provider,
  the 2x4 decomposed step under the options against one device, and the
  ring check of the decomposed step."""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extpom_tpu.bc import bcond as jx_bcond
from extpom_tpu.core import stepper as jx_stepper
from extpom_tpu.core.config import Config as JxConfig
from extpom_tpu.core.grid import make_grid as jx_make_grid
from extpom_tpu.core.grid import sigma_levels
from extpom_tpu.ops import pressure as jx_pressure
from extpom_tpu.ops import tracers as jx_tracers

from extpom_tpu_torch.bc import bcond
from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import make_grid
from extpom_tpu_torch.diag import stats
from extpom_tpu_torch.forcing import provider as prov
from extpom_tpu_torch.kernels import phases
from extpom_tpu_torch.mesh.shardmap import Mesh
from extpom_tpu_torch.ops import pressure, tracers

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "reference"))
import pom_ref  # noqa: E402

torch.set_num_threads(1)

IM, JM, KB = 14, 19, 7
ATOL = 1e-12


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def setup():
    """(port cfg, port grid, JAX cfg, JAX grid, rand3, rand2): one grid on
    both sides, with varying metrics and a land cell."""
    rng = np.random.default_rng(11)
    kw = dict(im=IM, jm=JM, kb=KB, dtype="float64", dte=6.0, isplit=10,
              nitera=2, sw=0.5)
    z, zz = sigma_levels(KB)
    dx = 5000.0 * (1.0 + 0.1 * rng.random((IM, JM)))
    dy = 5000.0 * (1.0 + 0.1 * rng.random((IM, JM)))
    h = 100.0 + 900.0 * rng.random((IM, JM))
    fsm = np.ones((IM, JM))
    fsm[5, 7] = 0.0
    cfg, jcfg = Config(**kw), JxConfig(**kw)
    grid = make_grid(cfg, z, zz, dx, dy, h, fsm, device="cpu")
    jgrid = jx_make_grid(jcfg, z, zz, dx, dy, h, fsm)

    def rand3(scale=1.0, off=0.0):
        return off + scale * rng.random((KB, IM, JM))

    def rand2(scale=1.0, off=0.0):
        return off + scale * rng.random((IM, JM))

    return cfg, grid, jcfg, jgrid, rand3, rand2


def _g(grid, name):
    return grid.__getattribute__(name).numpy()


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _mpdata_inputs(setup, cutoff=False):
    """(fb, f, fclim, u, v, w, aam, dt, etb, etf); with ``cutoff`` a field
    that crosses MPDATA's value_min (tests/test_kernels2.py:160)."""
    cfg, grid, _, _, rand3, rand2 = setup
    if cutoff:
        rng = np.random.default_rng(3)
        fb = np.where(rng.random((KB, IM, JM)) < 0.3, 0.0,
                      rng.random((KB, IM, JM)))
        f, fclim = fb.copy(), np.zeros_like(fb)
    else:
        fb = rand3(10.0, 5.0)
        f, fclim = fb + rand3(0.5), rand3(10.0, 5.0)
    return (fb, f, fclim, rand3(0.3), rand3(0.3), rand3(0.01),
            rand3(100.0, 10.0), _g(grid, "h") + rand2(0.5), rand2(0.1),
            rand2(0.1))


# ---- each new op against the JAX op ----

@pytest.mark.parametrize("nitera,cutoff", [(1, False), (3, False),
                                           (2, True)],
                         ids=["nitera1", "nitera3", "value_min"])
def test_advt2_matches_jax(setup, nitera, cutoff):
    cfg, grid, jcfg, jgrid, _, _ = setup
    args = _mpdata_inputs(setup, cutoff)
    got = tracers.advt2(grid, cfg.replace(nitera=nitera), *_t(*args))
    want = jx_tracers.advt2(jgrid, jcfg.replace(nitera=nitera),
                            *[jnp.asarray(a) for a in args])
    _close(got, want, ATOL)


def test_smol_adif_matches_jax(setup):
    """The antidiffusive velocities on fields crossing value_min, with the
    masked field."""
    cfg, grid, jcfg, jgrid, rand3, rand2 = setup
    rng = np.random.default_rng(5)
    ff = np.where(rng.random((KB, IM, JM)) < 0.2, 0.0, rand3(2.0))
    args = (rand3(4e5, -2e5), rand3(4e5, -2e5), rand3(2e4, -1e4), ff,
            _g(grid, "h") + rand2(0.5))
    got = tracers.smol_adif(grid, cfg, *_t(*args))
    want = jx_tracers.smol_adif(jgrid, jcfg, *[jnp.asarray(a) for a in args])
    for k, (a, b) in enumerate(zip(got, want)):
        _close(a, b, ATOL, f"output {k}")


def test_baropg_mcc_matches_jax(setup):
    cfg, grid, jcfg, jgrid, rand3, rand2 = setup
    h = _g(grid, "h")
    args = (rand3(0.02), rand3(0.02), h + rand2(0.5), h + rand2(0.5))
    got = pressure.baropg_mcc(grid, cfg, *_t(*args), 0.7)
    want = jx_pressure.baropg_mcc(jgrid, jcfg,
                                  *[jnp.asarray(a) for a in args], 0.7)
    for a, b in zip(got, want):
        _close(a, b, ATOL)


def _edge_series(rng):
    """The file scheme's velocity profiles: (kb, jm) east/west, (kb, im)
    south/north."""
    kj = lambda: 0.1 * rng.standard_normal((KB, JM))
    ki = lambda: 0.1 * rng.standard_normal((KB, IM))
    return dict(ubw=kj(), ube=kj(), vbw=kj(), vbe=kj(), ubs=ki(), ubn=ki(),
                vbs=ki(), vbn=ki())


def test_bc_vel3d_matches_jax(setup):
    cfg, grid, jcfg, jgrid, rand3, rand2 = setup
    rng = np.random.default_rng(7)
    series = _edge_series(rng)
    args = (rand3(0.2, -0.1), rand3(0.2, -0.1), rand3(0.2, -0.1),
            rand3(0.2, -0.1), _g(grid, "h") + rand2(0.5))
    fc = types.SimpleNamespace(**{k: torch.from_numpy(v)
                                  for k, v in series.items()})
    jfc = types.SimpleNamespace(**{k: jnp.asarray(v)
                                   for k, v in series.items()})
    got = bcond.bc_vel3d(grid, cfg, *_t(*args), fc)
    want = jx_bcond.bc_vel3d(jgrid, jcfg, *[jnp.asarray(a) for a in args],
                             jfc)
    for a, b in zip(got, want):
        _close(a, b, ATOL)


# ---- the plain phases under the options against the JAX stepper's ----

def _phase_inputs(setup):
    cfg, grid, _, _, rand3, rand2 = setup
    h = _g(grid, "h")
    rng = np.random.default_rng(13)
    f = dict(u=rand3(0.2, -0.1), v=rand3(0.2, -0.1), ub=rand3(0.2, -0.1),
             vb=rand3(0.2, -0.1), w=rand3(2e-5, -1e-5), aam=rand3(100, 10),
             rho=rand3(0.02), rmean=rand3(0.02), t=rand3(10.0, 5.0),
             tb=rand3(10.0, 5.0), s=rand3(1.0, 30.0), sb=rand3(1.0, 30.0),
             tclim=rand3(10.0, 5.0), sclim=rand3(1.0, 30.0),
             kh=rand3(1e-3, 1e-5), km=rand3(1e-3, 1e-5),
             advx=rand3(1e-3), advy=rand3(1e-3), drhox=rand3(1e-3),
             drhoy=rand3(1e-3), dt=h + rand2(0.5), d=h + rand2(0.5),
             etb=rand2(0.1), etf=rand2(0.1), egf=rand2(0.1), egb=rand2(0.1))
    fcd = dict(_edge_series(rng),
               trstr=rand3(10.0, 5.0), srstr=rand3(1.0, 30.0),
               taurstr=rand3(30.0))
    for name in ("wusurf", "wvsurf", "wtsurf", "wssurf", "swrad",
                 "e_atmos", "tsurf", "ssurf"):
        fcd[name] = 1e-5 * rng.standard_normal((IM, JM))
    for name in ("tbw", "tbe", "sbw", "sbe"):
        fcd[name] = rand3(1.0, 10.0)[:, 0, :]
    for name in ("tbs", "tbn", "sbs", "sbn"):
        fcd[name] = rand3(1.0, 10.0)[:, :, 0]
    return f, fcd


def _forcings(cfg, jgrid, jcfg, fcd):
    from extpom_tpu.core.state import zero_forcing as jx_zero_forcing
    from extpom_tpu_torch.core.state import zero_forcing
    fc = zero_forcing(cfg, "cpu", with_restore=True).replace(
        **{k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in fcd.items()})
    jfc = jx_zero_forcing(jgrid, jcfg, with_restore=True).replace(
        **{k: jnp.asarray(v) for k, v in fcd.items()})
    return fc, jfc


PHASE_CASES = [("lat", dict(npg=2)), ("tracer", dict(nadv=2)),
               ("tracer", dict(nadv=2, nitera=3, do_restore=True)),
               ("tracer", dict(do_restore=True)),
               ("mom", dict(bc_scheme="file"))]


@pytest.mark.parametrize("phase,kw", PHASE_CASES,
                         ids=["lat-npg2", "tracer-mpdata", "tracer-mpdata3-"
                              "restore", "tracer-restore", "mom-file"])
def test_plain_phase_options_match_jax(setup, phase, kw):
    cfg, grid, jcfg, jgrid, _, _ = setup
    cfg, jcfg = cfg.replace(**kw), jcfg.replace(**kw)
    f, fcd = _phase_inputs(setup)
    fc, jfc = _forcings(cfg, jgrid, jcfg, fcd)
    T = lambda *names: [torch.from_numpy(f[n]) for n in names]
    J = lambda *names: [jnp.asarray(f[n]) for n in names]
    ramp = 0.8
    if phase == "lat":
        names = ("u", "v", "ub", "vb", "aam", "rho", "rmean", "dt", "d")
        got = phases.phase_lat_plain(grid, cfg, *T(*names),
                                     torch.tensor(ramp, dtype=torch.float64))
        want = jx_stepper.phase_lat(jgrid, jcfg, *J(*names), ramp)
    elif phase == "tracer":
        got = phases.phase_tracer_plain(
            grid, cfg, *T("t", "tb", "s", "sb", "tclim", "sclim", "u", "v",
                          "w", "aam", "kh", "dt", "etb", "etf"), fc)
        want = jx_stepper.phase_tracer(
            jgrid, jcfg, *J("t", "tb", "s", "sb", "tclim", "sclim", "u",
                            "ub", "v", "w", "aam", "kh", "dt", "etb", "etf"),
            jfc)
    else:
        names = ("u", "ub", "v", "vb", "w", "advx", "advy", "drhox",
                 "drhoy", "km", "dt", "egf", "egb", "etb", "etf", "d")
        got = phases.phase_mom_plain(grid, cfg, *T(*names), fc)
        want = jx_stepper.phase_mom(jgrid, jcfg, *J(*names), jfc)
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        _close(a, b, ATOL, f"{phase} output {k}")


# ---- the same ops straight against the NumPy oracle ----

@pytest.mark.parametrize("cutoff", [False, True], ids=["mpdata",
                                                       "value_min"])
def test_advt2_matches_oracle(setup, cutoff):
    cfg, grid = setup[:2]
    args = _mpdata_inputs(setup, cutoff)
    got = tracers.advt2(grid, cfg, *_t(*args))
    g = lambda n: _g(grid, n)
    want = pom_ref.advt2_ref(*args, g("h"), g("dum"), g("dvm"), g("fsm"),
                             g("dx"), g("dy"), g("art"), g("aru"), g("arv"),
                             g("dz"), g("dzz"), cfg.dti2, cfg.tprni, cfg.sw,
                             cfg.nitera, cfg.kbm1)
    np.testing.assert_allclose(got.numpy()[:cfg.kbm1, 1:-1, 1:-1],
                               want[:cfg.kbm1, 1:-1, 1:-1], atol=1e-10)


def test_smol_adif_matches_oracle(setup):
    cfg, grid, _, _, rand3, rand2 = setup
    rng = np.random.default_rng(9)
    ff = np.where(rng.random((KB, IM, JM)) < 0.2, 0.0, rand3(2.0))
    args = (rand3(4e5, -2e5), rand3(4e5, -2e5), rand3(2e4, -1e4), ff,
            _g(grid, "h") + rand2(0.5))
    got = tracers.smol_adif(grid, cfg, *_t(*args))
    g = lambda n: _g(grid, n)
    want = pom_ref.smol_adif_ref(*args, g("aru"), g("arv"), g("dzz"),
                                 g("fsm"), cfg.dti2, cfg.sw, cfg.kbm1)
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-10,
                                   err_msg=f"output {k}")


def test_baropg_mcc_matches_oracle(setup):
    cfg, grid, _, _, rand3, rand2 = setup
    h = _g(grid, "h")
    rho, rmean, d, dt = rand3(0.02), rand3(0.02), h + rand2(0.5), \
        h + rand2(0.5)
    got = pressure.baropg_mcc(grid, cfg, *_t(rho, rmean, d, dt), 0.7)
    g = lambda n: _g(grid, n)
    want = pom_ref.baropg_mcc_ref(rho, rmean, d, dt, g("dum"), g("dvm"),
                                  g("dx"), g("dy"), g("zz"), g("dzz"),
                                  cfg.grav, 0.7, cfg.kbm1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy()[:cfg.kbm1, 1:-1, 1:-1],
                                   b[:cfg.kbm1, 1:-1, 1:-1], atol=1e-8)


# ---- mirrors of the JAX package's feature tests ----

def _run(n=8, **kw):
    kw.setdefault("im", 33)
    kw.setdefault("jm", 33)
    kw.setdefault("kb", 11)
    m = seamount_model(device="cpu", dtype="float64", **kw)
    m.run(n_steps=n)
    for name in ("el", "ua", "u", "t", "s", "q2", "km"):
        assert bool(torch.isfinite(getattr(m.state, name)).all()), name
    return m


def test_mpdata_advection():
    """nadv=2 (test_features.py::test_mpdata_advection): salinity stays
    uniform, T within its initial range."""
    m = _run(nadv=2, nitera=2, sw=0.5)
    saver = float(stats.domain_stats(m.grid, m.cfg, m.state)["saver"])
    assert abs(saver - 15.0) < 1e-6
    t = m.state.t[:m.cfg.kbm1]
    assert float(t.min()) > -5.3 and float(t.max()) < 10.3


def test_mcc_pressure_gradient():
    """npg=2 (test_features.py::test_mcc_pressure_gradient): the spurious
    flow of the no-flow problem stays small."""
    m = _run(npg=2, vel=0.0)
    assert float(m.state.u.abs().max()) < 1e-2


def test_interior_restoring():
    """do_restore (test_features.py::test_interior_restoring): T pulled
    strongly toward t + 1."""
    m = seamount_model(device="cpu", im=17, jm=17, kb=7, dtype="float64",
                       vel=0.0, do_restore=True)
    base = m.base_forcing
    trstr = m.state.t + 1.0
    m.forcing_fn = lambda model, iint: base.replace(
        trstr=trstr, srstr=m.state.s.clone(),
        taurstr=torch.full((m.cfg.kb, 17, 17), 30.0, dtype=torch.float64))
    t0 = float(m.state.t[0, 8, 8])
    m.run(n_steps=8)
    assert float(m.state.t[0, 8, 8]) > t0 + 0.5


def test_mpdata_monotonicity():
    """test_physics.py::test_mpdata_monotonicity on the port's ops: MPDATA
    advects a [0, 1] blob in a divergence-free vortex without negative
    values or new extrema, where the central scheme rings."""
    im = jm = 49
    kb, dx0, depth = 5, 1000.0, 100.0
    cfg = Config(im=im, jm=jm, kb=kb, mode=3, nadv=2, nitera=2, sw=0.5,
                 dte=4.0, isplit=5, dtype="float64", tprni=0.0)
    z, zz = sigma_levels(kb)
    fsm = np.ones((im, jm))
    fsm[0] = fsm[-1] = fsm[:, 0] = fsm[:, -1] = 0.0
    grid = make_grid(cfg, z, zz, np.full((im, jm), dx0),
                     np.full((im, jm), dx0), np.full((im, jm), depth), fsm,
                     cor=np.zeros((im, jm)), device="cpu")
    xc = (np.arange(im + 1) - im / 2.0)[:, None] * dx0
    yc = (np.arange(jm + 1) - jm / 2.0)[None, :] * dx0
    psi = 6.0e4 * np.exp(-(xc ** 2 + yc ** 2) / (12.0 * dx0) ** 2)
    u2 = (psi[:im, 1:] - psi[:im, :jm]) / dx0
    v2 = -(psi[1:, :jm] - psi[:im, :jm]) / dx0
    u = np.broadcast_to(u2, (kb, im, jm)).copy()
    v = np.broadcast_to(v2, (kb, im, jm)).copy()
    u[-1] = v[-1] = 0.0
    x = (np.arange(im) - im / 2.0)[:, None] * dx0
    y = (np.arange(jm) - jm / 2.0)[None, :] * dx0
    blob = np.exp(-((x - 8 * dx0) ** 2 + y ** 2) / (4.0 * dx0) ** 2)
    f0 = np.broadcast_to(blob, (kb, im, jm)).copy()
    f0[-1] = f0[-2]
    zero3, zero2 = np.zeros((kb, im, jm)), np.zeros((im, jm))
    args = _t(zero3, u, v, zero3, zero3, np.full((im, jm), depth), zero2,
              zero2)

    def run(adv, n=30):
        fb = f = torch.from_numpy(f0)
        for _ in range(n):
            fb, f = f, adv(grid, cfg, fb, f, *args)
        return f

    out = run(tracers.advt2)
    assert float(out.min()) >= -1e-12
    assert float(out.max()) <= f0.max() * (1.0 + 1e-6)
    out1 = run(tracers.advt1)
    assert float(out1.min()) < -1e-4 or float(out1.max()) > f0.max() * 1.001


def _provider(m, data, **kw):
    return prov.ForcingProvider(m.grid, m.cfg, m.base_forcing,
                                prov.ArraySource(data), prefetch=False, **kw)


def test_restore_series_provider():
    """test_parity.py::test_restore_series_provider: trstr/srstr at the
    30-day cadence, linearly interpolated, and the default taurstr
    1/TRST."""
    m = seamount_model(device="cpu", im=9, jm=9, kb=5, dtype="float64")
    nrec, kb = 3, m.cfg.kb
    tr = np.stack([np.full((kb, 9, 9), float(r)) for r in range(nrec)])
    p = _provider(m, {"trstr": tr, "srstr": tr + 100.0})
    iint = int(round(15.0 * 86400.0 / m.cfg.dti))
    fc = p(m, iint)
    frac = m.cfg.dti * iint / 86400.0 / prov.TRST
    assert abs(float(fc.trstr[0, 4, 4]) - frac) < 1e-6
    assert abs(float(fc.srstr[0, 4, 4]) - (100.0 + frac)) < 1e-6
    np.testing.assert_allclose(fc.taurstr.numpy(), 1.0 / prov.TRST)


@pytest.mark.parametrize("tau", [False, True], ids=["default_tau",
                                                    "taurstr"])
def test_staged_restoring_matches_provider(tau):
    """A staged run (run_segment: the series on the device, interpolated
    there) equals the per-step provider's (step_once), with the default
    rate where the source has no taurstr."""
    kw = dict(device="cpu", im=12, jm=10, kb=5, dtype="float64",
              do_restore=True)
    runs = []
    for staged in (True, False):
        m = seamount_model(**kw)
        rng = np.random.default_rng(21)
        t0, s0 = m.state.t.numpy(), m.state.s.numpy()
        data = {"trstr": np.stack([t0 + 0.5 * rng.random(t0.shape)
                                   for _ in range(2)]),
                "srstr": np.stack([s0 - 0.5 * rng.random(s0.shape)
                                   for _ in range(2)])}
        if tau:
            data["taurstr"] = np.stack([200.0 * rng.random(t0.shape)
                                        for _ in range(2)])
        m.forcing_fn = _provider(m, data, restore_cadence_days=0.01)
        if staged:
            m.run_segment(4)
        else:
            for _ in range(4):
                m.step_once()
        runs.append(m.state)
    for name in ("t", "tb", "s", "sb", "rho", "u"):
        _close(getattr(runs[0], name), getattr(runs[1], name).numpy(), 1e-12,
               name)


MESH_KW = dict(im=32, jm=48, kb=6, isplit=6, dtype="float64")


@pytest.mark.parametrize("kw", [dict(npg=2), dict(nadv=2, nitera=2)],
                         ids=["npg2", "mpdata"])
def test_mesh_options_bit_equal(kw):
    """The 2x4 decomposed step under McCalpin's pressure gradient and
    under MPDATA (a ring of 8 covers its 2-cell reach) gives the single
    device's bits after 3 steps."""
    one = seamount_model(device="cpu", **MESH_KW, **kw)
    one.run_segment(3)
    mesh = seamount_model(device="cpu", **MESH_KW, **kw).shard(
        Mesh(2, 4, device="cpu"))
    mesh.run_segment(3)
    got = mesh.gathered_state()
    for name in ("u", "v", "t", "s", "rho", "el", "q2"):
        assert torch.equal(getattr(got, name), getattr(one.state, name)), \
            name


def test_too_narrow_ring_raises():
    """MPDATA's nitera upstream steps read nitera cells: a phase ring
    narrower than that raises where the model is decomposed."""
    assert phases.mpdata_radius(Config(im=8, jm=8, kb=4, nadv=2,
                                       nitera=3)) == 3
    m = seamount_model(device="cpu", **MESH_KW, nadv=2, nitera=5,
                       phase_halo=4)
    with pytest.raises(ValueError, match="nitera"):
        m.shard(Mesh(2, 4, device="cpu"))
    seamount_model(device="cpu", **MESH_KW, nadv=2, nitera=4,
                   phase_halo=4).shard(Mesh(2, 4, device="cpu"))


@pytest.mark.parametrize("kw,names", [
    ({}, ("phase_lat", "phase_tracer", "phase_mom")),
    (dict(npg=2), ("phase_lat_npg2", "phase_tracer", "phase_mom")),
    (dict(nadv=2), ("phase_lat", "phase_tracer_options", "phase_mom")),
    (dict(do_restore=True), ("phase_lat", "phase_tracer_options",
                             "phase_mom")),
    (dict(bc_scheme="file"), ("phase_lat", "phase_tracer",
                              "phase_mom_file"))],
    ids=["main", "npg2", "mpdata", "restore", "file"])
def test_option_instantiations_count_apart(kw, names):
    """Each option instantiation counts its launches under its own name,
    which kernels.LAUNCHES holds for the grid and the block; the option
    operands are null pointers where the option is off."""
    from extpom_tpu_torch import kernels
    cfg = Config(im=IM, jm=JM, kb=KB, **kw)
    got = tuple(phases.counter(p, cfg) for p in ("lat", "tracer", "mom"))
    assert got == names
    for name in got + ("phase_uvw", "phase_tke"):
        assert name in kernels.LAUNCHES and f"{name}_mesh" in kernels.LAUNCHES
    m = seamount_model(device="cpu", im=IM, jm=JM, kb=KB, dtype="float64",
                       **kw)
    fc = m.base_forcing
    for phase, n in (("mom", 9), ("tracer", 3)):
        ops = phases.option_inputs(phase, m.grid, m.cfg, fc)
        on = (m.cfg.bc_scheme == "file" if phase == "mom"
              else m.cfg.do_restore)
        assert len(ops) == n
        assert all((x is not None) == on for x in ops)


@pytest.mark.parametrize("kw", [{}, dict(npg=2), dict(bc_scheme="file")],
                         ids=["main", "npg2", "file"])
def test_depth_formed_only_where_read(monkeypatch, kw):
    """The step forms d = h + el for lat only under npg=2 and for mom only
    under the file scheme, and passes None otherwise; a phase given None
    where it reads d raises, and gives the same result where it does
    not."""
    m = seamount_model(device="cpu", im=IM, jm=JM, kb=KB, dtype="float64",
                       **kw)
    m.run_segment(1)
    seen = {}
    for phase in ("lat", "mom"):
        fn = getattr(phases, f"phase_{phase}")
        at = phases._ARGS[phase].index("d") + 2

        def spy(*a, _fn=fn, _p=phase, _at=at, **k):
            seen[_p] = a[_at]
            return _fn(*a, **k)
        monkeypatch.setattr(phases, f"phase_{phase}", spy)
    m.run_segment(1)
    monkeypatch.undo()
    for phase in ("lat", "mom"):
        assert (seen[phase] is not None) == phases.reads_depth(phase, m.cfg)
    g, cfg, st = m.grid, m.cfg, m.state
    args = [st.u, st.v, st.ub, st.vb, st.aam, st.rho, m.rmean, g.h + st.et,
            g.h + st.el, m.base_forcing.ramp]
    full = phases.phase_lat(g, cfg, *args)
    args[8] = None
    if phases.reads_depth("lat", cfg):
        with pytest.raises(TypeError, match="d must be a tensor"):
            phases.phase_lat(g, cfg, *args)
    else:
        for a, b in zip(phases.phase_lat(g, cfg, *args), full):
            assert torch.equal(a, b)
