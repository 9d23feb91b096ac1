"""The port's wind-driven basin (cases/basin.py, mode 2 under Orlanski
edges) and mode 2 on the CPU in float64: the basin carried across from the
JAX package with core.convert and held to the JAX Model (1e-10 of each
field's scale), the port's counterparts of the JAX package's closed-basin
and western-intensification tests, and diag/profiling.py."""

import dataclasses

import numpy as np
import pytest
import torch

from extpom_tpu.cases.basin import basin_model as jx_basin

from extpom_tpu_torch.cases.basin import basin_case, basin_model
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.convert import model_from_numpy
from extpom_tpu_torch.core.grid import Grid, make_grid, sigma_levels
from extpom_tpu_torch.core.model import Model
from extpom_tpu_torch.core.state import Forcing, State
from extpom_tpu_torch.diag import profiling, stats

torch.set_num_threads(1)

KW = dict(im=41, jm=41, kb=5, dtype="float64")
STEPS = 20
FIELDS = ("el", "elb", "ua", "uab", "va", "vab", "advua", "advva", "wubot",
          "wvbot", "etf", "utb", "vtb")


def _dict(obj, cls):
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(cls)}


def _assert_close(got: State, want, rtol, what):
    for name in FIELDS:
        b = np.asarray(getattr(want, name))
        a = getattr(got, name).numpy()
        tol = rtol * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=f"{what}: {name}")


def test_basin_case_matches_jax():
    """The port builds the JAX package's basin: grid (cbc, cor), cold
    start and wind."""
    jm = jx_basin(**KW)
    m = basin_model(device="cpu", **KW)
    for name in ("h", "fsm", "dum", "dvm", "cor", "cbc", "art", "aru"):
        np.testing.assert_array_equal(getattr(m.grid, name).numpy(),
                                      np.asarray(getattr(jm.grid, name)),
                                      err_msg=name)
    np.testing.assert_allclose(m.base_forcing.wusurf.numpy(),
                               np.asarray(jm.base_forcing.wusurf), rtol=0,
                               atol=1e-18)
    for name in ("el", "t", "s", "rho", "drx2d"):
        np.testing.assert_allclose(getattr(m.state, name).numpy(),
                                   np.asarray(getattr(jm.state, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    assert m.cfg.mode == 2 and m.cfg.bc_scheme == "orlanski"


def test_basin_carried_across_matches_jax():
    """The JAX basin carried across after two steps (grid, state and the
    wind of base_forcing), then both run on: 1e-10 of scale."""
    jm = jx_basin(**KW)
    jm.run_segment(2)
    cfg = basin_case(device="cpu", **KW)[0]
    m = model_from_numpy(cfg, _dict(jm.grid, Grid), _dict(jm.state, State),
                         _dict(jm.base_forcing, Forcing),
                         np.array(jm.rmean), np.array(jm.tclim),
                         np.array(jm.sclim), device="cpu", iint=jm.iint)
    assert torch.equal(m.base_forcing.wusurf,
                       torch.from_numpy(np.array(jm.base_forcing.wusurf)))
    jm.run_segment(STEPS)
    m.run_segment(STEPS)
    _assert_close(m.state, jm.state, 1e-10, "carried across")


def test_basin_matches_jax_model():
    jm = jx_basin(**KW)
    jm.run_segment(STEPS)
    m = basin_model(device="cpu", **KW)
    m.run_segment(STEPS)
    _assert_close(m.state, jm.state, 1e-10, "from the cold start")


def test_mode2_skips_the_internal_mode(monkeypatch):
    """Mode 2 calls no phase: the 3-D fields keep their cold-start values."""
    from extpom_tpu_torch.kernels import phases
    for name in ("lat", "uvw", "tke", "tracer", "mom"):
        monkeypatch.setattr(phases, f"phase_{name}",
                            lambda *a, _n=name, **k: pytest.fail(_n))
    m = basin_model(device="cpu", im=12, jm=10, kb=4, dtype="float64")
    u0, t0 = m.state.u.clone(), m.state.t.clone()
    m.run_segment(3)
    assert torch.equal(m.state.u, u0) and torch.equal(m.state.t, t0)
    assert float(m.state.va.abs().max()) > 0.0


def test_mode2_barotropic_closed_basin():
    """The port's mirror of test_seamount.py's closed basin: gravity-wave
    adjustment of an elevation bump in a land ring conserves volume and
    keeps the mirror symmetry."""
    im, jm, kb = 33, 33, 5
    cfg = Config(im=im, jm=jm, kb=kb, mode=2, lramp=False, dte=6.0,
                 isplit=10, dtype="float64")
    z, zz = sigma_levels(kb)
    dx = np.full((im, jm), 5000.0)
    h = np.full((im, jm), 100.0)
    fsm = np.ones((im, jm))
    fsm[0, :] = fsm[-1, :] = fsm[:, 0] = fsm[:, -1] = 0.0
    grid = make_grid(cfg, z, zz, dx, dx, h, fsm, cor=np.zeros((im, jm)),
                     device="cpu")
    x = (np.arange(im) - (im - 1) / 2)[:, None]
    y = (np.arange(jm) - (jm - 1) / 2)[None, :]
    elb = 0.1 * np.exp(-(x ** 2 + y ** 2) / 25.0) * fsm
    m = Model(grid, cfg, tb=np.zeros((kb, im, jm)),
              sb=np.full((kb, im, jm), 35.0), elb=elb)
    art = grid.art.numpy() * fsm
    vol0 = float(np.sum(m.state.el.numpy() * art))
    m.run(n_steps=20)
    el = m.state.el.numpy()
    assert np.all(np.isfinite(el))
    vol1 = float(np.sum(el * art))
    assert abs(vol1 - vol0) / float(np.sum(art)) < 1e-8
    assert abs(el[im // 2, jm // 2]) < 0.07
    assert np.allclose(el, el[:, ::-1], atol=1e-12)


def test_wind_driven_gyre_western_intensification():
    """The port's mirror of test_physics.py's gyre: 12 days' spin-up of
    the 41x41x5 basin gives a southward Sverdrup interior, a northward
    western boundary current and a west/east |v| ratio above 3."""
    m = basin_model(device="cpu", **KW)
    steps = int(12.0 * 86400 / m.cfg.dti)
    assert steps == 1728
    m.run_segment(steps)
    va = m.state.va.numpy()
    im, jm = va.shape
    third = im // 3
    w = np.abs(va[1:third, 1:-1]).max()
    e = np.abs(va[-third:-1, 1:-1]).max()
    assert w > 3.0 * e, (w, e)
    assert va[third:-third, jm // 3:2 * jm // 3].mean() < 0.0
    assert va[2:6, jm // 3:2 * jm // 3].mean() > 0.0
    assert np.isfinite(m.state.el.numpy()).all()


def test_basin_cfl_at_ten_km_cells():
    """At 10 km cells cfl_min (the reference's advisory, half the
    gravity-wave limit dx / sqrt(2 g h) of about 101 s) reads 50.49 s for
    the 500 m basin."""
    m = basin_model(device="cpu", im=52, jm=52, kb=4, length=5.0e5,
                    dtype="float64")
    assert abs(float(m.grid.dx[0, 0]) - 1.0e4) < 1e-9
    limit = 1.0e4 / np.sqrt(2.0 * m.cfg.grav * 500.0)
    assert 100.0 < limit < 102.0
    cfl = float(stats.cfl_min(m.grid, m.cfg))
    assert abs(cfl - 0.5 * limit) < 1e-9


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").exists()
    assert prof is not None


def test_dispatch_report_names_the_options():
    """The echo names the options the external kernels compile in, and no
    phase in mode 2."""
    from extpom_tpu_torch.core import dispatch
    cfg = basin_case(device="cpu", im=12, jm=10, kb=4)[0]
    rep = dispatch.dispatch_report(cfg, torch.float32, "cpu")
    assert rep["external"] == {"machine": "plain",
                               "options": "orlanski+mode2"}
    assert rep["phases"] == {}
    text = dispatch.format_report(rep)
    assert "options=orlanski+mode2" in text and "mode 2" in text
    seamount = cfg.replace(mode=3, bc_scheme="extpom")
    assert "options" not in dispatch.dispatch_report(
        seamount, torch.float32, "cpu")["external"]


@pytest.mark.parametrize("dx,stable", [(1.0e4, False), (1.0e6 / 49, True)],
                         ids=["10km", "20.41km"])
def test_basin_cell_size_stability(dx, stable):
    """With the case's dte of 60 s the 500 m basin is unstable at 10 km
    cells (cfl_min 50.49 s), in the JAX package as in the port, and stable
    at the case's own 20.41 km (cfl_min 103 s): 32 steps of a 34x34 basin.
    chip_smoke.py's 512² basin keeps the 20.41 km cell for this reason."""
    kw = dict(im=34, jm=34, kb=3, length=32 * dx, dtype="float64")
    m = basin_model(device="cpu", **kw)
    m.run_segment(32)
    assert bool(torch.isfinite(m.state.el).all()) == stable
    if not stable:
        jm = jx_basin(**kw)
        jm.run_segment(32)
        assert not np.isfinite(np.asarray(jm.state.el)).all()
