"""The port's forcing against the JAX package's, on the CPU in float64: the
host provider (record interpolation, hold past the end, depth integration,
cont_bry offsets) and the staged plan's ``forcing_at`` (whole and windowed)
on the same numpy series at 1e-12 of each field's scale; the tidal channel's
plan path against JAX's ``channel_model().run_segment`` at 1e-10 of scale;
the host and plan paths against each other; windowed staging bit for bit
against whole staging; ``compute_wr``; and the float32 record index at a
record boundary."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extpom_tpu.cases.channel import channel_model as jx_channel
from extpom_tpu.cases.seamount import seamount_case as jx_case
from extpom_tpu.core.config import Config as JxConfig
from extpom_tpu.core.model import Model as JxModel
from extpom_tpu.forcing import device as jx_dev
from extpom_tpu.forcing import provider as jx_prov

from extpom_tpu_torch.cases.channel import channel_model
from extpom_tpu_torch.cases.seamount import seamount_case
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.convert import from_numpy, plan_from_numpy
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.core.model import Model
from extpom_tpu_torch.core.state import Forcing, State
from extpom_tpu_torch.forcing import device as fdev
from extpom_tpu_torch.forcing import provider as prov

torch.set_num_threads(1)

IM = JM = 17
KB = 7
CHANNEL = dict(im=33, jm=17, kb=7, dtype="float64")


def _series(nrec: int = 5, seed: int = 3) -> dict:
    """Surface, elevation and boundary-profile series made from a seed:
    wind ramps across records, a piecewise-constant SST, west/south
    profiles that depth-integrate, and a tide at the west edge."""
    rng = np.random.default_rng(seed)
    ramp = np.arange(nrec, dtype=float)[:, None, None]
    return {
        "wusurf": 1e-4 * ramp * np.ones((nrec, IM, JM)),
        "wvsurf": 1e-4 * rng.standard_normal((nrec, IM, JM)),
        "tsurf": rng.standard_normal((nrec, IM, JM)),
        "elw": 0.1 * rng.standard_normal((nrec, JM)),
        "ubw": 0.3 * rng.standard_normal((nrec, KB, JM)),
        "vbs": 0.2 * rng.standard_normal((nrec, KB, IM)),
        "tbe": rng.standard_normal((nrec, KB, JM)),
    }


@pytest.fixture(scope="module")
def models():
    """A JAX and a port seamount Model of the same case (17x17x7 f64)."""
    jcfg, jgrid, jics = jx_case(im=IM, jm=JM, kb=KB, dtype="float64")
    jm = JxModel(jgrid, jcfg, tb=jics["tb"], sb=jics["sb"], donate=False)
    cfg, grid, ics = seamount_case(im=IM, jm=JM, kb=KB, dtype="float64",
                                   device="cpu")
    pm = Model(grid, cfg, tb=ics["tb"], sb=ics["sb"])
    return jm, pm


def _providers(models, data, cont=0):
    jm, pm = models
    jp = jx_prov.ForcingProvider(jm.grid, jm.cfg, jm.base_forcing,
                                 jx_prov.ArraySource(data),
                                 cont_bry_offset=cont)
    pp = prov.ForcingProvider(pm.grid, pm.cfg, pm.base_forcing,
                              prov.ArraySource(data), cont_bry_offset=cont)
    return jp, pp


def _assert_forcing(got: Forcing, want, tol: float, what: str):
    for f in dataclasses.fields(Forcing):
        if f.name == "ramp":
            continue
        a = getattr(got, f.name).numpy()
        b = np.asarray(getattr(want, f.name))
        assert a.shape == b.shape, (what, f.name)
        err = np.abs(a - b).max() if a.size else 0.0
        assert err <= tol * max(1.0, np.abs(b).max()), (what, f.name, err)


@pytest.mark.parametrize("cont", [0, 3])
def test_provider_matches_jax(models, cont):
    """Wind ramps across records, SST holds each record, the profiles
    depth-integrate into uabw/vabs, and past the series' end every field
    holds its last record; the boundary series shifted by cont_bry."""
    jp, pp = _providers(models, _series(), cont)
    jm, pm = models
    rec = int(prov.TSURF * 86400 / pm.cfg.dti)       # steps per wind record
    for iint in (0, 1, rec // 2, rec, rec + 7, 3 * rec - 1, 40 * rec):
        _assert_forcing(pp(pm, iint), jp(jm, iint), 1e-12, f"iint={iint}")
    # the ramp: half a record in, wusurf is half its first increment
    half = pp(pm, rec // 2).wusurf[0, 0].item()
    assert abs(half - 1e-4 * (rec // 2) * pm.cfg.dti / 86400 / 0.125) < 1e-18
    # the hold: far past the end, the last record
    assert pp(pm, 40 * rec).wusurf[0, 0].item() == pytest.approx(4e-4)
    # the depth integration: uabw = sum_k ubw(k) dz(k)
    fc = pp(pm, 0)
    dz = pm.grid.dz[:KB - 1]
    want = (torch.tensor(_series()["ubw"][cont]
                         if cont < 5 else _series()["ubw"][4])[:KB - 1]
            * dz[:, None]).sum(0)
    torch.testing.assert_close(fc.uabw, want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("windowed", [False, True])
def test_forcing_at_matches_jax(models, windowed):
    """The staged plan: JAX's and the port's stacks hold the same records,
    and the port's forcing_at on them matches JAX's forcing_at at every
    step of a segment; a windowed plan (budget 0) matches a whole one over
    the segment it was staged for."""
    jm, pm = models
    jp, pp = _providers(models, _series(nrec=9), cont=2)
    dti = pm.cfg.dti
    i0, n = 37, 60
    t0, t1 = i0 * dti / 86400.0, (i0 + n) * dti / 86400.0
    kw = dict(budget_bytes=0, t0_days=t0, t1_days=t1) if windowed else {}
    jplan = jx_dev.make_device_plan(jp, **kw)
    plan = fdev.make_device_plan(pp, **kw)
    assert plan.names == jplan.names
    assert plan.starts == tuple(int(s) for s in jplan.starts)
    for s, js in zip(plan.stacks, jplan.stacks):
        assert np.array_equal(s.numpy(), np.asarray(js))
    whole = fdev.make_device_plan(pp)
    if windowed:
        assert all(s.shape[0] < w.shape[0]
                   for s, w in zip(plan.stacks, whole.stacks))
    carried = plan_from_numpy(jplan.names, jplan.cadences, jplan.offsets,
                              jplan.interp,
                              [np.asarray(s) for s in jplan.stacks],
                              [int(s) for s in jplan.starts], "cpu",
                              torch.float64)
    for i in range(i0 + 1, i0 + n + 1):
        t = fdev.t_days_at(pm.cfg, i, 0.0, torch.float64)
        jt = pm.cfg.dti * jnp.asarray(i, jnp.float64) / 86400.0
        want = jx_dev.forcing_at(jplan, jm.base_forcing, jm.cfg, jm.grid.dz,
                                 jt)
        got = fdev.forcing_at(plan, pm.base_forcing, pm.cfg, pm.grid.dz, t)
        _assert_forcing(got, want, 1e-12, f"step {i}")
        _assert_forcing(fdev.forcing_at(carried, pm.base_forcing, pm.cfg,
                                        pm.grid.dz, t), want, 1e-12,
                        f"carried, step {i}")
        for name in plan.names:
            assert torch.equal(
                getattr(got, name),
                getattr(fdev.forcing_at(whole, pm.base_forcing, pm.cfg,
                                        pm.grid.dz, t), name)), name


def test_float32_record_index_at_boundaries():
    """In float32 the model time and the record index are formed in float32,
    as the JAX package forms them inside its scan, so that floor() picks
    the same record at every record boundary."""
    cfg = Config(im=9, jm=9, kb=5, dtype="float32", dte=7.0, isplit=31)
    for time0 in (0.0, 0.3):
        for i in range(0, 3000, 7):
            t = fdev.t_days_at(cfg, i, time0, torch.float32)
            jt = (cfg.dti * jnp.asarray(i).astype(jnp.float32) / 86400.0
                  + time0)
            assert t.dtype == np.float32
            assert t == np.float32(jt), (i, t, jt)
            for cad in (prov.TBC, prov.TSURF):
                x = (t + np.float32(0.0)) / np.float32(cad)
                jx = (jt + 0.0) / cad
                assert np.floor(x) == np.floor(np.float32(jx)), (i, cad)


def test_unknown_and_restore_names_raise(models):
    """A series the provider does not know raises instead of being dropped;
    the restoring series are served: trstr and srstr interpolated at their
    30-day cadence, taurstr from the source or 1/TRST by default."""
    _, pm = models
    src = prov.ArraySource({"wusurf": np.zeros((2, IM, JM)),
                            "sustr": np.zeros((2, IM, JM))})
    with pytest.raises(ValueError, match="sustr"):
        prov.ForcingProvider(pm.grid, pm.cfg, pm.base_forcing, src)
    with pytest.raises(ValueError, match="uabw"):
        prov.check_names(["uabw"])
    kb = pm.cfg.kb
    rec = lambda r: np.full((2, kb, IM, JM), 1.0) * np.arange(2)[
        :, None, None, None] + r
    for names in (("trstr", "srstr"), prov.RESTORE_VARS):
        prov.check_names(["elw", *names])
        data = {n: rec(10.0 * k) for k, n in enumerate(names)}
        p = prov.ForcingProvider(pm.grid, pm.cfg, pm.base_forcing,
                                 prov.ArraySource(data), prefetch=False)
        iint = int(round(7.5 * 86400.0 / pm.cfg.dti))
        fc = p(pm, iint)
        frac = (pm.cfg.dti * iint / 86400.0 + pm.time0) / prov.TRST
        for k, n in enumerate(names):
            np.testing.assert_allclose(getattr(fc, n).numpy(),
                                       10.0 * k + frac, atol=1e-12)
        if "taurstr" not in names:
            np.testing.assert_allclose(fc.taurstr.numpy(), 1.0 / prov.TRST)
            assert tuple(fc.taurstr.shape) == (1, 1, 1)


def test_multisource():
    """Ownership resolved once, duplicate names raise, and the fused
    interpolation is delegated or declined (None)."""
    a = prov.ArraySource({"wusurf": np.zeros((2, 4, 4))})

    class Fused(prov.ArraySource):
        def interp(self, name, x):
            return np.full((4, 4), 42.0 + x)

    ms = prov.MultiSource([a, Fused({"wtsurf": np.ones((2, 4, 4))})])
    assert sorted(ms.names()) == ["wtsurf", "wusurf"]
    assert ms.nrec("wusurf") == 2
    np.testing.assert_array_equal(ms.read("wtsurf", 1), np.ones((4, 4)))
    np.testing.assert_allclose(ms.interp("wtsurf", 0.5), 42.5)
    assert ms.interp("wusurf", 0.5) is None
    with pytest.raises(ValueError, match="wusurf"):
        prov.MultiSource([a, prov.ArraySource(
            {"wusurf": np.zeros((1, 4, 4))})])


# segments of the channel runs: the first crosses two hourly lateral
# records, the second starts past them, so that a window staged for it
# (forcing_hbm_mb=0) starts at a later record than the series does
SEGMENTS = (42, 8)


@pytest.fixture(scope="module")
def jax_channel():
    m = jx_channel(**CHANNEL)
    m.run_segment(sum(SEGMENTS))
    return m


# the depth sums of the baroclinic gradient: a one-ulp change of T moves them
# by ~1e-9 of their scale within a few steps of the channel
# (test_baroclinic_sums_respond_to_one_ulp), so two correct implementations
# that round T or rho differently differ there by as much
BAROCLINIC_SUMS = ("drx2d", "dry2d")


def _state_errors(got: State, want) -> dict:
    """{field: max |got - want| / max(1, max |want|)} over every field."""
    out = {}
    for name in State.field_names():
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        out[name] = np.abs(a - b).max() / max(1.0, np.abs(b).max())
    return out


def _assert_state(got: State, want, tol: float, sums_tol=None):
    """Every State field of ``got`` within ``tol`` of its scale in
    ``want``; BAROCLINIC_SUMS within ``sums_tol`` where it is given."""
    for name, err in _state_errors(got, want).items():
        lim = sums_tol if sums_tol and name in BAROCLINIC_SUMS else tol
        assert err <= lim, (name, err)


def test_channel_plan_matches_jax(jax_channel):
    """The port's run_segment with the staged plan, windowed per segment
    (forcing_hbm_mb=0), against JAX's channel_model().run_segment over
    SEGMENTS' steps (two lateral records crossed, the second window moved
    past the series' start), every State field at 1e-10 of scale but
    BAROCLINIC_SUMS, at 1e-8; the tide has entered the channel and salinity
    stays uniform."""
    m = channel_model(device="cpu", forcing_hbm_mb=0, **CHANNEL)
    dti = m.cfg.dti / 86400.0
    m.run_segment(SEGMENTS[0])
    win = m._device_plan(m.time_days, m.time_days + SEGMENTS[1] * dti)
    assert win.starts[0] > 0
    m.run_segment(SEGMENTS[1])
    _assert_state(m.state, jax_channel.state, 1e-10, sums_tol=1e-8)
    assert float(m.state.el[1:10, 1:-1].abs().max()) > 0.005
    np.testing.assert_allclose(m.state.s[:KB - 1, :, 1:-1].numpy(), 15.0,
                               atol=1e-12)


def test_baroclinic_sums_respond_to_one_ulp():
    """Why BAROCLINIC_SUMS are held apart: T and its previous level raised
    by one ulp move drx2d/dry2d by more than 1e-10 of their scale after 4
    steps of the channel, while every other field moves by less than
    1e-12."""
    a = channel_model(device="cpu", **CHANNEL)
    b = channel_model(device="cpu", **CHANNEL)
    ulp = 1.0 + 2.0 ** -52
    b.state = b.state.replace(t=b.state.t * ulp, tb=b.state.tb * ulp)
    a.run_segment(4)
    b.run_segment(4)
    err = _state_errors(b.state, a.state)
    assert max(err[f] for f in BAROCLINIC_SUMS) > 1e-10, err
    assert max(e for f, e in err.items()
               if f not in BAROCLINIC_SUMS) < 1e-12, err


def test_channel_host_and_plan_paths_agree():
    """run() assembles each step's forcing on the host (ForcingProvider),
    run_segment() interpolates the staged plan: the same state at 1e-12."""
    a = channel_model(device="cpu", **CHANNEL)
    a.run(n_steps=10)
    b = channel_model(device="cpu", **CHANNEL)
    b.run_segment(10)
    _assert_state(a.state, b.state, 1e-12)


def test_windowed_staging_equals_whole():
    """Three segments with forcing_hbm_mb=0 (a window staged per segment,
    the last one starting past the series' first records) end bit for bit
    where whole staging ends; the window is a strict subset of the
    series."""
    a = channel_model(device="cpu", **CHANNEL)
    b = channel_model(device="cpu", forcing_hbm_mb=0, **CHANNEL)
    assert fdev.plan_bytes(b.forcing_fn) > 0
    dti = b.cfg.dti / 86400.0
    win = b._device_plan(0.0, 6 * dti)
    full = b._device_plan()
    assert win.stacks[0].shape[0] < full.stacks[0].shape[0]
    for n in (21, SEGMENTS[0] - 21, SEGMENTS[1]):
        if b.iint == SEGMENTS[0]:
            assert b._device_plan(b.time_days,
                                  b.time_days + n * dti).starts[0] > 0
        a.run_segment(n)
        b.run_segment(n)
    for name in State.field_names():
        assert torch.equal(getattr(a.state, name), getattr(b.state, name)), \
            name


def test_compute_wr_matches_jax(jax_channel):
    """realvertvl on the JAX channel's state after SEGMENTS' steps, carried
    across, against JAX's compute_wr at 1e-12 of scale."""
    jm = jax_channel
    d = lambda obj, cls: {f.name: np.asarray(getattr(obj, f.name))
                          for f in dataclasses.fields(cls)}
    cfg = Config(**{f.name: getattr(jm.cfg, f.name)
                    for f in dataclasses.fields(Config)})
    grid, st, fc, rmean, tclim, sclim = from_numpy(
        cfg, d(jm.grid, Grid), d(jm.state, State), d(jm.base_forcing, Forcing),
        jm.rmean, jm.tclim, jm.sclim, device="cpu")
    m = Model(grid, cfg, state=st, rmean=rmean, tclim=tclim, sclim=sclim,
              base_forcing=fc, iint=jm.iint)
    want = np.asarray(jm.compute_wr())
    got = m.compute_wr().numpy()
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())
    assert np.abs(want).max() > 0


def test_forcing_on_a_mesh_raises():
    """Forcing on a mesh runs where the grid divides it and raises where
    the mesh would pad it (the JAX package's forced padded run fails;
    tests/test_torch_forcing_mesh.py holds the mesh runs)."""
    from extpom_tpu_torch.mesh.shardmap import Mesh
    m = channel_model(device="cpu", im=32, jm=16, kb=5, dtype="float64")
    with pytest.raises(NotImplementedError, match="padded grid"):
        m.shard(Mesh(3, 2, device="cpu"))
    m.shard(Mesh(2, 2, device="cpu"))
    m.run_segment(2)
    m = channel_model(device="cpu", im=32, jm=16, kb=5, dtype="float64")
    m.shard(Mesh(1, 1, device="cpu"))      # a 1x1 mesh is one device
    m.run_segment(2)
