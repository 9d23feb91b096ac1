"""The port's I/O on the CPU: NetCDF round trips (grid, initial T/S, output
with append, restart with its step counter) and against the JAX package's
readers and writers on the same files; Zarr datasets on the port's own
store, with tensorstore masked; the native record store against numpy
(skipped without g++); and the async writer's host copies."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from extpom_tpu.cases.seamount import seamount_case as jx_case
from extpom_tpu.core.state import State as JxState
from extpom_tpu.io import netcdf as jx_nc
from extpom_tpu.io import zarrstore as jx_zarr

from extpom_tpu_torch.cases.seamount import seamount_case, seamount_model
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.core.state import State
from extpom_tpu_torch.diag import stats
from extpom_tpu_torch.io import netcdf as ncio
from extpom_tpu_torch.io import zarrstore as zio
from extpom_tpu_torch.io.asyncwriter import AsyncWriter
from extpom_tpu_torch.native import recordio

torch.set_num_threads(1)

KW = dict(im=17, jm=13, kb=7)


@pytest.fixture(scope="module")
def run3():
    """A 17x13x7 float64 seamount after 3 steps."""
    m = seamount_model(device="cpu", dtype="float64", **KW)
    m.run_segment(3)
    return m


def _write_nc(path, dims, variables):
    f = netcdf_file(path, "w", version=2)
    for name, n in dims.items():
        f.createDimension(name, n)
    for name, (a, d) in variables.items():
        a = np.asarray(a)
        f.createVariable(name, a.dtype.newbyteorder("="), d)[...] = a
    f.close()


def _grid_file(path, grid, kb):
    """A reference-style grid file (ROMS-style coordinate names)."""
    yx = lambda a: np.asarray(a).swapaxes(-1, -2)
    _write_nc(path, {"z": kb, "y": grid.jm, "x": grid.im}, {
        "z": (grid.z, ("z",)), "zz": (grid.zz, ("z",)),
        "dx": (yx(grid.dx), ("y", "x")), "dy": (yx(grid.dy), ("y", "x")),
        "lon_rho": (yx(grid.east_e), ("y", "x")),
        "lat_rho": (yx(grid.north_e), ("y", "x")),
        "angle": (yx(grid.rot), ("y", "x")),
        "h": (yx(grid.h), ("y", "x")), "fsm": (yx(grid.fsm), ("y", "x"))})


def test_grid_and_init_readers_match_jax(tmp_path):
    """read_grid_nc and read_initial_ts_nc against the JAX package's on the
    same reference-style files; a file whose levels are not kb raises."""
    cfg, grid, ics = seamount_case(device="cpu", dtype="float64", **KW)
    jcfg, _, _ = jx_case(dtype="float64", **KW)
    path = str(tmp_path / "grid.nc")
    _grid_file(path, grid, cfg.kb)
    got = ncio.read_grid_nc(path, cfg, "cpu")
    want = jx_nc.read_grid_nc(path, jcfg)
    for f in dataclasses.fields(Grid):
        assert np.array_equal(getattr(got, f.name).numpy(),
                              np.asarray(getattr(want, f.name))), f.name
    for name in ("h", "fsm", "dum", "dvm", "art", "cbc", "dz"):
        assert torch.equal(getattr(got, name), getattr(grid, name)), name
    with pytest.raises(ValueError, match="kb=8"):
        ncio.read_grid_nc(path, cfg.replace(kb=8), "cpu")

    init = str(tmp_path / "init.nc")
    zyx = lambda a: np.asarray(a).swapaxes(-1, -2)
    _write_nc(init, {"z": cfg.kb, "y": cfg.jm, "x": cfg.im},
              {"T": (zyx(ics["tb"]), ("z", "y", "x")),
               "S": (zyx(ics["sb"]), ("z", "y", "x"))})
    for a, b in zip(ncio.read_initial_ts_nc(init),
                    jx_nc.read_initial_ts_nc(init)):
        assert np.array_equal(a, b)
    assert np.array_equal(ncio.read_initial_ts_nc(init)[0], ics["tb"])


def test_output_append_matches_jax(tmp_path, run3):
    """Two snapshots into one record stream; the port's file holds what
    JAX's write_output_nc writes for the same state."""
    m = run3
    s = {k: float(v) for k, v in
         stats.domain_stats(m.grid, m.cfg, m.state).items()}
    path = str(tmp_path / "out.nc")
    ncio.write_output_nc(path, m.grid, m.cfg, m.state, 0.5, s, append=True)
    ncio.write_output_nc(path, m.grid, m.cfg, m.state, 0.75, s,
                         extra={"wr": m.compute_wr()}, append=True)
    jpath = str(tmp_path / "jx.nc")
    st = _numpy_state(m.state)
    jcfg, jgrid, _ = jx_case(dtype="float64", **KW)
    jx_nc.write_output_nc(jpath, jgrid, jcfg, st, 0.5, s)
    f = netcdf_file(path, "r", mmap=False)
    g = netcdf_file(jpath, "r", mmap=False)
    try:
        assert f.variables["time"][:].tolist() == [0.5, 0.75]
        for name in g.variables:
            a, b = f.variables[name][:], g.variables[name][:]
            if f.variables[name].dimensions[:1] == ("time",):
                a = a[:1]
            assert np.array_equal(a, b), name
        assert np.array_equal(f.variables["t"][1], st.t.swapaxes(-1, -2))
        assert "wr" not in f.variables     # extra only where it was created
    finally:
        f.close()
        g.close()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_append_adds_one_record(tmp_path, dtype):
    """Each append adds one record holding that call's time, diagnostics,
    fields and extras, in the file's dtype; the records before it and the
    grid stay as they were written."""
    m = seamount_model(device="cpu", dtype=dtype, **KW)
    m.run_segment(2)
    s = {k: float(v) for k, v in
         stats.domain_stats(m.grid, m.cfg, m.state).items()}
    wr = m.compute_wr()
    path = str(tmp_path / "out.nc")
    ncio.write_output_nc(path, m.grid, m.cfg, m.state, 0.5, s,
                         extra={"wr": wr})
    for k in range(1, 4):
        st = m.state.replace(t=m.state.t + k, u=m.state.u * k)
        ncio.write_output_nc(path, m.grid, m.cfg, st, 0.5 + k,
                             {**s, "saver": s["saver"] + k},
                             extra={"wr": wr * k}, append=True)
    hx = lambda x: x.numpy().swapaxes(-1, -2)
    f = netcdf_file(path, "r", mmap=False)
    try:
        assert f.variables["time"][:].tolist() == [0.5, 1.5, 2.5, 3.5]
        assert f.variables["savg"][:].tolist() == [s["saver"] + k
                                                   for k in range(4)]
        for k in range(4):
            assert np.array_equal(f.variables["u"][k], hx(m.state.u * k)
                                  if k else hx(m.state.u))
            assert np.array_equal(f.variables["t"][k], hx(m.state.t + k))
            assert np.array_equal(f.variables["wr"][k], hx(wr * k)
                                  if k else hx(wr))
            assert np.array_equal(f.variables["elb"][k], hx(m.state.elb))
        assert f.variables["u"].data.dtype == np.dtype(dtype).newbyteorder(">")
        assert np.array_equal(f.variables["h"][:], hx(m.grid.h))
    finally:
        f.close()


def _numpy_state(st):
    import types
    return types.SimpleNamespace(**{n: getattr(st, n).numpy()
                                    for n in State.field_names()})


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_restart_roundtrip(tmp_path, dtype):
    """write_restart_nc / read_restart_nc: the 37 fields back exactly, the
    step counter and time0 present; the unsaved fields seeded."""
    m = seamount_model(device="cpu", dtype=dtype, **KW)
    m.run_segment(2)
    m.time0 = 0.25
    path = str(tmp_path / "rst.nc")
    ncio.write_restart_nc(path, m.state, m.time_days, m.iint, m.time0)
    f = netcdf_file(path, "r", mmap=False)
    assert int(f.variables["iint"][...]) == 2
    f.close()
    st, iint, time0 = ncio.read_restart_nc(path, m.cfg, "cpu")
    assert (iint, time0) == (2, 0.25)
    for name in ncio.RESTART_FIELDS:
        a = getattr(st, name)
        assert a.dtype == m.state.el.dtype
        assert np.array_equal(a.numpy(), getattr(m.state, name).numpy()), \
            name
    assert torch.equal(st.etf, st.et)
    assert not st.drx2d.any() and not st.vfluxf.any()


def test_restart_interchange_with_jax(tmp_path, run3):
    """A JAX-written restart (no iint: the reference's convention, step
    counting restarts and time continues) reads into the port; the port's
    restart reads into the JAX package."""
    m = run3
    jcfg, _, _ = jx_case(dtype="float64", **KW)
    jpath = str(tmp_path / "jx.nc")
    jx_nc.write_restart_nc(jpath, _numpy_state(m.state), 0.125)
    st, iint, time0 = ncio.read_restart_nc(jpath, m.cfg, "cpu")
    assert (iint, time0) == (0, 0.125)
    for name in ncio.RESTART_FIELDS:
        assert torch.equal(getattr(st, name), getattr(m.state, name)), name
    path = str(tmp_path / "pt.nc")
    ncio.write_restart_nc(path, m.state, m.time_days, m.iint)
    jst, _, _ = jx_nc.read_restart_nc(path, jcfg)
    for f in dataclasses.fields(JxState):
        if f.name in ncio.RESTART_FIELDS:
            assert np.array_equal(np.asarray(getattr(jst, f.name)),
                                  getattr(m.state, f.name).numpy()), f.name


def test_nc_forcing_source_matches_jax(tmp_path):
    """NcForcingSource on a file the JAX package's write_forcing_series_nc
    wrote: the same names, record counts and records as JAX's reader."""
    rng = np.random.default_rng(5)
    im, jm, kb, nrec = 9, 7, 5, 4
    data = {"wusurf": rng.standard_normal((nrec, im, jm)),
            "elw": rng.standard_normal((nrec, jm)),
            "tbs": rng.standard_normal((nrec, kb, im)),
            "ubw": rng.standard_normal((nrec, kb, jm))}
    path = str(tmp_path / "lbry.nc")
    jx_nc.write_forcing_series_nc(path, data, im, jm, kb)
    got, want = ncio.NcForcingSource(path), jx_nc.NcForcingSource(path)
    assert sorted(got.names()) == sorted(want.names()) == sorted(data)
    for name in data:
        assert got.nrec(name) == want.nrec(name) == nrec
        for n in (-1, 0, 2, nrec + 3):
            assert np.array_equal(got.read(name, n), want.read(name, n))
        assert np.array_equal(got.read(name, 1), data[name][1])
    ncio.write_forcing_series_nc(str(tmp_path / "pt.nc"), data, im, jm, kb)
    again = ncio.NcForcingSource(str(tmp_path / "pt.nc"))
    for name in data:
        assert np.array_equal(again.read(name, 3), data[name][3])


def test_zarr_datasets(tmp_path, run3, monkeypatch):
    """Zarr restart (every State field, bit for bit, readable by the JAX
    package), snapshot (and its NetCDF conversion), grid, initial T/S and
    forcing series, written and read by the port with tensorstore
    masked."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    m = run3
    rst = str(tmp_path / "rst")
    zio.write_restart(rst, m.state, m.iint, 0.5)
    st, iint, time0 = zio.read_restart(rst, m.cfg, "cpu")
    assert (iint, time0) == (3, 0.5)
    for name in State.field_names():
        assert torch.equal(getattr(st, name), getattr(m.state, name)), name
    jcfg, _, _ = jx_case(dtype="float64", **KW)
    jst, _, _ = jx_zarr.read_restart(rst, jcfg)
    assert np.array_equal(np.asarray(jst.q2), m.state.q2.numpy())

    out = str(tmp_path / "out")
    s = {k: float(v) for k, v in
         stats.domain_stats(m.grid, m.cfg, m.state).items()}
    zio.write_output(out, m.grid, m.cfg, m.state, 0.5, s)
    snap = zio.read_output(out)
    assert np.array_equal(snap["t"], m.state.t.numpy())
    assert snap["attrs"]["stats"]["vtot"] == s["vtot"]
    nc = str(tmp_path / "out.nc")
    assert ncio.main([out, out, nc]) == 0
    f = netcdf_file(nc, "r", mmap=False)
    assert f.variables["u"].shape[0] == 2
    assert np.array_equal(f.variables["u"][1],
                          m.state.u.numpy().swapaxes(-1, -2))
    f.close()

    cfg, grid, ics = seamount_case(device="cpu", dtype="float64", **KW)
    zio.write_grid(str(tmp_path / "grid"), grid)
    g2 = zio.read_grid(str(tmp_path / "grid"), cfg, "cpu")
    assert torch.equal(g2.cbc, grid.cbc) and torch.equal(g2.h, grid.h)
    zio.write_initial_ts(str(tmp_path / "init"), ics["tb"], ics["sb"])
    tb, sb, tclim, _ = zio.read_initial_ts(str(tmp_path / "init"))
    assert np.array_equal(tb, ics["tb"]) and np.array_equal(tclim, tb)

    series = {"wusurf": np.arange(12.0).reshape(3, 2, 2)}
    zio.write_forcing_series(str(tmp_path / "sfrc"), series)
    src = zio.ZarrSource(str(tmp_path / "sfrc"))
    assert src.names() == ["wusurf"] and src.nrec("wusurf") == 3
    assert np.array_equal(src.read("wusurf", 9), series["wusurf"][2])


def test_zarr_without_tensorstore_raises(tmp_path, monkeypatch):
    """Where tensorstore is not installed the Zarr paths that once raised
    there run on the port's own store: an array is written and read back,
    and a forcing source opens and reads its records."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    a = np.arange(6.0).reshape(2, 3)
    zio.write_array(str(tmp_path / "x"), "a", a)
    assert np.array_equal(zio.read_array(str(tmp_path / "x"), "a"), a)
    src = zio.ZarrSource(str(tmp_path / "x"))
    assert src.names() == ["a"] and src.nrec("a") == 2
    assert np.array_equal(src.read("a", 5), a[1])


@pytest.mark.skipif(not recordio.available(),
                    reason="g++ or native/recordio.cpp unavailable")
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_native_record_source(tmp_path, dtype):
    """The port's own build of the record store: records, clamping and the
    fused interpolation against numpy (bit for bit: no contraction)."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal((6, 13, 9)).astype(dtype)
    recordio.write_records(str(tmp_path), {"wusurf": data, "elw": data[:, 0]})
    src = recordio.NativeRecordSource(str(tmp_path))
    assert sorted(src.names()) == ["elw", "wusurf"]
    assert src.nrec("wusurf") == 6
    assert np.array_equal(src.read("wusurf", 2), data[2])
    assert np.array_equal(src.read("wusurf", 99), data[-1])
    assert np.array_equal(src.read("elw", -3), data[0, 0])
    for x in (0.0, 2.25, 4.5):
        n, frac = int(x), x - int(x)
        want = ((1.0 - frac) * data[n].astype(np.float64)
                + frac * data[n + 1].astype(np.float64)).astype(dtype)
        if dtype == np.float64:
            assert np.array_equal(src.interp("wusurf", x), want)
        else:
            np.testing.assert_allclose(src.interp("wusurf", x), want,
                                       rtol=1e-6)
    assert np.array_equal(src.interp("wusurf", 7.5), data[-1])
    assert str(recordio.LIB).endswith("build/native/librecordio.so")


def test_async_writer_takes_host_copies():
    """The worker writes what the tensors held at submit: an in-place change
    made while the write waits does not reach it; writes keep their order
    and a failed write raises on the next flush."""
    w = AsyncWriter(max_pending=2)
    gate = threading.Event()
    seen = []

    def write(state, x, extra):
        gate.wait()
        seen.append((state.el.clone(), x.clone(), extra["wr"].clone()))

    m = seamount_model(device="cpu", dtype="float64", im=9, jm=9, kb=5)
    before = m.state.el.clone()
    x = torch.arange(4.0)
    w.submit(write, m.state, x, extra={"wr": x * 2})
    m.state.el.add_(1.0)
    x.zero_()
    gate.set()
    w.flush()
    el, xs, wr = seen[0]
    assert torch.equal(el, before)
    assert torch.equal(xs, torch.arange(4.0))
    assert torch.equal(wr, 2 * torch.arange(4.0))
    assert w.n_writes == 1 and w.busy_s > 0

    def boom():
        raise ValueError("disk full")

    w.submit(boom)
    with pytest.raises(RuntimeError, match="async output write failed"):
        w.flush()
    w.submit(lambda: seen.append("after"))
    w.close()
    assert seen[-1] == "after"
