"""The port's run driver (``python -m extpom_tpu_torch.run``) on the CPU in
float64: its printed diagnostics and NetCDF snapshots against the JAX
package's driver on the same seamount configuration, restart and resume
bit for bit (Zarr restarts under both output formats, and a reference
.nc restart), a fresh run's record stream, inputs and forcing from files,
the channel case, a 2x2 mesh block, the blow-up guard, and what raises;
the Zarr paths with tensorstore masked."""

import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from extpom_tpu.run import main as jx_main

from extpom_tpu_torch import run as ptrun
from extpom_tpu_torch.cases.channel import channel_model
from extpom_tpu_torch.cases.seamount import seamount_case
from extpom_tpu_torch.core.state import State
from extpom_tpu_torch.io import netcdf as ncio
from extpom_tpu_torch.io import zarrstore as zio
from extpom_tpu_torch.native import recordio

torch.set_num_threads(1)

DTI = 180.0
SEAMOUNT = {"run_name": "sm", "case": "seamount",
            "case_args": {"im": 17, "jm": 17, "kb": 7},
            "config": {"days": 16 * DTI / 86400, "prtd1": 4 * DTI / 86400,
                       "write_rst": 8 * DTI / 86400, "dtype": "float64"},
            "out_format": "nc"}


def _conf(tmp_path, name, base=SEAMOUNT, **kw):
    conf = json.loads(json.dumps(base))
    conf["out_dir"] = str(tmp_path / name)
    conf.update(kw)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(conf))
    return conf, str(path)


def _printed(fn, argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _diagnostics(text: str) -> np.ndarray:
    return np.array([[float(x) for x in re.findall(r"= *([-\d.e+]+)", line)]
                     for line in text.splitlines()
                     if line.startswith("time =")])


def _assert_equal_states(a: State, b: State):
    for name in State.field_names():
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """The JAX driver on the seamount configuration (snapshots to .nc)."""
    tmp = tmp_path_factory.mktemp("jax")
    conf, path = _conf(tmp, "jx")
    rc, text = _printed(jx_main, [path])
    assert rc == 0
    return text, f"{conf['out_dir']}/sm.nc"


def test_cli_matches_jax_driver(tmp_path, jax_cli):
    """The printed diagnostics to 1e-9 relative and every variable of the
    .nc record stream to 1e-10 of its scale; one record per print."""
    jtext, jnc = jax_cli
    conf, path = _conf(tmp_path, "pt")
    rc, text = _printed(ptrun.main, [path, "--device", "cpu"])
    assert rc == 0
    assert "CFL advisory" in text and "dispatch:" in text
    assert "external mode: plain" in text and "wall clock" in text
    got, want = _diagnostics(text), _diagnostics(jtext)
    assert got.shape == want.shape == (4, 6)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    f = netcdf_file(f"{conf['out_dir']}/sm.nc", "r", mmap=False)
    g = netcdf_file(jnc, "r", mmap=False)
    try:
        assert set(f.variables) == set(g.variables)
        assert f.variables["time"].shape == (4,)
        for name, v in g.variables.items():
            a, b = np.asarray(f.variables[name][:]), np.asarray(v[:])
            scale = max(1.0, float(np.abs(b).max()))
            assert np.abs(a - b).max() <= 1e-10 * scale, name
    finally:
        f.close()
        g.close()


@pytest.mark.parametrize("fmt", ["nc", "zarr"])
def test_resume_equals_uninterrupted(tmp_path, fmt, monkeypatch):
    """Restart at step 8, resume to 16: every state field equal to the
    uninterrupted run's; the restarts are Zarr under both out_formats (the
    JAX driver's rule), written and read with tensorstore masked."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    conf, _ = _conf(tmp_path, "whole", out_format=fmt)
    whole = ptrun.execute(conf, "cpu", log=lambda s: None)
    assert whole.rc == 0 and whole.steps == 16 and whole.writes == 6
    rst = f"{conf['out_dir']}/sm.rst.000008"
    assert os.path.isfile(os.path.join(rst, "attrs.json"))
    assert not os.path.exists(rst + ".nc")
    conf2, _ = _conf(tmp_path, "resumed", out_format=fmt, nread_rst=1,
                     read_rst_path=rst)
    resumed = ptrun.execute(conf2, "cpu", log=lambda s: None)
    assert resumed.rc == 0 and resumed.steps == 8
    assert resumed.model.iint == 16
    _assert_equal_states(resumed.model.state, whole.model.state)


def test_fresh_run_starts_its_record_stream(tmp_path):
    """A second fresh run into the same directory writes {run}.nc anew."""
    conf, path = _conf(tmp_path, "again")
    for _ in range(2):
        assert _printed(ptrun.main, [path, "--device", "cpu"])[0] == 0
    f = netcdf_file(f"{conf['out_dir']}/sm.nc", "r", mmap=False)
    assert f.variables["time"].shape == (4,)
    f.close()


def test_inputs_and_forcing_from_files(tmp_path):
    """Grid and initial T/S from .nc files: the grid the case builds (its
    f-plane Coriolis aside: from a file it is derived from the latitudes)
    and the case's initial state, run through; the same wind series from a
    .nc file and from a directory of .efr files (the native record store)
    drive bit-equal runs."""
    cfg, grid, ics = seamount_case(im=17, jm=17, kb=7, dtype="float64",
                                   device="cpu")
    ncio.write_output_nc(str(tmp_path / "grid.nc"), grid, cfg,
                         _zero_output(cfg), 0.0)
    yx = lambda a: np.asarray(a).swapaxes(-1, -2)
    f = netcdf_file(str(tmp_path / "init.nc"), "w", version=2)
    f.createDimension("z", 7)
    f.createDimension("y", 17)
    f.createDimension("x", 17)
    for name, a in (("T", ics["tb"]), ("S", ics["sb"])):
        f.createVariable(name, np.dtype(np.float64), ("z", "y", "x"))[...] = \
            yx(a)
    f.close()
    common = {"grid": str(tmp_path / "grid.nc"),
              "init": str(tmp_path / "init.nc"),
              "config": dict(SEAMOUNT["config"], im=17, jm=17, kb=7,
                             lramp=True)}
    conf, _ = _conf(tmp_path, "files", **common)
    del conf["case"]
    model = ptrun.build_model(conf, "cpu")
    for name in ("h", "fsm", "dum", "dvm", "art", "aru", "cbc", "dz"):
        assert torch.equal(getattr(model.grid, name), getattr(grid, name))
    assert torch.equal(model.state.t, torch.tensor(ics["tb"]))
    from_files = ptrun.execute(conf, "cpu", log=lambda s: None)
    assert from_files.rc == 0 and from_files.steps == 16
    case, _ = _conf(tmp_path, "case")
    from_case = ptrun.execute(case, "cpu", log=lambda s: None)

    rng = np.random.default_rng(11)
    wind = {"wusurf": 1e-4 * rng.standard_normal((3, 17, 17)),
            "wvsurf": 1e-4 * rng.standard_normal((3, 17, 17))}
    ncio.write_forcing_series_nc(str(tmp_path / "sfrc.nc"), wind, 17, 17)
    runs = [ptrun.execute(_conf(tmp_path, "nc_wind",
                                sfrc=str(tmp_path / "sfrc.nc"))[0], "cpu",
                          log=lambda s: None)]
    if recordio.available():
        recordio.write_records(str(tmp_path / "sfrc_efr"), wind)
        runs.append(ptrun.execute(
            _conf(tmp_path, "efr_wind", sfrc=str(tmp_path / "sfrc_efr"))[0],
            "cpu", log=lambda s: None))
    assert not torch.equal(runs[0].model.state.u, from_case.model.state.u)
    for r in runs[1:]:
        _assert_equal_states(r.model.state, runs[0].model.state)


def _zero_output(cfg):
    import types
    z2 = np.zeros((cfg.im, cfg.jm))
    z3 = np.zeros((cfg.kb, cfg.im, cfg.jm))
    return types.SimpleNamespace(**{n: (z2 if n in ("uab", "vab", "elb")
                                        else z3)
                                    for n in ncio.OUTPUT_FIELDS})


def test_cli_channel(tmp_path):
    """The channel case through the driver (its lateral series staged per
    segment; the last segments' windows start past the series' first
    records) ends where channel_model's run_segment ends, bit for bit, and
    so does a run resumed from its restart at half way."""
    n, seg = 48, 6
    base = {"run_name": "ch", "case": "channel",
            "case_args": {"im": 33, "jm": 17, "kb": 7},
            "config": {"days": n * DTI / 86400, "prtd1": seg * DTI / 86400,
                       "write_rst": n // 2 * DTI / 86400, "dtype": "float64",
                       "forcing_hbm_mb": 0},
            "out_format": "nc"}
    conf, path = _conf(tmp_path, "ch", base)
    r = ptrun.execute(conf, "cpu", log=lambda s: None)
    assert r.rc == 0 and r.steps == n
    t = lambda i: i * DTI / 86400
    assert r.model._device_plan(t(n - seg), t(n)).starts[0] > 0
    m = channel_model(device="cpu", im=33, jm=17, kb=7, dtype="float64")
    m.run_segment(n)
    _assert_equal_states(r.model.state, m.state)
    assert float(m.state.el[1:10, 1:-1].abs().max()) > 0.005
    conf2, _ = _conf(tmp_path, "ch2", base, nread_rst=1,
                     read_rst_path=f"{conf['out_dir']}/ch.rst.{n // 2:06d}")
    resumed = ptrun.execute(conf2, "cpu", log=lambda s: None)
    _assert_equal_states(resumed.model.state, m.state)


def test_cli_mesh_block(tmp_path):
    """A 2x2 mesh block: the decomposed run prints the single-device run's
    diagnostics and writes its snapshots."""
    base = json.loads(json.dumps(SEAMOUNT))
    base["case_args"] = {"im": 16, "jm": 16, "kb": 7}
    base["config"]["days"] = 8 * DTI / 86400
    conf, path = _conf(tmp_path, "one", base)
    rc, one = _printed(ptrun.main, [path, "--device", "cpu"])
    conf_m, path_m = _conf(tmp_path, "mesh", base,
                           mesh={"px": 2, "py": 2})
    rc_m, mesh = _printed(ptrun.main, [path_m, "--device", "cpu"])
    assert rc == rc_m == 0
    assert "mesh: 2x2 shardmap on 1 device" in mesh
    np.testing.assert_allclose(_diagnostics(mesh), _diagnostics(one),
                               rtol=1e-12, atol=0)
    f = netcdf_file(f"{conf['out_dir']}/sm.nc", "r", mmap=False)
    g = netcdf_file(f"{conf_m['out_dir']}/sm.nc", "r", mmap=False)
    try:
        for name in ("t", "u", "elb"):
            a, b = f.variables[name][:], g.variables[name][:]
            assert np.abs(a - b).max() <= 1e-10 * max(1.0, np.abs(a).max())
    finally:
        f.close()
        g.close()


def test_blowup_guard_returns_1(tmp_path):
    conf, path = _conf(tmp_path, "boom", config=dict(
        SEAMOUNT["config"], dte=600.0))
    rc, text = _printed(ptrun.main, [path, "--device", "cpu"])
    assert rc == 1
    assert "velocity condition violated" in text


@pytest.mark.parametrize("what", ["distributed", "gspmd", "mesh_forcing"])
def test_unported_blocks_raise(tmp_path, what):
    extra = {"distributed": {"distributed": {"num_processes": 2}},
             "gspmd": {"mesh": {"px": 2, "py": 1, "mode": "gspmd"}},
             # forcing on a grid the mesh pads: the JAX package's run
             # fails there (a forced run on a mesh that divides runs:
             # tests/test_torch_forcing_mesh.py)
             "mesh_forcing": {"case": "channel",
                              "case_args": {"im": 33, "jm": 16, "kb": 5},
                              "mesh": {"px": 2, "py": 2}}}[what]
    conf, _ = _conf(tmp_path, what, **extra)
    with pytest.raises(NotImplementedError):
        ptrun.execute(conf, "cpu", log=lambda s: None)


def test_no_card_raises(tmp_path):
    """Without --device cpu the driver runs on the card, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    conf, path = _conf(tmp_path, "card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ptrun.main([path])
    assert ptrun.main([]) == 2


def test_zarr_out_format_without_tensorstore_raises(tmp_path, monkeypatch):
    """Where tensorstore is not installed, out_format "zarr" (which raised
    there before the port had its own store) runs: one Zarr snapshot per
    print and a restart every 8 steps, holding the run's fields."""
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    conf, _ = _conf(tmp_path, "zarr", out_format="zarr")
    res = ptrun.execute(conf, "cpu", log=lambda s: None)
    assert res.rc == 0 and res.writes == 6
    out = conf["out_dir"]
    assert sorted(os.listdir(out)) == [
        "sm.000004", "sm.000008", "sm.000012", "sm.000016",
        "sm.rst.000008", "sm.rst.000016"]
    snap = zio.read_output(os.path.join(out, "sm.000016"))
    assert np.array_equal(snap["t"], res.model.state.t.numpy())
    st, iint, _ = zio.read_restart(os.path.join(out, "sm.rst.000016"),
                                   res.model.cfg, "cpu")
    assert iint == 16
    _assert_equal_states(st, res.model.state)


def test_nc_restart_still_resumes(tmp_path):
    """A read_rst_path ending in .nc resumes through read_restart_nc (the
    reference's restart format): a run to step 8, its state written as a
    .nc restart, resumed to 16, equals the uninterrupted run."""
    conf, _ = _conf(tmp_path, "whole")
    whole = ptrun.execute(conf, "cpu", log=lambda s: None)
    half = json.loads(json.dumps(conf))
    half["config"]["days"] = 8 * DTI / 86400
    half["out_dir"] = str(tmp_path / "half")
    first = ptrun.execute(half, "cpu", log=lambda s: None)
    assert first.rc == 0 and first.model.iint == 8
    rst = str(tmp_path / "sm.rst.000008.nc")
    ncio.write_restart_nc(rst, first.model.state, first.model.time_days,
                          first.model.iint, first.model.time0)
    conf2, _ = _conf(tmp_path, "resumed", nread_rst=1, read_rst_path=rst)
    resumed = ptrun.execute(conf2, "cpu", log=lambda s: None)
    assert resumed.rc == 0 and resumed.steps == 8
    _assert_equal_states(resumed.model.state, whole.model.state)
