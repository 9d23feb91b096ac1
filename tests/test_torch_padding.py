"""Ragged grids padded to the mesh (``extpom_tpu_torch/mesh/padding.py``)
on the CPU in float64, on the seamount at 33x65x7, which divides neither
axis of a 2x4 mesh (tests/test_ragged.py and test_shardmap.py's ragged
case for the JAX package):

* the padded single-device port (``pad_model``) against the JAX package's
  padded run, 1e-12 of each field's scale on the active region, and
  against the port's own unpadded run, bit for bit;
* a pad poisoned with NaN stays out of the active region, and the pad
  cells of the prognostic fields stay 0;
* the port's padded 2x4 mesh (``Model.shard`` pads) against its padded
  single-device run (``torch.equal``) and against the JAX package's padded
  shard_map run, 1e-10 of scale;
* the orlanski scheme on the padded grid;
* ``run.main`` with a mesh block the grid does not divide writes and
  resumes the active ``im x jm``.

The JAX shard_map path passes ``check_rep`` to ``shard_map``, which the
installed jax calls ``check_vma``; the fixture ``jax_shard_map`` renames the
keyword for the duration of one JAX run, inside this module only."""

import json

import numpy as np
import pytest
import torch

from extpom_tpu.cases.seamount import seamount_model as jx_model
from extpom_tpu.mesh import padding as jx_padding
from extpom_tpu.mesh import shardmap as jx_shardmap
from extpom_tpu.mesh.sharding import make_mesh

from extpom_tpu_torch import run as ptrun
from extpom_tpu_torch.cases.seamount import seamount_model as pt_model
from extpom_tpu_torch.core.state import State
from extpom_tpu_torch.diag import stats
from extpom_tpu_torch.io import netcdf as ncio
from extpom_tpu_torch.io import zarrstore as zio
from extpom_tpu_torch.mesh.padding import pad_model, padded_dims, unpad
from extpom_tpu_torch.mesh.shardmap import Mesh

torch.set_num_threads(1)

IM, JM, KB = 33, 65, 7
KW = dict(im=IM, jm=JM, kb=KB, dtype="float64")
N = 3
CHECK = ("el", "ua", "va", "u", "v", "w", "t", "s", "rho", "q2", "q2l",
         "km", "kh", "l", "wubot", "wvbot")
# fields whose pad cells hold exactly 0 (the turbulence fields' pad holds
# the closure's floor values, which no active cell reads)
PROGNOSTIC = ("el", "elb", "et", "etb", "etf", "ua", "uab", "va", "vab",
              "u", "ub", "v", "vb", "w", "t", "tb", "s", "sb", "rho")



def _close(got: dict, want: dict, tol: float, names=CHECK):
    for name in names:
        a, b = np.asarray(want[name]), np.asarray(got[name])
        atol = tol * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=name)


def _active(m, st=None) -> dict:
    st = st if st is not None else m.gathered_state()
    return {n: unpad(getattr(st, n), m.cfg).numpy() for n in CHECK}


@pytest.fixture(scope="module")
def unpadded():
    """The port's unpadded single-device model after N steps."""
    m = pt_model(device="cpu", **KW)
    m.run_segment(N)
    return m


@pytest.fixture(scope="module")
def padded():
    """The port's padded single-device model after N steps."""
    m = pt_model(device="cpu", **KW)
    pad_model(m, 2, 4)
    m.run_segment(N)
    return m


@pytest.fixture
def jax_shard_map(monkeypatch):
    """Run the JAX shard_map path on the installed jax: its ``check_rep``
    keyword becomes ``check_vma``."""
    orig = jx_shardmap.shard_map

    def shard_map(*a, check_rep=None, **k):
        if check_rep is not None:
            k["check_vma"] = check_rep
        return orig(*a, **k)

    monkeypatch.setattr(jx_shardmap, "shard_map", shard_map)


def test_padded_dims():
    assert padded_dims(33, 65, 2, 4) == (34, 68)
    assert padded_dims(32, 64, 2, 4) == (32, 64)
    assert padded_dims(255, 255, 2, 4) == (256, 256)


def test_padded_model_matches_jax_padded_run(padded):
    m = jx_model(donate=False, **KW)
    jx_padding.pad_model(m, 2, 4)
    for _ in range(N):
        m.step_once()
    assert (padded.cfg.im, padded.cfg.jm) == (m.cfg.im, m.cfg.jm) == (34, 68)
    assert (padded.cfg.im_act, padded.cfg.jm_act) == (IM, JM)
    want = {n: np.asarray(jx_padding.unpad(getattr(m.state, n), m.cfg))
            for n in CHECK}
    _close(_active(padded), want, 1e-12)


def test_padded_model_matches_unpadded_bit_for_bit(padded, unpadded):
    got = unpad(padded.state, padded.cfg)
    for name in State.field_names():
        assert torch.equal(getattr(got, name),
                           getattr(unpadded.state, name)), name


def test_pad_cells_stay_zero(padded):
    for name in PROGNOSTIC:
        a = getattr(padded.state, name)
        assert not a[..., IM:, :].any() and not a[..., :, JM:].any(), name


def test_no_pad_cell_is_read(padded):
    m = pt_model(device="cpu", **KW)
    pad_model(m, 2, 4)

    def poison(a):
        a = a.clone()
        if a.dim() >= 2 and a.shape[-2:] == (m.cfg.im, m.cfg.jm):
            a[..., IM:, :] = float("nan")
            a[..., :, JM:] = float("nan")
        return a

    m.state = State(**{n: poison(getattr(m.state, n))
                       for n in State.field_names()})
    m.run_segment(N)
    got, want = unpad(m.state, m.cfg), unpad(padded.state, padded.cfg)
    for name in State.field_names():
        assert torch.isfinite(getattr(got, name)).all(), name
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_padded_diagnostics_cover_the_active_region(padded, unpadded):
    got = stats.domain_stats(padded.grid, padded.cfg, padded.state)
    want = stats.domain_stats(unpadded.grid, unpadded.cfg, unpadded.state)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    assert stats.check_velocity(padded.cfg, padded.state.va)[0] == \
        stats.check_velocity(unpadded.cfg, unpadded.state.va)[0]


def test_shard_pads_the_grid(padded, jax_shard_map):
    """Model.shard pads 33x65 to 34x68 for 2x4; the decomposed run equals
    the padded single-device run bit for bit on the active region (the
    prognostic fields on the whole padded grid) and the JAX package's
    padded shard_map run at 1e-10 of scale."""
    m = pt_model(device="cpu", **KW).shard(Mesh(2, 4, device="cpu"))
    assert (m.cfg.im, m.cfg.jm, m.blocks.ni, m.blocks.nj) == (34, 68, 17, 17)
    m.run_segment(N)
    st = m.gathered_state()
    got, want = unpad(st, m.cfg), unpad(padded.state, padded.cfg)
    for name in State.field_names():
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in PROGNOSTIC:
        assert torch.equal(getattr(st, name), getattr(padded.state, name))

    jm = jx_model(donate=False, **KW)
    jx_padding.pad_model(jm, 2, 4)
    jm.shard(make_mesh(2, 4), mode="shardmap")
    jm.run_segment(N)
    want = {n: np.asarray(jx_padding.unpad(getattr(jm.state, n), jm.cfg))
            for n in CHECK}
    _close(_active(m, st), want, 1e-10)


def test_ragged_orlanski_scheme():
    """The orlanski scheme's edge writes land on the active edges: the
    padded 2x4 run equals the unpadded single-device run bit for bit and
    the JAX package's unpadded run at 1e-10 of scale."""
    kw = dict(KW, bc_scheme="orlanski")
    ref = pt_model(device="cpu", **kw)
    ref.run_segment(N)
    m = pt_model(device="cpu", **kw).shard(Mesh(2, 4, device="cpu"))
    m.run_segment(N)
    got = unpad(m.gathered_state(), m.cfg)
    for name in CHECK:
        assert torch.equal(getattr(got, name), getattr(ref.state, name)), \
            name
    jm = jx_model(donate=False, **kw)
    for _ in range(N):
        jm.step_once()
    _close({n: getattr(got, n).numpy() for n in CHECK},
           {n: np.asarray(getattr(jm.state, n)) for n in CHECK}, 1e-10)


def test_cli_ragged_mesh_block_writes_and_resumes_the_active_grid(tmp_path):
    """run.main on a 33x37 seamount with a 2x4 mesh block: the grid is
    padded to 34x40, the snapshots and restarts hold 33x37 and equal the
    unpadded run's, and a resume from the mid-run restart (read into the
    padded model) ends bit-equal to the whole run."""
    dti = 180.0
    base = {"case": "seamount", "case_args": {"im": 33, "jm": 37, "kb": 7},
            "config": {"days": 8 * dti / 86400, "prtd1": 4 * dti / 86400,
                       "write_rst": 4 * dti / 86400, "dtype": "float64"},
            "out_format": "nc"}
    runs = {}
    for name, extra in (("one", {}), ("mesh", {"mesh": {"px": 2, "py": 4}}),
                        ("resume", {"mesh": {"px": 2, "py": 4},
                                    "nread_rst": 1,
                                    "read_rst_path": str(
                                        tmp_path / "mesh" /
                                        "mesh.rst.000004")})):
        conf = dict(base, run_name=name if name != "resume" else "mesh",
                    out_dir=str(tmp_path / name), **extra)
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(conf))
        lines = []
        res = ptrun.execute(conf, "cpu", log=lines.append)
        assert res.rc == 0, lines
        runs[name] = (res, "\n".join(lines))
    res, text = runs["mesh"]
    assert "padded from 33x37" in text and (res.model.cfg.im,
                                            res.model.cfg.jm) == (34, 40)
    one = ncio._nc_vars(str(tmp_path / "one" / "one.nc"))
    mesh = ncio._nc_vars(str(tmp_path / "mesh" / "mesh.nc"))
    assert mesh["elb"].shape == one["elb"].shape == (2, 37, 33)
    for name in ("elb", "t", "u", "h", "fsm"):
        np.testing.assert_array_equal(mesh[name], one[name], err_msg=name)
    cfg1 = runs["one"][0].model.cfg
    rst_one = zio.read_restart(str(tmp_path / "one" / "one.rst.000008"),
                               cfg1, "cpu")[0]
    rst_mesh = zio.read_restart(
        str(tmp_path / "mesh" / "mesh.rst.000008"), cfg1, "cpu")[0]
    assert rst_mesh.el.shape == (33, 37)
    for name in State.field_names():
        assert torch.equal(getattr(rst_mesh, name),
                           getattr(rst_one, name)), name
    resumed = unpad(runs["resume"][0].model.gathered_state(),
                    runs["resume"][0].model.cfg)
    whole = unpad(res.model.gathered_state(), res.model.cfg)
    for name in State.field_names():
        assert torch.equal(getattr(resumed, name), getattr(whole, name)), \
            name
