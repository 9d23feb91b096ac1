"""The port's dispatch echo (core/dispatch.py) and CFL advisory
(diag/stats.py:cfl_min) on the CPU.  cfl_min is held against the JAX
package's extpom_tpu/diag/stats.py:cfl_min at 1e-12 (float64), on the
seamount grid and on a grid with land and a varying spacing."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extpom_tpu.core.config import Config as JxConfig
from extpom_tpu.diag import stats as jx_stats

from extpom_tpu_torch.cases.seamount import seamount_case
from extpom_tpu_torch.core import dispatch
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.diag import stats
from extpom_tpu_torch.mesh.shardmap import Mesh

torch.set_num_threads(1)


def _land_grid(im=30, jm=22, seed=7):
    """dx, dy, h, fsm of a grid with land (fsm = 0, h <= 0 there) and a
    spacing that varies from cell to cell."""
    rng = np.random.default_rng(seed)
    dx = 2000.0 + 3000.0 * rng.random((im, jm))
    dy = 1500.0 + 4000.0 * rng.random((im, jm))
    h = 10.0 + 4000.0 * rng.random((im, jm))
    fsm = (rng.random((im, jm)) > 0.25).astype(float)
    h = np.where(fsm > 0, h, -1.0)
    h[0, 0] = 0.0
    fsm[0, 0] = 1.0         # a wet cell of zero depth: h is clamped
    return dict(dx=dx, dy=dy, h=h, fsm=fsm)


def _seamount_grid():
    _, g, _ = seamount_case(im=33, jm=25, kb=5, dtype="float64",
                            device="cpu")
    return {f: getattr(g, f).numpy() for f in ("dx", "dy", "h", "fsm")}


@pytest.mark.parametrize("make", [_seamount_grid, _land_grid],
                         ids=["seamount", "land"])
def test_cfl_min_matches_jax(make):
    fields = make()
    im, jm = fields["h"].shape
    got = stats.cfl_min(
        SimpleNamespace(**{k: torch.from_numpy(v) for k, v in fields.items()}),
        Config(im=im, jm=jm, kb=5, dtype="float64"))
    want = jx_stats.cfl_min(
        SimpleNamespace(**{k: jnp.asarray(v) for k, v in fields.items()}),
        JxConfig(im=im, jm=jm, kb=5, dtype="float64"))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_cfl_min_skips_land():
    fields = _land_grid()
    fields["h"][fields["fsm"] == 0] = 1e-6    # shallow land: tiny step
    g = SimpleNamespace(**{k: torch.from_numpy(v) for k, v in fields.items()})
    cfg = Config(im=30, jm=22, kb=5, dtype="float64")
    wet = torch.from_numpy(fields["fsm"]) > 0
    tps = (0.5 / torch.sqrt(1.0 / g.dx ** 2 + 1.0 / g.dy ** 2)
           / torch.sqrt(cfg.grav * g.h.clamp(min=1e-12)))
    assert float(stats.cfl_min(g, cfg)) == float(tps[wet].min())


def test_dispatch_report_on_the_cpu():
    cfg = Config(im=2048, jm=2048, kb=41)
    rep = dispatch.dispatch_report(cfg, torch.float32, "cpu")
    assert rep["external"] == {"machine": "plain"}
    assert set(rep["phases"]) == set(dispatch.PHASES)
    assert all(d == {"machine": "plain"} for d in rep["phases"].values())
    text = dispatch.format_report(rep)
    assert "external mode: plain" in text
    assert "phases [plain]: lat, uvw, tke, tracer, mom" in text
    assert "grid 2048x2048x41" in text and "1x1 single-device" in text


def test_dispatch_report_names_what_runs():
    """On the CPU the step runs the plain versions, which launch no
    kernel, as the report says."""
    from extpom_tpu_torch import kernels
    from extpom_tpu_torch.cases.seamount import seamount_model
    m = seamount_model(device="cpu", im=9, jm=11, kb=5, dtype="float64")
    rep = dispatch.dispatch_report(m.cfg, torch.float64, "cpu")
    assert rep["external"]["machine"] == "plain"
    before = dict(kernels.LAUNCHES)
    m.run_segment(2)
    assert kernels.LAUNCHES == before


def test_dispatch_report_refuses_a_mesh():
    """The meshes the port cannot run yet raise: another parallel mode than
    shard_map, blocks on several devices.  A grid that does not divide the
    mesh is reported padded, as Model.shard pads it.  (config5's 2x4
    shard_map mesh on one device is reported: tests/test_torch_mesh.py.)"""
    cfg = Config(im=2048, jm=2048, kb=41)
    with pytest.raises(NotImplementedError, match="gspmd"):
        dispatch.dispatch_report(cfg, torch.float32, "cpu",
                                 mesh={"px": 2, "py": 4, "mode": "gspmd"})
    rep = dispatch.dispatch_report(Config(im=2046, jm=2048, kb=41),
                                   torch.float32, "cpu",
                                   mesh={"px": 4, "py": 4, "mode": "shardmap"})
    assert rep["grid"] == (2048, 2048, 41) and rep["active"] == (2046, 2048)
    assert rep["mesh"]["local_tile"] == (512, 512, 41)
    assert "padded from 2046x2048" in dispatch.format_report(rep)
    with pytest.raises(NotImplementedError, match="several devices"):
        dispatch.dispatch_report(cfg, torch.float32, "cpu",
                                 mesh=Mesh(1, 2, devices=["cpu", "meta"]))
    with pytest.raises(TypeError):
        dispatch.dispatch_report(cfg, torch.float32, "meta")
