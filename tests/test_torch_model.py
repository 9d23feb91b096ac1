"""The port's seamount slice end to end on the CPU in float64: the
33x33x11 10-step run against the golden snapshot (1e-9 relative, as in
test_golden.py) and against the JAX Model (1e-10), run_segment against run,
and a JAX state carried across with core.convert.from_numpy."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from extpom_tpu.cases.seamount import seamount_model as jx_model

from extpom_tpu_torch.cases.seamount import seamount_model as pt_model
from extpom_tpu_torch.core.convert import from_numpy
from extpom_tpu_torch.core.grid import Grid as PtGrid
from extpom_tpu_torch.core.model import Model as PtModel
from extpom_tpu_torch.core.state import Forcing as PtForcing, State as PtState
from extpom_tpu_torch.diag import stats

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "seamount_33x33x11_10steps.npz")
FIELDS = ("el", "u", "v", "t", "s", "q2", "q2l")
KW = dict(im=33, jm=33, kb=11, dtype="float64")
N = 10
CARRY_AT = 3        # the JAX step after which the state is carried across
CARRY_STEPS = 2


def _dict(obj, cls):
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(cls)}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model's states after CARRY_AT, CARRY_AT + CARRY_STEPS and
    N steps, as numpy dicts."""
    m = jx_model(donate=False, **KW)
    snaps = {}
    for _ in range(N):
        m.step_once()
        if m.iint in (CARRY_AT, CARRY_AT + CARRY_STEPS, N):
            snaps[m.iint] = _dict(m.state, PtState)
    snaps["model"] = m
    return snaps


@pytest.fixture(scope="module")
def port_run():
    m = pt_model(device="cpu", **KW)
    m.run(n_steps=N)
    return m


def _assert_close(got: PtState, want: dict, rtol: float, what: str):
    for name in FIELDS:
        b = want[name]
        a = getattr(got, name).numpy()
        tol = rtol * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=f"{what}: {name}")


def test_port_matches_golden(port_run):
    g = np.load(GOLDEN)
    im, jm, kb, n = (int(x) for x in g["meta"])
    assert (im, jm, kb, n) == (KW["im"], KW["jm"], KW["kb"], N)
    _assert_close(port_run.state, {k: g[k] for k in FIELDS}, 1e-9, "golden")


def test_port_matches_jax_model(port_run, jax_run):
    _assert_close(port_run.state, jax_run[N], 1e-10, "JAX Model")


def test_port_healthy_diagnostics(port_run):
    """The healthy print of the verify recipe: saver pinned at 15."""
    s = stats.domain_stats(port_run.grid, port_run.cfg, port_run.state)
    assert abs(float(s["saver"]) - 15.0) < 1e-9
    assert all(np.isfinite(float(v)) for v in s.values())


def test_run_segment_matches_run(port_run):
    m = pt_model(device="cpu", **KW)
    m.run_segment(4)
    m.run_segment(N - 4)
    assert m.iint == N
    for name in PtState.field_names():
        assert torch.equal(getattr(m.state, name),
                           getattr(port_run.state, name)), name


def test_carried_across_state(jax_run):
    jm = jax_run["model"]
    cfg = pt_model(device="cpu", **KW).cfg
    grid, st, fc, rmean, tclim, sclim = from_numpy(
        cfg, _dict(jm.grid, PtGrid), jax_run[CARRY_AT],
        _dict(jm.base_forcing, PtForcing), np.array(jm.rmean),
        np.array(jm.tclim), np.array(jm.sclim), device="cpu")
    m = PtModel(grid, cfg, state=st, rmean=rmean, tclim=tclim, sclim=sclim,
                base_forcing=fc, iint=CARRY_AT)
    m.run_segment(CARRY_STEPS)
    _assert_close(m.state, jax_run[CARRY_AT + CARRY_STEPS], 1e-10,
                  "carried across")


def test_blowup_guard_raises():
    m = pt_model(device="cpu", im=17, jm=17, kb=5, dtype="float64",
                 vmaxl=1e-6)
    with pytest.raises(FloatingPointError):
        m.run(n_steps=1)
