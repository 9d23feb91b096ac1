"""One run of a tiny cell on the CPU, driven as on the card but for the look
for a chip: its last line, its failures, and ``correct`` against the
reference, sound and with the timed path broken underneath."""

import json
import math
import subprocess
import sys

import pytest
import torch

from pombench import check, run
from pombench.cells import ROOT

CELLS = ("seamount2048.steady", "seamount2048.mpdata")


@pytest.mark.parametrize("name, namelist", [
    ("seamount2048.steady", {}), ("seamount2048.mpdata", {}),
    ("seamount2048.steady", {"npg": 2}),
    ("seamount2048.mpdata", {"nitera": 3, "sw": 0.9})])
def test_reference_follows_the_program_in_float64(run_tiny, name, namelist):
    """In float64 the reference, which shares no code with the port, gives
    the program's cold start, step and diagnostics to round-off."""
    r = run_tiny(name, dtype="float64", **namelist)
    for k in check.NUMBERS:
        assert r["checks"][k][0] < 1e-10, (k, r["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(run_tiny, name):
    r = run_tiny(name)
    assert r["correct"] is True
    assert r["failed"] == 0 and r["attempted"] >= 1
    for k in check.NUMBERS:
        value, limit = r["checks"][k]
        assert value <= limit


def test_last_line_keys(run_tiny):
    r = run_tiny("seamount2048.steady")
    out = json.loads(run.line(r))
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"gpts_per_s", "peak_mem_gb", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(out["device"])


def test_traced_line_keys(run_tiny):
    r = run_tiny("seamount2048.steady", traced=True)
    out = json.loads(run.line(r))
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["correct"] is True
    assert {"step_mfu"} <= set(out["metrics"])


def test_failed_velocity_check_counts(run_tiny, monkeypatch):
    from extpom_tpu_torch.core.model import Model
    monkeypatch.setattr(Model, "velocity_check",
                        lambda self, st=None: (1.0e3, (1, 1)))
    r = run_tiny("seamount2048.steady")
    assert r["failed"] == r["attempted"] >= 1
    assert r["correct"] is False


def _broken_step(monkeypatch, how):
    """The port's step broken underneath the window: ``how(old, new)`` ->
    the State the step returns."""
    from extpom_tpu_torch.core import stepper
    real = stepper.step

    def step(grid, cfg, st, *a, **k):
        return how(st, real(grid, cfg, st, *a, **k))
    monkeypatch.setattr(stepper, "step", step)


def _half(old, new):
    """Half of the grid (rows i >= im/2) left as it was."""
    im = new.el.shape[-2]
    keep = torch.arange(im)[:, None] >= im // 2
    return new.replace(**{f: torch.where(keep, getattr(old, f),
                                         getattr(new, f))
                          for f in new.field_names()})


def _altered(old, new):
    """One answer altered where it is produced: one cell of t."""
    t = new.t.clone()
    t[0, t.shape[1] // 2, t.shape[2] // 2] += 0.1
    return new.replace(t=t)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_step_is_not_correct(run_tiny, monkeypatch, name, fault):
    how = {"unchanged": lambda old, new: old, "half": _half,
           "altered": _altered}[fault]
    _broken_step(monkeypatch, how)
    r = run_tiny(name)
    assert r["correct"] is False
    failing = [k for k in check.NUMBERS
               if not r["checks"][k][0] <= r["checks"][k][1]]
    assert set(failing) & {"ext_gap", "uv_gap", "int_gap", "s_gap"}


def test_altered_diagnostics_are_not_correct(run_tiny, monkeypatch):
    from extpom_tpu_torch.core.model import Model
    real = Model.stats

    def stats(self, st=None):
        s = real(self, st)
        s["saver"] *= 1.0 + 1e-6
        return s
    monkeypatch.setattr(Model, "stats", stats)
    r = run_tiny("seamount2048.steady")
    assert r["correct"] is False
    assert r["checks"]["diag_gap"][0] > r["checks"]["diag_gap"][1]


def test_altered_cold_start_is_not_correct(run_tiny, monkeypatch):
    from extpom_tpu_torch.core import model
    real = model.cold_start

    def cold(*a, **k):
        st, rmean = real(*a, **k)
        return st.replace(rho=st.rho * (1.0 + 1e-3)), rmean
    monkeypatch.setattr(model, "cold_start", cold)
    r = run_tiny("seamount2048.steady")
    assert r["correct"] is False
    assert r["checks"]["start_gap"][0] > r["checks"]["start_gap"][1]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(run_tiny, name):
    """The reference in the precision below the configuration's (bfloat16)
    in the program's place fails the limits."""
    r = run_tiny(name, control=True)
    assert r["correct"] is True
    assert not check.correct(r["control"], r["checks"] and
                             {k: v[1] for k, v in r["checks"].items()})


def test_numbers_of_nonfinite_fields_are_infinite():
    a = torch.ones(3, 4)
    b = a.clone()
    b[1, 1] = math.nan
    assert check.scale_gap(b, a) == math.inf
    assert check.step_gap(b, a, a * 0) == math.inf
    assert check.step_gap(a, a, a) == 0.0


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "extpom_tpu_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "extpom_tpu.core", sys)
    assert run.forbidden_modules() == ["extpom_tpu.core"]


def test_a_run_imports_no_jax():
    """A whole tiny run in a fresh process loads no module whose top-level
    name is jax, jaxlib, flax or extpom_tpu."""
    code = ("import sys, time, torch\n"
            "from pombench.tests.conftest import tiny_cell\n"
            "from pombench import run\n"
            "r = run.run_cell(tiny_cell('seamount2048.steady'), 3, 0.0, False,"
            " torch.device('cpu'), log=lambda s: None)\n"
            "print(r['correct'], run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "[]"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "pombench.run", "--workload",
                          "seamount2048.steady", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
