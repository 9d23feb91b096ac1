"""The f32-against-f64 tolerance ladder of the port on the CPU
(``tests/test_tolerance.py``, VALIDATION.md §2), through
``extpom_tpu_torch/diag/ladder.py``:

* the seamount (33x33x11, 60 steps) and the channel with its boundary
  elevation series (32x24x7, 40 steps), each run by the port in float64
  and float32: every ladder field's drift and the conservation scalars'
  within the JAX test's bounds, of which the port keeps a copy that must
  equal them;
* the port's float64 run of each case against the JAX package's float64
  run: every State field within 1e-10 of its scale (max(1, max |.|), as
  ``tests/test_torch_forcing.py`` holds it), the baroclinic depth sums
  ``drx2d``/``dry2d`` at 1e-8 for the reason given there.

Each run is made once per module and shared by the tests.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from extpom_tpu.cases.channel import channel_model as jx_channel
from extpom_tpu.cases.seamount import seamount_model as jx_seamount

from extpom_tpu_torch.core.state import State
from extpom_tpu_torch.diag import ladder

torch.set_num_threads(1)

CASES = tuple(ladder.CASES)
# test_torch_forcing.py:243: one ulp of T moves these by ~1e-9 of scale
BAROCLINIC_SUMS = ("drx2d", "dry2d")


@pytest.fixture(scope="module")
def runs():
    """The port's model of (case, dtype) on the CPU, stepped once."""
    made = {}

    def get(case: str, dtype: str):
        if (case, dtype) not in made:
            made[case, dtype] = ladder.run(case, dtype, "cpu")
        return made[case, dtype]
    return get


def test_bounds_are_the_jax_tests():
    """The port's copy of the bounds is the JAX test's, field by field, and
    its cases are the JAX test's sizes and steps."""
    path = pathlib.Path(__file__).with_name("test_tolerance.py")
    spec = importlib.util.spec_from_file_location("_jx_tolerance", path)
    jx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jx)
    scalars = {"seamount": {"vtot": 1e-6, "saver": 1e-6, "taver": 1e-6,
                            "eaver": 3e-3},
               "channel": {"vtot": 1e-6, "saver": 1e-5}}
    assert ladder.BOUNDS == {
        "seamount": {**jx._SEAMOUNT_BOUNDS, **scalars["seamount"]},
        "channel": {**jx._CHANNEL_BOUNDS, **scalars["channel"]}}
    assert ladder.CASES == {"seamount": (dict(im=33, jm=33, kb=11), 60),
                            "channel": (dict(im=32, jm=24, kb=7), 40)}


@pytest.mark.parametrize("case", CASES)
def test_tolerance_ladder(runs, case):
    """The float32 run drifts from the float64 run within every bound."""
    d = ladder.drift(runs(case, "float64"), runs(case, "float32"))
    assert not ladder.over(case, d), d
    # the drift is the rounding of float32, not nothing
    assert d["el"] > 1e-9 and d["t"] > 1e-9, d


def _jax_model(case: str):
    kw, steps = ladder.CASES[case]
    if case == "seamount":
        m = jx_seamount(dtype="float64", donate=False, pallas_ext="off", **kw)
    else:
        m = jx_channel(dtype="float64", pallas_ext="off", **kw)
    m.run_segment(steps)
    return m


@pytest.mark.parametrize("case", CASES)
def test_f64_run_matches_jax(runs, case):
    """The port's float64 run of the ladder's case against the JAX
    package's, over every State field."""
    m, jm = runs(case, "float64"), _jax_model(case)
    for name in State.field_names():
        a = getattr(m.state, name).numpy()
        b = np.asarray(getattr(jm.state, name))
        err = np.abs(a - b).max() / max(1.0, np.abs(b).max())
        tol = 1e-8 if name in BAROCLINIC_SUMS else 1e-10
        assert err <= tol, (name, err)
