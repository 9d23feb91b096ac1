"""The port's host-side z->sigma interpolation (``extpom_tpu_torch/utils/
interp.py``) against the JAX package's (``extpom_tpu/utils/interp.py``) on
the four cases of tests/test_interp.py, the same seeded inputs through
both, at 1e-12; and the full-state debug dump ``io/zarrstore.py:
write_aux`` read back from the port's own Zarr store."""

import numpy as np
import pytest
import torch

from extpom_tpu.utils import interp as jx_interp

from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.core.state import State
from extpom_tpu_torch.io import zarrstore as zio
from extpom_tpu_torch.utils import interp

TOL = 1e-12


def _both(fn: str, *args):
    """(port, JAX package) results of ``fn`` on the same inputs."""
    return getattr(interp, fn)(*args), getattr(jx_interp, fn)(*args)


def test_spline_matches_jax_on_random_knots():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 100.0, 12))
    y = rng.normal(size=12)
    xq = rng.uniform(-5.0, 110.0, 40)   # end-interval extrapolation too
    y2, jy2 = _both("spline_coeffs", x, y)
    np.testing.assert_allclose(y2, jy2, rtol=TOL, atol=0)
    got, want = _both("spline_eval", x, y, y2, xq)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)


def test_spline_exact_on_linear_data():
    x = np.linspace(0.0, 10.0, 8)
    y = 3.0 * x + 1.0
    xq = np.linspace(0.5, 9.5, 17)
    got, want = _both("spline_eval", x, y, interp.spline_coeffs(x, y), xq)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    np.testing.assert_allclose(got, 3.0 * xq + 1.0, rtol=TOL)


def test_ztosig_monotone_profile_matches_jax():
    ks, im, jm, kb = 10, 8, 6, 5
    zs = np.linspace(0.0, 1000.0, ks)
    h = np.full((im, jm), 500.0)
    h[0, :] = 0.5                              # a dry column row
    tb = np.broadcast_to((20.0 - zs / 100.0)[:, None, None],
                         (ks, im, jm)).copy()
    zz = -np.linspace(0.05, 0.95, kb)
    got, want = _both("ztosig", zs, tb, zz, h)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[:, 3, 3], 20.0 - (-zz * 500.0) / 100.0,
                               rtol=1e-10)
    assert np.all(np.diff(got[:, 3, 3]) < 0)


def test_ztosig_missing_data_repair_matches_jax():
    ks, im, jm, kb = 6, 6, 6, 4
    zs = np.linspace(0.0, 100.0, ks)
    h = np.full((im, jm), 80.0)
    rng = np.random.default_rng(5)
    tb = 10.0 + rng.random((ks, im, jm))
    tb[2, 3, 3] = 0.0       # a hole on a submerged level
    zz = -np.linspace(0.1, 0.9, kb)
    got, want = _both("ztosig", zs, tb, zz, h)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.all(got[:, 3, 3] >= 10.0)


def test_write_aux_round_trip(tmp_path):
    m = seamount_model(device="cpu", im=9, jm=11, kb=5, dtype="float64")
    m.run_segment(2)
    path = str(tmp_path / "aux")
    wr = m.compute_wr()
    zio.write_aux(path, m.grid, m.cfg, m.state, m.time_days,
                  extra={"wr": wr})
    for name in State.field_names():
        np.testing.assert_array_equal(zio.read_array(path, name),
                                      getattr(m.state, name).numpy(), name)
    for name in zio.OUTPUT_GRID_VARS:
        np.testing.assert_array_equal(zio.read_array(path, name),
                                      getattr(m.grid, name).numpy(), name)
    np.testing.assert_array_equal(zio.read_array(path, "wr"), wr.numpy())
    attrs = zio._read_attrs(path)
    assert attrs["format"] == "extpom_tpu.aux.v1"
    assert attrs["time_days"] == pytest.approx(m.time_days)
    assert torch.is_tensor(wr)
