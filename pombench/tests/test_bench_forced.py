"""The harness under forcing, on the CPU in float64: the port's Model of the
small forced case (``forced_case.py``), built by ``program.build`` and
driven through ``Model.run_segment``, against ``check.reference_side``,
which steps the same inputs with the reference's own interpolation of the
series, ``file`` edges and restoring.  Sound, every compared field and
number agrees to 1e-10, the float64 tolerance of ``test_bench_run.py``:
the gaps are a few ulps of the field over the widest change the step
makes, and where a step moves S or rho little (at the surface crossing,
by 9e-5 and 1.3e-6) two ulps read 1e-11 to 4e-11.  With a fault planted
in the program, a compared number reads 1e3 times the tolerance or
more."""

import pytest
import torch

from pombench import check, program
from pombench.inputs import PERIODS
from pombench.reference import model as ref
from pombench.tests import forced_case

SEED = 2 ** 31 + 22
CPU = torch.device("cpu")
TOL = 1e-10
DTI = 180.0
# the steps followed, each from iint to iint + 1: one inside the first
# lateral record, the one that crosses into the second, and the one that
# crosses the first surface record
INSIDE, LATERAL, SURFACE = 5, 19, 59


def _pair(iint: int, dataset: str) -> tuple:
    nb, nf, _ = ref.record_pair(DTI * (iint + 1) / 86400.0,
                                PERIODS[dataset], 1000)
    return nb, nf


def test_the_points_are_where_they_say():
    assert _pair(INSIDE - 1, "lbry") == _pair(INSIDE, "lbry")
    assert _pair(LATERAL - 1, "lbry") != _pair(LATERAL, "lbry")
    assert _pair(SURFACE - 1, "sfrc") != _pair(SURFACE, "sfrc")


def _inputs(**namelist):
    inp = forced_case.make(forced_case.CONF, SEED, CPU, torch.float64)
    inp.namelist.update(namelist)
    return inp


def follow(points, shared=None, **program_namelist) -> dict:
    """Drive the program from its cold start and, at each of ``points``,
    one step through ``Model.run_segment`` against the reference's step
    from the same state -> iint -> (the compared numbers, each field's
    gap).  ``shared`` changes both sides' namelist, ``program_namelist``
    the program's alone."""
    shared = shared or {}
    m = program.build(_inputs(**shared, **program_namelist), CPU)
    prog0 = check.start_slabs(program.state_fields(m),
                              check.start_rows(m.cfg.im))
    out = {}
    for iint in points:
        m.run_segment(iint - m.iint)
        stats = m.stats()
        before = program.to_host(program.state_fields(m))
        m.run_segment(1)
        after = program.to_host({k: getattr(m.state, k)
                                 for k in check.STEP_FIELDS})
        want = check.reference_side(_inputs(**shared), CPU, torch.float64,
                                    before, iint)
        fields = check.field_gaps(before, after, want[2])
        out[iint] = (check.numbers(prog0, want[0], stats, want[1], fields),
                     fields)
    return out


@pytest.fixture(scope="module")
def sound():
    return follow((INSIDE, LATERAL, SURFACE))


@pytest.mark.parametrize("iint", (INSIDE, LATERAL, SURFACE))
def test_reference_follows_the_forced_program(sound, iint):
    numbers, fields = sound[iint]
    assert max(fields.values()) < TOL, fields
    assert max(numbers.values()) < TOL, numbers


def test_series_reach_the_extpom_edges():
    """Under the extpom scheme bcond(2) and bcond(4) read the step's
    series as well."""
    numbers, fields = follow((LATERAL,), {"bc_scheme": "extpom"})[LATERAL]
    assert max(fields.values()) < TOL, fields
    assert max(numbers.values()) < TOL, numbers


@pytest.fixture
def frozen_series(monkeypatch):
    """The series read at model time 0 at every step: record 0."""
    from extpom_tpu_torch.forcing import device as fdev
    real = fdev.t_days_at
    monkeypatch.setattr(fdev, "t_days_at",
                        lambda cfg, iint, t0, dtype: real(cfg, 0, t0, dtype))


@pytest.fixture
def no_restoring(monkeypatch):
    """The interior restoring left out of the tracer phase."""
    from extpom_tpu_torch.kernels import phases
    monkeypatch.setattr(phases, "restore",
                        lambda grid, cfg, t, tb, s, sb, fc: (t, tb, s, sb))


@pytest.mark.parametrize("fault, namelist", [
    ("frozen_series", {}), ("no_restoring", {}),
    (None, {"bc_scheme": "extpom"})])
def test_planted_fault_fails_by_far(request, fault, namelist):
    if fault is not None:
        request.getfixturevalue(fault)
    numbers, fields = follow((LATERAL,), **namelist)[LATERAL]
    assert max(numbers.values()) >= 1e3 * TOL, (numbers, fields)


def test_no_water_series():
    """advance.f:89 leaves water uncalled: a wssurf series is refused."""
    inp = _inputs()
    inp.series["wssurf"] = inp.series["wtsurf"]
    with pytest.raises(ValueError, match="no forcing series 'wssurf'"):
        check.Reference(inp, CPU, torch.float64)
