"""The step's forcing on the card (``kernels/forcing.py``,
``csrc/forcing.cu``).  On the CPU: the kernel's table against the plain
path's picks, the dispatch of the CPU to the plain path and the wrapper's
refusal of records off the card.  On the card
(marked ``cuda``, skipped without one): the ``k_forcing_interp`` path equal
to the plain path by ``torch.equal`` in float32 and float64, on whole and
windowed plans, on the harness's small forced case (33x33x11) and on
2048-long edges with 41 levels."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from extpom_tpu_torch import kernels
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.state import zero_forcing
from extpom_tpu_torch.forcing import device as fdev
from extpom_tpu_torch.forcing import provider as prov
from extpom_tpu_torch.kernels import forcing as kforcing
from pombench import program
from pombench.tests import forced_case

torch.set_num_threads(1)

SEED = 2 ** 31 + 23
DTYPES = {"float32": torch.float32, "float64": torch.float64}
# steps whose forcing is compared: inside the first lateral record, at and
# across a lateral and a surface record, and past every series' end
STEPS = (1, 5, 19, 20, 59, 60, 139, 700)


def forced_model(device, dtype: str, budget_mb: int = 16384):
    """The harness's small forced case (every series, the file edges and
    the restoring) as ``program.build`` builds it, in ``dtype``."""
    conf = dict(forced_case.CONF)
    conf["config"] = dict(conf["config"], dtype=dtype,
                          forcing_hbm_mb=budget_mb)
    return program.build(forced_case.make(conf, SEED, device,
                                          DTYPES[dtype]), device)


def plans(m, windowed: bool) -> list:
    """(plan, model time) at each step of :data:`STEPS`: the whole staged
    plan, or the window of records that a segment of a print from the step
    before staged."""
    dt = m.cfg.dti / 86400.0
    out = []
    for i in STEPS:
        t = fdev.t_days_at(m.cfg, i, m.time0, m.cfg.torch_dtype)
        plan = (m._device_plan((i - 1) * dt, (i - 1 + m.cfg.iprint) * dt)
                if windowed else m._device_plan())
        out.append((plan, t))
    return out


def assert_forcing_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert torch.equal(a, b), f.name


# -- on the CPU ---------------------------------------------------------------

def test_cpu_takes_the_plain_path():
    m = forced_model(torch.device("cpu"), "float64")
    before = dict(kernels.LAUNCHES)
    for plan, t in plans(m, False):
        ps = fdev.picks(plan, t)
        assert_forcing_equal(
            fdev.forcing_at(plan, m.base_forcing, m.cfg, m.grid.dz, t),
            fdev.forcing_at_plain(ps, m.base_forcing, m.cfg, m.grid.dz))
    assert kernels.LAUNCHES == before


def test_launch_refuses_records_off_the_card():
    """The kernel's wrapper raises on records it cannot take rather than
    giving way to the plain path."""
    m = forced_model(torch.device("cpu"), "float32")
    plan, t = plans(m, False)[0]
    with pytest.raises(TypeError, match="forcing kernel"):
        kforcing.launch(fdev.picks(plan, t), m.grid.dz, m.cfg.kbm1)


def is_record(x: torch.Tensor, stack: torch.Tensor) -> bool:
    return any(x.data_ptr() == stack[r].data_ptr()
               for r in range(stack.shape[0]))


@pytest.mark.parametrize("windowed", [False, True], ids=["whole", "window"])
def test_table_is_the_plain_paths_picks(windowed):
    """Every interpolated series is one row in the plan's order, its picks
    the plain path's, records of its stack; the four edge integrals follow
    with their profile's pick over kbm1 levels; tsurf and ssurf are not in
    the table and each is a record of its stack."""
    m = forced_model(torch.device("cpu"), "float64",
                     budget_mb=0 if windowed else 16384)
    staged = plans(m, windowed)
    assert any(any(plan.starts) for plan, _ in staged) == windowed
    for plan, t in staged:
        ps = fdev.picks(plan, t)
        table = kforcing.rows(ps, m.cfg.kbm1)
        interp = [p for p in ps if p.f is not None]
        assert [name for name, _, _ in table] == (
            [p.name for p in interp] + ["uabw", "uabe", "vabs", "vabn"])
        assert len(interp) == 27
        for (name, p, levels), want in zip(table, interp):
            assert p is want and levels == 0
        by_name = {p.name: p for p in ps}
        for side in prov.BRY_SIDES:
            un, tn = prov.barotropic_name(side)
            row = next(r for r in table if r[0] == tn)
            assert row[1] is by_name[un] and row[2] == m.cfg.kbm1
        stacks = dict(zip(plan.names, plan.stacks))
        for p in ps:
            assert is_record(p.b, stacks[p.name])
            assert p.f is None or is_record(p.f, stacks[p.name])
        assert {p.name for p in ps if p.f is None} == {"tsurf", "ssurf"}


def test_weights_are_exact_in_float32():
    """A weight handed to the kernel as a double is a float32 value, so
    the kernel's cast to float32 does not round it."""
    m = forced_model(torch.device("cpu"), "float32")
    for plan, t in plans(m, False):
        for p in fdev.picks(plan, t):
            assert float(np.float32(p.w0)) == p.w0
            assert float(np.float32(p.w1)) == p.w1


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("windowed", [False, True], ids=["whole", "window"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_equals_plain_on_the_forced_case(card, dtype, windowed):
    m = forced_model(card, dtype, budget_mb=0 if windowed else 16384)
    for plan, t in plans(m, windowed):
        ps = fdev.picks(plan, t)
        before = kernels.LAUNCHES["forcing"]
        got = fdev.forcing_at(plan, m.base_forcing, m.cfg, m.grid.dz, t)
        assert kernels.LAUNCHES["forcing"] == before + 1
        assert_forcing_equal(got, fdev.forcing_at_plain(
            ps, m.base_forcing, m.cfg, m.grid.dz))
        for p in ps:
            v = getattr(got, p.name)
            if p.f is None:
                assert v.data_ptr() == p.b.data_ptr()
            else:
                assert v.is_contiguous()
                assert v.data_ptr() not in (p.b.data_ptr(), p.f.data_ptr())


def long_edges(card, dtype: str, nrec: int = 6):
    """A provider of every lateral series and the four surface fluxes on a
    2048x2048x41 grid (no 3-D restoring series), its own dz."""
    cfg = Config(im=2048, jm=2048, kb=41, dtype=dtype, bc_scheme="file",
                 forcing_hbm_mb=16384)
    r = np.random.default_rng(SEED)
    data = {}
    for side in prov.BRY_SIDES:
        n = 2048
        data[f"el{side}"] = r.standard_normal((nrec, n))
        for v in "tsuv":
            data[f"{v}b{side}"] = r.standard_normal((nrec, 41, n))
    for v in prov.WIND_VARS + prov.HEAT_VARS:
        data[v] = r.standard_normal((nrec, 64, 2048)).repeat(32, axis=1)
    grid = types.SimpleNamespace(device=card)
    p = prov.ForcingProvider(grid, cfg, None, prov.ArraySource(data),
                             prefetch=False)
    dz = torch.tensor(r.uniform(0.005, 0.05, 41), dtype=DTYPES[dtype],
                      device=card)
    return p, cfg, dz


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_equals_plain_on_long_edges(card, dtype):
    p, cfg, dz = long_edges(card, dtype)
    base = zero_forcing(cfg, card)
    for windowed in (False, True):
        plan = (fdev.make_device_plan(p, budget_bytes=0, t0_days=0.1,
                                      t1_days=0.17, device=card)
                if windowed else fdev.make_device_plan(p, device=card))
        assert any(plan.starts) == windowed
        for t in (0.1, 0.1042, 0.125, 0.15, 0.17):
            t = fdev.t_days_at(cfg, 0, t, DTYPES[dtype])
            ps = fdev.picks(plan, t)
            before = kernels.LAUNCHES["forcing"]
            assert_forcing_equal(
                fdev.forcing_at(plan, base, cfg, dz, t),
                fdev.forcing_at_plain(ps, base, cfg, dz))
            assert kernels.LAUNCHES["forcing"] == before + 1


@pytest.mark.cuda
def test_one_launch_of_a_table(card):
    """A table of up to ``entries`` series takes one launch, each output
    the plain path's; one more entry is refused, and so are records of
    two dtypes."""
    info = kforcing.kernel_info(torch.float32, card)
    assert info["spill_bytes"] == 0
    n = info["entries"]
    g = torch.Generator(device="cpu").manual_seed(7)
    recs = [torch.randn((2, 37 + q), generator=g).to(card)
            for q in range(n + 1)]
    table = [fdev.Pick(f"s{q}", r[0], r[1], 0.75, 0.25)
             for q, r in enumerate(recs)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = kforcing.launch(table[:n], None, 0)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("k_forcing_" in x for x in names) == 1
    for q, r in enumerate(recs[:n]):
        assert torch.equal(got[f"s{q}"], r[0] * 0.75 + r[1] * 0.25)
    with pytest.raises(RuntimeError, match="forcing kernel"):
        kforcing.launch(table, None, 0)
    mixed = table[:2] + [table[2]._replace(f=table[2].f.double())]
    with pytest.raises(TypeError, match="forcing kernel"):
        kforcing.launch(mixed, None, 0)
