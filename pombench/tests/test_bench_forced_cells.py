"""The cells of the forced regional domain and of McCalpin's pressure
gradient: both resolve by name; the configuration ``forced2048`` is the
small forced case's at 2048x2048x41 in float32, made by
``cases/forced.py``; at 33x33x11 in float64 the port built from it
follows the reference within ``test_bench_forced.py``'s 1e-10; and
``forcing_roofline`` reads the hand-counted share of a made-up trace, the
series counted from the configuration the namelist matches, and nothing
where the trace, the namelist or the configurations give it nothing to
read."""

import copy
import json

import pytest
import torch

from pombench import cells, check, inputs, program
from pombench import trace as tr
from pombench import work
from pombench.cases import forced
from pombench.metrics import reader
from pombench.tests import forced_case

BENCH = cells.load_benchmark()
SEED = 2 ** 31 + 2323
CPU = torch.device("cpu")
TOL = 1e-10


def test_forced_cell_resolves():
    c = cells.resolve("forced2048.steady", BENCH)
    assert c.chips == 1 and c.config["case"] == "forced"
    nl = inputs.namelist(c.config)
    assert (nl["im"], nl["jm"], nl["kb"], nl["dtype"]) == (2048, 2048, 41,
                                                           "float32")
    assert nl["bc_scheme"] == "file" and nl["do_restore"]
    assert nl["forcing_hbm_mb"] * 2 ** 20 > 6e9   # staged whole, once
    assert [m["name"] for m in c.per_layer][-1] == "forcing_roofline"
    assert set(c.limits) == set(check.NUMBERS)


def test_mcc_cell_resolves():
    c = cells.resolve("seamount2048.mcc", BENCH)
    assert c.chips == 1 and c.config["case"] == "seamount"
    assert c.traffic["namelist"] == {"npg": 2}
    assert "forcing_roofline" not in [m["name"] for m in c.per_layer]
    assert set(c.limits) == set(check.NUMBERS)


def test_forced2048_is_the_forced_case_at_size():
    """Every setting of the small forced case but its sizes, dtype, print
    cadence and the case module that makes it."""
    conf = cells.resolve("forced2048.steady", BENCH).config
    small = forced_case.CONF
    assert forced.make is forced_case.make
    assert conf["assumed"]["forcing"] == {
        "why": conf["assumed"]["forcing"]["why"],
        **small["assumed"]["forcing"]}
    assert {k: v for k, v in conf["assumed"]["perturbation"].items()
            if k != "why"} == small["assumed"]["perturbation"]
    sizes = ("im", "jm", "kb")
    assert {k: v for k, v in conf["case_args"].items() if k not in sizes} \
        == {k: v for k, v in small["case_args"].items() if k not in sizes}
    keep = ("dtype", "prtd1")
    assert {k: v for k, v in conf["config"].items() if k not in keep} \
        == {k: v for k, v in small["config"].items() if k not in keep}


def small_forced(dtype: str = "float64") -> dict:
    conf = copy.deepcopy(cells.resolve("forced2048.steady", BENCH).config)
    conf["case_args"].update(im=33, jm=33, kb=11)
    conf["config"]["dtype"] = dtype
    return conf


@pytest.mark.parametrize("iint", [19, 59])
def test_forced_config_follows_the_reference(iint):
    """The configuration's file at 33x33x11 f64, through ``inputs.make``
    and ``program.build`` as a run builds it, one step across a lateral
    record (19) and a surface record (59) against
    ``check.reference_side``."""
    conf = small_forced()
    traffic = cells.traffic(cells.HERE / "traffic" / "steady.json")
    m = program.build(inputs.make(conf, traffic, SEED, CPU), CPU)
    prog0 = check.start_slabs(program.state_fields(m),
                              check.start_rows(m.cfg.im))
    m.run_segment(iint)
    stats = m.stats()
    before = program.to_host(program.state_fields(m))
    m.run_segment(1)
    after = program.to_host({k: getattr(m.state, k)
                             for k in check.STEP_FIELDS})
    want = check.reference_side(inputs.make(conf, traffic, SEED, CPU), CPU,
                                torch.float64, before, iint)
    fields = check.field_gaps(before, after, want[2])
    numbers = check.numbers(prog0, want[0], stats, want[1], fields)
    assert max(fields.values()) < TOL, fields
    assert max(numbers.values()) < TOL, numbers


NL = dict(im=64, jm=32, kb=5, dtype="float32", isplit=30, nadv=1, npg=1,
          bc_scheme="file", do_restore=True)


def trace_of(ops, namelist=NL, steps=4) -> tr.Trace:
    return tr.Trace(ops, [], 100e-6, steps, namelist, 2e-3)


def forcing_op(start, end):
    return tr.Op("void (anonymous namespace)::k_forcing_interp<float>(x)",
                 start, end, True)


@pytest.fixture
def bench_of(monkeypatch, tmp_path):
    """Point the reader's ``BENCHMARK.json`` at configurations of the
    ``forced`` case on NL's grid, one a ``taurstr`` flag of the list."""
    def make(*taurstr):
        confs = []
        for q, tau in enumerate(taurstr):
            conf = copy.deepcopy(forced_case.CONF)
            conf["case"] = "forced"
            conf["case_args"].update(im=NL["im"], jm=NL["jm"], kb=NL["kb"])
            conf["assumed"]["forcing"]["taurstr"] = tau
            path = tmp_path / f"forced{q}.json"
            path.write_text(json.dumps(conf))
            confs.append({"name": f"forced{q}", "file": str(path)})
        monkeypatch.setattr(cells, "load_benchmark",
                            lambda *a: {"configs": confs})
    return make


def test_forcing_roofline_hand_count(bench_of):
    r = reader("forcing_roofline")
    # 20 lateral series: el on 2x32 + 2x64 edge cells, t, s, u, v on 5
    # levels of each; 4 surface fluxes and 3 restoring fields; each read
    # twice and written once; the 192 barotropic edge values written
    edges = 2 * 32 + 2 * 64
    series = edges + 4 * 5 * edges + 4 * 64 * 32 + 3 * 5 * 64 * 32
    nbytes = (3 * series + edges) * 4
    assert r.step_bytes(64, 32, 5, "float32", True) == nbytes == 516_096
    assert r.step_bytes(64, 32, 5, "float64", True) == 2 * nbytes
    assert r.step_bytes(64, 32, 5, "float32", False) == \
        nbytes - 3 * 5 * 64 * 32 * 4
    assert r.step_bytes(2048, 2048, 41, "float32", True) == 6_408_372_224
    ops = [forcing_op(0, 3), forcing_op(10, 12),
           tr.Op("void at::native::elementwise_kernel<x>", 3, 9, True),
           tr.Op("void (anonymous namespace)::k_window<float, 0>(x)", 12,
                 40, True)]
    want = 100.0 * (nbytes / work.PEAK_BYTES_PER_S) * 4 / 5e-6
    bench_of(True)
    assert r.read(trace_of(ops)) == pytest.approx(want, rel=1e-12)
    bench_of(False)
    assert r.read(trace_of(ops)) == pytest.approx(
        want * (nbytes - 3 * 5 * 64 * 32 * 4) / nbytes, rel=1e-12)


def test_forcing_roofline_finds_forced2048():
    """On the benchmark as it is, the forced cell's namelist finds its own
    configuration, which draws taurstr: 6.41 GB a step."""
    r = reader("forcing_roofline")
    c = cells.resolve("forced2048.steady")
    nl = dict(c.config["config"], **c.config["case_args"],
              **c.traffic.get("namelist", {}))
    assert r.forced_configuration(nl) == c.config
    assert r.forced_configuration(dict(nl, im=1024)) is None


@pytest.mark.parametrize("case", ["no_kernel", "orlanski", "no_restore",
                                  "no_steps", "no_configuration",
                                  "two_configurations"])
def test_forcing_roofline_reads_nothing(case, bench_of):
    r = reader("forcing_roofline")
    ops = [forcing_op(0, 3)]
    nl, steps = NL, 4
    bench_of(*{"no_configuration": (), "two_configurations": (True, False)
               }.get(case, (True,)))
    if case == "no_kernel":
        ops = [tr.Op("void at::native::elementwise_kernel<x>", 0, 3, True)]
    elif case == "orlanski":
        nl = dict(NL, bc_scheme="extpom")
    elif case == "no_restore":
        nl = dict(NL, do_restore=False)
    elif case == "no_steps":
        steps = 0
    assert r.read(trace_of(ops, nl, steps)) is None
