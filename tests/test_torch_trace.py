"""The model's spans (``diag/profiling.py``) on the CPU, on a 17x17x5
seamount in float64: none without a profiler, the stages of each step
nested and in order under one, the diagnostics' reads counted, and the
state the same with the profiler as without."""

import json

import pytest
import torch

from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.diag import profiling

KW = dict(device="cpu", im=17, jm=17, kb=5, dtype="float64")
STAGES = ["lat", "interaction", "external", "uvw", "tke", "tracer", "mom"]


def profiled(fn):
    """The paths of the model's spans that ``fn()`` opens under
    torch.profiler (``segment/step/lat``), in the order they open."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [p for p, _, _ in profiling.span_paths(
        prof.profiler.kineto_results.events())]


def test_no_profiler_no_span(monkeypatch):
    """Without a profiler a span is the one shared null context, and no
    profiler range is made: a segment and its diagnostics run with the
    range unusable."""
    assert profiling.span("step") is profiling.span("sync")
    m = seamount_model(**KW)

    def refuse(*a, **k):
        raise AssertionError("a profiler range made with no profiler open")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    m.run_segment(2)
    m.stats()
    m.velocity_check()
    with profiling.span("lat") as x:
        assert x is None


def test_segment_steps_and_stages_in_order():
    m = seamount_model(**KW)
    m.run_segment(1)                 # the cold start's first step
    got = profiled(lambda: m.run_segment(2))
    step = ["segment/step"] + [f"segment/step/{s}" for s in STAGES]
    assert got == ["segment"] + step + step


def test_cold_start_first_step_has_no_internal_phases():
    m = seamount_model(**KW)
    got = profiled(lambda: m.run_segment(2))
    first = ["segment/step"] + [f"segment/step/{s}" for s in STAGES[:3]]
    assert got == (["segment"] + first + ["segment/step"]
                   + [f"segment/step/{s}" for s in STAGES])


def test_mpdata_inside_tracer():
    m = seamount_model(nadv=2, nitera=2, **KW)
    m.run_segment(1)
    got = profiled(lambda: m.run_segment(1))
    mp = [p for p in got if p.endswith("mpdata")]
    assert mp and all(p == "segment/step/tracer/mpdata" for p in mp)
    assert [p for p in got if not p.endswith("mpdata")] == (
        ["segment", "segment/step"]
        + [f"segment/step/{s}" for s in STAGES])


def test_diagnostics_read_eleven_values():
    """The eight values of the stats in one read, the velocity check's
    three in three."""
    m = seamount_model(**KW)
    m.run_segment(2)
    want = (m.stats(), m.velocity_check())
    got = []
    paths = profiled(lambda: got.extend((m.stats(), m.velocity_check())))
    assert tuple(got) == want
    assert len(got[0]) == 8
    assert paths.count("stats/sync") == 1
    assert paths.count("velocity/sync") == 3
    assert sum(p.endswith("sync") for p in paths) == 4
    assert set(paths) == {"stats", "stats/sync", "velocity",
                          "velocity/sync"}


def test_state_bit_equal_under_the_profiler():
    a, b = seamount_model(nadv=2, **KW), seamount_model(nadv=2, **KW)
    a.run_segment(3)
    profiled(lambda: b.run_segment(3))
    for f in a.state.field_names():
        x, y = getattr(a.state, f), getattr(b.state, f)
        assert torch.equal(x, y), f
    assert a.stats() == b.stats()


def test_chrome_trace_holds_the_spans(tmp_path):
    m = seamount_model(**KW)
    with profiling.trace(str(tmp_path)):
        m.run_segment(2)
        m.stats()
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"extpom.segment", "extpom.step", "extpom.external",
            "extpom.stats", "extpom.sync"} <= names


def test_spans_are_not_user_annotations():
    """A span is a function-scope range: the profiler makes no device-side
    copy of it (a user annotation gets one on the card's timeline)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("step"):
            torch.ones(3).sum()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "extpom.step"]
    assert len(ev) == 1 and not ev[0].is_user_annotation()


@pytest.mark.parametrize("kind", ["float", "int"])
def test_host_value_reads_as_float_and_int(kind):
    t = (torch.tensor(2.5, dtype=torch.float32) if kind == "float"
         else torch.tensor(7, dtype=torch.int64))
    v = profiling.host_value(t)
    assert type(v) is (float if kind == "float" else int)
    assert v == (float(t) if kind == "float" else int(t))


# made-up spans (path, start, end), launches {correlation id: time} and
# device operations (name, correlation id, linked id, us) for attribute()
SPANS = [("segment", 0, 100), ("segment/step", 10, 90),
         ("segment/step/tke", 20, 30), ("segment/step/mom", 30, 40),
         ("stats", 200, 300), ("stats/sync", 250, 260),
         ("velocity", 400, 500), ("velocity/sync", 400, 410)]
LAUNCHES = {1: 5, 2: 25, 3: 35, 4: 95, 5: 150, 6: 255, 7: 40, 8: 405,
            9: 450}
OPS = [("k_a", 1, 0, 1.0), ("k_tke_tile", 2, 0, 10.0),
       ("k_mom_tile", 3, 0, 5.0), ("k_mom_tile", 0, 7, 2.0),
       ("plain", 4, 0, 0.5), ("plain", 5, 0, 0.25), ("Memcpy DtoH", 6, 0, 3.0),
       ("lost", 99, 98, 4.0), ("Memcpy DtoH", 8, 0, 1.0),
       ("reduce", 9, 0, 2.0)]


@pytest.mark.parametrize("path, spans, us, ops", [
    ("segment", 1, 1.5, {"k_a": [1, 1.0], "plain": [1, 0.5]}),
    ("segment/step", 1, 0.0, {}),
    ("segment/step/tke", 1, 10.0, {"k_tke_tile": [1, 10.0]}),
    # a launch at a span's end is inside it; a linked id matches too
    ("segment/step/mom", 1, 7.0, {"k_mom_tile": [2, 7.0]}),
    ("stats", 1, 0.0, {}),
    ("stats/sync", 1, 3.0, {"Memcpy DtoH": [1, 3.0]}),
    # two spans that open at one time: the longer encloses the other
    ("velocity", 1, 2.0, {"reduce": [1, 2.0]}),
    ("velocity/sync", 1, 1.0, {"Memcpy DtoH": [1, 1.0]}),
    # outside every span, or matched to no launch
    ("", 0, 4.25, {"plain": [1, 0.25], "lost": [1, 4.0]}),
])
def test_attribute_to_the_innermost_span(path, spans, us, ops):
    got = profiling.attribute(SPANS, LAUNCHES, OPS)
    assert set(got) == {p for p, _, _ in SPANS} | {""}
    assert got[path] == {"spans": spans, "device_us": us, "ops": ops}


def test_stage_times_count_the_spans_on_the_cpu():
    """On the CPU the profile holds the spans and no device operation."""
    m = seamount_model(**KW)
    m.run_segment(1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m.run_segment(2)
        m.stats()
        m.velocity_check()
    got = profiling.stage_times(prof.profiler.kineto_results.events())
    want = {"segment": 1, "segment/step": 2, "stats": 1, "stats/sync": 1,
            "velocity": 1, "velocity/sync": 3,
            **{f"segment/step/{s}": 2 for s in STAGES}}
    assert {p: e["spans"] for p, e in got.items()} == want
    assert all(e["device_us"] == 0 and not e["ops"] for e in got.values())


def forced_model(budget_mb: int):
    """The harness's small forced case (every series of bounds_forcing.f,
    the file edges, the restoring) at 17x17x5 in float64, its series
    staged whole (``budget_mb`` large) or a window a segment (0)."""
    from pombench import program
    from pombench.tests import forced_case
    conf = dict(forced_case.CONF,
                case_args=dict(forced_case.CONF["case_args"], im=17, jm=17,
                               kb=5),
                config=dict(forced_case.CONF["config"],
                            forcing_hbm_mb=budget_mb))
    cpu = torch.device("cpu")
    return program.build(forced_case.make(conf, 2 ** 31 + 23, cpu,
                                          torch.float64), cpu)


@pytest.mark.parametrize("budget_mb, stagings", [(16384, [1, 0]),
                                                 (0, [1, 1])],
                         ids=["whole", "window"])
def test_forcing_spans_count_steps_and_stagings(budget_mb, stagings):
    """One ``forcing`` span a step inside ``step``; one ``forcing_stage``
    a staging inside ``segment``: at the first segment only for a whole
    plan, at every segment for a windowed one."""
    m = forced_model(budget_mb)
    for want in stagings:
        got = profiled(lambda: m.run_segment(3))
        assert got.count("segment/forcing_stage") == want
        assert got.count("segment/step/forcing") == 3
        assert [p for p in got if p.endswith("forcing")] == [
            "segment/step/forcing"] * 3
        assert got.count("segment/step") == 3


def test_every_forcing_operation_under_step_forcing(monkeypatch):
    """Each operation that ``forcing_at`` runs, marked by a probe range
    around the call, falls under ``segment/step/forcing`` by
    ``profiling.attribute``, and the probe opens once a forcing span."""
    from extpom_tpu_torch.forcing import device as fdev
    real = fdev.forcing_at

    def probed(*a, **k):
        with torch.profiler.record_function("probe.forcing"):
            return real(*a, **k)
    monkeypatch.setattr(fdev, "forcing_at", probed)
    m = forced_model(16384)
    m.run_segment(1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m.run_segment(2)
    events = list(prof.profiler.kineto_results.events())
    probes = [(e.start_ns(), e.end_ns()) for e in events
              if e.name() == "probe.forcing"]
    inside = [e for e in events if e.name().startswith("aten::")
              and any(a <= e.start_ns() <= e.end_ns() <= b
                      for a, b in probes)]
    assert len(probes) == 2 and inside
    spans = profiling.span_paths(events)
    got = profiling.attribute(
        spans, {q: e.start_ns() for q, e in enumerate(inside)},
        [(e.name(), q, -1, 1.0) for q, e in enumerate(inside)])
    assert got["segment/step/forcing"]["spans"] == 2
    assert sum(c for c, _ in got["segment/step/forcing"]["ops"].values()) \
        == len(inside)
