"""Every cell of BENCHMARK.json resolves from its files, and every metric
it names has a reader that says what BENCHMARK.json says of it."""

import json

import pytest

from pombench import cells, check
from pombench.metrics import handwritten, reader

BENCH = cells.load_benchmark()
NAMES = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", NAMES)
def test_cell_resolves(name):
    c = cells.resolve(name, BENCH)
    assert c.chips == 1
    assert (cells.HERE / "cases" / f"{c.config['case']}.py").is_file()
    assert set(c.limits) == set(check.NUMBERS)
    assert [m["name"] for m in c.end_to_end] == [
        "gpts_per_s", "peak_mem_gb", "setup_s"]
    assert c.per_layer
    assert all(m["moves"] == "gpts_per_s" for m in c.per_layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_matches_entry(metric):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    r = reader(metric)
    assert (r.LAYER, r.UNIT, r.MOVES) == (entry["layer"], entry["unit"],
                                          entry["moves"])
    assert callable(r.read)


@pytest.mark.parametrize("extra", [{"trace_segments": 2},
                                   {"output": "zarr"}])
def test_traffic_the_harness_would_not_run_is_refused(tmp_path, extra):
    t = dict(cells.traffic(cells.HERE / "traffic" / "steady.json"), **extra)
    p = tmp_path / "t.json"
    p.write_text(json.dumps(t))
    with pytest.raises(ValueError):
        cells.traffic(p)


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        cells.resolve("no.such.cell", BENCH)


def test_handwritten_names():
    names = handwritten()
    assert "k_window<" in names and "k_mpdata_tile<" in names
    assert not any(n.startswith("#") for n in names)
