"""A cell of ``BENCHMARK.json``, resolved from files by name: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the limits of its comparison
(``limits/<cell>.json``) and the metrics it reports.  A cell, a
configuration, a traffic mix or a metric is added as files and entries, and
nothing here names one."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file
    traffic: dict       # the traffic file
    limits: dict        # compared number -> its limit
    end_to_end: tuple   # the end-to-end metric entries the cell reports
    per_layer: tuple    # the per-layer metric entries the cell reports


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


# what a traffic file may say: why it exists, the namelist's overrides (any
# Config field: prtd1 sets the print cadence, forcing_hbm_mb the forcing's
# staging) and its output, which is none: the harness drives no writer
TRAFFIC_KEYS = {"why", "namelist", "output"}


def traffic(path: Path) -> dict:
    """The traffic file ``path``, refused where it says what the harness
    would not do."""
    t = _read(path)
    unknown = set(t) - TRAFFIC_KEYS
    if unknown or t.get("output", "none") != "none":
        raise ValueError(f"{path.name}: the harness reads {sorted(TRAFFIC_KEYS)}"
                         f" and drives no output; got {sorted(t)} with "
                         f"output {t.get('output', 'none')!r}")
    return t


def _reports(metric: dict, cell: str, e2e=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists; without the key, an end-to-end metric every cell, a per-layer
    metric every cell that reports the end-to-end metric it moves (names
    ``e2e``)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e is None or metric["moves"] in e2e


def resolve(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = load_benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {BENCHMARK.name}; it has "
                       f"{', '.join(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name))
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_read(ROOT / conf["file"]),
        traffic=traffic(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_read(HERE / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=tuple(m for m in bench["per_layer"]
                        if _reports(m, name, {m["name"] for m in e2e})))
