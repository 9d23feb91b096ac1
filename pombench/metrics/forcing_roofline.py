"""The step's forcing interpolation's share of its roofline: the bytes it
must move (:func:`step_bytes`: each interpolated series' two records read
and its value written once, and the four barotropic edge values written)
over 3.35 TB/s, over the device time of the port's hand-written forcing
launch (``k_forcing_``).

The series are those that the configuration's case stages, and a
:class:`~pombench.trace.Trace` carries only the run's namelist: so the
reader takes the configuration of ``BENCHMARK.json`` whose case is
``forced`` (``cases/forced.py``) and whose grid, ``bc_scheme`` and
``do_restore`` are the namelist's (:func:`forced_configuration`), and
counts the series that case makes from its ``assumed.forcing``.  It reads
None where no such configuration, or more than one, matches; on a run
without the ``file`` edges and the interior restoring; and where no such
kernel ran (a port that forms the forcing in plain kernels)."""

import json
from typing import Optional

from pombench import cells, work

LAYER = "forcing"
UNIT = "%"
MOVES = "gpts_per_s"
KERNELS = ("k_forcing_",)
CASE = "forced"


def step_bytes(im: int, jm: int, kb: int, dtype: str,
               taurstr: bool) -> int:
    """Compulsory bytes of one step's forcing of the ``forced`` case
    (``pombench/tests/forced_case.py``): the 20 lateral series (el on each
    side; t, s, u and v profiles of kb levels on each side), the four
    interpolated surface fluxes (wusurf, wvsurf, wtsurf, swrad) and the
    3-D restoring series trstr, srstr and, where the case draws it
    (``taurstr``), taurstr, each two records read and one value written;
    the four barotropic edge values (uab on the west and east, vab on the
    south and north) written.  tsurf and ssurf are held, not interpolated,
    and the port's default taurstr is one constant record."""
    edges = 2 * jm + 2 * im                  # one value on each side
    lateral = edges + 4 * kb * edges
    series = lateral + 4 * im * jm + (2 + bool(taurstr)) * kb * im * jm
    return (3 * series + edges) * work.ITEMSIZE[dtype]


def forced_configuration(nl: dict) -> Optional[dict]:
    """The configuration file of ``BENCHMARK.json`` that the namelist
    ``nl`` runs, of case ``forced``: the one whose grid (``case_args``)
    and whose ``bc_scheme`` and ``do_restore`` are ``nl``'s; None where
    none or several are."""
    found = []
    for entry in cells.load_benchmark()["configs"]:
        with open(cells.ROOT / entry["file"]) as f:
            conf = json.load(f)
        if conf.get("case") != CASE:
            continue
        grid = conf["case_args"]
        c = conf.get("config", {})
        if all(grid.get(k) == nl.get(k) for k in ("im", "jm", "kb")) \
                and c.get("bc_scheme") == nl.get("bc_scheme") \
                and bool(c.get("do_restore")) == bool(nl.get("do_restore")):
            found.append(conf)
    return found[0] if len(found) == 1 else None


def read(trace):
    nl = trace.namelist
    if nl.get("bc_scheme") != "file" or not nl.get("do_restore"):
        return None
    ks = trace.kernels(KERNELS)
    if not ks or trace.steps <= 0:
        return None
    conf = forced_configuration(nl)
    if conf is None:
        return None
    taurstr = conf["assumed"]["forcing"]["taurstr"]
    bound = work.bound_s(0.0, step_bytes(nl["im"], nl["jm"], nl["kb"],
                                         nl["dtype"], taurstr), nl["dtype"])
    spent = sum(k.end_us - k.start_us for k in ks) / 1e6
    return 100.0 * bound * trace.steps / spent
