"""Tiny cells for the CPU tests: a cell of BENCHMARK.json with its grid cut
to a size the CPU steps in well under a second, and a print every six
steps."""

import copy
import time

import pytest
import torch

from pombench import cells

SHAPES = {"seamount2048": (33, 33, 11)}


def tiny_cell(name: str, **namelist) -> cells.Cell:
    """The cell ``name`` at a tiny size, its namelist overridden by
    ``namelist``."""
    c = cells.resolve(name)
    conf = copy.deepcopy(c.config)
    im, jm, kb = SHAPES[name.split(".")[0]]
    conf["case_args"].update(im=im, jm=jm, kb=kb)
    conf["config"]["prtd1"] = 6 * conf["config"].get("dte", 6.0) * \
        conf["config"].get("isplit", 30) / 86400.0
    conf["config"].update(namelist)
    return cells.Cell(c.name, c.chips, conf, c.traffic, c.limits,
                      c.end_to_end, c.per_layer)


@pytest.fixture
def run_tiny():
    """run(name, **kw) -> the result of one run of the tiny cell on the
    CPU: a window of one print."""
    from pombench import run

    def go(name, seed=2 ** 31 + 11, traced=False, control=False,
           **namelist):
        return run.run_cell(tiny_cell(name, **namelist), seed, 0.0, traced,
                            torch.device("cpu"), t0=time.perf_counter(),
                            log=lambda s: None, control=control)
    return go
