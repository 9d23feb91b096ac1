"""The run driver with a ``distributed`` block (``python -m
extpom_tpu_torch.run``) on the CPU: two processes over gloo, launched as
torchrun would (``mesh.distributed.spawn``), run the seamount on a 2x2
mesh, print the diagnostics once (rank 0), and write Zarr snapshots and
restarts cooperatively; held to the same run in one process (snapshots and
restarts bit-equal, the diagnostics to 1e-12 of their value).  A
two-process resume from the mid-run restart is bit-equal to the
uninterrupted run, and NetCDF output raises under two processes.  The
port writes and reads every store itself: tensorstore is masked in the
ranks (a package of that name on their path that fails to import) and in
this process while the one-process run writes."""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from extpom_tpu_torch import run as ptrun
from extpom_tpu_torch.core.state import State
from extpom_tpu_torch.io import zarr
from extpom_tpu_torch.io import zarrstore as zio
from extpom_tpu_torch.mesh import distributed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTI = 6.0 * 6                   # dte x isplit
CONF = {"run_name": "sm", "case": "seamount",
        "case_args": {"im": 24, "jm": 16, "kb": 5},
        "config": {"days": 8 * DTI / 86400, "prtd1": 2 * DTI / 86400,
                   "write_rst": 4 * DTI / 86400, "isplit": 6,
                   "calc_wr": True, "dtype": "float64"},
        "out_dir": "out", "out_format": "zarr", "mesh": {"px": 2, "py": 2},
        "distributed": {"backend": "gloo"}}


def _ranks(tmp, conf: dict, n: int = 2) -> list:
    """Run ``conf`` from ``tmp`` as ``n`` ranks of the driver on the CPU;
    each rank's (exit code, stdout, stderr)."""
    path = os.path.join(tmp, f"{conf['run_name']}.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    mask = os.path.join(tmp, "mask")
    os.makedirs(os.path.join(mask, "tensorstore"), exist_ok=True)
    with open(os.path.join(mask, "tensorstore", "__init__.py"), "w") as f:
        f.write('raise ImportError("tensorstore is masked")\n')
    env = dict(os.environ, PYTHONPATH=os.pathsep.join((mask, ROOT)),
               OMP_NUM_THREADS="1")
    return distributed.spawn(
        [sys.executable, "-m", "extpom_tpu_torch.run", path, "--device",
         "cpu"], n, 240.0, env=env, cwd=tmp)


def _ok(res: list) -> str:
    for r, (rc, so, se) in enumerate(res):
        assert rc == 0, f"rank {r} exited {rc}:\n{so[-2000:]}\n{se[-4000:]}"
    return res[0][1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-process run, its resume from step 4, and the one-process
    run of the same configuration (the driver's lines of each)."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    two = _ranks(tmp, CONF)
    resume = dict(copy.deepcopy(CONF), run_name="rs", out_dir="out_rs",
                  nread_rst=1, read_rst_path=os.path.join(
                      tmp, "out", "sm.rst.000004"))
    res = _ranks(tmp, resume)
    one = dict(copy.deepcopy(CONF), out_dir=os.path.join(tmp, "out1"))
    del one["distributed"]
    lines: list = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorstore", None)
        assert ptrun.execute(one, "cpu", log=lines.append).rc == 0
    return tmp, two, res, lines


def _time_lines(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith("time = ")]


def test_rank_0_prints_once(runs):
    _, two, _, one_lines = runs
    text = _ok(two)
    assert two[1][1].strip() == ""            # rank 1 prints nothing
    assert len(_time_lines(text)) == len(
        _time_lines("\n".join(one_lines))) == 4
    assert "processes = 2  devices = 1" in text
    assert "processes: 2 over gloo (device tensors)" in text
    assert "rank 1: blocks (1, 0), (1, 1) on cpu" in text
    assert "printed by rank 0" in text
    for r in (0, 1):                 # each rank's clock and writer, once
        assert text.count(f"rank {r}: wall clock ") == 1


def test_snapshots_and_restarts_equal_one_process(runs):
    tmp, two, _, _ = runs
    _ok(two)
    for k in (2, 4, 6, 8):
        got = zio.read_output(os.path.join(tmp, "out", f"sm.{k:06d}"))
        want = zio.read_output(os.path.join(tmp, "out1", f"sm.{k:06d}"))
        for name in zio.OUTPUT_GRID_VARS + zio.OUTPUT_FIELDS + ("wr",):
            g = zio.read_array(os.path.join(tmp, "out", f"sm.{k:06d}"), name)
            w = zio.read_array(os.path.join(tmp, "out1", f"sm.{k:06d}"),
                               name)
            assert np.array_equal(g, w), (k, name)
        gs, ws = got["attrs"]["stats"], want["attrs"]["stats"]
        for key, w in ws.items():
            assert abs(gs[key] - w) <= 1e-12 * abs(w), (k, key)
    for k in (4, 8):
        _same_restart(os.path.join(tmp, "out", f"sm.rst.{k:06d}"),
                      os.path.join(tmp, "out1", f"sm.rst.{k:06d}"))
    for d, _, files in os.walk(os.path.join(tmp, "out")):
        if ".zarray" in files:       # blosc-lz4 as the JAX package's
            with open(os.path.join(d, ".zarray")) as f:  # no temporary left
                assert json.load(f)["compressor"] == zarr.BLOSC, d
            assert not [n for n in files if n.startswith(".tmp")], d


def _same_restart(a: str, b: str) -> None:
    for f in State.field_names():
        assert np.array_equal(zio.read_array(a, f), zio.read_array(b, f)), f
    assert zio._read_attrs(a) == zio._read_attrs(b)


def test_two_process_resume_is_bit_equal(runs):
    tmp, _, res, _ = runs
    text = _ok(res)
    assert len(_time_lines(text)) == 2
    _same_restart(os.path.join(tmp, "out_rs", "rs.rst.000008"),
                  os.path.join(tmp, "out", "sm.rst.000008"))


def test_netcdf_output_raises_under_two_processes(tmp_path):
    conf = dict(copy.deepcopy(CONF), run_name="nc", out_format="nc")
    res = _ranks(str(tmp_path), conf)
    assert all(rc not in (0, None) for rc, _, _ in res)
    assert "single-process only" in res[0][2]
