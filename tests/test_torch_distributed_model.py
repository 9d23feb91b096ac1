"""The port's model decomposed over several processes on the CPU over gloo
(``Model.shard`` of a mesh whose blocks span ranks, ``stepper.mesh_step``
with one exchange per stage), each rank building the case on the host
and keeping its blocks:

* JAX's own multi-process case (tests/test_multihost.py): the seamount at
  32x16x7 f64 on a 2x1 mesh over two processes, ``run_segment(3)`` and a
  cooperative Zarr restart, held to the JAX single-process run at 1e-9 of
  each field's scale (that test's tolerance) and to the port's
  single-process run with ``torch.equal``;
* a ragged grid (33x17x7, padded to 34x20 on 2x4) over two processes,
  bit-equal to the port's single-process mesh run on the active region;
* the tidal channel with its staged forcing over two processes on 2x4,
  bit-equal to the single-process mesh run.

The ranks save their blocks (or write the restart); the parent runs the
references and compares."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from extpom_tpu.cases.seamount import seamount_model as jx_model

from extpom_tpu_torch.cases.channel import channel_model as pt_channel
from extpom_tpu_torch.cases.seamount import seamount_model as pt_model
from extpom_tpu_torch.core.state import State
from extpom_tpu_torch.mesh import distributed
from extpom_tpu_torch.mesh.padding import unpad
from extpom_tpu_torch.mesh.shardmap import Mesh, shard_args

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "multihost": dict(model="seamount", kw=dict(im=32, jm=16, kb=7),
                      mesh=(2, 1), segs=(3,)),
    # blocks of 17x5 after padding: the narrowest phase ring (4 cells)
    "ragged": dict(model="seamount", kw=dict(im=33, jm=17, kb=7, isplit=6,
                                             phase_halo=4),
                   mesh=(2, 4), segs=(2, 1), run=2),
    "channel": dict(model="channel", kw=dict(im=32, jm=64, kb=7),
                    mesh=(2, 4), segs=(2, 2), run=2),
}

_WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from extpom_tpu_torch.cases.channel import channel_model
from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.io import zarrstore as zio
from extpom_tpu_torch.mesh import distributed
from extpom_tpu_torch.mesh.shardmap import Mesh

case, out = json.loads(sys.argv[1]), sys.argv[2]
p = distributed.init_distributed(device="cpu", timeout_s=120)
make = seamount_model if case["model"] == "seamount" else channel_model
m = make(device="cpu", dtype="float64", **case["kw"])
m.shard(Mesh(*case["mesh"]))
assert m.state is None and m.device == torch.device("cpu")
for n in case["segs"]:
    m.run_segment(n)
lines = []
if case.get("run"):    # Model.run: step_once and the block diagnostics
    assert m.run(n_steps=case["run"], log=lines.append,
                 check_interval=1) is None
    print("RUN_LINES " + json.dumps(lines), flush=True)
if case.get("restart"):
    zio.write_restart(out, m.blocks.state_slabs(), m.iint)
else:
    torch.save({b: {f: getattr(s, f) for f in s.field_names()}
                for b, s in m.blocks.state.items()},
               os.path.join(out, f"rank{p.rank}.pt"))
try:
    m.gathered_state()
    raise AssertionError("a gather under several processes")
except RuntimeError:
    pass
print(f"MODEL_OK rank={p.rank} blocks={m.blocks.ids}", flush=True)
distributed.destroy()
"""


def _run_ranks(case: dict, out: str, n: int = 2) -> list:
    """Run the case as ``n`` ranks; rank 0's logged lines of Model.run."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = distributed.spawn([sys.executable, "-c", _WORKER, json.dumps(case),
                             out], n, 240.0, env=env, cwd=ROOT)
    for r, (rc, so, se) in enumerate(res):
        assert rc == 0, f"rank {r} exited {rc}:\n{so[-2000:]}\n{se[-4000:]}"
        assert f"MODEL_OK rank={r}" in so
    runs = [ln for ln in res[0][1].splitlines() if ln.startswith("RUN_LINES")]
    return json.loads(runs[0].split(" ", 1)[1]) if runs else []


def _blocks_of(out: str, n: int, px: int, py: int) -> State:
    """The global state assembled from the ranks' saved blocks."""
    blocks = {}
    for r in range(n):
        blocks.update(torch.load(os.path.join(out, f"rank{r}.pt")))
    assert sorted(blocks) == [(i, j) for i in range(px) for j in range(py)]
    cat = lambda f: torch.cat([torch.cat([blocks[(i, j)][f]
                                          for j in range(py)], dim=-1)
                               for i in range(px)], dim=-2)
    return State(**{f: cat(f) for f in State.field_names()})


def _equal(got: State, want: State) -> None:
    for f in State.field_names():
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_jax_multihost_case_with_a_cooperative_restart(tmp_path):
    from extpom_tpu_torch.io import zarrstore as zio
    case = dict(CASES["multihost"], restart=True)
    out = str(tmp_path / "rst")
    _run_ranks(case, out)
    ref = pt_model(device="cpu", dtype="float64", **case["kw"])
    ref.run_segment(3)
    st, iint, _ = zio.read_restart(out, ref.cfg, "cpu")
    assert iint == 3
    _equal(st, ref.state)
    jx = jx_model(dtype="float64", donate=False, **case["kw"])
    for _ in range(3):
        jx.step_once()
    for name in ("el", "ua", "u", "t", "s", "q2"):
        a = np.asarray(getattr(jx.state, name))
        b = getattr(st, name).numpy()
        tol = 1e-9 * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("name", ["ragged", "channel"])
def test_two_processes_are_bit_equal_to_one(tmp_path, name):
    """``run_segment``, then ``Model.run`` (each step's forcing assembled
    on the host, the diagnostics from the blocks; it returns None)."""
    case = CASES[name]
    lines = _run_ranks(case, str(tmp_path))
    make = pt_model if case["model"] == "seamount" else pt_channel
    ref = make(device="cpu", dtype="float64", **case["kw"])
    ref.shard(Mesh(*case["mesh"], device="cpu"))
    for n in case["segs"]:
        ref.run_segment(n)
    want: list = []
    ref.run(n_steps=case["run"], log=want.append, check_interval=1)
    assert lines == want and len(want) == case["run"]
    got = _blocks_of(str(tmp_path), 2, ref.mesh.px, ref.mesh.py)
    _equal(unpad(got, ref.cfg), unpad(ref.gathered_state(), ref.cfg))
    if name == "channel":    # the tide reached the blocks
        assert float(got.el.abs().max()) > 1e-3


def test_cold_start_on_the_blocks_equals_the_cut_one():
    """The cold start of each block (``Blocks(cold=True)``, from a deferred
    model's ``ColdInputs``): on the CPU the blocks equal the whole grid's
    cold start cut to them, but for the depth sums of drx2d and dry2d
    (torch.sum on the CPU orders a plane's cells by its size; within 1e-15
    of their scale)."""
    from extpom_tpu_torch.core.model import ColdInputs
    m = pt_model(device="cpu", dtype="float64", im=24, jm=16, kb=6)
    mesh = Mesh(2, 2, device="cpu")
    st = m.state
    ics = ColdInputs(st.tb, st.sb, st.elb, st.uab, st.vab, st.ub, st.vb)
    cold = shard_args(mesh, m.cfg, m.grid, ics, m.base_forcing, None,
                      m.tclim, m.sclim, cold=True)
    cut = shard_args(mesh, m.cfg, m.grid, m.state, m.base_forcing, m.rmean,
                     m.tclim, m.sclim)
    for b in cut.ids:
        for f in State.field_names():
            a, w = getattr(cold.state[b], f), getattr(cut.state[b], f)
            if f in ("drx2d", "dry2d"):
                tol = 1e-15 * float(w.abs().max())
                assert float((a - w).abs().max()) <= tol, f
            else:
                assert torch.equal(a, w), f
        assert all(torch.equal(x, y) for x, y in zip(cold.clim[b],
                                                      cut.clim[b]))


@pytest.mark.parametrize("im,jm", [(24, 16), (23, 15)])
def test_deferred_cold_start_runs_on_the_blocks(im, jm):
    """``Model(defer=True)`` keeps only the cold start's inputs and runs it
    on each block when it is decomposed (on a padded grid too, with the pad
    cells at 0); after three steps every field is bit-equal to the model
    cold-started whole."""
    from extpom_tpu_torch.cases.seamount import seamount_case
    from extpom_tpu_torch.core.model import ColdInputs, Model
    kw = dict(device="cpu", dtype="float64", im=im, jm=jm, kb=6, isplit=6,
              phase_halo=4)
    cfg, grid, ics = seamount_case(**kw)
    m = Model(grid, cfg, defer=True, **ics)
    assert isinstance(m.state, ColdInputs) and m.rmean is None
    with pytest.raises(RuntimeError, match="shard it first"):
        m.run_segment(1)
    m.shard(Mesh(2, 2, device="cpu"))
    ref = pt_model(**kw).shard(Mesh(2, 2, device="cpu"))
    for x in (m, ref):
        x.run_segment(3)
    _equal(m.gathered_state(), ref.gathered_state())
