"""The MPDATA kernel's planner (kernels/phases.py:mpdata_plan) on the CPU:
for every nitera a mesh allows (1..8, the phase ring) in both dtypes, at
256x256, 512x512, 2048x2048 and a ring-extended block of the 256x256 2x4
mesh (31 levels), each launch fits a Hopper block, the launches chain
exactly nitera steps, each launch's halo covers its steps' reach, the
columns are cut into the chunks of levels that waste the fewest waves, and
chip_smoke.py's launch gates count the plan's launches; the planner raises
where nothing fits, and the wrapper's pointer table is the kernel's."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from extpom_tpu_torch import kernels
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.kernels import build, phases

ROOT = pathlib.Path(__file__).resolve().parent.parent
# (R, L): whole grids, and a 128x64 block of 256x256 on 2x4 with its ring
# of 8
SHAPES = [(256, 256), (512, 512), (2048, 2048), (144, 80)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nitera", range(1, 9))
def test_mpdata_plan(nitera, dtype):
    item = torch.finfo(dtype).bits // 8
    cs = _chip_smoke()
    for R, L in SHAPES:
        plan = phases.mpdata_plan(nitera, dtype, 31, R, L)
        assert 0 < plan.smem <= phases.SMEM_BYTES == 232_448
        assert plan.threads % 32 == 0
        assert plan.threads <= phases.mpdata_layout()["kMaxThreads"]
        tiles = 2 * -(-R // plan.ti) * -(-L // plan.tj)
        assert plan.blocks == tiles * plan.chunks
        # the chunks of levels: waves of blocks times the levels a block
        # walks, least; the whole column where the tiles fill the card
        slots = phases.MPDATA_RESIDENT[item] * phases.H100_SMS
        walk = lambda k: (-(-tiles * k // slots)
                          * (-(-31 // k) + plan.halos[0] + plan.groups[0]))
        assert all(walk(plan.chunks) <= walk(k) for k in range(1, 32))
        assert plan.chunks == 1 or tiles < slots
        # the groups chain exactly nitera steps, at most G each, the
        # fewest launches that do
        assert sum(plan.groups) == nitera
        assert plan.group <= phases.mpdata_layout()["kMaxGroup"]
        assert len(plan.groups) == plan.launches == -(-nitera // plan.group)
        assert 1 <= min(plan.groups) and max(plan.groups) <= plan.group
        assert max(plan.groups) - min(plan.groups) <= 1
        if plan.group < min(nitera, phases.mpdata_layout()["kMaxGroup"]):
            g = plan.group + 1
            assert (phases._mpdata_smem(g, g, plan.ti, plan.tj, item)
                    > phases.SMEM_BYTES or
                    phases._mpdata_smem(g, g + 1, plan.ti, plan.tj, item)
                    > phases.SMEM_BYTES)
        # each launch's halo covers the reach of its steps, one cell more
        # where another launch reads its last step's velocities
        assert plan.halos[0] == max(plan.halos)
        for k, n in enumerate(plan.groups):
            halo = n + (k + 1 < plan.launches)
            assert plan.halos[k] == halo
            reach = phases.mpdata_radius(Config(R, L, 31, nitera=n))
            assert reach <= n <= halo
            assert (phases._mpdata_smem(n, halo, plan.ti, plan.tj, item)
                    <= plan.smem)
        # chip_smoke's gates count the plan's launches per tracer phase
        cfg = Config(im=R, jm=L, kb=31, dtype=str(dtype).split(".")[1],
                     nadv=2, nitera=nitera)
        assert cs.mpdata_launches(cfg) == plan.launches
        want = cs.option_want(dict(kernels.LAUNCHES), cfg, 22)
        assert want["phase_tracer_mpdata"] == 21 * plan.launches
        want = cs.option_want(dict(kernels.LAUNCHES), cfg, 5, nb=8,
                              chunks=8)
        assert want["phase_tracer_mpdata_mesh"] == 4 * 8 * plan.launches
        assert cs.mpdata_launches(cfg.replace(nadv=1)) == 0


def test_mpdata_plan_refuses_what_does_not_fit():
    for kw in (dict(threads=1024), dict(threads=48), dict(threads=16)):
        with pytest.raises(ValueError, match="threads"):
            phases.mpdata_plan(2, torch.float32, 31, 256, 256, **kw)


def test_mpdata_pointer_table_is_the_kernels():
    """The wrapper's operands and the fields and velocities in and out
    fill the kernel's pointer table (kMpdPointers), and the layout the
    planner reads is the source's."""
    src = (build.CSRC / "phase_mpdata.cu").read_text()
    n = int(re.search(r"constexpr int kMpdPointers = (\d+);", src).group(1))
    z = torch.zeros(1)
    grid = type("G", (), {k: z for k in ("dx", "dy", "h", "art", "aru",
                                         "arv", "fsm", "dz", "dzz")})()
    reads = phases.mpdata_inputs(grid, *[z] * 10)
    assert len(reads) + 2 + 6 + 2 + 6 == n
    c = phases.mpdata_layout()
    assert set(c) == {"kInRing", "kInVelRing", "kFieldRing", "kVelRing",
                      "k2D", "kTable", "kMaxGroup", "kMaxHalo", "kMaxThreads"}
    # the tiles compiled in are the planner's
    ti = re.search(r"kTileI = sizeof\(T\) == 4 \? (\d+) : (\d+);", src)
    tj = int(re.search(r"constexpr int kTileJ = (\d+);", src).group(1))
    assert phases.MPDATA_TILE == {4: (int(ti.group(1)), tj),
                                  8: (int(ti.group(2)), tj)}
    # every (steps, halo) the planner can launch is instantiated
    for dtype in (torch.float32, torch.float64):
        for nitera in range(1, 9):
            plan = phases.mpdata_plan(nitera, dtype, 31, 256, 256)
            for n, h in zip(plan.groups, plan.halos):
                assert f"case {n} * 8 + {h}:" in src
    assert c["k2D"] == len(re.search(r"enum \{ (DDT[^}]*)\}", src)
                           .group(1).split(","))
    assert "planes(int ns)" in src


def test_mpdata_cpu_dispatch_is_plain():
    """On CPU tensors phases.mpdata runs mpdata_plain and launches
    nothing."""
    from extpom_tpu_torch.cases.seamount import seamount_model
    m = seamount_model(device="cpu", im=9, jm=12, kb=5, dtype="float64",
                       nadv=2, nitera=3)
    st, g = m.state, m.grid
    rng = np.random.default_rng(7)
    noise = lambda: torch.from_numpy(0.05 * rng.standard_normal(st.u.shape))
    ops = (st.t + 1.0, st.tb + 1.0, st.s, st.sb, st.u + noise(),
           st.v + noise(), st.w + 1e-3 * noise(), g.h + st.et, st.etb,
           st.etf)
    before = dict(kernels.LAUNCHES)
    got = phases.mpdata(g, m.cfg, *ops)
    assert kernels.LAUNCHES == before
    for a, b in zip(got, phases.mpdata_plain(g, m.cfg, *ops)):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a).all())
