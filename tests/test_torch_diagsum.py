"""The print's compensated sums (``kernels/diagsum.py``) on the CPU: the
launcher's region and operand tables against ``diag/stats.py``'s
``_regions``/``_cells`` on square, ragged and decomposed grids, the
dispatch of the CPU to the plain sums, and the plain sums that the kernel
is held to on the card against ``math.fsum`` of their cells."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.diag import stats
from extpom_tpu_torch.kernels import diagsum

RECTS = ("inner", "south", "north", "west", "east")


def blocks_of(shape, mesh):
    """(offset, extent) of every block of an array ``shape`` cut into
    ``mesh`` = (px, py) blocks, as ``Blocks.goff`` places them."""
    ni, nj = shape[0] // mesh[0], shape[1] // mesh[1]
    return [((bi * ni, bj * nj), (ni, nj))
            for bi in range(mesh[0]) for bj in range(mesh[1])]


CASES = {
    "square": ((33, 33), (33, 33), (1, 1)),
    "ragged": ((36, 40), (33, 35), (1, 1)),
    "blocks": ((32, 48), (32, 48), (2, 4)),
    "ragged_blocks": ((256, 256), (255, 255), (2, 4)),
    # blocks of nothing but padding
    "padding_blocks": ((40, 48), (17, 13), (4, 4)),
}


def rect_cells(rect, n) -> set:
    i0, i1, j0, j1 = rect
    assert 0 <= i0 <= i1 <= n[0] and 0 <= j0 <= j1 <= n[1]
    return {(i, j) for i in range(i0, i1) for j in range(j0, j1)}


def region_cells(region, off, n) -> set:
    """The block's cells of a global region, by ``_cells`` of an index
    field."""
    idx = torch.arange(n[0] * n[1]).reshape(n)
    return {divmod(int(k), n[1])
            for k in stats._cells(idx, region, off, n)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_agrees_with_regions_and_cells(case):
    shape, active, mesh = CASES[case]
    reg = stats._regions(*active)
    named = dict(zip(RECTS, reg["edge"]))
    for off, n in blocks_of(shape, mesh):
        geo = diagsum.pack(reg, active, off, n)
        assert len(geo) == 4 + 4 * len(RECTS)
        box = rect_cells(geo[:4], n)
        want_box = {(i, j) for i in range(n[0]) for j in range(n[1])
                    if off[0] + i < active[0] and off[1] + j < active[1]}
        assert box == want_box
        got = {r: rect_cells(geo[4 + 4 * q:8 + 4 * q], n)
               for q, r in enumerate(RECTS)}
        for r in RECTS:
            assert got[r] == region_cells(named[r], off, n), (off, r)
            assert got[r] <= box
        # the kernel's mass and kinetic-energy regions are _regions' own
        assert reg["mass"] == (named["inner"],)
        assert [(c, w) for c, w in reg["ke"]] == [
            (named["inner"], 0.5), (named["north"], 1.0),
            (named["east"], 1.0)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_covers_each_active_cell_once_but_the_corners(case):
    """Over every block the five rectangles hold each active cell once,
    but the four corners of the active grid, which no sum takes."""
    shape, active, mesh = CASES[case]
    reg = stats._regions(*active)
    count = np.zeros(shape, dtype=int)
    for off, n in blocks_of(shape, mesh):
        geo = diagsum.pack(reg, active, off, n)
        for q in range(len(RECTS)):
            for i, j in rect_cells(geo[4 + 4 * q:8 + 4 * q], n):
                count[off[0] + i, off[1] + j] += 1
    ia, ja = active
    want = np.zeros(shape, dtype=int)
    want[:ia, :ja] = 1
    for i, j in ((0, 0), (0, ja - 1), (ia - 1, 0), (ia - 1, ja - 1)):
        want[i, j] = 0
    assert np.array_equal(count, want)


def test_pack_refuses_other_regions():
    reg = dict(stats._regions(9, 9))
    reg["ke"] = reg["ke"][:1]
    with pytest.raises(ValueError):
        diagsum.pack(reg, (9, 9), (0, 0), (9, 9))


def test_operand_table_strides():
    """The launch's operands in order with each one's element strides, a
    view's as it lies in memory (no copy)."""
    m = seamount_model(device="cpu", im=12, jm=10, kb=5, dtype="float32")
    g, st = m.grid, m.state
    wide = torch.zeros(12, 20, dtype=torch.float32)
    g = dataclasses.replace(g, dx=wide[:, ::2])
    xs, strides = diagsum.operands(g, st)
    names = [g.dx, g.dy, g.fsm, g.h, st.et, st.rho, st.tb, st.sb, st.u,
             st.v, g.dz]
    assert all(x is y for x, y in zip(xs, names))
    assert strides[:2] == [20, 2]
    assert strides == [s for x in names for s in x.stride()]
    assert len(strides) == 2 * 5 + 3 * 5 + 1


def test_operand_table_refuses_mixed_dtypes():
    m = seamount_model(device="cpu", im=12, jm=10, kb=5, dtype="float32")
    st = dataclasses.replace(m.state, u=m.state.u.double())
    with pytest.raises(TypeError):
        diagsum.operands(m.grid, st)


@pytest.fixture(scope="module")
def runs():
    """A 33x33x11 seamount after four steps, in float32 and float64."""
    out = {}
    for dtype in ("float32", "float64"):
        m = seamount_model(device="cpu", im=33, jm=33, kb=11, dtype=dtype)
        m.run_segment(4)
        out[dtype] = m
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cpu_takes_the_plain_sums(runs, dtype, monkeypatch):
    m = runs[dtype]

    def refuse(*a, **k):
        raise AssertionError("the kernel's launcher on the CPU")
    monkeypatch.setattr(diagsum, "domain_stats", refuse)
    monkeypatch.setattr(diagsum, "block_pairs", refuse)
    got = stats.domain_stats(m.grid, m.cfg, m.state)
    want = stats.domain_stats_plain(m.grid, m.cfg, m.state)
    assert list(got) == list(diagsum.NAMES)
    for k in want:
        assert got[k].dtype == torch.float64 and got[k].dim() == 0
        assert torch.equal(got[k], want[k]), k
    assert m.stats() == {k: float(v) for k, v in want.items()}


def cell_values(m) -> dict:
    """Each sum's cells in float64, formed in NumPy in the order
    ``domain_stats`` forms them, over its regions written out here."""
    g, st, cfg = m.grid, m.state, m.cfg
    w = lambda a: a.double().numpy()
    kbm1 = cfg.kbm1
    darea = w(g.dx) * w(g.dy) * w(g.fsm)
    dt2 = w(g.h) + w(st.et)
    dvol = (darea * dt2)[None] * w(g.dz)[:kbm1, None, None]
    dmass = dvol * (w(st.rho)[:kbm1] * cfg.rhoref + 1000.0)
    u, v = w(st.u)[:kbm1], w(st.v)[:kbm1]
    ke = dmass * (u * u + v * v)
    ia, ja = cfg.active
    edge = np.ones((ia, ja), dtype=bool)
    edge[[0, 0, -1, -1], [0, -1, 0, -1]] = False
    inner = np.zeros((ia, ja), dtype=bool)
    inner[1:-1, 1:-1] = True
    north = np.zeros((ia, ja), dtype=bool)
    north[-1, 1:-1] = True
    east = np.zeros((ia, ja), dtype=bool)
    east[1:-1, -1] = True
    cells = lambda a, mask: list(a[..., mask].reshape(-1))
    return {
        "atot": cells(darea, edge), "eavg": cells(w(st.et) * darea, edge),
        "vtot": cells(dvol, edge), "mtot": cells(dmass, inner),
        "tavg": cells(w(st.tb)[:kbm1] * dvol, edge),
        "stot": cells(w(st.sb)[:kbm1] * dvol, edge),
        "ekin": (cells(0.5 * ke, inner) + cells(ke, north)
                 + cells(ke, east)),
    }


def ulps(a: float, b: float) -> float:
    return 0.0 if a == b else abs(a - b) / math.ulp(max(abs(a), abs(b)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_sums_equal_fsum_of_their_cells(runs, dtype):
    """vtot, atot, mtot, tsalt and ekin within 1 ulp of ``math.fsum`` of
    their cells, the three means within 2 ulp of the ratios of such sums."""
    m = runs[dtype]
    got = {k: float(v) for k, v in
           stats.domain_stats_plain(m.grid, m.cfg, m.state).items()}
    f = {k: math.fsum(v) for k, v in cell_values(m).items()}
    assert min(len(v) for v in cell_values(m).values()) > 900
    assert f["ekin"] > 0 and f["eavg"] != 0
    for name, key in (("vtot", "vtot"), ("atot", "atot"), ("mtot", "mtot"),
                      ("tsalt", "stot"), ("ekin", "ekin")):
        assert ulps(got[name], f[key]) <= 1, (name, got[name], f[key])
    for name, num, den in (("taver", "tavg", "vtot"),
                           ("saver", "stot", "vtot"),
                           ("eaver", "eavg", "atot")):
        assert ulps(got[name], f[num] / f[den]) <= 2, (name, got[name])
