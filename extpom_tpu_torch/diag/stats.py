"""Global diagnostics and the blow-up guard (``extpom_tpu/diag/stats.py``;
advance.f:611-756).

:func:`domain_stats` and :func:`check_velocity` read a whole state; their
block forms (:func:`domain_stats_blocks`, :func:`check_velocity_blocks`)
read the blocks of a model decomposed over several processes: each rank
sums its blocks' cells of the same regions, and the ranks' partial sums
are summed again (``mesh.distributed.host_all_gather``).  On the card
both forms sum in one pass of the hand-written kernel
(``kernels/diagsum.py``); the CPU runs the plain sums
(:func:`domain_stats_plain`, :func:`_csum2`), which the kernel is held to."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.grid import Grid
from extpom_tpu_torch.core.state import State
from extpom_tpu_torch.diag.profiling import host_value, span
from extpom_tpu_torch.kernels import diagsum


def _csum(x: torch.Tensor) -> torch.Tensor:
    """Compensated pairwise sum (a log2(N)-level TwoSum tree carrying an
    error channel): ~double-length totals in any float dtype."""
    s, c = _csum2(x)
    return s + c


def _csum2(x: torch.Tensor) -> tuple:
    """:func:`_csum` as (sum, error channel), whose sum stands for the total
    to about twice the dtype's precision, so that partial totals (each
    rank's) can be summed again without losing what cancels.  The error
    of each addition is Knuth's TwoSum, exact; the JAX package's
    ``(a - (t - b)) + (b - (t - a))`` is not (ROADMAP Queue 3), which cost
    ~1e-12 of a total that cancels (eaver)."""
    x = x.reshape(-1)
    n = x.shape[0]
    if n == 0:
        z = torch.zeros((), dtype=x.dtype, device=x.device)
        return z, z
    p = 1 << max(n - 1, 1).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros(p - n)])
    s, c = x, torch.zeros_like(x)
    while s.shape[0] > 1:
        a, b = s[0::2], s[1::2]
        t = a + b
        bv = t - a
        e = (a - (t - bv)) + (b - bv)
        s = t
        c = c[0::2] + c[1::2] + e
    return s[0], c[0]


def domain_stats(grid: Grid, cfg: Config, st: State) -> Dict[str, torch.Tensor]:
    """vtot, atot, mtot, tsalt, taver, saver, eaver, ekin as 0-d float64
    tensors; sums cover the interior plus the four edges without the
    corners (advance.f:669-745), accumulated in float64, over the active
    region of a padded grid.  CUDA tensors are summed by the kernel
    (``kernels/diagsum.py``), CPU tensors by :func:`domain_stats_plain`."""
    if st.et.device.type == "cuda":
        return diagsum.domain_stats(grid, cfg, st, _regions(*cfg.active))
    return domain_stats_plain(grid, cfg, st)


def domain_stats_plain(grid: Grid, cfg: Config,
                       st: State) -> Dict[str, torch.Tensor]:
    """:func:`domain_stats` in plain PyTorch: each sum a :func:`_csum` of
    its cells."""
    kbm1 = cfg.kbm1
    ia, ja = cfg.active
    wide = lambda a: a[..., :ia, :ja].to(torch.float64)
    darea = wide(grid.dx) * wide(grid.dy) * wide(grid.fsm)

    def edge_sum(a2d):
        return _csum(torch.cat([
            a2d[1:-1, 1:-1].reshape(-1),
            a2d[0, 1:-1], a2d[-1, 1:-1], a2d[1:-1, 0], a2d[1:-1, -1]]))

    atot = edge_sum(darea)
    eavg = edge_sum(wide(st.et) * darea)
    eavg = torch.where(atot != 0, eavg / atot, 0.0)

    dt2 = wide(grid.h) + wide(st.et)
    dvol = darea[None] * dt2[None] * grid.dz3[:kbm1].to(torch.float64)

    def edge_sum3(a3d):
        return _csum(torch.cat([
            a3d[:, 1:-1, 1:-1].reshape(-1),
            a3d[:, 0, 1:-1].reshape(-1), a3d[:, -1, 1:-1].reshape(-1),
            a3d[:, 1:-1, 0].reshape(-1), a3d[:, 1:-1, -1].reshape(-1)]))

    vtot = edge_sum3(dvol)
    dmass = dvol * (wide(st.rho)[:kbm1] * cfg.rhoref + 1000.0)
    mtot = _csum(dmass[:, 1:-1, 1:-1])
    tavg = edge_sum3(wide(st.tb)[:kbm1] * dvol)
    stot = edge_sum3(wide(st.sb)[:kbm1] * dvol)
    tavg = torch.where(vtot != 0, tavg / vtot, 0.0)
    savg = torch.where(vtot != 0, stot / vtot, 0.0)

    ke = dmass * (wide(st.u)[:kbm1] ** 2 + wide(st.v)[:kbm1] ** 2)
    ekin = _csum(torch.cat([
        (0.5 * ke[:, 1:-1, 1:-1]).reshape(-1),
        ke[:, -1, 1:-1].reshape(-1), ke[:, 1:-1, -1].reshape(-1)]))

    return dict(vtot=vtot, atot=atot, mtot=mtot, tsalt=stot,
                taver=tavg, saver=savg, eaver=eavg, ekin=ekin)


def cfl_min(grid: Grid, cfg: Config) -> torch.Tensor:
    """Minimum external-mode CFL time step over water points
    (parallel_mpi.f:488-502): 0.5 / sqrt(1/dx^2 + 1/dy^2) / sqrt(g h)."""
    tps = (0.5 / torch.sqrt(1.0 / grid.dx ** 2 + 1.0 / grid.dy ** 2)
           / torch.sqrt(cfg.grav * torch.clamp(grid.h, min=1.0e-12)))
    big = torch.full((), 1.0e30, dtype=tps.dtype, device=tps.device)
    return torch.min(torch.where(grid.fsm > 0, tps, big))


def check_velocity(cfg: Config, vaf: torch.Tensor
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Blow-up detector: (max |vaf|, (i, j) of the max) over the active
    region."""
    ia, ja = cfg.active
    a = torch.abs(vaf[..., :ia, :ja])
    k = torch.argmax(a)
    return torch.max(a), (k // a.shape[1], k % a.shape[1])


def _regions(ia: int, ja: int) -> dict:
    """The global regions of :func:`domain_stats` on an active ia x ja
    grid, as ((i0, i1), (j0, j1)): the interior and the four edges without
    the corners (``edge``), the interior (``mass``), and the regions of
    the kinetic energy with their weights (``ke``)."""
    inner = ((1, ia - 1), (1, ja - 1))
    south, north = ((0, 1), (1, ja - 1)), ((ia - 1, ia), (1, ja - 1))
    west, east = ((1, ia - 1), (0, 1)), ((1, ia - 1), (ja - 1, ja))
    return {"edge": (inner, south, north, west, east), "mass": (inner,),
            "ke": ((inner, 0.5), (north, 1.0), (east, 1.0))}


def _cells(a: torch.Tensor, region, off, n) -> torch.Tensor:
    """The cells of global ``region`` in a block of ``n`` = (ni, nj) cells
    at global ``off``, flattened (empty where they miss the block)."""
    i0, i1, j0, j1 = diagsum.clip(region, off, n)
    return a[..., i0:i1, j0:j1].reshape(-1)


def domain_stats_blocks(blocks, cfg: Config) -> Dict[str, torch.Tensor]:
    """:func:`domain_stats` of a model decomposed over several processes
    (``mesh.shardmap.Blocks``): each rank forms the compensated sums of its
    blocks' cells of the same regions in float64 (:func:`_csum2`; on the
    card the kernel, ``kernels/diagsum.py:block_pairs``), and a compensated
    sum of every rank's (sum, error) pairs combines them; within 1e-12 of
    the single-process values.  CPU tensors of float64."""
    from extpom_tpu_torch.mesh import distributed
    reg = _regions(*cfg.active)
    # each rank's totals as (sum, error) pairs, summed again over the
    # ranks: a partial sum rounded to float64 would lose what cancels
    if blocks.device.type == "cuda":
        pairs = diagsum.block_pairs(blocks, cfg, reg)
        with span("sync"):
            mine = pairs.cpu()
    else:
        mine = _block_pairs_plain(blocks, cfg, reg)
    every = distributed.host_all_gather(mine)
    atot, eavg, vtot, mtot, tavg, stot, ekin = (
        _csum(torch.cat([t[k] for t in every])) for k in range(len(mine)))
    eavg = torch.where(atot != 0, eavg / atot, 0.0)
    tavg = torch.where(vtot != 0, tavg / vtot, 0.0)
    savg = torch.where(vtot != 0, stot / vtot, 0.0)
    return dict(vtot=vtot, atot=atot, mtot=mtot, tsalt=stot,
                taver=tavg, saver=savg, eaver=eavg, ekin=ekin)


def _block_pairs_plain(blocks, cfg: Config, reg: dict) -> torch.Tensor:
    """This process's (sum, error) pairs of :func:`domain_stats_blocks`'
    seven sums in plain PyTorch: a (7, 2) float64 tensor on the host."""
    n = (blocks.ni, blocks.nj)
    parts: dict = {k: [] for k in diagsum.SUMS}
    for b in blocks.ids:
        cells = block_cells(blocks.grid[b], blocks.state[b], cfg, reg,
                            blocks.goff(b, (0, 0)), n)
        for k, v in cells.items():
            parts[k] += v
    with span("sync"):
        mine = [torch.stack(_csum2(torch.cat(v))).cpu()
                for v in parts.values()]
    return torch.stack(mine)


def block_cells(g: Grid, st: State, cfg: Config, reg: dict, off,
                n) -> dict:
    """The float64 cells of each of the seven sums (``diagsum.SUMS``) in a
    block of ``n`` cells at global ``off``, as lists of flat tensors over
    the global regions ``reg`` (:func:`_regions`) cut to the block."""
    kbm1 = cfg.kbm1
    w = lambda a: a.to(torch.float64)
    edge = lambda a: [_cells(a, r, off, n) for r in reg["edge"]]
    darea = w(g.dx) * w(g.dy) * w(g.fsm)
    dvol = (darea[None] * (w(g.h) + w(st.et))[None]
            * g.dz3[:kbm1].to(torch.float64))
    dmass = dvol * (w(st.rho)[:kbm1] * cfg.rhoref + 1000.0)
    ke = dmass * (w(st.u)[:kbm1] ** 2 + w(st.v)[:kbm1] ** 2)
    return {"atot": edge(darea), "eavg": edge(w(st.et) * darea),
            "vtot": edge(dvol),
            "mtot": [_cells(dmass, r, off, n) for r in reg["mass"]],
            "tavg": edge(w(st.tb)[:kbm1] * dvol),
            "stot": edge(w(st.sb)[:kbm1] * dvol),
            "ekin": [c * _cells(ke, r, off, n) for r, c in reg["ke"]]}


def check_velocity_blocks(blocks, cfg: Config) -> Tuple[torch.Tensor,
                                                        Tuple[int, int]]:
    """:func:`check_velocity` of a model decomposed over several processes:
    each rank's largest |va| over its blocks' active cells and the global
    (i, j) of it, then the largest over the ranks, the first in row-major
    order among equals (as ``torch.argmax`` of the whole field) and a NaN
    before any number."""
    from extpom_tpu_torch.mesh import distributed
    ia, ja = cfg.active
    best = None
    for b in blocks.ids:
        (i0, i1), (j0, j1) = blocks.active_span(b)
        if i1 <= i0 or j1 <= j0:
            continue
        a = torch.abs(blocks.state[b].va[..., :i1 - i0, :j1 - j0])
        k = host_value(torch.argmax(a))
        i, j = i0 + k // a.shape[1], j0 + k % a.shape[1]
        cand = (host_value(torch.max(a)), i * ja + j)
        best = cand if best is None else _larger(best, cand)
    for cand in distributed.host_all_gather(best):
        if cand is not None:
            best = _larger(best, cand)
    vamax, k = best
    dtype = blocks.state[blocks.ids[0]].va.dtype
    return torch.tensor(vamax, dtype=dtype), (k // ja, k % ja)


def _larger(x: tuple, y: tuple) -> tuple:
    """The larger of two (value, flat index): a NaN first, then the value,
    then the lower index."""
    key = lambda c: (math.isnan(c[0]), 0.0 if math.isnan(c[0]) else c[0],
                     -c[1])
    return x if key(x) >= key(y) else y
