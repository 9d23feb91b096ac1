"""Compensated float64 sums of a print's diagnostics: the CUDA kernels
``csrc/diagsum.cu`` (``k_diag_sums``, ``k_diag_finish``) behind
``diag/stats.py:domain_stats`` and ``domain_stats_blocks`` on the card.

One pass over the state forms each cell's float64 value as
``domain_stats`` forms it and adds it, by Knuth's TwoSum, into seven
(sum, error) pairs (:data:`SUMS`); the blocks of the launch leave one row
of pairs each in a partials buffer, and one more launch combines the rows
in a fixed order into the seven pairs and the eight values of
``domain_stats`` (:data:`NAMES`), one float64 buffer on the card
(:func:`finish`).  A decomposed model's blocks each add their rows to one
buffer, given the block's global offset (:func:`block_pairs`).  The plain
version is ``diag/stats.py:domain_stats_plain``, which the CPU runs.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from extpom_tpu_torch.kernels import build

# the pairs in the order of the kernel's rows (domain_stats_blocks' order)
SUMS = ("atot", "eavg", "vtot", "mtot", "tavg", "stot", "ekin")
# the values after the pairs: domain_stats' dict
NAMES = ("vtot", "atot", "mtot", "tsalt", "taver", "saver", "eaver", "ekin")
PAIR = 2 * len(SUMS)


def clip(region, off, n) -> tuple:
    """``region`` = ((i0, i1), (j0, j1)) of the global grid as the local
    (i0, i1, j0, j1) of a block of ``n`` = (ni, nj) cells at global ``off``
    (``diag/stats.py:_cells`` cuts the block's cells so); (0, 0, 0, 0)
    where it misses the block."""
    (i0, i1), (j0, j1) = region
    li0, li1 = max(i0 - off[0], 0), min(i1 - off[0], n[0])
    lj0, lj1 = max(j0 - off[1], 0), min(j1 - off[1], n[1])
    if li1 <= li0 or lj1 <= lj0:
        return (0, 0, 0, 0)
    return (li0, li1, lj0, lj1)


def pack(reg: dict, active, off, n) -> list:
    """The kernel's region table for a block of ``n`` cells at global
    ``off`` of an ``active`` = (ia, ja) grid whose regions ``reg`` are
    ``diag/stats.py:_regions``: the active box, then the interior, south,
    north, west and east rectangles, each (i0, i1, j0, j1) in the block's
    cells.  The kernel takes mtot over the interior and ekin over half the
    interior and the north and east edges: raises where ``reg`` says
    otherwise."""
    inner, south, north, west, east = reg["edge"]
    if (reg["mass"] != (inner,)
            or reg["ke"] != ((inner, 0.5), (north, 1.0), (east, 1.0))):
        raise ValueError("diagsum: the regions are not the kernel's")
    box = clip(((0, active[0]), (0, active[1])), off, n)
    return [*box, *(e for r in (inner, south, north, west, east)
                    for e in clip(r, off, n))]


def operands(grid, st) -> tuple:
    """(tensors, strides) of a launch: dx, dy, fsm, h, et, rho, tb, sb, u,
    v, dz, and the element strides of each, (i, j) of the 2-D operands,
    (k, i, j) of the 3-D ones, dz's.  Raises unless all share one dtype
    (float32 or float64) and device."""
    two = (grid.dx, grid.dy, grid.fsm, grid.h, st.et)
    three = (st.rho, st.tb, st.sb, st.u, st.v)
    xs = (*two, *three, grid.dz)
    dtype, device = st.et.dtype, st.et.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"diagsum: dtype {dtype} not supported")
    if any(x.dtype != dtype or x.device != device for x in xs):
        raise TypeError("diagsum: operands differ in dtype or device")
    if (any(x.dim() != 2 or x.shape != two[0].shape for x in two)
            or any(x.dim() != 3 or x.shape[1:] != two[0].shape
                   for x in three) or grid.dz.dim() != 1):
        raise ValueError("diagsum: operand shapes do not agree")
    return xs, [s for x in xs for s in x.stride()]


@functools.lru_cache(maxsize=None)
def _info(f64: bool, device: int) -> dict:
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        status = build.library().extpom_diag_sums_info(
            int(f64), ctypes.cast(out, ctypes.c_void_p))
    build.check(status, "diag sums info")
    return dict(zip(("threads", "registers", "static_smem", "dynamic_smem",
                     "blocks_per_sm", "spill_bytes", "sms"), out))


def kernel_info(dtype: torch.dtype, device=None) -> dict:
    """What the compiler and the card give ``k_diag_sums`` in ``dtype``:
    threads per block, registers, static and dynamic shared bytes, resident
    blocks per SM, spill bytes, SMs.  Builds the kernels; needs a CUDA
    device."""
    device = torch.device("cuda" if device is None else device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _info(dtype == torch.float64, index)


def rows(geo: list, dtype: torch.dtype, device) -> int:
    """Rows a launch on the box of ``geo`` writes: its blocks, one wave of
    resident blocks at most and no more than the box's columns need (0 for
    an empty box)."""
    cols = (geo[1] - geo[0]) * (geo[3] - geo[2])
    if cols <= 0:
        return 0
    info = kernel_info(dtype, device)
    return min(math.ceil(cols / info["threads"]),
               info["sms"] * info["blocks_per_sm"])


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_sums(grid, st, nk: int, rhoref: float, geo: list,
                part: torch.Tensor, row: int) -> int:
    """Launch ``k_diag_sums`` over the cells of ``geo`` (:func:`pack`),
    writing its rows of pairs into ``part`` (a float64 [rows, 14] buffer)
    from ``row`` on; returns the rows written."""
    xs, strides = operands(grid, st)
    if not 1 <= nk <= min(st.u.shape[0], grid.dz.shape[0]):
        raise ValueError(f"diagsum: {nk} levels of {st.u.shape[0]}")
    n = rows(geo, xs[0].dtype, xs[0].device)
    if n == 0:
        return 0
    if part.shape[0] < row + n or part.shape[1:] != (PAIR,):
        raise ValueError("diagsum: the partials buffer is too small")
    ptrs = [x.data_ptr() for x in xs] + [part[row].data_ptr()]
    lib = build.library()
    fn = lib.extpom_diag_sums_f32 if xs[0].dtype == torch.float32 \
        else lib.extpom_diag_sums_f64
    with torch.cuda.device(xs[0].device):
        status = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
                    (ctypes.c_longlong * len(strides))(*strides),
                    (ctypes.c_int * len(geo))(*geo), float(rhoref), nk, n,
                    _stream(xs[0].device))
    build.check(status, "diag sums kernel")
    return n


def finish(part: torch.Tensor) -> torch.Tensor:
    """The rows of ``part`` combined by ``k_diag_finish``: a float64 buffer
    on the card holding the seven pairs (:data:`SUMS`, sum then error) and
    the values of :data:`NAMES`."""
    out = torch.empty(PAIR + len(NAMES), dtype=torch.float64,
                      device=part.device)
    with torch.cuda.device(part.device):
        status = build.library().extpom_diag_finish(
            part.data_ptr(), part.shape[0], out.data_ptr(),
            _stream(part.device))
    build.check(status, "diag finish kernel")
    return out


def _run(cases, nk: int, rhoref: float) -> torch.Tensor:
    """:func:`finish` of the rows of every (grid, state, region table) of
    ``cases``, launched in order into one partials buffer."""
    x = cases[0][1].et
    counts = [rows(geo, x.dtype, x.device) for _, _, geo in cases]
    part = torch.empty((max(sum(counts), 1), PAIR), dtype=torch.float64,
                       device=x.device)
    if sum(counts) == 0:
        part.zero_()
    row = 0
    for grid, st, geo in cases:
        row += launch_sums(grid, st, nk, rhoref, geo, part, row)
    return finish(part)


def domain_stats(grid, cfg, st, reg: dict) -> dict:
    """``diag/stats.py:domain_stats`` on the card over the regions ``reg``
    (``_regions`` of the active grid): one launch of each kernel, and a
    dict of 0-d float64 tensors, views of one buffer on the card."""
    geo = pack(reg, cfg.active, (0, 0), tuple(st.et.shape))
    out = _run([(grid, st, geo)], cfg.kbm1, cfg.rhoref)
    return {k: out[PAIR + q] for q, k in enumerate(NAMES)}


def block_pairs(blocks, cfg, reg: dict) -> torch.Tensor:
    """This process's (sum, error) pairs of the seven sums over its blocks'
    cells (``mesh.shardmap.Blocks``, each block's regions cut at its global
    offset): a float64 (7, 2) tensor on the card, in the order of
    :data:`SUMS`."""
    n = (blocks.ni, blocks.nj)
    out = _run([(blocks.grid[b], blocks.state[b],
                 pack(reg, cfg.active, blocks.goff(b, (0, 0)), n))
                for b in blocks.ids], cfg.kbm1, cfg.rhoref)
    return out[:PAIR].view(len(SUMS), 2)
