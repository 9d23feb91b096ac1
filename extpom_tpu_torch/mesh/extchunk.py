"""Ring exchange of the decomposed step and its chunked external loop
(``extpom_tpu/mesh/extchunk.py``).

Every block of the step works on its own cells grown by a ring of its
neighbours' cells (:func:`_ring_extend`), runs a stage there with shifts
that stay local to the block and regions that are global (a
``DomainCtx``), and keeps the cells the ring covered.  The external loop
exchanges one ring of width ``C x ext_halo_sub`` per C substeps
(:func:`run_external_loop_chunked`), the temporal tiling of the JAX
package's shard_map path; a substep's stencil radius is 2 and the metrics
of ``ext_precompute`` add one, so ``ext_halo_sub`` = 3 covers it.

Fill beyond the physical domain: 0, as ``sft`` reads there, except for the
grid metrics that sit in denominators (``padding._GRID_PAD_ONE``), which
hold 1 so that the arithmetic of the ring stays finite; no committed cell
reads them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from extpom_tpu_torch.kernels import extloop, extwin


# the forcing fields the external loop reads (csrc/extloop.cu's operands)
EXT_FORCING = (extloop.FC_2D_FIELDS + extloop.FC_1D_J + extloop.FC_1D_I)


def _ring_extend(vals: dict, b, hx: int, hy: int,
                 fill: float = 0.0) -> torch.Tensor:
    """Block ``b``'s (.., ni, nj) tensor of ``vals`` (block -> tensor)
    grown to (.., ni + 2 hx, nj + 2 hy) by its neighbours' edge cells, the
    diagonal neighbours' in the corners (what an x exchange followed by a y
    exchange of the x-extended block gives); ``fill`` where no block is.
    A ring wider than the block raises: its cells would come from blocks
    further away."""
    a = vals[b]
    ni, nj = a.shape[-2:]
    if hx > ni or hy > nj:
        raise ValueError(f"a ring of ({hx}, {hy}) cells is wider than the "
                         f"({ni}, {nj}) block it would be read from")
    if not (hx or hy):
        return a
    out = a.new_full(a.shape[:-2] + (ni + 2 * hx, nj + 2 * hy), fill)
    bi, bj = b
    # (source cells of the neighbour, destination cells) along one axis,
    # for the neighbour before, the block itself and the neighbour after
    spans_i = [(slice(ni - hx, ni), slice(0, hx)),
               (slice(0, ni), slice(hx, hx + ni)),
               (slice(0, hx), slice(hx + ni, 2 * hx + ni))]
    spans_j = [(slice(nj - hy, nj), slice(0, hy)),
               (slice(0, nj), slice(hy, hy + nj)),
               (slice(0, hy), slice(hy + nj, 2 * hy + nj))]
    for di, (si, ti) in zip((-1, 0, 1), spans_i):
        for dj, (sj, tj) in zip((-1, 0, 1), spans_j):
            q = (bi + di, bj + dj)
            if (di and not hx) or (dj and not hy) or q not in vals:
                continue
            out[..., ti, tj] = vals[q][..., si, sj]
    return out


def _ring_extend_1d(vals: dict, b, h: int, axis: str) -> torch.Tensor:
    """A per-side boundary series (.., n) of block ``b``, along i
    (``axis="x"``) or j (``"y"``), grown by ``h`` cells of its neighbours'
    on each side; 0 beyond the domain."""
    a = vals[b]
    if not h:
        return a
    n = a.shape[-1]
    if h > n:
        raise ValueError(f"a ring of {h} cells is wider than the {n} cells "
                         f"it would be read from")
    step = (1, 0) if axis == "x" else (0, 1)
    lo = vals.get((b[0] - step[0], b[1] - step[1]))
    hi = vals.get((b[0] + step[0], b[1] + step[1]))
    z = a.new_zeros(a.shape[:-1] + (h,))
    return torch.cat([z if lo is None else lo[..., n - h:], a,
                      z if hi is None else hi[..., :h]], dim=-1)


def _chunk(cfg, px: int, py: int, ni: int, nj: int) -> int:
    """Substeps per ring exchange: the largest divisor C of isplit, up to
    ``extwin_chunk``, whose ring C x ext_halo_sub fits the extents of a
    (ni, nj) block on the axes that carry a ring (split or padded,
    ``padding.ring_axes``); 1 with ``ext_local_chunk="off"``."""
    from extpom_tpu_torch.mesh.padding import ring_axes
    lim = cfg.isplit * cfg.ext_halo_sub
    on_i, on_j = ring_axes(cfg, px, py)
    if on_i:
        lim = min(lim, ni)
    if on_j:
        lim = min(lim, nj)
    top = 1 if cfg.ext_local_chunk == "off" else min(cfg.extwin_chunk,
                                                     cfg.isplit)
    for C in range(top, 0, -1):
        if cfg.isplit % C == 0 and C * cfg.ext_halo_sub <= lim:
            return C
    raise ValueError(f"a ring of {cfg.ext_halo_sub} cells is wider than the "
                     f"({ni}, {nj}) block it would be read from")


class ChunkPlan(NamedTuple):
    """Substeps per ring exchange C, ring (hx, hy), extended block (R, L),
    the machine of a chunk (``plain``, ``cuda-extchunk`` for
    ``extloop.run_external_chunk``, ``cuda-extwin-chunk`` for
    ``extwin.run_external_chunk_windowed``) and the window kernel's
    geometry."""
    C: int
    hx: int
    hy: int
    R: int
    L: int
    machine: str
    geo: Optional[extwin.Geometry]


def chunk_plan(cfg, px: int, py: int, ni: int, nj: int, device,
               itemsize: int) -> ChunkPlan:
    """The external loop's decisions for (ni, nj) blocks on a (px, py)
    mesh: on the card the whole-block chain while the extended block's
    working set fits the L2, the window kernel beyond it (the choice
    ``extwin.use_windowed`` makes for a whole grid).  Shared by the runner
    and the dispatch report."""
    from extpom_tpu_torch.mesh.padding import ring_axes
    C = _chunk(cfg, px, py, ni, nj)
    H = C * cfg.ext_halo_sub
    on_i, on_j = ring_axes(cfg, px, py)
    hx, hy = (H if on_i else 0), (H if on_j else 0)
    R, L = ni + 2 * hx, nj + 2 * hy
    device = torch.device(device)
    geo = None
    if device.type != "cuda":
        machine = "plain"
    elif extwin.use_win_chunk(R, L, itemsize, extwin.l2_bytes(device)):
        machine, geo = "cuda-extwin-chunk", extwin.win_geometry(
            C, itemsize, extloop.ext_flags(cfg))
    else:
        machine = "cuda-extchunk"
    return ChunkPlan(C, hx, hy, R, L, machine, geo)


def run_external_loop_chunked(blocks, cfg, carry: dict, aux: dict, fc):
    """The isplit external substeps of every block of ``blocks``
    (``mesh.shardmap.Blocks``): per C substeps, ring-extend each block's
    carry from its neighbours' current carry, run the chunk on the
    extended block and trim the ring.  ``carry`` and ``aux`` map a block
    to its ``ExtCarry`` and its (adx2d, ady2d, drx2d, dry2d, aam2d); the
    static operands are extended once, and the step's forcing ``fc``
    (``mesh.shardmap.BlockForcing``: wind stress, vflux, e_atmos, the
    lateral series of bcond and bc_el, and the ramp) is read at the
    chunk's own ring.  Returns the new carry dict."""
    from extpom_tpu_torch.core.stepper import ExtCarry
    el = next(iter(carry.values())).el
    plan = chunk_plan(cfg, blocks.px, blocks.py, blocks.ni, blocks.nj,
                      el.device, el.element_size())
    h = (plan.hx, plan.hy)
    aux_e = {b: tuple(blocks.ext({q: aux[q][k] for q in blocks.ids}, b, h)
                      for k in range(len(aux[b])))
             for b in blocks.ids}
    for ic in range(cfg.isplit // plan.C):
        new = {}
        for b in blocks.ids:
            c = ExtCarry(*(blocks.ext({q: carry[q][k] for q in blocks.ids},
                                      b, h)
                           for k in range(len(ExtCarry._fields))))
            args = (blocks.grid_ext(b, h), cfg, c,
                    fc.ext(b, h, EXT_FORCING),
                    aux_e[b],
                    plan.C, ic * plan.C + 1, blocks.goff(b, h))
            if plan.machine == "cuda-extwin-chunk":
                c = extwin.run_external_chunk_windowed(*args, geo=plan.geo)
            else:
                c = extloop.run_external_chunk(*args)
            new[b] = ExtCarry(*(blocks.trim(x, h) for x in c))
        carry = new
    return carry
