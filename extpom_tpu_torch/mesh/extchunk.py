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


def _spans(n: int, h: int) -> dict:
    """Along one axis of n cells grown by h: (source cells of the
    neighbour, destination cells) for the neighbour before (-1), the block
    itself (0) and the neighbour after (1)."""
    return {-1: (slice(n - h, n), slice(0, h)),
            0: (slice(0, n), slice(h, h + n)),
            1: (slice(0, h), slice(h + n, 2 * h + n))}


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
    spans_i, spans_j = _spans(ni, hx), _spans(nj, hy)
    for di, (si, ti) in spans_i.items():
        for dj, (sj, tj) in spans_j.items():
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


# the eight neighbours, in the order both sides of an exchange pack them
_DIRS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
         (1, 1))


def _reads(axis, d, h, n) -> Optional[tuple]:
    """(source index in the neighbour, destination index in the extended
    tensor) of the cells that a block's ring of ``h`` = (hx, hy) reads from
    its neighbour in direction ``d``, for a field over (.., ni, nj) (``axis``
    None, ``n`` = (ni, nj)) or a per-side series along i (``"x"``, ``n`` =
    (ni,)) or j (``"y"``, ``n`` = (nj,)); None where it reads none."""
    di, dj = d
    if axis is None:
        if (di and not h[0]) or (dj and not h[1]):
            return None
        (si, ti), (sj, tj) = _spans(n[0], h[0])[di], _spans(n[1], h[1])[dj]
        return (..., si, sj), (..., ti, tj)
    k = 0 if axis == "x" else 1
    if d[1 - k] or not h[k]:
        return None
    s, t = _spans(n[0], h[k])[d[k]]
    return (..., s), (..., t)


def ring_extend_all(fields: list, h, owner: dict, rank: int,
                    fills=0.0, axes=None) -> list:
    """The collective :func:`_ring_extend` (and :func:`_ring_extend_1d`) of
    every field of ``fields`` (each a dict: this rank's block -> tensor) on
    every block this rank owns, with the neighbours' cells from whichever
    rank owns them (``owner``: block -> rank, the whole mesh): the blocks
    of this rank are copied from, and for each other rank all strips of
    all fields go in one buffer each way (``distributed.exchange``).  The
    corners come from the diagonal neighbours, so the result is bit-equal
    to the in-process ring.  ``fills`` and ``axes`` give each field its
    fill and, for a per-side series, its axis ("x", "y"; None for a field
    over (.., ni, nj)).  Every rank must make the same calls in the same
    order.  Returns a list of dicts, one per field."""
    from extpom_tpu_torch.mesh import distributed
    nf = len(fields)
    fills = [fills] * nf if not isinstance(fills, (list, tuple)) else fills
    axes = [None] * nf if axes is None else axes
    hx, hy = h
    if not (hx or hy) or not nf:
        return [dict(f) for f in fields]
    ids = sorted(fields[0])
    first = fields[0][ids[0]]
    device, dtype = first.device, first.dtype
    size = {None: first.shape[-2:]}
    for f, ax in zip(fields, axes):
        a = f[ids[0]]
        if a.dtype != dtype:
            raise ValueError(f"one exchange of {dtype} and {a.dtype} fields")
        if ax is not None:
            size[ax] = a.shape[-1:]
    ni, nj = size[None]
    if hx > ni or hy > nj:
        raise ValueError(f"a ring of ({hx}, {hy}) cells is wider than the "
                         f"({ni}, {nj}) block it would be read from")
    n_of = lambda ax: size[ax] if ax is not None else (ni, nj)
    out = []
    for f, ax, fill in zip(fields, axes, fills):
        ext = {}
        for b in ids:
            a = f[b]
            if ax is None:
                e = a.new_full(a.shape[:-2] + (ni + 2 * hx, nj + 2 * hy),
                               fill)
                e[..., hx:hx + ni, hy:hy + nj] = a
            else:
                k = hx if ax == "x" else hy
                e = a.new_zeros(a.shape[:-1] + (a.shape[-1] + 2 * k,))
                e[..., k:k + a.shape[-1]] = a
            ext[b] = e
        out.append(ext)
    # what this rank's blocks read from each other rank, in its packing
    # order: block (row-major), direction, field
    pending: dict = {}
    for b in ids:
        for d in _DIRS:
            q = (b[0] + d[0], b[1] + d[1])
            if q not in owner:
                continue
            for k, ax in enumerate(axes):
                rd = _reads(ax, d, h, n_of(ax))
                if rd is None:
                    continue
                if owner[q] == rank:
                    out[k][b][rd[1]] = fields[k][q][rd[0]]
                else:
                    pending.setdefault(owner[q], []).append((k, b, rd[1]))
    if not pending:
        return out
    # what each other rank's blocks read from this rank's, in that rank's
    # packing order
    send: dict = {}
    for p in sorted(owner):
        r = owner[p]
        if r == rank:
            continue
        for d in _DIRS:
            q = (p[0] + d[0], p[1] + d[1])
            if owner.get(q) != rank:
                continue
            for k, ax in enumerate(axes):
                rd = _reads(ax, d, h, n_of(ax))
                if rd is not None:
                    send.setdefault(r, []).append(
                        fields[k][q][rd[0]].reshape(-1))
    send = {r: torch.cat(s) for r, s in send.items()}
    numel = {r: sum(out[k][b][t].numel() for k, b, t in lst)
             for r, lst in pending.items()}
    got = distributed.exchange(send, numel, device, dtype)
    for r, lst in pending.items():
        o = 0
        for k, b, t in lst:
            dst = out[k][b][t]
            dst.copy_(got[r][o:o + dst.numel()].view(dst.shape))
            o += dst.numel()
    return out


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
    carry from its neighbours' current carry (the 14 fields of every block
    in one exchange), run the chunk on the extended block and trim the
    ring; ``aux`` is extended once per step.  ``carry`` and ``aux`` map a block
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
    ids = blocks.ids
    aux_e = blocks.ext_all([{q: aux[q][k] for q in ids}
                            for k in range(len(aux[ids[0]]))], h)
    aux_e = {b: tuple(a[b] for a in aux_e) for b in ids}
    for ic in range(cfg.isplit // plan.C):
        ext = blocks.ext_all([{q: carry[q][k] for q in ids}
                              for k in range(len(ExtCarry._fields))], h)
        new = {}
        for b in ids:
            c = ExtCarry(*(e[b] for e in ext))
            args = (blocks.grid_ext(b, h), cfg, c,
                    fc.ext(b, h, EXT_FORCING),
                    aux_e[b],
                    plan.C, ic * plan.C + 1, blocks.goff(b, h))
            if plan.machine == "cuda-extwin-chunk":
                c = extwin.run_external_chunk_windowed(*args, geo=plan.geo)
            else:
                c = extloop.run_external_chunk(*args)
            new[b] = ExtCarry(*(blocks.trim(x, h) for x in c))
        del ext
        carry = new
    return carry
