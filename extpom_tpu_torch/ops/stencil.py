"""Shifted-slice stencil primitives (``extpom_tpu/ops/stencil.py``).

* :func:`sft` -- zero-filled shifted read: ``sft(a, di, dj)[..., i, j] ==
  a[..., i+di, j+dj]`` and 0 outside the array (Fortran ``a(i-1,j)`` is
  ``sft(a, -1, 0)``).
* :func:`put` -- region-limited commit: a full-shape expression is written
  onto a copy of the base only on the region the Fortran loop covered.

The i axis is ``-2`` and the j axis ``-1``; 3-D arrays are (kb, im, jm).

Arrays are the whole domain unless a :class:`DomainCtx` is installed with
:func:`domain`: then they are one ring-extended block of it (the decomposed
step, ``mesh/shardmap.py``), or a whole domain padded beyond its active
extents (:func:`domain_of`, ``mesh/padding.py``); shifts stay local to the
array, and the regions of :func:`put`, :func:`set_i` and :func:`set_j` and
the rows of :func:`row` and :func:`col` are read as those of the GLOBAL
active domain and mapped onto the array's slice of it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class DomainCtx:
    """The block the stencil primitives work on: the global extents ``im``
    and ``jm`` and the global (i, j) of the block's cell (0, 0), which is
    negative by the ring width on a block at the domain's low edge.  It is
    the JAX package's ``windowed`` context; the port has no other kind."""

    im: int
    jm: int
    off_i: int = 0
    off_j: int = 0


_tls = threading.local()


def domain_ctx() -> Optional[DomainCtx]:
    """The installed :class:`DomainCtx`, or None for whole-domain arrays."""
    return getattr(_tls, "domain", None)


@contextlib.contextmanager
def domain(ctx: Optional[DomainCtx]):
    """Install ``ctx`` for the enclosed calls."""
    prev = domain_ctx()
    _tls.domain = ctx
    try:
        yield
    finally:
        _tls.domain = prev


def domain_of(cfg, off=None):
    """The context of the arrays of a possibly padded ``cfg``: with ``off``
    the block whose cell (0, 0) is global ``off``; without, the whole
    domain, under ``DomainCtx(im_act, jm_act)`` where it is padded and no
    context where it is not.  Regions resolve against the active
    extents."""
    im, jm = cfg.active
    if off is not None:
        return domain(DomainCtx(im, jm, *off))
    return domain(None if (im, jm) == (cfg.im, cfg.jm) else DomainCtx(im, jm))


class _RegionBuilder:
    """``s_[KM1, 1:-1, :]`` -> a tuple of region entries."""

    def __getitem__(self, item):
        return item if isinstance(item, tuple) else (item,)


s_ = _RegionBuilder()


def _shift1(a: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """out[i] = a[i+d] along ``axis``, 0 outside."""
    if d == 0:
        return a
    n = a.shape[axis]
    out = torch.zeros_like(a)
    if abs(d) >= n:
        return out
    if d > 0:
        out.narrow(axis, 0, n - d).copy_(a.narrow(axis, d, n - d))
    else:
        out.narrow(axis, -d, n + d).copy_(a.narrow(axis, 0, n + d))
    return out


def sft(a: torch.Tensor, di: int = 0, dj: int = 0) -> torch.Tensor:
    """Horizontal shifted read ``out[..., i, j] = a[..., i+di, j+dj]``,
    zero outside the array."""
    return _shift1(_shift1(a, di, -2), dj, -1)


def sfk(a: torch.Tensor, dk: int) -> torch.Tensor:
    """Vertical shifted read along the leading k axis: out[k] = a[k+dk]."""
    return _shift1(a, dk, 0)


def _local(n: int, r, n_act: int, off: int) -> slice:
    """Region entry ``r`` of a global axis of ``n_act`` cells, as a slice of
    a block of ``n`` cells whose first cell is global ``off``: ``-1`` and
    ``slice(1, -1)`` name global rows, not the block's own."""
    if isinstance(r, int):
        lo = r % n_act
        hi = lo + 1
    else:
        lo, hi, step = r.indices(n_act)
        if step != 1:
            raise ValueError("strided regions are not supported")
    lo = min(max(lo - off, 0), n)
    return slice(lo, max(min(hi - off, n), lo))


def _region(shape, region) -> tuple:
    """``region`` as an index of an array of ``shape``: unchanged for
    whole-domain arrays, mapped onto the block under a DomainCtx."""
    ctx = domain_ctx()
    if ctx is None:
        return region
    nd = len(shape)
    out = []
    for ax, r in enumerate(region):
        if ax == nd - 2:
            r = _local(shape[ax], r, ctx.im, ctx.off_i)
        elif ax == nd - 1:
            r = _local(shape[ax], r, ctx.jm, ctx.off_j)
        out.append(r)
    return tuple(out)


def put(base: torch.Tensor, expr, *region) -> torch.Tensor:
    """Commit ``expr`` onto a copy of ``base`` over ``region`` (ints or
    slices on the leading ``len(region)`` axes of ``base``, numpy-style);
    elsewhere keep ``base``."""
    expr = torch.as_tensor(expr, dtype=base.dtype, device=base.device)
    shape = torch.broadcast_shapes(base.shape, expr.shape)
    if len(shape) != base.dim():
        raise ValueError(f"put: expression {tuple(expr.shape)} widens base "
                         f"{tuple(base.shape)}")
    region = _region(shape, region)
    out = base.expand(shape).clone()
    out[region] = expr.expand(shape)[region]
    return out


def _edge(base: torch.Tensor, val, axis: int, idx: int) -> torch.Tensor:
    """A full-shape or slice-shaped edge value, reduced to the slice
    ``idx`` on ``axis`` (a full-shape expression commits its own row)."""
    val = torch.as_tensor(val, dtype=base.dtype, device=base.device)
    if val.dim() == base.dim():
        n = base.shape[axis]
        return val.select(axis, idx % n if val.shape[axis] != 1 else 0)
    return val


def _row(base: torch.Tensor, idx: int, axis: int) -> Optional[int]:
    """Global row (axis -2) or column (axis -1) ``idx`` as an index of
    ``base``: itself for whole-domain arrays, the block's local index under
    a DomainCtx, None when the block does not hold it."""
    ctx = domain_ctx()
    if ctx is None:
        return idx
    n_act, off = (ctx.im, ctx.off_i) if axis == -2 else (ctx.jm, ctx.off_j)
    loc = idx % n_act - off
    return loc if 0 <= loc < base.shape[axis] else None


def set_i(base: torch.Tensor, i: int, val,
          j=slice(None), k=slice(None)) -> torch.Tensor:
    """Set row ``i`` (axis -2) to ``val``, restricted to ``j`` (and ``k``
    on 3-D bases)."""
    i = _row(base, i, -2)
    if i is None:
        return base
    j = _region(base.shape[-2:], (slice(None), j))[1]
    row_val = _edge(base, val, -2, i)
    out = base.clone()
    if base.dim() == 2:
        out[i, j] = torch.broadcast_to(row_val, out[i].shape)[j]
    else:
        out[k, i, j] = torch.broadcast_to(row_val, out[:, i].shape)[k, j]
    return out


def set_j(base: torch.Tensor, j: int, val,
          i=slice(None), k=slice(None)) -> torch.Tensor:
    """Set column ``j`` (axis -1) to ``val``, restricted to ``i`` (and
    ``k`` on 3-D bases)."""
    j = _row(base, j, -1)
    if j is None:
        return base
    i = _region(base.shape[-2:], (i, slice(None)))[0]
    col_val = _edge(base, val, -1, j)
    out = base.clone()
    if base.dim() == 2:
        out[i, j] = torch.broadcast_to(col_val, out[:, j].shape)[i]
    else:
        out[k, i, j] = torch.broadcast_to(col_val, out[:, :, j].shape)[k, i]
    return out


def set_k(base: torch.Tensor, k: int, val) -> torch.Tensor:
    """Set level ``k`` (axis 0 of a (kb, ...) array) to ``val``."""
    out = base.clone()
    out[k] = torch.as_tensor(val, dtype=base.dtype, device=base.device)
    return out


def _global_index(a: torch.Tensor, idx: int, axis: int, what: str) -> int:
    """Global row (axis -2) or column (axis -1) ``idx`` as an index of
    ``a``; under a DomainCtx a block that does not hold it raises."""
    loc = _row(a, idx, axis)
    if loc is None:
        raise RuntimeError(f"{what}() reads global index {idx}, which this "
                           f"block does not hold; blocks use sft and "
                           f"set_i/set_j instead")
    return loc


def row(a: torch.Tensor, i: int) -> torch.Tensor:
    """``a[..., i, :]``, ``i`` a row of the active domain."""
    return a[..., _global_index(a, i, -2, "row"), :]


def col(a: torch.Tensor, j: int) -> torch.Tensor:
    """``a[..., :, j]``, ``j`` a column of the active domain."""
    return a[..., :, _global_index(a, j, -1, "col")]
