"""Shifted-slice stencil primitives on global arrays
(``extpom_tpu/ops/stencil.py``, global mode only).

* :func:`sft` -- zero-filled shifted read: ``sft(a, di, dj)[..., i, j] ==
  a[..., i+di, j+dj]`` and 0 outside the array (Fortran ``a(i-1,j)`` is
  ``sft(a, -1, 0)``).
* :func:`put` -- region-limited commit: a full-shape expression is written
  onto a copy of the base only on the region the Fortran loop covered.

The i axis is ``-2`` and the j axis ``-1``; 3-D arrays are (kb, im, jm).
"""

from __future__ import annotations

import torch


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


def put(base: torch.Tensor, expr, *region) -> torch.Tensor:
    """Commit ``expr`` onto a copy of ``base`` over ``region`` (ints or
    slices on the leading ``len(region)`` axes of ``base``, numpy-style);
    elsewhere keep ``base``."""
    expr = torch.as_tensor(expr, dtype=base.dtype, device=base.device)
    shape = torch.broadcast_shapes(base.shape, expr.shape)
    if len(shape) != base.dim():
        raise ValueError(f"put: expression {tuple(expr.shape)} widens base "
                         f"{tuple(base.shape)}")
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


def set_i(base: torch.Tensor, i: int, val,
          j=slice(None), k=slice(None)) -> torch.Tensor:
    """Set row ``i`` (axis -2) to ``val``, restricted to ``j`` (and ``k``
    on 3-D bases)."""
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


def row(a: torch.Tensor, i: int) -> torch.Tensor:
    """``a[..., i, :]``."""
    return a[..., i % a.shape[-2], :]


def col(a: torch.Tensor, j: int) -> torch.Tensor:
    """``a[..., :, j]``."""
    return a[..., :, j % a.shape[-1]]

