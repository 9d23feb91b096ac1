"""Vertical z-level -> sigma-level interpolation (host-side preprocessing;
``extpom_tpu/utils/interp.py``, numpy, copied so that the port imports
nothing of the JAX package).

The reference interpolates z-level climatology/IC data onto sigma levels with
a natural-cubic-spline column interpolation (``ztosig``/``splinc``/``splint``,
initialize.f:547-667).  It runs once at initialization (and is currently
commented out of the active path there, initialize.f:409-422), so this is
host-side NumPy: vectorized over all water columns instead of the reference's
per-column loops, no device involvement.

Array convention: 3-D fields are (ks|kb, im, jm) like the rest of the
framework (the reference uses (im, jm, k)).
"""

from __future__ import annotations

import numpy as np


def spline_coeffs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Second derivatives of the natural cubic spline through (x, y).

    Mirrors ``splinc`` (initialize.f:598-638) with the distributed defaults
    ``yp1 = ypn = 2e30`` (> .99e30 -> natural boundary conditions).

    x: (n,) strictly increasing knots; y: (n, ...) values per knot (any
    number of trailing column axes).  Returns y2 with y's shape.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.shape[0]
    if y.shape[0] != n:
        raise ValueError("x and y knot counts differ")
    y2 = np.zeros_like(y)
    u = np.zeros_like(y)
    # forward sweep (initialize.f:612-620)
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        u[i] = ((6.0 * ((y[i + 1] - y[i]) / (x[i + 1] - x[i])
                        - (y[i] - y[i - 1]) / (x[i] - x[i - 1]))
                 / (x[i + 1] - x[i - 1]) - sig * u[i - 1]) / p)
    # natural top/bottom: qn = un = 0 (initialize.f:622-629)
    y2[n - 1] = 0.0
    for k in range(n - 2, -1, -1):
        y2[k] = y2[k] * y2[k + 1] + u[k]
    return y2


def spline_eval(x: np.ndarray, y: np.ndarray, y2: np.ndarray,
                xq: np.ndarray) -> np.ndarray:
    """Evaluate the cubic spline at query points ``xq`` (``splint``,
    initialize.f:641-667).

    x: (n,) knots; y, y2: (n, ...) per-column values/second derivatives;
    xq: (m, ...) query depths per column (broadcastable against y's trailing
    axes).  Queries outside [x[0], x[-1]] extrapolate with the end cubic,
    exactly like the reference's bisection (klo/khi clamp to the end
    interval).
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    xq = np.asarray(xq, np.float64)
    # interval index: klo in [0, n-2] with x[klo] <= xq < x[klo+1] (clamped)
    klo = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, n - 2)
    khi = klo + 1
    h = x[khi] - x[klo]
    a = (x[khi] - xq) / h
    b = (xq - x[klo]) / h
    # gather per-column knot values at the selected interval
    ylo = np.take_along_axis(y, klo.astype(np.intp), axis=0) \
        if y.ndim == xq.ndim else y[klo]
    yhi = np.take_along_axis(y, khi.astype(np.intp), axis=0) \
        if y.ndim == xq.ndim else y[khi]
    y2lo = np.take_along_axis(y2, klo.astype(np.intp), axis=0) \
        if y2.ndim == xq.ndim else y2[klo]
    y2hi = np.take_along_axis(y2, khi.astype(np.intp), axis=0) \
        if y2.ndim == xq.ndim else y2[khi]
    return (a * ylo + b * yhi
            + ((a ** 3 - a) * y2lo + (b ** 3 - b) * y2hi) * (h ** 2) / 6.0)


def ztosig(zs: np.ndarray, tb: np.ndarray, zz: np.ndarray, h: np.ndarray,
           fill_threshold: float = 0.01,
           min_depth: float = 1.0) -> np.ndarray:
    """Interpolate z-level data onto sigma mid-layers (``ztosig``,
    initialize.f:547-595).

    zs: (ks,) positive z-level depths (increasing downward);
    tb: (ks, im, jm) z-level field; zz: (kb,) sigma mid-layers (negative);
    h: (im, jm) bottom depth.  Returns (kb, im, jm).

    Reproduces the reference's no-data repair: where a submerged level
    (zs <= h) has a value below ``fill_threshold`` it takes the max of the
    4 horizontal neighbors, then fills any remaining gap from the level
    above (initialize.f:563-572).  Columns shallower than ``min_depth`` and
    the outermost ring are zero in the interior pass; the ring is then
    copied from the adjacent row/column (edge fill, initialize.f:589-593).
    """
    zs = np.asarray(zs, np.float64)
    tb = np.asarray(tb, np.float64)
    zz = np.asarray(zz, np.float64)
    h = np.asarray(h, np.float64)
    ks, im, jm = tb.shape
    kb = zz.shape[0]

    # neighbor-max repair of missing values on submerged levels
    tin = tb.copy()
    nbmax = np.full_like(tb, -np.inf)
    nbmax[:, 1:, :] = np.maximum(nbmax[:, 1:, :], tb[:, :-1, :])
    nbmax[:, :-1, :] = np.maximum(nbmax[:, :-1, :], tb[:, 1:, :])
    nbmax[:, :, 1:] = np.maximum(nbmax[:, :, 1:], tb[:, :, :-1])
    nbmax[:, :, :-1] = np.maximum(nbmax[:, :, :-1], tb[:, :, 1:])
    submerged = zs[:, None, None] <= h[None]
    repair = submerged & (tin < fill_threshold)
    tin = np.where(repair, nbmax, tin)
    for k in range(1, ks):   # downward fill of still-missing values
        tin[k] = np.where(tin[k] < fill_threshold, tin[k - 1], tin[k])

    # per-column natural spline from z levels to sigma depths -zz*h
    cols = tin.reshape(ks, im * jm)
    y2 = spline_coeffs(zs, cols)
    zzh = (-zz[:, None] * h.reshape(1, im * jm))          # (kb, im*jm)
    tout = spline_eval(zs, cols, y2, zzh).reshape(kb, im, jm)

    out = np.zeros((kb, im, jm))
    wet = h > min_depth
    out[:, 1:-1, 1:-1] = np.where(wet[None, 1:-1, 1:-1], tout[:, 1:-1, 1:-1],
                                  0.0)
    # edge fill (initialize.f:589-593)
    out[:, 0, :] = out[:, 1, :]
    out[:, -1, :] = out[:, -2, :]
    out[:, :, 0] = out[:, :, 1]
    out[:, :, -1] = out[:, :, -2]
    return out
