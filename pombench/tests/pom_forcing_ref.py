"""Loop transcriptions of what a forced run adds to the step, in the style
of ``pom_ref.py`` beside this file (whose frozen copy this file leaves as
it is): NumPy, one loop per index, written from POM's bounds_forcing.f.

- ``bcond_vel3d_ref``: bcond(3), the internal velocity of the open edges
  (bounds_forcing.f:85-149);
- ``restore_interior_ref``: the interior restoring of T and S
  (bounds_forcing.f:1023-1121);
- ``record_ref``, ``series_at_ref``, ``depth_mean_ref`` and
  ``forcing_ref``: lateral_bc's, wind's, heat's, surface's and
  restore_interior's record pair and linear time interpolation at the time
  get_time gives a step (bounds_forcing.f:593-1121; :841-865 for the
  interpolation, :626-635 for the depth-mean edge velocities).

Indices are 0-based: row ``i = 0`` is Fortran's ``i = 1``.
"""

import numpy as np


def _smooth_ref(a, n):
    """The 1-2-1 average of ``a`` (a sequence) at ``n``."""
    return 0.25 * a[n - 1] + 0.5 * a[n] + 0.25 * a[n + 1]


def bcond_vel3d_ref(uf_in, vf_in, u, v, d, fc, hmax, dum, dvm, kbm1):
    """bcond idx=3: on levels k < kbm1 each edge's normal velocity is
    ga * (the old velocity one cell in) + (1 - ga) * (the edge profile),
    both smoothed 1-2-1 along the edge, ga = sqrt(d / hmax) at the edge's
    outer cell; its tangential velocity is the profile.  East, west,
    south, north, then the dum/dvm mask."""
    uf = np.array(uf_in, dtype=np.float64)
    vf = np.array(vf_in, dtype=np.float64)
    kb, im, jm = uf.shape
    for k in range(kbm1):
        for j in range(1, jm - 1):
            # east: the edge face reads u one row in
            ga = np.sqrt(d[im - 1, j] / hmax)
            uf[k, im - 1, j] = (ga * _smooth_ref(u[k, im - 2, :], j)
                                + (1.0 - ga) * _smooth_ref(fc["ube"][k], j))
            vf[k, im - 1, j] = fc["vbe"][k, j]
        for j in range(1, jm - 1):
            # west: the face at i = 1 reads d at i = 0 and u at i = 2
            ga = np.sqrt(d[0, j] / hmax)
            uf[k, 1, j] = (ga * _smooth_ref(u[k, 2, :], j)
                           + (1.0 - ga) * _smooth_ref(fc["ubw"][k], j))
            uf[k, 0, j] = uf[k, 1, j]
            vf[k, 0, j] = fc["vbw"][k, j]
        for i in range(1, im - 1):
            # south: the face at j = 1 reads d at j = 0 and v at j = 2
            ga = np.sqrt(d[i, 0] / hmax)
            vf[k, i, 1] = (ga * _smooth_ref(v[k, :, 2], i)
                           + (1.0 - ga) * _smooth_ref(fc["vbs"][k], i))
            vf[k, i, 0] = vf[k, i, 1]
            uf[k, i, 0] = fc["ubs"][k, i]
        for i in range(1, im - 1):
            # north
            ga = np.sqrt(d[i, jm - 1] / hmax)
            vf[k, i, jm - 1] = (ga * _smooth_ref(v[k, :, jm - 2], i)
                                + (1.0 - ga) * _smooth_ref(fc["vbn"][k], i))
            uf[k, i, jm - 1] = fc["ubn"][k, i]
    for k in range(kbm1):
        for j in range(jm):
            for i in range(im):
                uf[k, i, j] = uf[k, i, j] * dum[i, j]
                vf[k, i, j] = vf[k, i, j] * dvm[i, j]
    return uf, vf


def restore_interior_ref(t, tb, s, sb, trstr, srstr, taurstr, fsm, dti,
                         kbm1):
    """T and S of both time levels relaxed toward trstr and srstr:
    f = (f + 2 dti / 86400 * taurstr * (clim - f)) * fsm on levels
    k < kbm1.  ``taurstr`` [1/day] is (kb, im, jm), or (1, 1, 1) for one
    rate everywhere -> (t, tb, s, sb)."""
    out = [np.array(f, dtype=np.float64) for f in (t, tb, s, sb)]
    clims = (trstr, trstr, srstr, srstr)
    kb, im, jm = out[0].shape
    for f, clim in zip(out, clims):
        for k in range(kbm1):
            for j in range(jm):
                for i in range(im):
                    tau = taurstr[min(k, taurstr.shape[0] - 1),
                                  min(i, taurstr.shape[1] - 1),
                                  min(j, taurstr.shape[2] - 1)]
                    fac = 2.0 * dti / 86400.0 * tau
                    f[k, i, j] = (f[k, i, j]
                                  + fac * (clim[k, i, j] - f[k, i, j])) \
                        * fsm[i, j]
    return tuple(out)


def record_ref(t_days, days, nrec):
    """The record read last by model time ``t_days``, counted as the
    routines count their reads (one more each time the time passes the
    next record's), the one after it, and the fraction of the time between
    them -> (b, f, frac).  Past the last record both hold it."""
    n = 0
    while (n + 1) * days <= t_days:
        n += 1
    frac = (t_days - n * days) / days
    return min(n, nrec - 1), min(n + 1, nrec - 1), frac


def series_at_ref(recs, t_days, days, interpolate=True):
    """A series of records ``days`` apart at ``t_days``: fb + frac *
    (ff - fb) element by element, written (1 - frac) * fb + frac * ff as
    bounds_forcing.f:841-865 writes it; with ``interpolate`` False the
    record read last (surface, :963-983)."""
    nb, nf, frac = record_ref(t_days, days, recs.shape[0])
    b, f = recs[nb].ravel(), recs[nf].ravel()
    out = np.empty(b.shape)
    for n in range(b.size):
        out[n] = ((1.0 - frac) * b[n] + frac * f[n]) if interpolate \
            else b[n]
    return out.reshape(recs.shape[1:])


def depth_mean_ref(prof, dz, kbm1):
    """The depth integral of an edge profile (kb, n): sum over k < kbm1 of
    prof[k] dz[k], the side's depth-mean velocity (:626-635)."""
    out = np.zeros(prof.shape[1])
    for n in range(prof.shape[1]):
        for k in range(kbm1):
            out[n] += prof[k, n] * dz[k]
    return out


# the depth-mean normal velocity of each side and the profile it comes from
NORMAL_REF = {"uabw": "ubw", "uabe": "ube", "vabs": "vbs", "vabn": "vbn"}


def forcing_ref(series, cadences, dti, iint, dz, kbm1, restore):
    """The forced fields of the step from ``iint`` to ``iint + 1``, at
    get_time's dti * (iint + 1) / 86400 days: each series at that time
    (SST and SSS held, the others interpolated), each normal profile's
    depth-mean velocity from its records' depth integrals, and under
    ``restore`` the rate 1 / trst where no taurstr is given."""
    t_days = dti * (iint + 1) / 86400.0
    out = {}
    for name, recs in series.items():
        out[name] = series_at_ref(recs, t_days, cadences[name],
                                  name not in ("tsurf", "ssurf"))
    for bar, name in NORMAL_REF.items():
        if name in series:
            recs = series[name]
            means = np.stack([depth_mean_ref(r, dz, kbm1) for r in recs])
            out[bar] = series_at_ref(means, t_days, cadences[name])
    if restore and "taurstr" not in series:
        out["taurstr"] = np.full((1, 1, 1), 1.0 / cadences["trstr"])
    return out
