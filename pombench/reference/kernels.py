"""The kernels of one step of the mode-split model, in plain PyTorch.

Each function computes what the loop function of the same name with
``_ref`` appended computes in ``pombench/tests/pom_ref.py``, a frozen copy
of the repository's NumPy oracle, written from the equations of POM's
solver.f, advance.f and bounds_forcing.f with one i/j/k loop per sum.  Here
the loops over i and j become slices: a loop ``for i in range(a, im - b)``
is the rows ``a:im-b`` of a field, and a read at ``i-1`` the same rows
shifted by one (:func:`at`).  Loops over k that carry a value from one level
to the next (the vertical integrals and the tridiagonal solves) stay loops
over the levels.  The operations are those of the oracle, grouped as the
slices group them, so the rounding is not the oracle's nor the port's.

Fields are (kb, im, jm) or (im, jm) tensors of one dtype on one device;
``z``, ``zz``, ``dz``, ``dzz`` are (kb,) tensors of the same.  Nothing here
imports the port.
"""

from __future__ import annotations

import torch

# row or column ranges (first, cells left out at the end): range(a, n - b)
ALL = (0, 0)
FROM1 = (1, 0)
IN = (1, 1)
FROM2 = (2, 1)


def at(a, ri, rj, di=0, dj=0):
    """``a`` over the rows ``range(ri[0], im - ri[1])`` and the columns
    ``range(rj[0], jm - rj[1])``, each read ``di`` rows and ``dj`` columns
    away (a view)."""
    im, jm = a.shape[-2], a.shape[-1]
    return a[..., ri[0] + di:im - ri[1] + di, rj[0] + dj:jm - rj[1] + dj]


def put(out, ri, rj, value) -> None:
    """Write ``value`` into ``out`` over the rows and columns of
    :func:`at`."""
    at(out, ri, rj).copy_(value)


def lv(x, k0=None, k1=None):
    """A slice of a (kb,) vector of levels as (n, 1, 1), to broadcast over
    the plane."""
    return x[k0:k1, None, None]


# --------------------------------------------------------------------------
# equation of state, pressure gradient, continuity
# --------------------------------------------------------------------------

def dens(s, t, zz, h, fsm, tbias, sbias, grav, rhoref):
    """dens_ref: Mellor (1991)'s UNESCO approximation, solver.f:1162-1209."""
    tr = t[:-1] + tbias
    sr = s[:-1] + sbias
    tr2 = tr * tr
    tr3 = tr2 * tr
    tr4 = tr3 * tr
    p = grav * rhoref * (-lv(zz, None, -1) * h) * 1.0e-5
    rhor = (-0.157406 + 6.793952e-2 * tr - 9.095290e-3 * tr2
            + 1.001685e-4 * tr3 - 1.120083e-6 * tr4 + 6.536332e-9 * tr4 * tr)
    rhor = rhor + ((0.824493 - 4.0899e-3 * tr + 7.6438e-5 * tr2
                    - 8.2467e-7 * tr3 + 5.3875e-9 * tr4) * sr
                   + (-5.72466e-3 + 1.0227e-4 * tr - 1.6546e-6 * tr2)
                   * sr.abs() ** 1.5
                   + 4.8314e-4 * sr * sr)
    cr = 1449.1 + 0.0821 * p + 4.55 * tr - 0.045 * tr2 + 1.34 * (sr - 35.0)
    rhor = rhor + 1.0e5 * p / (cr * cr) * (1.0 - 2.0 * p / (cr * cr))
    rho = torch.zeros_like(t)
    rho[:-1] = rhor / rhoref * fsm
    return rho


def _running_sum(first, inc):
    """[first, first + inc[0], first + inc[0] + inc[1], ...], added one
    level after another."""
    out = [first]
    for x in inc:
        out.append(out[-1] + x)
    return torch.stack(out)


def _baropg_side(rr, dt, dm, dl, zz, grav, ramp, kbm1, di, dj):
    """One component of baropg_ref: the neighbour is at (i - di, j - dj);
    ``dm`` is the face's mask and ``dl`` the metric across it."""
    r0, r1 = at(rr, IN, IN), at(rr, IN, IN, -di, -dj)
    dts = at(dt, IN, IN) + at(dt, IN, IN, -di, -dj)
    dtd = at(dt, IN, IN) - at(dt, IN, IN, -di, -dj)
    z0, z1 = lv(zz, 0, kbm1 - 1), lv(zz, 1, kbm1)
    first = 0.5 * grav * (-zz[0]) * dts * (r0[0] - r1[0])
    inc = (grav * 0.25 * (z0 - z1) * dts
           * (r0[1:kbm1] - r1[1:kbm1] + r0[:kbm1 - 1] - r1[:kbm1 - 1])
           + grav * 0.25 * (z0 + z1) * dtd
           * (r0[1:kbm1] + r1[1:kbm1] - r0[:kbm1 - 1] - r1[:kbm1 - 1]))
    acc = _running_sum(first, inc)
    out = torch.zeros_like(rr)
    put(out[:kbm1], IN, IN,
        0.25 * dts * acc * at(dm, IN, IN)
        * (at(dl, IN, IN) + at(dl, IN, IN, -di, -dj)) * ramp)
    return out


def baropg(rho, rmean, dt, dum, dvm, dx, dy, zz, grav, ramp, kbm1):
    """baropg_ref: the second-order sigma-coordinate pressure gradient,
    solver.f:848-940 -> (drhox, drhoy)."""
    rr = rho - rmean
    return (_baropg_side(rr, dt, dum, dy, zz, grav, ramp, kbm1, 1, 0),
            _baropg_side(rr, dt, dvm, dx, zz, grav, ramp, kbm1, 0, 1))


def _mcc_side(rho, d, dt, dm, dl, zz, dzz, grav, kbm1, di, dj):
    """One component of baropg_mcc_ref, the neighbour at (i - di, j - dj)."""
    R = rho[:kbm1]
    m = lambda r: at(dm, r[0], r[1])
    # second-order differences and means on the faces (i >= 1, all j for x)
    rx = (FROM1, ALL) if di else (ALL, FROM1)
    drho = torch.zeros_like(rho[:kbm1])
    rhou = torch.zeros_like(rho[:kbm1])
    ddx = torch.zeros_like(d)
    d4 = torch.zeros_like(d)
    put(drho, *rx, (at(R, *rx) - at(R, *rx, -di, -dj)) * m(rx))
    put(rhou, *rx, 0.5 * (at(R, *rx) + at(R, *rx, -di, -dj)) * m(rx))
    put(ddx, *rx, (at(d, *rx) - at(d, *rx, -di, -dj)) * m(rx))
    put(d4, *rx, 0.5 * (at(d, *rx) + at(d, *rx, -di, -dj)) * m(rx))
    # fourth-order corrections away from the west (south) edge
    r4 = (FROM2, ALL) if di else (ALL, FROM2)
    sh = lambda a, n: at(a, *r4, n * di, n * dj)
    mp, mm = sh(dm, 1), sh(dm, -1)
    put(drho, *r4, at(drho, *r4) - (1.0 / 24.0) * (
        mp * (sh(R, 1) - sh(R, 0)) - 2.0 * (sh(R, 0) - sh(R, -1))
        + mm * (sh(R, -1) - sh(R, -2))))
    put(rhou, *r4, at(rhou, *r4) + (1.0 / 16.0) * (
        mp * (sh(R, 0) - sh(R, 1)) + mm * (sh(R, -1) - sh(R, -2))))
    put(ddx, *r4, at(ddx, *r4) - (1.0 / 24.0) * (
        mp * (sh(d, 1) - sh(d, 0)) - 2.0 * (sh(d, 0) - sh(d, -1))
        + mm * (sh(d, -1) - sh(d, -2))))
    put(d4, *r4, at(d4, *r4) + (1.0 / 16.0) * (
        mp * (sh(d, 0) - sh(d, 1)) + mm * (sh(d, -1) - sh(d, -2))))
    dr, ru = at(drho, IN, IN), at(rhou, IN, IN)
    a4, ax = at(d4, IN, IN), at(ddx, IN, IN)
    first = grav * (-zz[0]) * a4 * dr[0]
    inc = (grav * 0.5 * lv(dzz, 0, kbm1 - 1) * a4
           * (dr[:kbm1 - 1] + dr[1:kbm1])
           + grav * 0.5 * (lv(zz, 0, kbm1 - 1) + lv(zz, 1, kbm1)) * ax
           * (ru[1:kbm1] - ru[:kbm1 - 1]))
    acc = _running_sum(first, inc)
    out = torch.zeros_like(rho)
    put(out[:kbm1], IN, IN,
        0.25 * (at(dt, IN, IN) + at(dt, IN, IN, -di, -dj)) * acc
        * at(dm, IN, IN) * (at(dl, IN, IN) + at(dl, IN, IN, -di, -dj)))
    return out


def baropg_mcc(rho_in, rmean, d, dt, dum, dvm, dx, dy, zz, dzz, grav, ramp,
               kbm1):
    """baropg_mcc_ref: McCalpin's fourth-order pressure gradient,
    solver.f:943-1159 -> (drhox, drhoy)."""
    rho = rho_in - rmean
    out = []
    for dm, dl, di, dj in ((dum, dy, 1, 0), (dvm, dx, 0, 1)):
        g = _mcc_side(rho, d, dt, dm, dl, zz, dzz, grav, kbm1, di, dj)
        g[:, 1:-1, 1:-1] *= ramp
        out.append(g)
    return tuple(out)


def vertvl(w_in, u, v, dt, etf, etb, vfluxb, vfluxf, dx, dy, dz, dti2,
           kbm1):
    """vertvl_ref: the vertical velocity from continuity,
    solver.f:1970-2021."""
    xflux = torch.zeros_like(u[:kbm1])
    yflux = torch.zeros_like(u[:kbm1])
    put(xflux, FROM1, FROM1,
        0.25 * (at(dy, FROM1, FROM1) + at(dy, FROM1, FROM1, -1, 0))
        * (at(dt, FROM1, FROM1) + at(dt, FROM1, FROM1, -1, 0))
        * at(u[:kbm1], FROM1, FROM1))
    put(yflux, FROM1, FROM1,
        0.25 * (at(dx, FROM1, FROM1) + at(dx, FROM1, FROM1, 0, -1))
        * (at(dt, FROM1, FROM1) + at(dt, FROM1, FROM1, 0, -1))
        * at(v[:kbm1], FROM1, FROM1))
    inc = lv(dz, 0, kbm1) * (
        (at(xflux, IN, IN, 1, 0) - at(xflux, IN, IN)
         + at(yflux, IN, IN, 0, 1) - at(yflux, IN, IN))
        / (at(dx, IN, IN) * at(dy, IN, IN))
        + (at(etf, IN, IN) - at(etb, IN, IN)) / dti2)
    w = w_in.clone()
    put(w[:kbm1 + 1], IN, IN, _running_sum(
        0.5 * (at(vfluxb, IN, IN) + at(vfluxf, IN, IN)), inc))
    return w


# --------------------------------------------------------------------------
# implicit vertical diffusion (tridiagonal solves down each column)
# --------------------------------------------------------------------------

_JERLOV = {"R": (0.58, 0.62, 0.67, 0.77, 0.78),
           "ad1": (0.35, 0.60, 1.0, 1.5, 1.4),
           "ad2": (23.0, 20.0, 17.0, 14.0, 7.9)}


def proft(f_in, wfsurf, fsurf, nbc, kh, etf, swrad, h, z, dz, dzz, dti2,
          umol, ntp, kb):
    """proft_ref: implicit vertical tracer diffusion with its four surface
    conditions and two-band shortwave absorption, solver.f:1541-1683."""
    kbm1, kbm2 = kb - 1, kb - 2
    f = f_in.clone()
    dh = h + etf
    dh2 = dh * dh
    a = lambda k: -dti2 * (kh[k + 1] + umol) / (dz[k] * dzz[k] * dh2)
    c = lambda k: -dti2 * (kh[k] + umol) / (dz[k] * dzz[k - 1] * dh2)
    rad = None
    if nbc in (2, 4):
        R = _JERLOV["R"][ntp - 1]
        ad1, ad2 = _JERLOV["ad1"][ntp - 1], _JERLOV["ad2"][ntp - 1]
        rad = [swrad * (R * torch.exp(z[k] * dh / ad1)
                        + (1.0 - R) * torch.exp(z[k] * dh / ad2))
               for k in range(kbm1)] + [torch.zeros_like(dh)]
    src = lambda k: (0.0 if rad is None
                     else dti2 * (rad[k] - rad[k + 1]) / (dh * dz[k]))
    if nbc in (1, 2):
        a0 = a(0)
        flux0 = wfsurf + (rad[0] - rad[1] if nbc == 2 else 0.0)
        ee = [a0 / (a0 - 1.0)]
        gg = [(dti2 * flux0 / (dz[0] * dh) - f[0]) / (a0 - 1.0)]
    else:
        ee = [torch.zeros_like(dh)]
        gg = [fsurf + torch.zeros_like(dh)]
    for k in range(1, kbm2):
        ck = c(k)
        r = 1.0 / (a(k) + ck * (1.0 - ee[-1]) - 1.0)
        ee.append(a(k) * r)
        gg.append((ck * gg[-1] - f[k] + src(k)) * r)
    k = kbm1 - 1
    ck = c(k)
    f[k] = (ck * gg[-1] - f[k] + src(k)) / (ck * (1.0 - ee[-1]) - 1.0)
    for k in range(kbm2 - 1, -1, -1):
        f[k] = ee[k] * f[k + 1] + gg[k]
    return f


def _prof_vel(uf_in, km, etf, wsurf, h, dm, tps, dz, dzz, dti2, umol, kb,
              di, dj):
    """The column solve of profu_ref (di=1) and profv_ref (dj=1) on the
    interior, with the bottom friction ``tps`` -> (uf, wbot)."""
    kbm1, kbm2 = kb - 1, kb - 2
    uf = uf_in.clone()
    U = at(uf, IN, IN)
    hs = h + etf
    dh = 0.5 * (at(hs, IN, IN) + at(hs, IN, IN, -di, -dj))
    dh2 = dh * dh
    cm = 0.5 * (at(km, IN, IN) + at(km, IN, IN, -di, -dj))
    a = lambda k: -dti2 * (cm[k + 1] + umol) / (dz[k] * dzz[k] * dh2)
    c = lambda k: -dti2 * (cm[k] + umol) / (dz[k] * dzz[k - 1] * dh2)
    m = at(dm, IN, IN)
    a0 = a(0)
    ee = [a0 / (a0 - 1.0)]
    gg = [(-dti2 * at(wsurf, IN, IN) / (-dz[0] * dh) - U[0]) / (a0 - 1.0)]
    for k in range(1, kbm2):
        ck = c(k)
        r = 1.0 / (a(k) + ck * (1.0 - ee[-1]) - 1.0)
        ee.append(a(k) * r)
        gg.append((ck * gg[-1] - U[k]) * r)
    k = kbm1 - 1
    ck = c(k)
    U[k] = ((ck * gg[-1] - U[k])
            / (tps * dti2 / (-dz[k] * dh) - 1.0 - (ee[-1] - 1.0) * ck)) * m
    for k in range(kbm2 - 1, -1, -1):
        U[k] = (ee[k] * U[k + 1] + gg[k]) * m
    wbot = torch.zeros_like(h)
    put(wbot, IN, IN, -tps * U[kbm1 - 1])
    return uf, wbot


def profu(uf_in, ub, vb, km, etf, wusurf, h, cbc, dum, dz, dzz, dti2, umol,
          kb):
    """profu_ref: implicit vertical u-diffusion with quadratic bottom
    friction, solver.f:1686-1780 -> (uf, wubot)."""
    k = kb - 2
    tps = (0.5 * (at(cbc, IN, IN) + at(cbc, IN, IN, -1, 0))
           * torch.sqrt(at(ub[k], IN, IN) ** 2
                        + (0.25 * (at(vb[k], IN, IN) + at(vb[k], IN, IN, 0, 1)
                                   + at(vb[k], IN, IN, -1, 0)
                                   + at(vb[k], IN, IN, -1, 1))) ** 2))
    return _prof_vel(uf_in, km, etf, wusurf, h, dum, tps, dz, dzz, dti2,
                     umol, kb, 1, 0)


def profv(vf_in, ub, vb, km, etf, wvsurf, h, cbc, dvm, dz, dzz, dti2, umol,
          kb):
    """profv_ref: implicit vertical v-diffusion with quadratic bottom
    friction, solver.f:1783-1877 -> (vf, wvbot)."""
    k = kb - 2
    tps = (0.5 * (at(cbc, IN, IN) + at(cbc, IN, IN, 0, -1))
           * torch.sqrt((0.25 * (at(ub[k], IN, IN) + at(ub[k], IN, IN, 1, 0)
                                 + at(ub[k], IN, IN, 0, -1)
                                 + at(ub[k], IN, IN, 1, -1))) ** 2
                        + at(vb[k], IN, IN) ** 2))
    return _prof_vel(vf_in, km, etf, wvsurf, h, dvm, tps, dz, dzz, dti2,
                     umol, kb, 0, 1)


# --------------------------------------------------------------------------
# advection and horizontal diffusion
# --------------------------------------------------------------------------

def advt1(fb, f_in, fclim, u, v, w, aam, dt, etb, etf, h, dum, dvm, dx, dy,
          art, dz, dti2, tprni, kbm1):
    """advt1_ref: central tracer advection and diffusion with the leapfrog
    step, solver.f:480-574."""
    f = f_in.clone()
    f[-1] = f[-2]
    fbw = fb.clone()
    fbw[-1] = fbw[-2]
    fbmc = fbw - fclim
    K = slice(0, kbm1)
    r = (FROM1, FROM1)
    F, M, A, U, V = (x[K] for x in (f, fbmc, aam, u, v))
    xa = 0.25 * ((at(dt, *r) + at(dt, *r, -1, 0)) * (at(F, *r)
                 + at(F, *r, -1, 0)) * at(U, *r))
    ya = 0.25 * ((at(dt, *r) + at(dt, *r, 0, -1)) * (at(F, *r)
                 + at(F, *r, 0, -1)) * at(V, *r))
    xd = (-0.5 * (at(A, *r) + at(A, *r, -1, 0)) * (at(h, *r) + at(h, *r, -1, 0))
          * tprni * (at(M, *r) - at(M, *r, -1, 0)) * at(dum, *r)
          / (at(dx, *r) + at(dx, *r, -1, 0)))
    yd = (-0.5 * (at(A, *r) + at(A, *r, 0, -1)) * (at(h, *r) + at(h, *r, 0, -1))
          * tprni * (at(M, *r) - at(M, *r, 0, -1)) * at(dvm, *r)
          / (at(dy, *r) + at(dy, *r, 0, -1)))
    xflux = torch.zeros_like(F)
    yflux = torch.zeros_like(F)
    put(xflux, *r, 0.5 * (at(dy, *r) + at(dy, *r, -1, 0)) * (xa + xd))
    put(yflux, *r, 0.5 * (at(dx, *r) + at(dx, *r, 0, -1)) * (ya + yd))
    zflux = torch.zeros_like(f)
    ar = at(art, IN, IN)
    put(zflux[0], IN, IN, at(f[0], IN, IN) * at(w[0], IN, IN) * ar)
    put(zflux[1:kbm1], IN, IN,
        0.5 * (at(f[:kbm1 - 1], IN, IN) + at(f[1:kbm1], IN, IN))
        * at(w[1:kbm1], IN, IN) * ar)
    adv = (at(xflux, IN, IN, 1, 0) - at(xflux, IN, IN)
           + at(yflux, IN, IN, 0, 1) - at(yflux, IN, IN)
           + (at(zflux[:kbm1], IN, IN) - at(zflux[1:kbm1 + 1], IN, IN))
           / lv(dz, 0, kbm1))
    ff = torch.zeros_like(f)
    put(ff[K], IN, IN,
        (at(fbw[K], IN, IN) * (at(h, IN, IN) + at(etb, IN, IN)) * ar
         - dti2 * adv) / ((at(h, IN, IN) + at(etf, IN, IN)) * ar))
    return ff


def smol_adif(xm_in, ym_in, zw_in, ff, dt, aru, arv, dzz, fsm, dti2, sw,
              kbm1):
    """smol_adif_ref: MPDATA's antidiffusive velocities, solver.f:1880-1967
    -> (xm, ym, zw, ff masked)."""
    value_min, epsilon = 1.0e-9, 1.0e-14
    ff = ff * fsm
    F = ff[:kbm1]

    def face(flux, r, di, dj, area):
        f0, f1 = at(F, *r), at(F, *r, -di, -dj)
        x = at(flux[:kbm1], *r)
        udx = x.abs()
        u2dt = dti2 * x * x * 2.0 / (at(area, *r) * (at(dt, *r, -di, -dj)
                                                     + at(dt, *r)))
        mol = (f0 - f1) / (f1 + f0 + epsilon)
        new = (udx - u2dt) * mol * sw
        zero = (f0 < value_min) | (f1 < value_min) | (udx.abs() < u2dt.abs())
        out = flux.clone()
        put(out[:kbm1], *r, torch.where(zero, torch.zeros_like(new), new))
        return out
    xm = face(xm_in, (FROM1, IN), 1, 0, aru)
    ym = face(ym_in, (IN, FROM1), 0, 1, arv)
    f0, f1 = at(ff[1:kbm1], IN, IN), at(ff[:kbm1 - 1], IN, IN)
    z = at(zw_in[1:kbm1], IN, IN)
    wdz = z.abs()
    w2dt = dti2 * z * z / (lv(dzz, 0, kbm1 - 1) * at(dt, IN, IN))
    mol = (f1 - f0) / (f0 + f1 + epsilon)
    new = (wdz - w2dt) * mol * sw
    zero = (f0 < value_min) | (f1 < value_min) | (wdz.abs() < w2dt.abs())
    zw = zw_in.clone()
    put(zw[1:kbm1], IN, IN, torch.where(zero, torch.zeros_like(new), new))
    return xm, ym, zw, ff


def _upstream(flux, lo, hi):
    """The upwind flux: the mass flux times the field on its upstream
    side (``lo`` behind the face, ``hi`` ahead of it)."""
    return 0.5 * ((flux + flux.abs()) * lo + (flux - flux.abs()) * hi)


def advt2(fb_in, f, fclim, u, v, w, aam, dt, etb, etf, h, dum, dvm, fsm, dx,
          dy, art, aru, arv, dz, dzz, dti2, tprni, sw, nitera, kbm1):
    """advt2_ref: Smolarkiewicz's MPDATA tracer step with the climatology-
    deviation diffusion, solver.f:577-731 (the work array starts as ``fb``,
    as the oracle and the JAX package document)."""
    kb = fb_in.shape[0]
    K = slice(0, kbm1)
    fb = fb_in.clone()
    fb[-1] = fb[-2]
    xmass = torch.zeros_like(fb)
    ymass = torch.zeros_like(fb)
    r = (FROM1, IN)
    put(xmass[K], *r, 0.25 * (at(dy, *r, -1, 0) + at(dy, *r))
        * (at(dt, *r, -1, 0) + at(dt, *r)) * at(u[K], *r))
    r = (IN, FROM1)
    put(ymass[K], *r, 0.25 * (at(dx, *r, 0, -1) + at(dx, *r))
        * (at(dt, *r, 0, -1) + at(dt, *r)) * at(v[K], *r))
    eta = etb
    zw = w.clone()
    fbmem = fb.clone()
    ff = fb.clone()
    xflux = torch.zeros_like(fb)
    yflux = torch.zeros_like(fb)
    zflux = torch.zeros_like(fb)
    ar = at(art, IN, IN)
    hf = (at(h, IN, IN) + at(etf, IN, IN)) * ar
    for itera in range(nitera):
        r = (FROM1, FROM1)
        put(xflux[K], *r, _upstream(at(xmass[K], *r),
                                    at(fbmem[K], *r, -1, 0),
                                    at(fbmem[K], *r)))
        put(yflux[K], *r, _upstream(at(ymass[K], *r),
                                    at(fbmem[K], *r, 0, -1),
                                    at(fbmem[K], *r)))
        top = (at(w[0], IN, IN) * at(f[0], IN, IN) * ar if itera == 0
               else torch.zeros_like(ar))
        put(zflux[0], IN, IN, top)
        put(zflux[kb - 1], IN, IN, torch.zeros_like(ar))
        put(zflux[1:kbm1], IN, IN,
            _upstream(at(zw[1:kbm1], IN, IN), at(fbmem[1:kbm1], IN, IN),
                      at(fbmem[:kbm1 - 1], IN, IN)) * ar)
        adv = (at(xflux[K], IN, IN, 1, 0) - at(xflux[K], IN, IN)
               + at(yflux[K], IN, IN, 0, 1) - at(yflux[K], IN, IN)
               + (at(zflux[:kbm1], IN, IN) - at(zflux[1:kbm1 + 1], IN, IN))
               / lv(dz, 0, kbm1))
        put(ff[K], IN, IN,
            (at(fbmem[K], IN, IN) * (at(h, IN, IN) + at(eta, IN, IN)) * ar
             - dti2 * adv) / hf)
        xmass, ymass, zw, ff = smol_adif(xmass, ymass, zw, ff, dt, aru, arv,
                                         dzz, fsm, dti2, sw, kbm1)
        eta = etf
        fbmem = ff.clone()
    fbmc = fb - fclim
    r = (FROM1, FROM1)
    M, A = fbmc[K], aam[K]
    put(xflux[K], *r,
        -(0.5 * (at(A, *r) + at(A, *r, -1, 0))) * (at(h, *r) + at(h, *r, -1, 0))
        * tprni * (at(M, *r) - at(M, *r, -1, 0)) * at(dum, *r)
        * (at(dy, *r) + at(dy, *r, -1, 0)) * 0.5
        / (at(dx, *r) + at(dx, *r, -1, 0)))
    put(yflux[K], *r,
        -(0.5 * (at(A, *r) + at(A, *r, 0, -1))) * (at(h, *r) + at(h, *r, 0, -1))
        * tprni * (at(M, *r) - at(M, *r, 0, -1)) * at(dvm, *r)
        * (at(dx, *r) + at(dx, *r, 0, -1)) * 0.5
        / (at(dy, *r) + at(dy, *r, 0, -1)))
    put(ff[K], IN, IN, at(ff[K], IN, IN) - dti2 * (
        at(xflux[K], IN, IN, 1, 0) - at(xflux[K], IN, IN)
        + at(yflux[K], IN, IN, 0, 1) - at(yflux[K], IN, IN)) / hf)
    return ff


def advq(qb, q, u, v, w, aam, dt, etb, etf, h, dum, dvm, dx, dy, art, dz,
         dti2, kbm1):
    """advq_ref: advection and diffusion of a turbulence quantity with the
    leapfrog step, solver.f:411-477."""
    K, K1 = slice(1, kbm1), slice(0, kbm1 - 1)
    r = (FROM1, FROM1)
    Q, QB = q[K], qb[K]
    xf = (0.125 * (at(Q, *r) + at(Q, *r, -1, 0))
          * (at(dt, *r) + at(dt, *r, -1, 0)) * (at(u[K], *r) + at(u[K1], *r)))
    yf = (0.125 * (at(Q, *r) + at(Q, *r, 0, -1))
          * (at(dt, *r) + at(dt, *r, 0, -1)) * (at(v[K], *r) + at(v[K1], *r)))
    xf = xf - (0.25 * (at(aam[K], *r) + at(aam[K], *r, -1, 0)
                       + at(aam[K1], *r) + at(aam[K1], *r, -1, 0))
               * (at(h, *r) + at(h, *r, -1, 0))
               * (at(QB, *r) - at(QB, *r, -1, 0)) * at(dum, *r)
               / (at(dx, *r) + at(dx, *r, -1, 0)))
    yf = yf - (0.25 * (at(aam[K], *r) + at(aam[K], *r, 0, -1)
                       + at(aam[K1], *r) + at(aam[K1], *r, 0, -1))
               * (at(h, *r) + at(h, *r, 0, -1))
               * (at(QB, *r) - at(QB, *r, 0, -1)) * at(dvm, *r)
               / (at(dy, *r) + at(dy, *r, 0, -1)))
    xflux = torch.zeros_like(Q)
    yflux = torch.zeros_like(Q)
    put(xflux, *r, xf * (0.5 * (at(dy, *r) + at(dy, *r, -1, 0))))
    put(yflux, *r, yf * (0.5 * (at(dx, *r) + at(dx, *r, 0, -1))))
    ar = at(art, IN, IN)
    qf = torch.zeros_like(q)
    tend = ((at(w[:kbm1 - 1], IN, IN) * at(q[:kbm1 - 1], IN, IN)
             - at(w[2:kbm1 + 1], IN, IN) * at(q[2:kbm1 + 1], IN, IN)) * ar
            / (lv(dz, 1, kbm1) + lv(dz, 0, kbm1 - 1))
            + at(xflux, IN, IN, 1, 0) - at(xflux, IN, IN)
            + at(yflux, IN, IN, 0, 1) - at(yflux, IN, IN))
    put(qf[K], IN, IN,
        ((at(h, IN, IN) + at(etb, IN, IN)) * ar * at(QB, IN, IN)
         - dti2 * tend) / ((at(h, IN, IN) + at(etf, IN, IN)) * ar))
    return qf


def _curv(u, v, dx, dy):
    """The curvature term of advct_ref and advave_ref on the interior."""
    return (0.25 * ((at(v, IN, IN, 0, 1) + at(v, IN, IN))
                    * (at(dy, IN, IN, 1, 0) - at(dy, IN, IN, -1, 0))
                    - (at(u, IN, IN, 1, 0) + at(u, IN, IN))
                    * (at(dx, IN, IN, 0, 1) - at(dx, IN, IN, 0, -1)))
            / (at(dx, IN, IN) * at(dy, IN, IN)))


def _sum4(a, r):
    """a + a(i-1) + a(j-1) + a(i-1, j-1) over ``r``."""
    return (at(a, *r) + at(a, *r, -1, 0) + at(a, *r, 0, -1)
            + at(a, *r, -1, -1))


def _shear_visc(dt, aam, ub, vb, dx, dy, r):
    """The viscous shear flux at the cell corners of advct_ref and
    advave_ref (dtaam times the strain) over ``r``."""
    dtaam = 0.25 * _sum4(dt, r) * (at(aam, *r) + at(aam, *r, -1, 0)
                                   + at(aam, *r, 0, -1)
                                   + at(aam, *r, -1, -1))
    return dtaam * ((at(ub, *r) - at(ub, *r, 0, -1)) / _sum4(dy, r)
                    + (at(vb, *r) - at(vb, *r, -1, 0)) / _sum4(dx, r))


def advct(u, v, ub, vb, aam, dt, dx, dy, aru, arv, kbm1):
    """advct_ref: three-dimensional horizontal momentum advection and
    diffusion with the curvature terms, solver.f:201-408 -> (advx, advy)."""
    K = slice(0, kbm1)
    U, V, UB, VB, A = (x[K] for x in (u, v, ub, vb, aam))
    curv = torch.zeros_like(U)
    put(curv, IN, IN, _curv(U, V, dx, dy))
    # x-component
    xflux = torch.zeros_like(U)
    yflux = torch.zeros_like(U)
    r = (IN, ALL)
    put(xflux, *r, 0.125 * ((at(dt, *r, 1, 0) + at(dt, *r)) * at(U, *r, 1, 0)
                            + (at(dt, *r) + at(dt, *r, -1, 0)) * at(U, *r))
        * (at(U, *r, 1, 0) + at(U, *r)))
    r = (FROM1, FROM1)
    put(yflux, *r, 0.125 * ((at(dt, *r) + at(dt, *r, 0, -1)) * at(V, *r)
                            + (at(dt, *r, -1, 0) + at(dt, *r, -1, -1))
                            * at(V, *r, -1, 0))
        * (at(U, *r) + at(U, *r, 0, -1)))
    r = (IN, FROM1)
    put(xflux, *r, (at(xflux, *r) - at(dt, *r) * at(A, *r) * 2.0
                    * (at(UB, *r, 1, 0) - at(UB, *r)) / at(dx, *r))
        * at(dy, *r))
    put(yflux, *r, (at(yflux, *r) - _shear_visc(dt, A, UB, VB, dx, dy, r))
        * (0.25 * _sum4(dx, r)))
    advx = torch.zeros_like(u)
    put(advx[K], IN, IN, at(xflux, IN, IN) - at(xflux, IN, IN, -1, 0)
        + at(yflux, IN, IN, 0, 1) - at(yflux, IN, IN))
    r = (FROM2, IN)
    put(advx[K], *r, at(advx[K], *r) - at(aru, *r) * 0.25 * (
        at(curv, *r) * at(dt, *r) * (at(V, *r, 0, 1) + at(V, *r))
        + at(curv, *r, -1, 0) * at(dt, *r, -1, 0)
        * (at(V, *r, -1, 1) + at(V, *r, -1, 0))))
    # y-component
    xflux = torch.zeros_like(U)
    yflux = torch.zeros_like(U)
    r = (FROM1, FROM1)
    put(xflux, *r, 0.125 * ((at(dt, *r) + at(dt, *r, -1, 0)) * at(U, *r)
                            + (at(dt, *r, 0, -1) + at(dt, *r, -1, -1))
                            * at(U, *r, 0, -1))
        * (at(V, *r) + at(V, *r, -1, 0)))
    r = (ALL, IN)
    put(yflux, *r, 0.125 * ((at(dt, *r, 0, 1) + at(dt, *r)) * at(V, *r, 0, 1)
                            + (at(dt, *r) + at(dt, *r, 0, -1)) * at(V, *r))
        * (at(V, *r, 0, 1) + at(V, *r)))
    r = (FROM1, IN)
    put(xflux, *r, (at(xflux, *r) - _shear_visc(dt, A, UB, VB, dx, dy, r))
        * (0.25 * _sum4(dy, r)))
    put(yflux, *r, (at(yflux, *r) - at(dt, *r) * at(A, *r) * 2.0
                    * (at(VB, *r, 0, 1) - at(VB, *r)) / at(dy, *r))
        * at(dx, *r))
    advy = torch.zeros_like(u)
    put(advy[K], IN, IN, at(xflux, IN, IN, 1, 0) - at(xflux, IN, IN)
        + at(yflux, IN, IN) - at(yflux, IN, IN, 0, -1))
    r = (IN, FROM2)
    put(advy[K], *r, at(advy[K], *r) + at(arv, *r) * 0.25 * (
        at(curv, *r) * at(dt, *r) * (at(U, *r, 1, 0) + at(U, *r))
        + at(curv, *r, 0, -1) * at(dt, *r, 0, -1)
        * (at(U, *r, 1, -1) + at(U, *r, 0, -1))))
    return advx, advy


def advave(d, ua, va, uab, vab, aam2d, wubot, wvbot, cbc, dx, dy, aru, arv,
           mode):
    """advave_ref in mode 3: depth-mean momentum advection and diffusion,
    solver.f:6-199 -> (advua, advva, wubot, wvbot); the bottom stress and
    the curvature terms that mode 2 adds are not here (the reference steps
    mode 3 only), so ``wubot`` and ``wvbot`` come back as they went in."""
    if mode != 3:
        raise NotImplementedError("advave in mode 3 only")
    # u-advection
    fluxua = torch.zeros_like(d)
    fluxva = torch.zeros_like(d)
    r = (IN, FROM1)
    put(fluxua, *r, 0.125 * ((at(d, *r, 1, 0) + at(d, *r)) * at(ua, *r, 1, 0)
                             + (at(d, *r) + at(d, *r, -1, 0)) * at(ua, *r))
        * (at(ua, *r, 1, 0) + at(ua, *r))
        - at(d, *r) * 2.0 * at(aam2d, *r) * (at(uab, *r, 1, 0) - at(uab, *r))
        / at(dx, *r))
    r = (FROM1, FROM1)
    put(fluxva, *r, 0.125 * ((at(d, *r) + at(d, *r, 0, -1)) * at(va, *r)
                             + (at(d, *r, -1, 0) + at(d, *r, -1, -1))
                             * at(va, *r, -1, 0))
        * (at(ua, *r) + at(ua, *r, 0, -1)))
    tps = _shear_visc(d, aam2d, uab, vab, dx, dy, r)
    put(fluxua, *r, at(fluxua, *r) * at(dy, *r))
    put(fluxva, *r, (at(fluxva, *r) - tps) * 0.25 * _sum4(dx, r))
    advua = torch.zeros_like(d)
    put(advua, IN, IN, at(fluxua, IN, IN) - at(fluxua, IN, IN, -1, 0)
        + at(fluxva, IN, IN, 0, 1) - at(fluxva, IN, IN))
    # v-advection
    fluxua = torch.zeros_like(d)
    fluxva = torch.zeros_like(d)
    put(fluxua, *r, 0.125 * ((at(d, *r) + at(d, *r, -1, 0)) * at(ua, *r)
                             + (at(d, *r, 0, -1) + at(d, *r, -1, -1))
                             * at(ua, *r, 0, -1))
        * (at(va, *r, -1, 0) + at(va, *r)))
    r2 = (FROM1, IN)
    put(fluxva, *r2, 0.125 * ((at(d, *r2, 0, 1) + at(d, *r2))
                              * at(va, *r2, 0, 1)
                              + (at(d, *r2) + at(d, *r2, 0, -1))
                              * at(va, *r2))
        * (at(va, *r2, 0, 1) + at(va, *r2))
        - at(d, *r2) * 2.0 * at(aam2d, *r2)
        * (at(vab, *r2, 0, 1) - at(vab, *r2)) / at(dy, *r2))
    put(fluxva, *r, at(fluxva, *r) * at(dx, *r))
    put(fluxua, *r, (at(fluxua, *r) - tps) * 0.25 * _sum4(dy, r))
    advva = torch.zeros_like(d)
    put(advva, IN, IN, at(fluxua, IN, IN, 1, 0) - at(fluxua, IN, IN)
        + at(fluxva, IN, IN) - at(fluxva, IN, IN, 0, -1))
    return advua, advva, wubot, wvbot


def _adv_vel(u, ub, v, w, advx, drhox, dt, egf, egb, e_atmos, etb, etf, h,
             dl, ar, cor, dz, grav, dti2, kbm1, di, dj, sign):
    """advu_ref (di=1, sign -1) and advv_ref (dj=1, sign +1): the momentum
    tendency and the leapfrog step; ``u`` is the component advanced, ``v``
    the other one."""
    K, K1 = slice(1, kbm1), slice(0, kbm1 - 1)
    vadv = torch.zeros_like(u)
    r = (FROM1, ALL) if di else (ALL, FROM1)
    put(vadv[K], *r, 0.25 * (at(w[K], *r) + at(w[K], *r, -di, -dj))
        * (at(u[K], *r) + at(u[K1], *r)))
    uf = vadv.clone()
    A = slice(0, kbm1)
    c = lambda a, x=0, y=0: at(a, IN, IN, x, y)
    dtc = c(dt)
    # the Coriolis term reads the other component at the face's two cells
    ox, oy = dj, di
    cor_term = sign * c(ar) * 0.25 * (
        c(cor) * dtc * (c(v[A], ox, oy) + c(v[A]))
        + c(cor, -di, -dj) * c(dt, -di, -dj)
        * (c(v[A], ox - di, oy - dj) + c(v[A], -di, -dj)))
    tend = (c(advx[A]) + (c(vadv[A]) - c(vadv[1:kbm1 + 1])) * c(ar)
            / lv(dz, 0, kbm1)
            + cor_term
            + grav * 0.125 * (dtc + c(dt, -di, -dj))
            * (c(egf) - c(egf, -di, -dj) + c(egb) - c(egb, -di, -dj)
               + (c(e_atmos) - c(e_atmos, -di, -dj)) * 2.0)
            * (c(dl) + c(dl, -di, -dj))
            + c(drhox[A]))
    put(uf[A], IN, IN,
        ((c(h) + c(etb) + c(h, -di, -dj) + c(etb, -di, -dj)) * c(ar)
         * c(ub[A]) - 2.0 * dti2 * tend)
        / ((c(h) + c(etf) + c(h, -di, -dj) + c(etf, -di, -dj)) * c(ar)))
    return uf


def advu(u, ub, v, w, advx, drhox, dt, egf, egb, e_atmos, etb, etf, h, dy,
         aru, cor, dz, grav, dti2, kbm1):
    """advu_ref: the u tendency and leapfrog step, solver.f:734-788."""
    return _adv_vel(u, ub, v, w, advx, drhox, dt, egf, egb, e_atmos, etb,
                    etf, h, dy, aru, cor, dz, grav, dti2, kbm1, 1, 0, -1.0)


def advv(v, vb, u, w, advy, drhoy, dt, egf, egb, e_atmos, etb, etf, h, dx,
         arv, cor, dz, grav, dti2, kbm1):
    """advv_ref: the v tendency and leapfrog step, solver.f:791-845."""
    return _adv_vel(v, vb, u, w, advy, drhoy, dt, egf, egb, e_atmos, etb,
                    etf, h, dx, arv, cor, dz, grav, dti2, kbm1, 0, 1, 1.0)


# --------------------------------------------------------------------------
# Mellor-Yamada 2.5
# --------------------------------------------------------------------------

def profq(q2f_in, q2lf_in, q2, q2b_in, q2lb_in, u, v, t, s, rho, km_in,
          kh_in, kq_in, l_in, etf, wusurf, wvsurf, wubot, wvbot, h, fsm, z,
          zz, dz, dzz, dti2, umol, grav, kappa, tbias, sbias, rhoref, small,
          kb):
    """profq_ref: the Mellor-Yamada 2.5 closure, solver.f:1212-1538
    -> (q2f, q2lf, km, kh, kq, l, q2b, q2lb)."""
    kbm1 = kb - 1
    a1, b1, a2, b2, c1 = 0.92, 16.6, 0.74, 10.1, 0.08
    e1, e2 = 1.8, 1.33
    sef = 1.0
    cbcnst, surfl, shiw = 100.0, 2.0e5, 0.0
    q2f, q2lf = q2f_in.clone(), q2lf_in.clone()
    q2b, q2lb = q2b_in.clone(), q2lb_in.clone()
    km, kh, kq = km_in.clone(), kh_in.clone(), kq_in.clone()
    dh = h + etf
    dh2 = dh * dh
    a = lambda k: (-dti2 * (kq[k + 1] + kq[k] + 2.0 * umol) * 0.5
                   / (dzz[k - 1] * dz[k] * dh2))
    c = lambda k: (-dti2 * (kq[k - 1] + kq[k] + 2.0 * umol) * 0.5
                   / (dzz[k - 1] * dz[k - 1] * dh2))
    const1 = (16.6 ** (2.0 / 3.0)) * sef
    r = ((0, 1), (0, 1))
    utau2 = torch.zeros_like(h)
    put(utau2, *r, torch.sqrt(
        (0.5 * (at(wusurf, *r) + at(wusurf, *r, 1, 0))) ** 2
        + (0.5 * (at(wvsurf, *r) + at(wvsurf, *r, 0, 1))) ** 2))
    put(q2f[kb - 1], *r, torch.sqrt(
        (0.5 * (at(wubot, *r) + at(wubot, *r, 1, 0))) ** 2
        + (0.5 * (at(wvbot, *r) + at(wvbot, *r, 0, 1))) ** 2) * const1)
    l0 = surfl * utau2 / grav
    # sound speed (solver.f:1303-1319)
    tp = t[:kbm1] + tbias
    sp = s[:kbm1] + sbias
    p = grav * rhoref * (-lv(zz, 0, kbm1) * h) * 1.0e-4
    ccv = (1449.1 + 0.00821 * p + 4.55 * tp - 0.045 * tp ** 2
           + 1.34 * (sp - 35.0))
    cc = ccv / torch.sqrt((1.0 - 0.01642 * p / ccv)
                          * (1.0 - 0.40 * p / ccv ** 2))
    K = slice(1, kbm1)
    q2b[K] = q2b[K].abs()
    q2lb[K] = q2lb[K].abs()
    boygr = torch.zeros_like(q2)
    boygr[K] = (grav * (rho[:kbm1 - 1] - rho[K]) / (lv(dzz, 0, kbm1 - 1) * h)
                + (grav ** 2) * 2.0 / (cc[:kbm1 - 1] ** 2 + cc[1:] ** 2))
    l = l_in.clone()
    gh = torch.zeros_like(q2)
    l[K] = (q2lb[K] / q2b[K]).abs()
    near = (z[K] > -0.5)[:, None, None]
    l[K] = torch.where(near, torch.maximum(l[K], kappa * l0), l[K])
    gh[K] = torch.clamp(l[K] ** 2 * boygr[K] / q2b[K], max=0.028)
    l[0] = kappa * l0
    l[kb - 1] = 0.0
    prod = torch.zeros_like(q2)
    K1 = slice(0, kbm1 - 1)
    du = (at(u[K], IN, IN) - at(u[K1], IN, IN) + at(u[K], IN, IN, 1, 0)
          - at(u[K1], IN, IN, 1, 0))
    dv = (at(v[K], IN, IN) - at(v[K1], IN, IN) + at(v[K], IN, IN, 0, 1)
          - at(v[K1], IN, IN, 0, 1))
    put(prod[K], IN, IN,
        at(km[K], IN, IN) * 0.25 * sef * (du ** 2 + dv ** 2)
        / (lv(dzz, 0, kbm1 - 1) * at(dh, IN, IN)) ** 2
        - shiw * at(km[K], IN, IN) * at(boygr[K], IN, IN)
        + at(kh[K], IN, IN) * at(boygr[K], IN, IN))
    stf = 1.0
    dtef = torch.sqrt(q2b.abs()) * stf / (b1 * l + small)
    # q2 (solver.f:1394-1413)
    ee = [torch.zeros_like(h)]
    gg = [(15.8 * cbcnst) ** (2.0 / 3.0) * utau2]
    for k in range(1, kbm1):
        ak, ck = a(k), c(k)
        rr = 1.0 / (ak + ck * (1.0 - ee[k - 1]) - (2.0 * dti2 * dtef[k] + 1.0))
        ee.append(ak * rr)
        gg.append((-2.0 * dti2 * prod[k] + ck * gg[k - 1] - q2f[k]) * rr)
    for k in range(kbm1 - 1, -1, -1):
        q2f[k] = ee[k] * q2f[k + 1] + gg[k]
    # q2l (solver.f:1415-1455)
    q2lf[0] = 0.0
    q2lf[kb - 1] = 0.0
    ee[1] = torch.zeros_like(h)
    gg[1] = -kappa * z[1] * dh * q2[1]
    q2lf[kb - 2] = kappa * (1.0 + z[kbm1 - 1]) * dh * q2[kbm1 - 1]
    wall = ((1.0 / (z[K] - z[0]).abs() + 1.0 / (z[K] - z[kb - 1]).abs())
            [:, None, None] * l[K] / (dh * kappa))
    dtef[K] = dtef[K] * (1.0 + e2 * wall ** 2)
    for k in range(2, kbm1):
        ak, ck = a(k), c(k)
        rr = 1.0 / (ak + ck * (1.0 - ee[k - 1]) - (dti2 * dtef[k] + 1.0))
        ee[k] = ak * rr
        gg[k] = (dti2 * (-prod[k] * l[k] * e1) + ck * gg[k - 1]
                 - q2lf[k]) * rr
    for k in range(kb - 2, 0, -1):
        q2lf[k] = ee[k] * q2lf[k + 1] + gg[k]
    q2f[K] = q2f[K].abs()
    q2lf[K] = q2lf[K].abs()
    # stability functions and mixing coefficients (solver.f:1474-1506)
    coef4 = 18.0 * a1 * a1 + 9.0 * a1 * a2
    coef5 = 9.0 * a1 * a2
    coef1 = a2 * (1.0 - 6.0 * a1 / b1 * stf)
    coef2 = 3.0 * a2 * b2 / stf + 18.0 * a1 * a2
    coef3 = a1 * (1.0 - 3.0 * c1 - 6.0 * a1 / b1 * stf)
    sh = coef1 / (1.0 - coef2 * gh)
    sm = (coef3 + sh * coef4 * gh) / (1.0 - coef5 * gh)
    kn = l * torch.sqrt(q2.abs())
    kq = (kn * 0.41 * sh + kq) * 0.5
    km = (kn * sm + km) * 0.5
    kh = (kn * sh + kh) * 0.5
    out = []
    for x in (km, kh, kq):
        x[:, :, -1] = x[:, :, -2]
        x[:, :, 0] = x[:, :, 1]
        x[:, -1, :] = x[:, -2, :]
        x[:, 0, :] = x[:, 1, :]
        out.append(x * fsm)
    km, kh, kq = out
    return q2f, q2lf, km, kh, kq, l, q2b, q2lb


# --------------------------------------------------------------------------
# open boundaries
# --------------------------------------------------------------------------

def _edge_ts(t, s, vel, dl, w, dt, zz, dti, prof_t, prof_s, kbm1, edge,
             inner, inflow_if_positive):
    """One side of bcond_ts_ref, all levels k < kbm1 along the side:
    ``edge``/``inner`` pick the side's cells and the ones a cell in from
    it (callables on a (…, im, jm) field); ``vel`` is the normal velocity
    the side reads, ``dl`` the two metrics' sum."""
    K = slice(0, kbm1)
    u1 = 2.0 * vel * dti / dl
    inflow = (u1 >= 0.0) if inflow_if_positive else (u1 <= 0.0)
    out = []
    for f, prof in ((t, prof_t), (s, prof_s)):
        fe, fi = edge(f[K]), inner(f[K])
        if inflow_if_positive:
            inn = fe - u1 * (fe - prof[K])
            outf = fe - u1 * (fi - fe)
        else:
            inn = fe - u1 * (prof[K] - fe)
            outf = fe - u1 * (fe - fi)
        # the vertical advection of an outflowing column, levels 1..kbm1-2
        wm = torch.zeros_like(outf)
        wi, dti_ = inner(w), inner(dt)
        wm[1:kbm1 - 1] = (0.5 * (wi[1:kbm1 - 1] + wi[2:kbm1]) * dti
                          / ((zz[:kbm1 - 2] - zz[2:kbm1])[:, None]
                             * dti_[None]))
        outf = outf - wm * torch.cat([
            torch.zeros_like(fi[:1]), fi[:kbm1 - 2] - fi[2:kbm1],
            torch.zeros_like(fi[:1])])
        out.append(torch.where(inflow, inn, outf))
    return out


def bcond_ts(uf_in, vf_in, t, s, u, v, w, dt, fc, dx, dy, zz, fsm, dti,
             kbm1):
    """bcond_ts_ref: the advective open boundary of T and S, east and west
    then south and north (which take the corners),
    bounds_forcing.f:151-242."""
    uf, vf = uf_in.clone(), vf_in.clone()
    K = slice(0, kbm1)
    sides = (
        # (velocity, metric sum, edge, inner, profiles, inflow if u1 >= 0)
        (u[K, -1, :], dx[-1, :] + dx[-2, :], lambda a: a[..., -1, :],
         lambda a: a[..., -2, :], "e", False),
        (u[K, 1, :], dx[0, :] + dx[1, :], lambda a: a[..., 0, :],
         lambda a: a[..., 1, :], "w", True),
        (v[K, :, 1], dy[:, 0] + dy[:, 1], lambda a: a[..., :, 0],
         lambda a: a[..., :, 1], "s", True),
        (v[K, :, -1], dy[:, -1] + dy[:, -2], lambda a: a[..., :, -1],
         lambda a: a[..., :, -2], "n", False))
    for vel, dl, edge, inner, side, pos in sides:
        nt, ns = _edge_ts(t, s, vel, dl, w, dt, zz, dti, fc["tb" + side],
                          fc["sb" + side], kbm1, edge, inner, pos)
        edge(uf[K]).copy_(nt)
        edge(vf[K]).copy_(ns)
    uf[K] = uf[K] * fsm
    vf[K] = vf[K] * fsm
    return uf, vf


def bcond_turb(uf_in, vf_in, q2, q2l, u, v, dx, dy, fsm, dti, small):
    """bcond_turb_ref: the upstream open boundary of q2 and q2l, west and
    east then south and north, bounds_forcing.f:257-325."""
    uf, vf = uf_in.clone(), vf_in.clone()
    sides = ((u[:, 1, :], dx[0, :] + dx[1, :], lambda a: a[..., 0, :],
              lambda a: a[..., 1, :], True),
             (u[:, -1, :], dx[-1, :] + dx[-2, :], lambda a: a[..., -1, :],
              lambda a: a[..., -2, :], False),
             (v[:, :, 1], dy[:, 0] + dy[:, 1], lambda a: a[..., :, 0],
              lambda a: a[..., :, 1], True),
             (v[:, :, -1], dy[:, -1] + dy[:, -2], lambda a: a[..., :, -1],
              lambda a: a[..., :, -2], False))
    for vel, dl, edge, inner, pos in sides:
        u1 = 2.0 * vel * dti / dl
        inflow = (u1 >= 0.0) if pos else (u1 <= 0.0)
        for f, out in ((q2, uf), (q2l, vf)):
            fe, fi = edge(f), inner(f)
            if pos:
                new = torch.where(inflow, fe - u1 * (fe - small),
                                  fe - u1 * (fi - fe))
            else:
                new = torch.where(inflow, fe - u1 * (small - fe),
                                  fe - u1 * (fe - fi))
            edge(out).copy_(new)
    return uf * fsm + 1.0e-10, vf * fsm + 1.0e-10


def _orl_cl(ff, fb, fi):
    """The Orlanski phase speed of bcondorl: clamped to [0, 1], with a zero
    denominator taken as 0.01."""
    den = ff + fb - 2.0 * fi
    den = torch.where(den == 0.0, torch.full_like(den, 0.01), den)
    return torch.clamp((fb - ff) / den, 0.0, 1.0)


def bcondorl_vel3d(uf_in, vf_in, u, ub, v, vb, dum, dvm, kbm1):
    """bcondorl_vel3d_ref: Orlanski radiation of the internal velocity,
    bounds_forcing.f:418-487."""
    uf, vf = uf_in.clone(), vf_in.clone()
    K, J, I = slice(0, kbm1), slice(1, -1), slice(1, -1)
    cl = _orl_cl(uf[K, -2, J], ub[K, -2, J], u[K, -3, J])
    uf[K, -1, J] = (ub[K, -1, J] * (1.0 - cl) + 2.0 * cl * u[K, -2, J]) \
        / (1.0 + cl)
    vf[K, -1, J] = 0.0
    cl = _orl_cl(uf[K, 2, J], ub[K, 2, J], u[K, 3, J])
    uf[K, 1, J] = (ub[K, 1, J] * (1.0 - cl) + 2.0 * cl * u[K, 2, J]) \
        / (1.0 + cl)
    uf[K, 0, J] = uf[K, 1, J]
    vf[K, 0, J] = 0.0
    cl = _orl_cl(vf[K, I, 2], vb[K, I, 2], v[K, I, 3])
    vf[K, I, 1] = (vb[K, I, 1] * (1.0 - cl) + 2.0 * cl * v[K, I, 2]) \
        / (1.0 + cl)
    vf[K, I, 0] = vf[K, I, 1]
    uf[K, I, 0] = 0.0
    cl = _orl_cl(vf[K, I, -2], vb[K, I, -2], v[K, I, -3])
    vf[K, I, -1] = (vb[K, I, -1] * (1.0 - cl) + 2.0 * cl * v[K, I, -2]) \
        / (1.0 + cl)
    uf[K, I, -1] = 0.0
    uf[K] = uf[K] * dum
    vf[K] = vf[K] * dvm
    return uf, vf


def bcond_el(elf_in, fsm):
    """bcond_el_ref: zero-gradient elevation, west, east, south, north."""
    elf = elf_in.clone()
    elf[0, :] = elf[1, :]
    elf[-1, :] = elf[-2, :]
    elf[:, 0] = elf[:, 1]
    elf[:, -1] = elf[:, -2]
    return elf * fsm


def bcond_vel2d(uaf_in, vaf_in, el, d, fc, dum, dvm, grav, ramp, rfe, rfw,
                rfn, rfs):
    """bcond_vel2d_ref: Flather radiation of the depth-mean velocity,
    bounds_forcing.f:43-83."""
    uaf, vaf = uaf_in.clone(), vaf_in.clone()
    J, I = slice(1, -1), slice(1, -1)
    uaf[1, J] = ramp * (fc["uabw"][J] - rfw * torch.sqrt(grav / d[1, J])
                        * (el[1, J] - fc["elw"][J]))
    uaf[0, J] = uaf[1, J]
    vaf[0, J] = fc["vabw"][J]
    uaf[-1, J] = ramp * (fc["uabe"][J] + rfe * torch.sqrt(grav / d[-2, J])
                         * (el[-2, J] - fc["ele"][J]))
    vaf[-1, J] = fc["vabe"][J]
    vaf[I, 1] = ramp * (fc["vabs"][I] - rfs * torch.sqrt(grav / d[I, 1])
                        * (el[I, 1] - fc["els"][I]))
    vaf[I, 0] = vaf[I, 1]
    uaf[I, 0] = fc["uabs"][I]
    vaf[I, -1] = ramp * (fc["vabn"][I] + rfn * torch.sqrt(grav / d[I, -2])
                         * (el[I, -2] - fc["eln"][I]))
    uaf[I, -1] = fc["uabn"][I]
    return uaf * dum, vaf * dvm


def _smooth(a):
    """The 1-2-1 average along the last axis, on its interior points."""
    return 0.25 * a[..., :-2] + 0.5 * a[..., 1:-1] + 0.25 * a[..., 2:]


def bcond_vel3d(uf_in, vf_in, u, v, d, fc, hmax, dum, dvm, kbm1):
    """bcond_vel3d_ref: the internal velocity of the open edges,
    bounds_forcing.f:85-149.  On levels k < kbm1 the normal velocity of
    each edge is the blend ga * (the old velocity one cell in) + (1 - ga)
    * (the edge's profile), each smoothed 1-2-1 along the edge, with
    ga = sqrt(d / hmax) at the edge's outer cell; the tangential velocity
    is the profile.  Written east, west, south, north, then masked."""
    uf, vf = uf_in.clone(), vf_in.clone()
    K, J, I = slice(0, kbm1), slice(1, -1), slice(1, -1)
    blend = lambda ga, inner, prof: (ga * _smooth(inner)
                                     + (1.0 - ga) * _smooth(prof[K]))
    uf[K, -1, J] = blend(torch.sqrt(d[-1, J] / hmax), u[K, -2, :],
                         fc["ube"])
    vf[K, -1, J] = fc["vbe"][K, J]
    uf[K, 1, J] = blend(torch.sqrt(d[0, J] / hmax), u[K, 2, :], fc["ubw"])
    uf[K, 0, J] = uf[K, 1, J]
    vf[K, 0, J] = fc["vbw"][K, J]
    vf[K, I, 1] = blend(torch.sqrt(d[I, 0] / hmax), v[K, :, 2], fc["vbs"])
    vf[K, I, 0] = vf[K, I, 1]
    uf[K, I, 0] = fc["ubs"][K, I]
    vf[K, I, -1] = blend(torch.sqrt(d[I, -1] / hmax), v[K, :, -2],
                         fc["vbn"])
    uf[K, I, -1] = fc["ubn"][K, I]
    uf[K] = uf[K] * dum
    vf[K] = vf[K] * dvm
    return uf, vf


def restore_interior(t, tb, s, sb, trstr, srstr, taurstr, fsm, dti, kbm1):
    """restore_interior_ref: T and S of both time levels relaxed toward
    ``trstr`` and ``srstr`` at the rate ``taurstr`` [1/day] on levels
    k < kbm1, then masked, bounds_forcing.f:1097-1118 -> (t, tb, s, sb).
    ``taurstr`` is (kb, im, jm) or one value as (1, 1, 1)."""
    fac = 2.0 * dti / 86400.0 * taurstr[:kbm1]
    out = []
    for f, clim in ((t, trstr), (tb, trstr), (s, srstr), (sb, srstr)):
        f = f.clone()
        f[:kbm1] = (f[:kbm1] + fac * (clim[:kbm1] - f[:kbm1])) * fsm
        out.append(f)
    return tuple(out)
