"""Independent NumPy oracle implementations of the numerical kernels.

Loop-based (Fortran-ordered i/j/k loops), written directly from the
discretized equations (solver.f citations in each function) as an
independent check on the vectorized JAX ops.  Arrays follow the framework
convention: 3-D fields are (kb, im, jm); loops run over 0-based indices
with the reference's 1-based bounds shifted by one.
"""

import numpy as np


def dens_ref(s, t, zz, h, fsm, tbias, sbias, grav, rhoref):
    """EOS, solver.f:1162-1209 (Mellor 1991 approximate UNESCO)."""
    kb, im, jm = t.shape
    rho = np.zeros((kb, im, jm))
    for k in range(kb - 1):
        for i in range(im):
            for j in range(jm):
                tr = t[k, i, j] + tbias
                sr = s[k, i, j] + sbias
                tr2 = tr * tr
                tr3 = tr2 * tr
                tr4 = tr3 * tr
                p = grav * rhoref * (-zz[k] * h[i, j]) * 1.0e-5
                rhor = (-0.157406 + 6.793952e-2 * tr - 9.095290e-3 * tr2
                        + 1.001685e-4 * tr3 - 1.120083e-6 * tr4
                        + 6.536332e-9 * tr4 * tr)
                rhor += ((0.824493 - 4.0899e-3 * tr + 7.6438e-5 * tr2
                          - 8.2467e-7 * tr3 + 5.3875e-9 * tr4) * sr
                         + (-5.72466e-3 + 1.0227e-4 * tr
                            - 1.6546e-6 * tr2) * abs(sr) ** 1.5
                         + 4.8314e-4 * sr * sr)
                cr = (1449.1 + 0.0821 * p + 4.55 * tr - 0.045 * tr2
                      + 1.34 * (sr - 35.0))
                rhor += 1.0e5 * p / (cr * cr) * (1.0 - 2.0 * p / (cr * cr))
                rho[k, i, j] = rhor / rhoref * fsm[i, j]
    return rho


def baropg_ref(rho, rmean, dt, dum, dvm, dx, dy, zz, grav, ramp, kbm1):
    """2nd-order sigma-coordinate pressure gradient, solver.f:848-940."""
    kb, im, jm = rho.shape
    rr = rho - rmean
    drhox = np.zeros((kb, im, jm))
    drhoy = np.zeros((kb, im, jm))
    # x component
    for j in range(1, jm - 1):
        for i in range(1, im - 1):
            drhox[0, i, j] = (0.5 * grav * (-zz[0]) * (dt[i, j] + dt[i-1, j])
                              * (rr[0, i, j] - rr[0, i-1, j]))
            for k in range(1, kbm1):
                drhox[k, i, j] = (
                    drhox[k-1, i, j]
                    + grav * 0.25 * (zz[k-1] - zz[k])
                    * (dt[i, j] + dt[i-1, j])
                    * (rr[k, i, j] - rr[k, i-1, j]
                       + rr[k-1, i, j] - rr[k-1, i-1, j])
                    + grav * 0.25 * (zz[k-1] + zz[k])
                    * (dt[i, j] - dt[i-1, j])
                    * (rr[k, i, j] + rr[k, i-1, j]
                       - rr[k-1, i, j] - rr[k-1, i-1, j]))
    for k in range(kbm1):
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                drhox[k, i, j] = (0.25 * (dt[i, j] + dt[i-1, j])
                                  * drhox[k, i, j] * dum[i, j]
                                  * (dy[i, j] + dy[i-1, j])) * ramp
    # y component
    for j in range(1, jm - 1):
        for i in range(1, im - 1):
            drhoy[0, i, j] = (0.5 * grav * (-zz[0]) * (dt[i, j] + dt[i, j-1])
                              * (rr[0, i, j] - rr[0, i, j-1]))
            for k in range(1, kbm1):
                drhoy[k, i, j] = (
                    drhoy[k-1, i, j]
                    + grav * 0.25 * (zz[k-1] - zz[k])
                    * (dt[i, j] + dt[i, j-1])
                    * (rr[k, i, j] - rr[k, i, j-1]
                       + rr[k-1, i, j] - rr[k-1, i, j-1])
                    + grav * 0.25 * (zz[k-1] + zz[k])
                    * (dt[i, j] - dt[i, j-1])
                    * (rr[k, i, j] + rr[k, i, j-1]
                       - rr[k-1, i, j] - rr[k-1, i, j-1]))
    for k in range(kbm1):
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                drhoy[k, i, j] = (0.25 * (dt[i, j] + dt[i, j-1])
                                  * drhoy[k, i, j] * dvm[i, j]
                                  * (dx[i, j] + dx[i, j-1])) * ramp
    return drhox, drhoy


def vertvl_ref(w_in, u, v, dt, etf, etb, vfluxb, vfluxf,
               dx, dy, dz, dti2, kbm1):
    """Vertical velocity from continuity, solver.f:1970-2021."""
    kb, im, jm = u.shape
    xflux = np.zeros((kb, im, jm))
    yflux = np.zeros((kb, im, jm))
    for k in range(kbm1):
        for j in range(1, jm):
            for i in range(1, im):
                xflux[k, i, j] = (0.25 * (dy[i, j] + dy[i-1, j])
                                  * (dt[i, j] + dt[i-1, j]) * u[k, i, j])
                yflux[k, i, j] = (0.25 * (dx[i, j] + dx[i, j-1])
                                  * (dt[i, j] + dt[i, j-1]) * v[k, i, j])
    w = w_in.copy()
    for j in range(1, jm - 1):
        for i in range(1, im - 1):
            w[0, i, j] = 0.5 * (vfluxb[i, j] + vfluxf[i, j])
            for k in range(kbm1):
                w[k+1, i, j] = (w[k, i, j]
                                + dz[k] * ((xflux[k, i+1, j] - xflux[k, i, j]
                                            + yflux[k, i, j+1] - yflux[k, i, j])
                                           / (dx[i, j] * dy[i, j])
                                           + (etf[i, j] - etb[i, j]) / dti2))
    return w


def proft_ref(f_in, wfsurf, fsurf, nbc, kh, etf, swrad,
              h, z, dz, dzz, dti2, umol, ntp, kb):
    """Implicit vertical tracer diffusion, solver.f:1541-1683.

    Richtmyer-Morton tridiagonal: a[k] f[k+1] + (denominator) f[k] +
    c[k] f[k-1] with 4 surface BC variants and the Paulson-Simpson
    two-band shortwave absorption profile."""
    kbm1, kbm2 = kb - 1, kb - 2
    _, im, jm = f_in.shape
    R = (0.58, 0.62, 0.67, 0.77, 0.78)[ntp - 1]
    ad1 = (0.35, 0.60, 1.0, 1.5, 1.4)[ntp - 1]
    ad2 = (23.0, 20.0, 17.0, 14.0, 7.9)[ntp - 1]
    f = f_in.copy()
    for i in range(im):
        for j in range(jm):
            dh = h[i, j] + etf[i, j]
            a = np.zeros(kb)
            c = np.zeros(kb)
            for k in range(kbm2):
                a[k] = -dti2 * (kh[k+1, i, j] + umol) / (
                    dz[k] * dzz[k] * dh * dh)
            for k in range(1, kbm1):
                c[k] = -dti2 * (kh[k, i, j] + umol) / (
                    dz[k] * dzz[k-1] * dh * dh)
            rad = np.zeros(kb)
            if nbc in (2, 4):
                for k in range(kbm1):
                    rad[k] = swrad[i, j] * (
                        R * np.exp(z[k] * dh / ad1)
                        + (1.0 - R) * np.exp(z[k] * dh / ad2))
            ee = np.zeros(kb)
            gg = np.zeros(kb)
            if nbc in (1, 2):
                ee[0] = a[0] / (a[0] - 1.0)
                flux0 = wfsurf[i, j] + (rad[0] - rad[1] if nbc == 2 else 0.0)
                gg[0] = (dti2 * flux0 / (dz[0] * dh)
                         - f[0, i, j]) / (a[0] - 1.0)
            else:
                ee[0] = 0.0
                gg[0] = fsurf[i, j]
            for k in range(1, kbm2):
                gg_ = 1.0 / (a[k] + c[k] * (1.0 - ee[k-1]) - 1.0)
                ee[k] = a[k] * gg_
                gg[k] = (c[k] * gg[k-1] - f[k, i, j]
                         + dti2 * (rad[k] - rad[k+1]) / (dh * dz[k])) * gg_
            # bottom adiabatic BC at k = kbm1-1
            f[kbm1-1, i, j] = ((c[kbm1-1] * gg[kbm2-1] - f[kbm1-1, i, j]
                                + dti2 * (rad[kbm1-1] - rad[kbm1])
                                / (dh * dz[kbm1-1]))
                               / (c[kbm1-1] * (1.0 - ee[kbm2-1]) - 1.0))
            for k in range(kbm2 - 1, -1, -1):
                f[k, i, j] = ee[k] * f[k+1, i, j] + gg[k]
    return f


def advt1_ref(fb, f_in, fclim, u, v, w, aam, dt, etb, etf,
              h, dum, dvm, dx, dy, art, dz, dti2, tprni, kbm1):
    """Central tracer advection-diffusion + leapfrog, solver.f:480-574."""
    kb, im, jm = fb.shape
    f = f_in.copy()
    fbw = fb.copy()
    f[kb-1] = f[kb-2]
    fbw[kb-1] = fbw[kb-2]
    xflux = np.zeros((kb, im, jm))
    yflux = np.zeros((kb, im, jm))
    fbmc = fbw - fclim
    for k in range(kbm1):
        for j in range(1, jm):
            for i in range(1, im):
                xa = 0.25 * ((dt[i, j] + dt[i-1, j])
                             * (f[k, i, j] + f[k, i-1, j]) * u[k, i, j])
                ya = 0.25 * ((dt[i, j] + dt[i, j-1])
                             * (f[k, i, j] + f[k, i, j-1]) * v[k, i, j])
                xd = (-0.5 * (aam[k, i, j] + aam[k, i-1, j])
                      * (h[i, j] + h[i-1, j]) * tprni
                      * (fbmc[k, i, j] - fbmc[k, i-1, j]) * dum[i, j]
                      / (dx[i, j] + dx[i-1, j]))
                yd = (-0.5 * (aam[k, i, j] + aam[k, i, j-1])
                      * (h[i, j] + h[i, j-1]) * tprni
                      * (fbmc[k, i, j] - fbmc[k, i, j-1]) * dvm[i, j]
                      / (dy[i, j] + dy[i, j-1]))
                xflux[k, i, j] = 0.5 * (dy[i, j] + dy[i-1, j]) * (xa + xd)
                yflux[k, i, j] = 0.5 * (dx[i, j] + dx[i, j-1]) * (ya + yd)
    zflux = np.zeros((kb, im, jm))
    for j in range(1, jm - 1):
        for i in range(1, im - 1):
            zflux[0, i, j] = f[0, i, j] * w[0, i, j] * art[i, j]
            for k in range(1, kbm1):
                zflux[k, i, j] = (0.5 * (f[k-1, i, j] + f[k, i, j])
                                  * w[k, i, j] * art[i, j])
    ff = np.zeros((kb, im, jm))
    for k in range(kbm1):
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                adv = (xflux[k, i+1, j] - xflux[k, i, j]
                       + yflux[k, i, j+1] - yflux[k, i, j]
                       + (zflux[k, i, j] - zflux[k+1, i, j]) / dz[k])
                ff[k, i, j] = ((fbw[k, i, j] * (h[i, j] + etb[i, j])
                                * art[i, j] - dti2 * adv)
                               / ((h[i, j] + etf[i, j]) * art[i, j]))
    return ff


def profu_ref(uf_in, ub, vb, km, etf, wusurf, h, cbc, dum,
              dz, dzz, dti2, umol, kb):
    """Implicit vertical u-diffusion + quadratic bottom friction,
    solver.f:1686-1780."""
    kbm1, kbm2 = kb - 1, kb - 2
    _, im, jm = ub.shape
    uf = uf_in.copy()
    wubot = np.zeros((im, jm))
    for i in range(1, im - 1):
        for j in range(1, jm - 1):
            dh = 1.0
            if i > 0 and j > 0:
                dh = 0.5 * (h[i, j] + etf[i, j] + h[i-1, j] + etf[i-1, j])
            cm = np.zeros(kb)
            for k in range(kb):
                cm[k] = 0.5 * (km[k, i, j] + km[k, i-1, j])
            a = np.zeros(kb)
            c = np.zeros(kb)
            for k in range(kbm2):
                a[k] = -dti2 * (cm[k+1] + umol) / (dz[k] * dzz[k] * dh * dh)
            for k in range(1, kbm1):
                c[k] = -dti2 * (cm[k] + umol) / (dz[k] * dzz[k-1] * dh * dh)
            ee = np.zeros(kb)
            gg = np.zeros(kb)
            ee[0] = a[0] / (a[0] - 1.0)
            gg[0] = (-dti2 * wusurf[i, j] / (-dz[0] * dh)
                     - uf[0, i, j]) / (a[0] - 1.0)
            for k in range(1, kbm2):
                gg_ = 1.0 / (a[k] + c[k] * (1.0 - ee[k-1]) - 1.0)
                ee[k] = a[k] * gg_
                gg[k] = (c[k] * gg[k-1] - uf[k, i, j]) * gg_
            tps = (0.5 * (cbc[i, j] + cbc[i-1, j])
                   * np.sqrt(ub[kbm1-1, i, j] ** 2
                             + (0.25 * (vb[kbm1-1, i, j] + vb[kbm1-1, i, j+1]
                                        + vb[kbm1-1, i-1, j]
                                        + vb[kbm1-1, i-1, j+1])) ** 2))
            uf[kbm1-1, i, j] = ((c[kbm1-1] * gg[kbm2-1] - uf[kbm1-1, i, j])
                                / (tps * dti2 / (-dz[kbm1-1] * dh) - 1.0
                                   - (ee[kbm2-1] - 1.0) * c[kbm1-1])
                                ) * dum[i, j]
            for k in range(kbm2 - 1, -1, -1):
                uf[k, i, j] = (ee[k] * uf[k+1, i, j] + gg[k]) * dum[i, j]
            wubot[i, j] = -tps * uf[kbm1-1, i, j]
    return uf, wubot


# ---------------------------------------------------------------------------
# round-2 additions: oracles for the remaining solver.f kernels
# ---------------------------------------------------------------------------

def advave_ref(d, ua, va, uab, vab, aam2d, wubot_in, wvbot_in,
               cbc, dx, dy, aru, arv, mode):
    """External-mode momentum advection + diffusion, solver.f:6-199.

    Single-tile semantics (n_west = n_south = -1: curvature loops start one
    row further in at the physical west/south edges)."""
    im, jm = d.shape
    advua = np.zeros((im, jm))
    fluxua = np.zeros((im, jm))
    fluxva = np.zeros((im, jm))
    # u-advection: advective fluxes (solver.f:20-34)
    for j in range(1, jm):
        for i in range(1, im - 1):
            fluxua[i, j] = (0.125 * ((d[i+1, j] + d[i, j]) * ua[i+1, j]
                                     + (d[i, j] + d[i-1, j]) * ua[i, j])
                            * (ua[i+1, j] + ua[i, j]))
    for j in range(1, jm):
        for i in range(1, im):
            fluxva[i, j] = (0.125 * ((d[i, j] + d[i, j-1]) * va[i, j]
                                     + (d[i-1, j] + d[i-1, j-1]) * va[i-1, j])
                            * (ua[i, j] + ua[i, j-1]))
    # viscous fluxes (solver.f:37-58)
    for j in range(1, jm):
        for i in range(1, im - 1):
            fluxua[i, j] -= (d[i, j] * 2.0 * aam2d[i, j]
                             * (uab[i+1, j] - uab[i, j]) / dx[i, j])
    tps = np.zeros((im, jm))
    for j in range(1, jm):
        for i in range(1, im):
            tps[i, j] = (0.25 * (d[i, j] + d[i-1, j] + d[i, j-1] + d[i-1, j-1])
                         * (aam2d[i, j] + aam2d[i, j-1]
                            + aam2d[i-1, j] + aam2d[i-1, j-1])
                         * ((uab[i, j] - uab[i, j-1])
                            / (dy[i, j] + dy[i-1, j] + dy[i, j-1] + dy[i-1, j-1])
                            + (vab[i, j] - vab[i-1, j])
                            / (dx[i, j] + dx[i-1, j] + dx[i, j-1] + dx[i-1, j-1])))
            fluxua[i, j] *= dy[i, j]
            fluxva[i, j] = ((fluxva[i, j] - tps[i, j]) * 0.25
                            * (dx[i, j] + dx[i-1, j] + dx[i, j-1] + dx[i-1, j-1]))
    for j in range(1, jm - 1):
        for i in range(1, im - 1):
            advua[i, j] = (fluxua[i, j] - fluxua[i-1, j]
                           + fluxva[i, j+1] - fluxva[i, j])
    # v-advection (solver.f:72-121)
    advva = np.zeros((im, jm))
    fluxua = np.zeros((im, jm))
    fluxva = np.zeros((im, jm))
    for j in range(1, jm):
        for i in range(1, im):
            fluxua[i, j] = (0.125 * ((d[i, j] + d[i-1, j]) * ua[i, j]
                                     + (d[i, j-1] + d[i-1, j-1]) * ua[i, j-1])
                            * (va[i-1, j] + va[i, j]))
    for j in range(1, jm - 1):
        for i in range(1, im):
            fluxva[i, j] = (0.125 * ((d[i, j+1] + d[i, j]) * va[i, j+1]
                                     + (d[i, j] + d[i, j-1]) * va[i, j])
                            * (va[i, j+1] + va[i, j]))
    for j in range(1, jm - 1):
        for i in range(1, im):
            fluxva[i, j] -= (d[i, j] * 2.0 * aam2d[i, j]
                             * (vab[i, j+1] - vab[i, j]) / dy[i, j])
    for j in range(1, jm):
        for i in range(1, im):
            fluxva[i, j] *= dx[i, j]
            fluxua[i, j] = ((fluxua[i, j] - tps[i, j]) * 0.25
                            * (dy[i, j] + dy[i-1, j] + dy[i, j-1] + dy[i-1, j-1]))
    for j in range(1, jm - 1):
        for i in range(1, im - 1):
            advva[i, j] = (fluxua[i+1, j] - fluxua[i, j]
                           + fluxva[i, j] - fluxva[i, j-1])

    wubot = wubot_in.copy()
    wvbot = wvbot_in.copy()
    if mode == 2:
        # bottom stress + curvature terms (solver.f:123-195)
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                wubot[i, j] = (-0.5 * (cbc[i, j] + cbc[i-1, j])
                               * np.sqrt(uab[i, j] ** 2
                                         + (0.25 * (vab[i, j] + vab[i, j+1]
                                                    + vab[i-1, j]
                                                    + vab[i-1, j+1])) ** 2)
                               * uab[i, j])
                wvbot[i, j] = (-0.5 * (cbc[i, j] + cbc[i, j-1])
                               * np.sqrt(vab[i, j] ** 2
                                         + (0.25 * (uab[i, j] + uab[i+1, j]
                                                    + uab[i, j-1]
                                                    + uab[i+1, j-1])) ** 2)
                               * vab[i, j])
        curv2d = np.zeros((im, jm))
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                curv2d[i, j] = (0.25 * ((va[i, j+1] + va[i, j])
                                        * (dy[i+1, j] - dy[i-1, j])
                                        - (ua[i+1, j] + ua[i, j])
                                        * (dx[i, j+1] - dx[i, j-1]))
                                / (dx[i, j] * dy[i, j]))
        for j in range(1, jm - 1):
            for i in range(2, im - 1):        # west edge: i from 3
                advua[i, j] -= (aru[i, j] * 0.25
                                * (curv2d[i, j] * d[i, j]
                                   * (va[i, j+1] + va[i, j])
                                   + curv2d[i-1, j] * d[i-1, j]
                                   * (va[i-1, j+1] + va[i-1, j])))
        for i in range(1, im - 1):
            for j in range(2, jm - 1):        # south edge: j from 3
                advva[i, j] += (arv[i, j] * 0.25
                                * (curv2d[i, j] * d[i, j]
                                   * (ua[i+1, j] + ua[i, j])
                                   + curv2d[i, j-1] * d[i, j-1]
                                   * (ua[i+1, j-1] + ua[i, j-1])))
    return advua, advva, wubot, wvbot


def advct_ref(u, v, ub, vb, aam, dt, dx, dy, aru, arv, kbm1):
    """3-D horizontal momentum advection + diffusion, solver.f:201-408
    (single tile: curvature loops honor the physical west/south edges)."""
    kb, im, jm = u.shape
    curv = np.zeros((kb, im, jm))
    for k in range(kbm1):
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                curv[k, i, j] = (0.25 * ((v[k, i, j+1] + v[k, i, j])
                                         * (dy[i+1, j] - dy[i-1, j])
                                         - (u[k, i+1, j] + u[k, i, j])
                                         * (dx[i, j+1] - dx[i, j-1]))
                                 / (dx[i, j] * dy[i, j]))
    # x-component (solver.f:231-313)
    advx = np.zeros((kb, im, jm))
    xflux = np.zeros((kb, im, jm))
    yflux = np.zeros((kb, im, jm))
    for k in range(kbm1):
        for j in range(jm):
            for i in range(1, im - 1):
                xflux[k, i, j] = (0.125 * ((dt[i+1, j] + dt[i, j]) * u[k, i+1, j]
                                           + (dt[i, j] + dt[i-1, j]) * u[k, i, j])
                                  * (u[k, i+1, j] + u[k, i, j]))
        for j in range(1, jm):
            for i in range(1, im):
                yflux[k, i, j] = (0.125 * ((dt[i, j] + dt[i, j-1]) * v[k, i, j]
                                           + (dt[i-1, j] + dt[i-1, j-1])
                                           * v[k, i-1, j])
                                  * (u[k, i, j] + u[k, i, j-1]))
        for j in range(1, jm):
            for i in range(1, im - 1):
                xflux[k, i, j] -= (dt[i, j] * aam[k, i, j] * 2.0
                                   * (ub[k, i+1, j] - ub[k, i, j]) / dx[i, j])
                dtaam = (0.25 * (dt[i, j] + dt[i-1, j] + dt[i, j-1]
                                 + dt[i-1, j-1])
                         * (aam[k, i, j] + aam[k, i-1, j]
                            + aam[k, i, j-1] + aam[k, i-1, j-1]))
                yflux[k, i, j] -= (dtaam
                                   * ((ub[k, i, j] - ub[k, i, j-1])
                                      / (dy[i, j] + dy[i-1, j]
                                         + dy[i, j-1] + dy[i-1, j-1])
                                      + (vb[k, i, j] - vb[k, i-1, j])
                                      / (dx[i, j] + dx[i-1, j]
                                         + dx[i, j-1] + dx[i-1, j-1])))
                xflux[k, i, j] *= dy[i, j]
                yflux[k, i, j] *= 0.25 * (dx[i, j] + dx[i-1, j]
                                          + dx[i, j-1] + dx[i-1, j-1])
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                advx[k, i, j] = (xflux[k, i, j] - xflux[k, i-1, j]
                                 + yflux[k, i, j+1] - yflux[k, i, j])
        for j in range(1, jm - 1):
            for i in range(2, im - 1):        # west edge: i from 3
                advx[k, i, j] -= (aru[i, j] * 0.25
                                  * (curv[k, i, j] * dt[i, j]
                                     * (v[k, i, j+1] + v[k, i, j])
                                     + curv[k, i-1, j] * dt[i-1, j]
                                     * (v[k, i-1, j+1] + v[k, i-1, j])))
    # y-component (solver.f:317-403)
    advy = np.zeros((kb, im, jm))
    xflux = np.zeros((kb, im, jm))
    yflux = np.zeros((kb, im, jm))
    for k in range(kbm1):
        for j in range(1, jm):
            for i in range(1, im):
                xflux[k, i, j] = (0.125 * ((dt[i, j] + dt[i-1, j]) * u[k, i, j]
                                           + (dt[i, j-1] + dt[i-1, j-1])
                                           * u[k, i, j-1])
                                  * (v[k, i, j] + v[k, i-1, j]))
        for j in range(1, jm - 1):
            for i in range(im):
                yflux[k, i, j] = (0.125 * ((dt[i, j+1] + dt[i, j]) * v[k, i, j+1]
                                           + (dt[i, j] + dt[i, j-1]) * v[k, i, j])
                                  * (v[k, i, j+1] + v[k, i, j]))
        for j in range(1, jm - 1):
            for i in range(1, im):
                dtaam = (0.25 * (dt[i, j] + dt[i-1, j] + dt[i, j-1]
                                 + dt[i-1, j-1])
                         * (aam[k, i, j] + aam[k, i-1, j]
                            + aam[k, i, j-1] + aam[k, i-1, j-1]))
                xflux[k, i, j] -= (dtaam
                                   * ((ub[k, i, j] - ub[k, i, j-1])
                                      / (dy[i, j] + dy[i-1, j]
                                         + dy[i, j-1] + dy[i-1, j-1])
                                      + (vb[k, i, j] - vb[k, i-1, j])
                                      / (dx[i, j] + dx[i-1, j]
                                         + dx[i, j-1] + dx[i-1, j-1])))
                yflux[k, i, j] -= (dt[i, j] * aam[k, i, j] * 2.0
                                   * (vb[k, i, j+1] - vb[k, i, j]) / dy[i, j])
                xflux[k, i, j] *= 0.25 * (dy[i, j] + dy[i-1, j]
                                          + dy[i, j-1] + dy[i-1, j-1])
                yflux[k, i, j] *= dx[i, j]
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                advy[k, i, j] = (xflux[k, i+1, j] - xflux[k, i, j]
                                 + yflux[k, i, j] - yflux[k, i, j-1])
        for i in range(1, im - 1):
            for j in range(2, jm - 1):        # south edge: j from 3
                advy[k, i, j] += (arv[i, j] * 0.25
                                  * (curv[k, i, j] * dt[i, j]
                                     * (u[k, i+1, j] + u[k, i, j])
                                     + curv[k, i, j-1] * dt[i, j-1]
                                     * (u[k, i+1, j-1] + u[k, i, j-1])))
    return advx, advy


def advq_ref(qb, q, u, v, w, aam, dt, etb, etf,
             h, dum, dvm, dx, dy, art, dz, dti2, kbm1):
    """TKE-pair advection-diffusion + leapfrog, solver.f:411-477."""
    kb, im, jm = q.shape
    xflux = np.zeros((kb, im, jm))
    yflux = np.zeros((kb, im, jm))
    for k in range(1, kbm1):
        for j in range(1, jm):
            for i in range(1, im):
                xflux[k, i, j] = (0.125 * (q[k, i, j] + q[k, i-1, j])
                                  * (dt[i, j] + dt[i-1, j])
                                  * (u[k, i, j] + u[k-1, i, j]))
                yflux[k, i, j] = (0.125 * (q[k, i, j] + q[k, i, j-1])
                                  * (dt[i, j] + dt[i, j-1])
                                  * (v[k, i, j] + v[k-1, i, j]))
    for k in range(1, kbm1):
        for j in range(1, jm):
            for i in range(1, im):
                xflux[k, i, j] -= (0.25 * (aam[k, i, j] + aam[k, i-1, j]
                                           + aam[k-1, i, j] + aam[k-1, i-1, j])
                                   * (h[i, j] + h[i-1, j])
                                   * (qb[k, i, j] - qb[k, i-1, j]) * dum[i, j]
                                   / (dx[i, j] + dx[i-1, j]))
                yflux[k, i, j] -= (0.25 * (aam[k, i, j] + aam[k, i, j-1]
                                           + aam[k-1, i, j] + aam[k-1, i, j-1])
                                   * (h[i, j] + h[i, j-1])
                                   * (qb[k, i, j] - qb[k, i, j-1]) * dvm[i, j]
                                   / (dy[i, j] + dy[i, j-1]))
                xflux[k, i, j] *= 0.5 * (dy[i, j] + dy[i-1, j])
                yflux[k, i, j] *= 0.5 * (dx[i, j] + dx[i, j-1])
    qf = np.zeros((kb, im, jm))
    for k in range(1, kbm1):
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                qf[k, i, j] = ((w[k-1, i, j] * q[k-1, i, j]
                                - w[k+1, i, j] * q[k+1, i, j]) * art[i, j]
                               / (dz[k] + dz[k-1])
                               + xflux[k, i+1, j] - xflux[k, i, j]
                               + yflux[k, i, j+1] - yflux[k, i, j])
                qf[k, i, j] = (((h[i, j] + etb[i, j]) * art[i, j]
                                * qb[k, i, j] - dti2 * qf[k, i, j])
                               / ((h[i, j] + etf[i, j]) * art[i, j]))
    return qf


def advu_ref(u, ub, v, w, advx, drhox, dt, egf, egb, e_atmos, etb, etf,
             h, dy, aru, cor, dz, grav, dti2, kbm1):
    """u-momentum tendency + leapfrog step, solver.f:734-788."""
    kb, im, jm = u.shape
    vadv = np.zeros((kb, im, jm))
    for k in range(1, kbm1):
        for j in range(jm):
            for i in range(1, im):
                vadv[k, i, j] = (0.25 * (w[k, i, j] + w[k, i-1, j])
                                 * (u[k, i, j] + u[k-1, i, j]))
    uf = vadv.copy()
    for k in range(kbm1):
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                uf[k, i, j] = (advx[k, i, j]
                               + (vadv[k, i, j] - vadv[k+1, i, j])
                               * aru[i, j] / dz[k]
                               - aru[i, j] * 0.25
                               * (cor[i, j] * dt[i, j]
                                  * (v[k, i, j+1] + v[k, i, j])
                                  + cor[i-1, j] * dt[i-1, j]
                                  * (v[k, i-1, j+1] + v[k, i-1, j]))
                               + grav * 0.125 * (dt[i, j] + dt[i-1, j])
                               * (egf[i, j] - egf[i-1, j]
                                  + egb[i, j] - egb[i-1, j]
                                  + (e_atmos[i, j] - e_atmos[i-1, j]) * 2.0)
                               * (dy[i, j] + dy[i-1, j])
                               + drhox[k, i, j])
                uf[k, i, j] = (((h[i, j] + etb[i, j] + h[i-1, j] + etb[i-1, j])
                                * aru[i, j] * ub[k, i, j]
                                - 2.0 * dti2 * uf[k, i, j])
                               / ((h[i, j] + etf[i, j]
                                   + h[i-1, j] + etf[i-1, j]) * aru[i, j]))
    return uf


def advv_ref(v, vb, u, w, advy, drhoy, dt, egf, egb, e_atmos, etb, etf,
             h, dx, arv, cor, dz, grav, dti2, kbm1):
    """v-momentum tendency + leapfrog step, solver.f:791-845."""
    kb, im, jm = v.shape
    vadv = np.zeros((kb, im, jm))
    for k in range(1, kbm1):
        for j in range(1, jm):
            for i in range(im):
                vadv[k, i, j] = (0.25 * (w[k, i, j] + w[k, i, j-1])
                                 * (v[k, i, j] + v[k-1, i, j]))
    vf = vadv.copy()
    for k in range(kbm1):
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                vf[k, i, j] = (advy[k, i, j]
                               + (vadv[k, i, j] - vadv[k+1, i, j])
                               * arv[i, j] / dz[k]
                               + arv[i, j] * 0.25
                               * (cor[i, j] * dt[i, j]
                                  * (u[k, i+1, j] + u[k, i, j])
                                  + cor[i, j-1] * dt[i, j-1]
                                  * (u[k, i+1, j-1] + u[k, i, j-1]))
                               + grav * 0.125 * (dt[i, j] + dt[i, j-1])
                               * (egf[i, j] - egf[i, j-1]
                                  + egb[i, j] - egb[i, j-1]
                                  + (e_atmos[i, j] - e_atmos[i, j-1]) * 2.0)
                               * (dx[i, j] + dx[i, j-1])
                               + drhoy[k, i, j])
                vf[k, i, j] = (((h[i, j] + etb[i, j] + h[i, j-1] + etb[i, j-1])
                                * arv[i, j] * vb[k, i, j]
                                - 2.0 * dti2 * vf[k, i, j])
                               / ((h[i, j] + etf[i, j]
                                   + h[i, j-1] + etf[i, j-1]) * arv[i, j]))
    return vf


def smol_adif_ref(xmassflux, ymassflux, zwflux, ff, dt,
                  aru, arv, dzz, fsm, dti2, sw, kbm1):
    """MPDATA antidiffusive velocities, solver.f:1880-1967.  Mutates copies
    of the mass fluxes; returns (xm, ym, zw, ff_masked)."""
    kb, im, jm = ff.shape
    value_min, epsilon = 1.0e-9, 1.0e-14
    xm = xmassflux.copy()
    ym = ymassflux.copy()
    zw = zwflux.copy()
    ff = ff * fsm
    for k in range(kbm1):
        for j in range(1, jm - 1):
            for i in range(1, im):
                if ff[k, i, j] < value_min or ff[k, i-1, j] < value_min:
                    xm[k, i, j] = 0.0
                else:
                    udx = abs(xm[k, i, j])
                    u2dt = (dti2 * xm[k, i, j] * xm[k, i, j] * 2.0
                            / (aru[i, j] * (dt[i-1, j] + dt[i, j])))
                    mol = ((ff[k, i, j] - ff[k, i-1, j])
                           / (ff[k, i-1, j] + ff[k, i, j] + epsilon))
                    xm[k, i, j] = (udx - u2dt) * mol * sw
                    if abs(udx) < abs(u2dt):
                        xm[k, i, j] = 0.0
    for k in range(kbm1):
        for j in range(1, jm):
            for i in range(1, im - 1):
                if ff[k, i, j] < value_min or ff[k, i, j-1] < value_min:
                    ym[k, i, j] = 0.0
                else:
                    vdy = abs(ym[k, i, j])
                    v2dt = (dti2 * ym[k, i, j] * ym[k, i, j] * 2.0
                            / (arv[i, j] * (dt[i, j-1] + dt[i, j])))
                    mol = ((ff[k, i, j] - ff[k, i, j-1])
                           / (ff[k, i, j-1] + ff[k, i, j] + epsilon))
                    ym[k, i, j] = (vdy - v2dt) * mol * sw
                    if abs(vdy) < abs(v2dt):
                        ym[k, i, j] = 0.0
    for k in range(1, kbm1):
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                if ff[k, i, j] < value_min or ff[k-1, i, j] < value_min:
                    zw[k, i, j] = 0.0
                else:
                    wdz = abs(zw[k, i, j])
                    w2dt = (dti2 * zw[k, i, j] * zw[k, i, j]
                            / (dzz[k-1] * dt[i, j]))
                    mol = ((ff[k-1, i, j] - ff[k, i, j])
                           / (ff[k, i, j] + ff[k-1, i, j] + epsilon))
                    zw[k, i, j] = (wdz - w2dt) * mol * sw
                    if abs(wdz) < abs(w2dt):
                        zw[k, i, j] = 0.0
    return xm, ym, zw, ff


def advt2_ref(fb_in, f, fclim, u, v, w, aam, dt, etb, etf,
              h, dum, dvm, fsm, dx, dy, art, aru, arv, dz, dzz,
              dti2, tprni, sw, nitera, kbm1):
    """Smolarkiewicz MPDATA tracer step, solver.f:577-731.  Returns ff
    (interior j,i = 2..m-1 valid, like the reference).

    Boundary-column convention: the reference's ff work array is a reused
    scratch buffer whose boundary columns hold STALE values from earlier
    kernels (advance.f:406-449); those stale values feed the upwind flux at
    the first interior face from the second MPDATA iteration on.  That is
    unreproducible; the framework's documented deviation initializes the
    work array with ``fb`` (extpom_tpu.ops.tracers module note), which this
    oracle follows."""
    kb, im, jm = fb_in.shape
    fb = fb_in.copy()
    fb[kb-1] = fb[kb-2]
    xmassflux = np.zeros((kb, im, jm))
    ymassflux = np.zeros((kb, im, jm))
    for k in range(kbm1):
        for j in range(1, jm - 1):
            for i in range(1, im):
                xmassflux[k, i, j] = (0.25 * (dy[i-1, j] + dy[i, j])
                                      * (dt[i-1, j] + dt[i, j]) * u[k, i, j])
        for j in range(1, jm):
            for i in range(1, im - 1):
                ymassflux[k, i, j] = (0.25 * (dx[i, j-1] + dx[i, j])
                                      * (dt[i, j-1] + dt[i, j]) * v[k, i, j])
    eta = etb.copy()
    zwflux = w.copy()
    fbmem = fb.copy()
    ff = fb.copy()
    xflux = np.zeros((kb, im, jm))
    yflux = np.zeros((kb, im, jm))
    zflux = np.zeros((kb, im, jm))
    for itera in range(nitera):
        for k in range(kbm1):
            for j in range(1, jm):
                for i in range(1, im):
                    xflux[k, i, j] = (0.5 * ((xmassflux[k, i, j]
                                              + abs(xmassflux[k, i, j]))
                                             * fbmem[k, i-1, j]
                                             + (xmassflux[k, i, j]
                                                - abs(xmassflux[k, i, j]))
                                             * fbmem[k, i, j]))
                    yflux[k, i, j] = (0.5 * ((ymassflux[k, i, j]
                                              + abs(ymassflux[k, i, j]))
                                             * fbmem[k, i, j-1]
                                             + (ymassflux[k, i, j]
                                                - abs(ymassflux[k, i, j]))
                                             * fbmem[k, i, j]))
        zflux[0, 1:-1, 1:-1] = 0.0
        if itera == 0:
            zflux[0, 1:-1, 1:-1] = (w[0, 1:-1, 1:-1] * f[0, 1:-1, 1:-1]
                                    * art[1:-1, 1:-1])
        zflux[kb-1, 1:-1, 1:-1] = 0.0
        for k in range(1, kbm1):
            for j in range(1, jm - 1):
                for i in range(1, im - 1):
                    zflux[k, i, j] = (0.5 * ((zwflux[k, i, j]
                                              + abs(zwflux[k, i, j]))
                                             * fbmem[k, i, j]
                                             + (zwflux[k, i, j]
                                                - abs(zwflux[k, i, j]))
                                             * fbmem[k-1, i, j])
                                      * art[i, j])
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                for k in range(kbm1):
                    adv = (xflux[k, i+1, j] - xflux[k, i, j]
                           + yflux[k, i, j+1] - yflux[k, i, j]
                           + (zflux[k, i, j] - zflux[k+1, i, j]) / dz[k])
                    ff[k, i, j] = ((fbmem[k, i, j] * (h[i, j] + eta[i, j])
                                    * art[i, j] - dti2 * adv)
                                   / ((h[i, j] + etf[i, j]) * art[i, j]))
        xmassflux, ymassflux, zwflux, ff = smol_adif_ref(
            xmassflux, ymassflux, zwflux, ff, dt, aru, arv, dzz, fsm,
            dti2, sw, kbm1)
        eta = etf.copy()
        fbmem = ff.copy()
    # climatology-deviation horizontal diffusion (solver.f:691-726)
    fbmc = fb - fclim
    for k in range(kbm1):
        for j in range(1, jm):
            for i in range(1, im):
                xm = 0.5 * (aam[k, i, j] + aam[k, i-1, j])
                ym = 0.5 * (aam[k, i, j] + aam[k, i, j-1])
                xflux[k, i, j] = (-xm * (h[i, j] + h[i-1, j]) * tprni
                                  * (fbmc[k, i, j] - fbmc[k, i-1, j])
                                  * dum[i, j] * (dy[i, j] + dy[i-1, j]) * 0.5
                                  / (dx[i, j] + dx[i-1, j]))
                yflux[k, i, j] = (-ym * (h[i, j] + h[i, j-1]) * tprni
                                  * (fbmc[k, i, j] - fbmc[k, i, j-1])
                                  * dvm[i, j] * (dx[i, j] + dx[i, j-1]) * 0.5
                                  / (dy[i, j] + dy[i, j-1]))
    for j in range(1, jm - 1):
        for i in range(1, im - 1):
            for k in range(kbm1):
                ff[k, i, j] -= (dti2 * (xflux[k, i+1, j] - xflux[k, i, j]
                                        + yflux[k, i, j+1] - yflux[k, i, j])
                                / ((h[i, j] + etf[i, j]) * art[i, j]))
    return ff


def baropg_mcc_ref(rho_in, rmean, d, dt, dum, dvm, dx, dy, zz, dzz,
                   grav, ramp, kbm1):
    """McCalpin 4th-order baroclinic pressure gradient, solver.f:943-1159
    (single tile: n_west = n_south = -1 edge branches; no wide halo)."""
    kb, im, jm = rho_in.shape
    rho = rho_in - rmean
    # ---- x-component ----
    drho = np.zeros((kb, im, jm))
    rhou = np.zeros((kb, im, jm))
    ddx = np.zeros((im, jm))
    d4 = np.zeros((im, jm))
    for j in range(jm):
        for i in range(1, im):
            for k in range(kbm1):
                drho[k, i, j] = (rho[k, i, j] - rho[k, i-1, j]) * dum[i, j]
                rhou[k, i, j] = 0.5 * (rho[k, i, j] + rho[k, i-1, j]) * dum[i, j]
            ddx[i, j] = (d[i, j] - d[i-1, j]) * dum[i, j]
            d4[i, j] = 0.5 * (d[i, j] + d[i-1, j]) * dum[i, j]
    for j in range(jm):                       # n_west=-1: i = 3..imm1
        for i in range(2, im - 1):
            for k in range(kbm1):
                drho[k, i, j] -= ((1.0 / 24.0)
                                  * (dum[i+1, j] * (rho[k, i+1, j] - rho[k, i, j])
                                     - 2.0 * (rho[k, i, j] - rho[k, i-1, j])
                                     + dum[i-1, j] * (rho[k, i-1, j]
                                                      - rho[k, i-2, j])))
                rhou[k, i, j] += ((1.0 / 16.0)
                                  * (dum[i+1, j] * (rho[k, i, j] - rho[k, i+1, j])
                                     + dum[i-1, j] * (rho[k, i-1, j]
                                                      - rho[k, i-2, j])))
            ddx[i, j] -= ((1.0 / 24.0)
                          * (dum[i+1, j] * (d[i+1, j] - d[i, j])
                             - 2.0 * (d[i, j] - d[i-1, j])
                             + dum[i-1, j] * (d[i-1, j] - d[i-2, j])))
            d4[i, j] += ((1.0 / 16.0)
                         * (dum[i+1, j] * (d[i, j] - d[i+1, j])
                            + dum[i-1, j] * (d[i-1, j] - d[i-2, j])))
    drhox = np.zeros((kb, im, jm))
    for j in range(1, jm - 1):
        for i in range(1, im - 1):
            drhox[0, i, j] = grav * (-zz[0]) * d4[i, j] * drho[0, i, j]
            for k in range(1, kbm1):
                drhox[k, i, j] = (drhox[k-1, i, j]
                                  + grav * 0.5 * dzz[k-1] * d4[i, j]
                                  * (drho[k-1, i, j] + drho[k, i, j])
                                  + grav * 0.5 * (zz[k-1] + zz[k]) * ddx[i, j]
                                  * (rhou[k, i, j] - rhou[k-1, i, j]))
            for k in range(kbm1):
                drhox[k, i, j] = (0.25 * (dt[i, j] + dt[i-1, j])
                                  * drhox[k, i, j] * dum[i, j]
                                  * (dy[i, j] + dy[i-1, j]))
    # ---- y-component ----
    drho[:] = 0.0
    rhou[:] = 0.0
    ddx[:] = 0.0
    d4[:] = 0.0
    for j in range(1, jm):
        for i in range(im):
            for k in range(kbm1):
                drho[k, i, j] = (rho[k, i, j] - rho[k, i, j-1]) * dvm[i, j]
                rhou[k, i, j] = 0.5 * (rho[k, i, j] + rho[k, i, j-1]) * dvm[i, j]
            ddx[i, j] = (d[i, j] - d[i, j-1]) * dvm[i, j]
            d4[i, j] = 0.5 * (d[i, j] + d[i, j-1]) * dvm[i, j]
    for j in range(2, jm - 1):                # n_south=-1: j = 3..jmm1
        for i in range(im):
            for k in range(kbm1):
                drho[k, i, j] -= ((1.0 / 24.0)
                                  * (dvm[i, j+1] * (rho[k, i, j+1] - rho[k, i, j])
                                     - 2.0 * (rho[k, i, j] - rho[k, i, j-1])
                                     + dvm[i, j-1] * (rho[k, i, j-1]
                                                      - rho[k, i, j-2])))
                rhou[k, i, j] += ((1.0 / 16.0)
                                  * (dvm[i, j+1] * (rho[k, i, j] - rho[k, i, j+1])
                                     + dvm[i, j-1] * (rho[k, i, j-1]
                                                      - rho[k, i, j-2])))
            ddx[i, j] -= ((1.0 / 24.0)
                          * (dvm[i, j+1] * (d[i, j+1] - d[i, j])
                             - 2.0 * (d[i, j] - d[i, j-1])
                             + dvm[i, j-1] * (d[i, j-1] - d[i, j-2])))
            d4[i, j] += ((1.0 / 16.0)
                         * (dvm[i, j+1] * (d[i, j] - d[i, j+1])
                            + dvm[i, j-1] * (d[i, j-1] - d[i, j-2])))
    drhoy = np.zeros((kb, im, jm))
    for j in range(1, jm - 1):
        for i in range(1, im - 1):
            drhoy[0, i, j] = grav * (-zz[0]) * d4[i, j] * drho[0, i, j]
            for k in range(1, kbm1):
                drhoy[k, i, j] = (drhoy[k-1, i, j]
                                  + grav * 0.5 * dzz[k-1] * d4[i, j]
                                  * (drho[k-1, i, j] + drho[k, i, j])
                                  + grav * 0.5 * (zz[k-1] + zz[k]) * ddx[i, j]
                                  * (rhou[k, i, j] - rhou[k-1, i, j]))
            for k in range(kbm1):
                drhoy[k, i, j] = (0.25 * (dt[i, j] + dt[i, j-1])
                                  * drhoy[k, i, j] * dvm[i, j]
                                  * (dx[i, j] + dx[i, j-1]))
    drhox[:, 1:-1, 1:-1] *= ramp
    drhoy[:, 1:-1, 1:-1] *= ramp
    return drhox, drhoy


def profv_ref(vf_in, ub, vb, km, etf, wvsurf, h, cbc, dvm,
              dz, dzz, dti2, umol, kb):
    """Implicit vertical v-diffusion + quadratic bottom friction,
    solver.f:1783-1877."""
    kbm1, kbm2 = kb - 1, kb - 2
    _, im, jm = vb.shape
    vf = vf_in.copy()
    wvbot = np.zeros((im, jm))
    for i in range(1, im - 1):
        for j in range(1, jm - 1):
            dh = 0.5 * (h[i, j] + etf[i, j] + h[i, j-1] + etf[i, j-1])
            cm = np.zeros(kb)
            for k in range(kb):
                cm[k] = 0.5 * (km[k, i, j] + km[k, i, j-1])
            a = np.zeros(kb)
            c = np.zeros(kb)
            for k in range(kbm2):
                a[k] = -dti2 * (cm[k+1] + umol) / (dz[k] * dzz[k] * dh * dh)
            for k in range(1, kbm1):
                c[k] = -dti2 * (cm[k] + umol) / (dz[k] * dzz[k-1] * dh * dh)
            ee = np.zeros(kb)
            gg = np.zeros(kb)
            ee[0] = a[0] / (a[0] - 1.0)
            gg[0] = (-dti2 * wvsurf[i, j] / (-dz[0] * dh)
                     - vf[0, i, j]) / (a[0] - 1.0)
            for k in range(1, kbm2):
                gg_ = 1.0 / (a[k] + c[k] * (1.0 - ee[k-1]) - 1.0)
                ee[k] = a[k] * gg_
                gg[k] = (c[k] * gg[k-1] - vf[k, i, j]) * gg_
            tps = (0.5 * (cbc[i, j] + cbc[i, j-1])
                   * np.sqrt((0.25 * (ub[kbm1-1, i, j] + ub[kbm1-1, i+1, j]
                                      + ub[kbm1-1, i, j-1]
                                      + ub[kbm1-1, i+1, j-1])) ** 2
                             + vb[kbm1-1, i, j] ** 2))
            vf[kbm1-1, i, j] = ((c[kbm1-1] * gg[kbm2-1] - vf[kbm1-1, i, j])
                                / (tps * dti2 / (-dz[kbm1-1] * dh) - 1.0
                                   - (ee[kbm2-1] - 1.0) * c[kbm1-1])
                                ) * dvm[i, j]
            for k in range(kbm2 - 1, -1, -1):
                vf[k, i, j] = (ee[k] * vf[k+1, i, j] + gg[k]) * dvm[i, j]
            wvbot[i, j] = -tps * vf[kbm1-1, i, j]
    return vf, wvbot


def realvertvl_ref(w, u, v, dt, et, etf, etb, dx, dy, zz, fsm, dti2, kbm1):
    """Physical vertical velocity diagnostic, solver.f:2024-2067
    (single tile: all four edge copies apply)."""
    kb, im, jm = w.shape
    wr = np.zeros((kb, im, jm))
    for k in range(kbm1):
        tps = zz[k] * dt + et
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                dxr = 2.0 / (dx[i+1, j] + dx[i, j])
                dxl = 2.0 / (dx[i, j] + dx[i-1, j])
                dyt = 2.0 / (dy[i, j+1] + dy[i, j])
                dyb = 2.0 / (dy[i, j] + dy[i, j-1])
                wr[k, i, j] = (0.5 * (w[k, i, j] + w[k+1, i, j])
                               + 0.5 * (u[k, i+1, j] * (tps[i+1, j] - tps[i, j]) * dxr
                                        + u[k, i, j] * (tps[i, j] - tps[i-1, j]) * dxl
                                        + v[k, i, j+1] * (tps[i, j+1] - tps[i, j]) * dyt
                                        + v[k, i, j] * (tps[i, j] - tps[i, j-1]) * dyb)
                               + (1.0 + zz[k]) * (etf[i, j] - etb[i, j]) / dti2)
    # edge copies S, N, W, E (solver.f:2057-2060)
    wr[:, :, 0] = wr[:, :, 1]
    wr[:, :, -1] = wr[:, :, -2]
    wr[:, 0, :] = wr[:, 1, :]
    wr[:, -1, :] = wr[:, -2, :]
    for k in range(kbm1):
        wr[k] *= fsm
    return wr


def profq_ref(q2f_in, q2lf_in, q2, q2b_in, q2lb_in, u, v, t, s, rho,
              km_in, kh_in, kq_in, l_in, etf, wusurf, wvsurf, wubot, wvbot,
              h, fsm, z, zz, dz, dzz, dti2, umol, grav, kappa,
              tbias, sbias, rhoref, small, kb):
    """Mellor-Yamada 2.5 closure, solver.f:1212-1538 (single tile:
    all four edge-cosmetics branches apply).

    Returns (q2f, q2lf, km, kh, kq, l, q2b, q2lb) like the framework's
    profq: q2f/q2lf enter as the advected quantities (advq output)."""
    kbm1, kbm2 = kb - 1, kb - 2
    _, im, jm = q2.shape
    a1, b1, a2, b2, c1 = 0.92, 16.6, 0.74, 10.1, 0.08
    e1, e2 = 1.8, 1.33
    sef = 1.0
    cbcnst, surfl, shiw = 100.0, 2.0e5, 0.0

    q2f = q2f_in.copy()
    q2lf = q2lf_in.copy()
    q2b = q2b_in.copy()
    q2lb = q2lb_in.copy()
    km = km_in.copy()
    kh = kh_in.copy()
    kq = kq_in.copy()
    l = l_in.copy()

    dh = h + etf
    a = np.zeros((kb, im, jm))
    c = np.zeros((kb, im, jm))
    for k in range(1, kbm1):
        for j in range(jm):
            for i in range(im):
                a[k, i, j] = (-dti2 * (kq[k+1, i, j] + kq[k, i, j]
                                       + 2.0 * umol) * 0.5
                              / (dzz[k-1] * dz[k] * dh[i, j] * dh[i, j]))
                c[k, i, j] = (-dti2 * (kq[k-1, i, j] + kq[k, i, j]
                                       + 2.0 * umol) * 0.5
                              / (dzz[k-1] * dz[k-1] * dh[i, j] * dh[i, j]))

    const1 = (16.6 ** (2.0 / 3.0)) * sef
    utau2 = np.zeros((im, jm))
    for j in range(jm - 1):
        for i in range(im - 1):
            utau2[i, j] = np.sqrt(
                (0.5 * (wusurf[i, j] + wusurf[i+1, j])) ** 2
                + (0.5 * (wvsurf[i, j] + wvsurf[i, j+1])) ** 2)
            q2f[kb-1, i, j] = np.sqrt(
                (0.5 * (wubot[i, j] + wubot[i+1, j])) ** 2
                + (0.5 * (wvbot[i, j] + wvbot[i, j+1])) ** 2) * const1
    ee = np.zeros((kb, im, jm))
    gg = np.zeros((kb, im, jm))
    gg[0] = (15.8 * cbcnst) ** (2.0 / 3.0) * utau2
    l0 = surfl * utau2 / grav

    # sound speed (solver.f:1303-1319)
    cc = np.zeros((kb, im, jm))
    for k in range(kbm1):
        for j in range(jm):
            for i in range(im):
                tp = t[k, i, j] + tbias
                sp = s[k, i, j] + sbias
                p = grav * rhoref * (-zz[k] * h[i, j]) * 1.0e-4
                ccv = (1449.1 + 0.00821 * p + 4.55 * tp - 0.045 * tp ** 2
                       + 1.34 * (sp - 35.0))
                cc[k, i, j] = ccv / np.sqrt((1.0 - 0.01642 * p / ccv)
                                            * (1.0 - 0.40 * p / ccv ** 2))

    boygr = np.zeros((kb, im, jm))
    for k in range(1, kbm1):
        for j in range(jm):
            for i in range(im):
                q2b[k, i, j] = abs(q2b[k, i, j])
                q2lb[k, i, j] = abs(q2lb[k, i, j])
                boygr[k, i, j] = (grav * (rho[k-1, i, j] - rho[k, i, j])
                                  / (dzz[k-1] * h[i, j])
                                  + (grav ** 2) * 2.0
                                  / (cc[k-1, i, j] ** 2 + cc[k, i, j] ** 2))

    gh = np.zeros((kb, im, jm))
    for k in range(1, kbm1):
        for j in range(jm):
            for i in range(im):
                l[k, i, j] = abs(q2lb[k, i, j] / q2b[k, i, j])
                if z[k] > -0.5:
                    l[k, i, j] = max(l[k, i, j], kappa * l0[i, j])
                gh[k, i, j] = min((l[k, i, j] ** 2) * boygr[k, i, j]
                                  / q2b[k, i, j], 0.028)
    l[0] = kappa * l0
    l[kb-1] = 0.0
    gh[0] = 0.0
    gh[kb-1] = 0.0

    prod = np.zeros((kb, im, jm))
    for k in range(1, kbm1):
        for j in range(1, jm - 1):
            for i in range(1, im - 1):
                prod[k, i, j] = (km[k, i, j] * 0.25 * sef
                                 * ((u[k, i, j] - u[k-1, i, j]
                                     + u[k, i+1, j] - u[k-1, i+1, j]) ** 2
                                    + (v[k, i, j] - v[k-1, i, j]
                                       + v[k, i, j+1] - v[k-1, i, j+1]) ** 2)
                                 / (dzz[k-1] * dh[i, j]) ** 2
                                 - shiw * km[k, i, j] * boygr[k, i, j])
                prod[k, i, j] += kh[k, i, j] * boygr[k, i, j]

    stf = np.ones((kb, im, jm))
    dtef = np.sqrt(np.abs(q2b)) * stf / (b1 * l + small)

    # q2 solve (solver.f:1394-1413)
    for k in range(1, kbm1):
        for j in range(jm):
            for i in range(im):
                gg_ = 1.0 / (a[k, i, j] + c[k, i, j] * (1.0 - ee[k-1, i, j])
                             - (2.0 * dti2 * dtef[k, i, j] + 1.0))
                ee[k, i, j] = a[k, i, j] * gg_
                gg[k, i, j] = (-2.0 * dti2 * prod[k, i, j]
                               + c[k, i, j] * gg[k-1, i, j]
                               - q2f[k, i, j]) * gg_
    for ki in range(kbm1 - 1, -1, -1):
        q2f[ki] = ee[ki] * q2f[ki+1] + gg[ki]

    # q2l solve (solver.f:1415-1455)
    q2lf[0] = 0.0
    q2lf[kb-1] = 0.0
    ee[1] = 0.0
    gg[1] = -kappa * z[1] * dh * q2[1]
    q2lf[kb-2] = kappa * (1.0 + z[kbm1-1]) * dh * q2[kbm1-1]
    for k in range(1, kbm1):
        for j in range(jm):
            for i in range(im):
                dtef[k, i, j] *= (1.0 + e2 * ((1.0 / abs(z[k] - z[0])
                                               + 1.0 / abs(z[k] - z[kb-1]))
                                              * l[k, i, j]
                                              / (dh[i, j] * kappa)) ** 2)
    for k in range(2, kbm1):
        for j in range(jm):
            for i in range(im):
                gg_ = 1.0 / (a[k, i, j] + c[k, i, j] * (1.0 - ee[k-1, i, j])
                             - (dti2 * dtef[k, i, j] + 1.0))
                ee[k, i, j] = a[k, i, j] * gg_
                gg[k, i, j] = (dti2 * (-prod[k, i, j] * l[k, i, j] * e1)
                               + c[k, i, j] * gg[k-1, i, j]
                               - q2lf[k, i, j]) * gg_
    for ki in range(kb - 2, 0, -1):
        q2lf[ki] = ee[ki] * q2lf[ki+1] + gg[ki]

    # rectify (solver.f:1460-1471)
    for k in range(1, kbm1):
        q2f[k] = np.abs(q2f[k])
        q2lf[k] = np.abs(q2lf[k])

    # stability functions + mixing coefficients (solver.f:1474-1506)
    coef4 = 18.0 * a1 * a1 + 9.0 * a1 * a2
    coef5 = 9.0 * a1 * a2
    coef1 = a2 * (1.0 - 6.0 * a1 / b1 * stf)
    coef2 = 3.0 * a2 * b2 / stf + 18.0 * a1 * a2
    coef3 = a1 * (1.0 - 3.0 * c1 - 6.0 * a1 / b1 * stf)
    sh = coef1 / (1.0 - coef2 * gh)
    sm = (coef3 + sh * coef4 * gh) / (1.0 - coef5 * gh)
    kn = l * np.sqrt(np.abs(q2))
    kq = (kn * 0.41 * sh + kq) * 0.5
    km = (kn * sm + km) * 0.5
    kh = (kn * sh + kh) * 0.5

    # edge cosmetics N, S, E, W (solver.f:1510-1529)
    for arr in (km, kh, kq):
        arr[:, :, -1] = arr[:, :, -2]
        arr[:, :, 0] = arr[:, :, 1]
        arr[:, -1, :] = arr[:, -2, :]
        arr[:, 0, :] = arr[:, 1, :]
    km = km * fsm
    kh = kh * fsm
    kq = kq * fsm
    return q2f, q2lf, km, kh, kq, l, q2b, q2lb


# ---------------------------------------------------------------------------
# boundary-condition oracles (single tile: all four sides physical)
# ---------------------------------------------------------------------------

def bcond_ts_ref(uf_in, vf_in, t, s, u, v, w, dt, fc, dx, dy, zz, fsm,
                 dti, kbm1):
    """bcond idx=4: T/S advective open boundary (bounds_forcing.f:151-242).
    fc: dict with tbe/tbw/tbs/tbn, sbe/... each (kb, side-length)."""
    kb, im, jm = t.shape
    uf = uf_in.copy()
    vf = vf_in.copy()
    for k in range(kbm1):
        for j in range(jm):
            # east
            u1 = 2.0 * u[k, im-1, j] * dti / (dx[im-1, j] + dx[im-2, j])
            if u1 <= 0.0:
                uf[k, im-1, j] = t[k, im-1, j] - u1 * (fc["tbe"][k, j]
                                                       - t[k, im-1, j])
                vf[k, im-1, j] = s[k, im-1, j] - u1 * (fc["sbe"][k, j]
                                                       - s[k, im-1, j])
            else:
                uf[k, im-1, j] = t[k, im-1, j] - u1 * (t[k, im-1, j]
                                                       - t[k, im-2, j])
                vf[k, im-1, j] = s[k, im-1, j] - u1 * (s[k, im-1, j]
                                                       - s[k, im-2, j])
                if k != 0 and k != kbm1 - 1:
                    wm = (0.5 * (w[k, im-2, j] + w[k+1, im-2, j]) * dti
                          / ((zz[k-1] - zz[k+1]) * dt[im-2, j]))
                    uf[k, im-1, j] -= wm * (t[k-1, im-2, j]
                                            - t[k+1, im-2, j])
                    vf[k, im-1, j] -= wm * (s[k-1, im-2, j]
                                            - s[k+1, im-2, j])
            # west
            u1 = 2.0 * u[k, 1, j] * dti / (dx[0, j] + dx[1, j])
            if u1 >= 0.0:
                uf[k, 0, j] = t[k, 0, j] - u1 * (t[k, 0, j]
                                                 - fc["tbw"][k, j])
                vf[k, 0, j] = s[k, 0, j] - u1 * (s[k, 0, j]
                                                 - fc["sbw"][k, j])
            else:
                uf[k, 0, j] = t[k, 0, j] - u1 * (t[k, 1, j] - t[k, 0, j])
                vf[k, 0, j] = s[k, 0, j] - u1 * (s[k, 1, j] - s[k, 0, j])
                if k != 0 and k != kbm1 - 1:
                    wm = (0.5 * (w[k, 1, j] + w[k+1, 1, j]) * dti
                          / ((zz[k-1] - zz[k+1]) * dt[1, j]))
                    uf[k, 0, j] -= wm * (t[k-1, 1, j] - t[k+1, 1, j])
                    vf[k, 0, j] -= wm * (s[k-1, 1, j] - s[k+1, 1, j])
        for i in range(im):
            # south
            u1 = 2.0 * v[k, i, 1] * dti / (dy[i, 0] + dy[i, 1])
            if u1 >= 0.0:
                uf[k, i, 0] = t[k, i, 0] - u1 * (t[k, i, 0]
                                                 - fc["tbs"][k, i])
                vf[k, i, 0] = s[k, i, 0] - u1 * (s[k, i, 0]
                                                 - fc["sbs"][k, i])
            else:
                uf[k, i, 0] = t[k, i, 0] - u1 * (t[k, i, 1] - t[k, i, 0])
                vf[k, i, 0] = s[k, i, 0] - u1 * (s[k, i, 1] - s[k, i, 0])
                if k != 0 and k != kbm1 - 1:
                    wm = (0.5 * (w[k, i, 1] + w[k+1, i, 1]) * dti
                          / ((zz[k-1] - zz[k+1]) * dt[i, 1]))
                    uf[k, i, 0] -= wm * (t[k-1, i, 1] - t[k+1, i, 1])
                    vf[k, i, 0] -= wm * (s[k-1, i, 1] - s[k+1, i, 1])
            # north
            u1 = 2.0 * v[k, i, jm-1] * dti / (dy[i, jm-1] + dy[i, jm-2])
            if u1 <= 0.0:
                uf[k, i, jm-1] = t[k, i, jm-1] - u1 * (fc["tbn"][k, i]
                                                       - t[k, i, jm-1])
                vf[k, i, jm-1] = s[k, i, jm-1] - u1 * (fc["sbn"][k, i]
                                                       - s[k, i, jm-1])
            else:
                uf[k, i, jm-1] = t[k, i, jm-1] - u1 * (t[k, i, jm-1]
                                                       - t[k, i, jm-2])
                vf[k, i, jm-1] = s[k, i, jm-1] - u1 * (s[k, i, jm-1]
                                                       - s[k, i, jm-2])
                if k != 0 and k != kbm1 - 1:
                    wm = (0.5 * (w[k, i, jm-2] + w[k+1, i, jm-2]) * dti
                          / ((zz[k-1] - zz[k+1]) * dt[i, jm-2]))
                    uf[k, i, jm-1] -= wm * (t[k-1, i, jm-2]
                                            - t[k+1, i, jm-2])
                    vf[k, i, jm-1] -= wm * (s[k-1, i, jm-2]
                                            - s[k+1, i, jm-2])
    for k in range(kbm1):
        uf[k] *= fsm
        vf[k] *= fsm
    return uf, vf


def bcond_turb_ref(uf_in, vf_in, q2, q2l, u, v, dx, dy, fsm, dti, small):
    """bcond idx=6: q2/q2l upstream boundary (bounds_forcing.f:257-325)."""
    kb, im, jm = q2.shape
    uf = uf_in.copy()
    vf = vf_in.copy()
    for k in range(kb):
        for j in range(jm):
            u1 = 2.0 * u[k, 1, j] * dti / (dx[0, j] + dx[1, j])
            if u1 >= 0.0:
                uf[k, 0, j] = q2[k, 0, j] - u1 * (q2[k, 0, j] - small)
                vf[k, 0, j] = q2l[k, 0, j] - u1 * (q2l[k, 0, j] - small)
            else:
                uf[k, 0, j] = q2[k, 0, j] - u1 * (q2[k, 1, j]
                                                  - q2[k, 0, j])
                vf[k, 0, j] = q2l[k, 0, j] - u1 * (q2l[k, 1, j]
                                                   - q2l[k, 0, j])
            u1 = 2.0 * u[k, im-1, j] * dti / (dx[im-1, j] + dx[im-2, j])
            if u1 <= 0.0:
                uf[k, im-1, j] = q2[k, im-1, j] - u1 * (small
                                                        - q2[k, im-1, j])
                vf[k, im-1, j] = q2l[k, im-1, j] - u1 * (small
                                                         - q2l[k, im-1, j])
            else:
                uf[k, im-1, j] = q2[k, im-1, j] - u1 * (q2[k, im-1, j]
                                                        - q2[k, im-2, j])
                vf[k, im-1, j] = q2l[k, im-1, j] - u1 * (q2l[k, im-1, j]
                                                         - q2l[k, im-2, j])
        for i in range(im):
            u1 = 2.0 * v[k, i, 1] * dti / (dy[i, 0] + dy[i, 1])
            if u1 >= 0.0:
                uf[k, i, 0] = q2[k, i, 0] - u1 * (q2[k, i, 0] - small)
                vf[k, i, 0] = q2l[k, i, 0] - u1 * (q2l[k, i, 0] - small)
            else:
                uf[k, i, 0] = q2[k, i, 0] - u1 * (q2[k, i, 1]
                                                  - q2[k, i, 0])
                vf[k, i, 0] = q2l[k, i, 0] - u1 * (q2l[k, i, 1]
                                                   - q2l[k, i, 0])
            u1 = 2.0 * v[k, i, jm-1] * dti / (dy[i, jm-1] + dy[i, jm-2])
            if u1 <= 0.0:
                uf[k, i, jm-1] = q2[k, i, jm-1] - u1 * (small
                                                        - q2[k, i, jm-1])
                vf[k, i, jm-1] = q2l[k, i, jm-1] - u1 * (small
                                                         - q2l[k, i, jm-1])
            else:
                uf[k, i, jm-1] = q2[k, i, jm-1] - u1 * (q2[k, i, jm-1]
                                                        - q2[k, i, jm-2])
                vf[k, i, jm-1] = q2l[k, i, jm-1] - u1 * (q2l[k, i, jm-1]
                                                         - q2l[k, i, jm-2])
    uf = uf * fsm + 1.0e-10
    vf = vf * fsm + 1.0e-10
    return uf, vf


def bcondorl_vel3d_ref(uf_in, vf_in, u, ub, v, vb, dum, dvm, kbm1):
    """bcondorl idx=3: Orlanski internal velocity
    (bounds_forcing.f:418-487)."""
    kb, im, jm = u.shape
    uf = uf_in.copy()
    vf = vf_in.copy()

    def cl_of(ff, fb, fi):
        denom = ff + fb - 2.0 * fi
        if denom == 0.0:
            denom = 0.01
        return min(max((fb - ff) / denom, 0.0), 1.0)

    for k in range(kbm1):
        for j in range(1, jm - 1):
            cl = cl_of(uf[k, im-2, j], ub[k, im-2, j], u[k, im-3, j])
            uf[k, im-1, j] = (ub[k, im-1, j] * (1.0 - cl)
                              + 2.0 * cl * u[k, im-2, j]) / (1.0 + cl)
            vf[k, im-1, j] = 0.0
            cl = cl_of(uf[k, 2, j], ub[k, 2, j], u[k, 3, j])
            uf[k, 1, j] = (ub[k, 1, j] * (1.0 - cl)
                           + 2.0 * cl * u[k, 2, j]) / (1.0 + cl)
            uf[k, 0, j] = uf[k, 1, j]
            vf[k, 0, j] = 0.0
        for i in range(1, im - 1):
            cl = cl_of(vf[k, i, 2], vb[k, i, 2], v[k, i, 3])
            vf[k, i, 1] = (vb[k, i, 1] * (1.0 - cl)
                           + 2.0 * cl * v[k, i, 2]) / (1.0 + cl)
            vf[k, i, 0] = vf[k, i, 1]
            uf[k, i, 0] = 0.0
            cl = cl_of(vf[k, i, jm-2], vb[k, i, jm-2], v[k, i, jm-3])
            vf[k, i, jm-1] = (vb[k, i, jm-1] * (1.0 - cl)
                              + 2.0 * cl * v[k, i, jm-2]) / (1.0 + cl)
            uf[k, i, jm-1] = 0.0
    for k in range(kbm1):
        uf[k] *= dum
        vf[k] *= dvm
    return uf, vf


def bcondorl_ts_ref(uf_in, vf_in, t, tb, s, sb, ub, tbe, tbw,
                    sbe, sbw, fsm, kbm1):
    """bcondorl idx=4: Orlanski T/S at the east/west boundaries with
    upstream clamping to the boundary profile when the phase speed
    vanishes on inflow (bounds_forcing.f:489-548).  uf/vf hold the new
    T/S fields."""
    kb, im, jm = t.shape
    uf = uf_in.copy()
    vf = vf_in.copy()

    def cl_of(ff, fb, fi):
        denom = ff + fb - 2.0 * fi
        if denom == 0.0:
            denom = 0.01
        return min(max((fb - ff) / denom, 0.0), 1.0)

    for k in range(kbm1):
        for j in range(jm):
            # east (bounds_forcing.f:495-516)
            ube = ub[k, im-1, j]
            cl = cl_of(uf[k, im-2, j], tb[k, im-2, j], t[k, im-3, j])
            uf[k, im-1, j] = (tb[k, im-1, j] * (1.0 - cl)
                              + 2.0 * cl * t[k, im-2, j]) / (1.0 + cl)
            if cl == 0.0 and ube <= 0.0:
                uf[k, im-1, j] = tbe[k, j]
            cl = cl_of(vf[k, im-2, j], sb[k, im-2, j], s[k, im-3, j])
            vf[k, im-1, j] = (sb[k, im-1, j] * (1.0 - cl)
                              + 2.0 * cl * s[k, im-2, j]) / (1.0 + cl)
            if cl == 0.0 and ube <= 0.0:
                vf[k, im-1, j] = sbe[k, j]
            # west (bounds_forcing.f:518-535)
            ubw = ub[k, 1, j]
            cl = cl_of(uf[k, 1, j], tb[k, 1, j], t[k, 2, j])
            uf[k, 0, j] = (tb[k, 0, j] * (1.0 - cl)
                           + 2.0 * cl * t[k, 1, j]) / (1.0 + cl)
            if cl == 0.0 and ubw >= 0.0:
                uf[k, 0, j] = tbw[k, j]
            cl = cl_of(vf[k, 1, j], sb[k, 1, j], s[k, 2, j])
            vf[k, 0, j] = (sb[k, 0, j] * (1.0 - cl)
                           + 2.0 * cl * s[k, 1, j]) / (1.0 + cl)
            if cl == 0.0 and ubw >= 0.0:
                vf[k, 0, j] = sbw[k, j]
    for k in range(kbm1):
        uf[k] *= fsm
        vf[k] *= fsm
    return uf, vf


def mode_internal_ref(st, carry, aux, fc, g, cfg):
    """Full internal (3-D) mode oracle, advance.f:356-537, composing the
    per-kernel oracles with the reference's glue (depth-mean adjustment,
    Asselin filters with depth-mean correction, time-level rotations) for
    the bc_scheme='extpom' mix (bcond 4,6 + bcondorl 3,5).

    st/carry/aux/fc: dicts of numpy arrays; g: dict of grid arrays;
    cfg: object with the scalar constants.  Returns the updated state
    dict (same keys as st plus rotated levels).
    """
    kb = cfg.kb
    kbm1 = cfg.kbm1
    dz = g["dz"]
    h = g["h"]
    dt = h + st["et"]

    u, ub = st["u"].copy(), st["ub"].copy()
    v, vb = st["v"].copy(), st["vb"].copy()
    w = st["w"].copy()
    t, tb = st["t"].copy(), st["tb"].copy()
    s, sb = st["s"].copy(), st["sb"].copy()
    q2, q2b = st["q2"].copy(), st["q2b"].copy()
    q2l, q2lb = st["q2l"].copy(), st["q2lb"].copy()
    km, kh, kq, l = (st[n].copy() for n in ("km", "kh", "kq", "l"))
    rho = st["rho"].copy()
    etf = carry["etf"]
    aam = aux["aam"]

    # depth-mean adjustment (advance.f:364-393)
    tps = (u[:kbm1] * dz[:kbm1, None, None]).sum(0)
    un = (u - tps) + (st["utb"] + carry["utf"]) / (
        dt + np.roll(dt, 1, axis=0))
    u[:kbm1, 1:, :] = un[:kbm1, 1:, :]
    tps = (v[:kbm1] * dz[:kbm1, None, None]).sum(0)
    vn = (v - tps) + (st["vtb"] + carry["vtf"]) / (
        dt + np.roll(dt, 1, axis=1))
    v[:kbm1, :, 1:] = vn[:kbm1, :, 1:]

    # w from continuity + idx5 mask (advance.f:396-398)
    w = vertvl_ref(w, u, v, dt, etf, st["etb"], st["vfluxb"],
                   fc["vflux"], g["dx"], g["dy"], dz, cfg.dti2, kbm1)
    for k in range(kbm1):
        w[k] *= g["fsm"]

    # turbulence (advance.f:406-421)
    q2f = advq_ref(q2b, q2, u, v, w, aam, dt, st["etb"], etf, h,
                   g["dum"], g["dvm"], g["dx"], g["dy"], g["art"], dz,
                   cfg.dti2, kbm1)
    q2lf = advq_ref(q2lb, q2l, u, v, w, aam, dt, st["etb"], etf, h,
                    g["dum"], g["dvm"], g["dx"], g["dy"], g["art"], dz,
                    cfg.dti2, kbm1)
    (q2f, q2lf, km, kh, kq, l, q2b, q2lb) = profq_ref(
        q2f, q2lf, q2, q2b, q2lb, u, v, t, s, rho, km, kh, kq, l, etf,
        fc["wusurf"], fc["wvsurf"], carry["wubot"], carry["wvbot"],
        h, g["fsm"], g["z"], g["zz"], dz, g["dzz"], cfg.dti2, cfg.umol,
        cfg.grav, cfg.kappa, cfg.tbias, cfg.sbias, cfg.rhoref, cfg.small,
        kb)
    q2f, q2lf = bcond_turb_ref(q2f, q2lf, q2, q2l, u, v, g["dx"],
                               g["dy"], g["fsm"], cfg.dti, cfg.small)
    q2 = q2 + 0.5 * cfg.smoth * (q2f + q2b - 2.0 * q2)
    q2l = q2l + 0.5 * cfg.smoth * (q2lf + q2lb - 2.0 * q2l)
    q2b, q2 = q2, q2f
    q2lb, q2l = q2l, q2lf

    # tracers (advance.f:424-456), nadv=1
    tf = advt1_ref(tb, t, st["tclim"], u, v, w, aam, dt, st["etb"], etf,
                   h, g["dum"], g["dvm"], g["dx"], g["dy"], g["art"], dz,
                   cfg.dti2, cfg.tprni, kbm1)
    sf = advt1_ref(sb, s, st["sclim"], u, v, w, aam, dt, st["etb"], etf,
                   h, g["dum"], g["dvm"], g["dx"], g["dy"], g["art"], dz,
                   cfg.dti2, cfg.tprni, kbm1)
    tf = proft_ref(tf, fc["wtsurf"], fc["tsurf"], cfg.nbct, kh, etf,
                   fc["swrad"], h, g["z"], dz, g["dzz"], cfg.dti2,
                   cfg.umol, cfg.ntp, kb)
    sf = proft_ref(sf, fc["wssurf"], fc["ssurf"], cfg.nbcs, kh, etf,
                   fc["swrad"], h, g["z"], dz, g["dzz"], cfg.dti2,
                   cfg.umol, cfg.ntp, kb)
    tf, sf = bcond_ts_ref(tf, sf, t, s, u, v, w, dt, fc, g["dx"],
                          g["dy"], g["zz"], g["fsm"], cfg.dti, kbm1)
    t = t + 0.5 * cfg.smoth * (tf + tb - 2.0 * t)
    s = s + 0.5 * cfg.smoth * (sf + sb - 2.0 * s)
    tb, t = t, tf
    sb, s = s, sf
    rho = dens_ref(s, t, g["zz"], h, g["fsm"], cfg.tbias, cfg.sbias,
                   cfg.grav, cfg.rhoref)

    # momentum (advance.f:459-521)
    uf = advu_ref(u, ub, v, w, aux["advx"], aux["drhox"], dt,
                  carry["egf"], st["egb"], fc["e_atmos"], st["etb"], etf,
                  h, g["dy"], g["aru"], g["cor"], dz, cfg.grav, cfg.dti2,
                  kbm1)
    vf = advv_ref(v, vb, u, w, aux["advy"], aux["drhoy"], dt,
                  carry["egf"], st["egb"], fc["e_atmos"], st["etb"], etf,
                  h, g["dx"], g["arv"], g["cor"], dz, cfg.grav, cfg.dti2,
                  kbm1)
    uf, wubot = profu_ref(uf, ub, vb, km, etf, fc["wusurf"], h, g["cbc"],
                          g["dum"], dz, g["dzz"], cfg.dti2, cfg.umol, kb)
    vf, wvbot = profv_ref(vf, ub, vb, km, etf, fc["wvsurf"], h, g["cbc"],
                          g["dvm"], dz, g["dzz"], cfg.dti2, cfg.umol, kb)
    uf, vf = bcondorl_vel3d_ref(uf, vf, u, ub, v, vb, g["dum"], g["dvm"],
                                kbm1)

    # Asselin with depth-mean correction (advance.f:469-509)
    tps = ((uf + ub - 2.0 * u)[:kbm1] * dz[:kbm1, None, None]).sum(0)
    u = u + 0.5 * cfg.smoth * (uf + ub - 2.0 * u - tps)
    tps = ((vf + vb - 2.0 * v)[:kbm1] * dz[:kbm1, None, None]).sum(0)
    v = v + 0.5 * cfg.smoth * (vf + vb - 2.0 * v - tps)
    ub, u = u, uf
    vb, v = v, vf

    return dict(u=u, ub=ub, v=v, vb=vb, w=w, t=t, tb=tb, s=s, sb=sb,
                rho=rho, q2=q2, q2b=q2b, q2l=q2l, q2lb=q2lb,
                km=km, kh=kh, kq=kq, l=l, wubot=wubot, wvbot=wvbot,
                egb=carry["egf"], etb=st["et"], et=etf, etf=etf,
                utb=carry["utf"], vtb=carry["vtf"], vfluxb=fc["vflux"])


def bcond_el_ref(elf_in, fsm):
    """bcond idx=1: zero-gradient elevation (bounds_forcing.f:18-41),
    side order W, E, S, N."""
    elf = elf_in.copy()
    elf[0, :] = elf[1, :]
    elf[-1, :] = elf[-2, :]
    elf[:, 0] = elf[:, 1]
    elf[:, -1] = elf[:, -2]
    return elf * fsm


def bcond_vel2d_ref(uaf_in, vaf_in, el, d, fc, dum, dvm, grav, ramp,
                    rfe, rfw, rfn, rfs):
    """bcond idx=2: Flather-type external velocity
    (bounds_forcing.f:43-83)."""
    uaf = uaf_in.copy()
    vaf = vaf_in.copy()
    im, jm = el.shape
    J = slice(1, jm - 1)
    I = slice(1, im - 1)
    # west
    uaf[1, J] = ramp * (fc["uabw"][J] - rfw * np.sqrt(grav / d[1, J])
                        * (el[1, J] - fc["elw"][J]))
    uaf[0, J] = uaf[1, J]
    vaf[0, J] = fc["vabw"][J]
    # east
    uaf[im-1, J] = ramp * (fc["uabe"][J]
                           + rfe * np.sqrt(grav / d[im-2, J])
                           * (el[im-2, J] - fc["ele"][J]))
    vaf[im-1, J] = fc["vabe"][J]
    # south
    vaf[I, 1] = ramp * (fc["vabs"][I] - rfs * np.sqrt(grav / d[I, 1])
                        * (el[I, 1] - fc["els"][I]))
    vaf[I, 0] = vaf[I, 1]
    uaf[I, 0] = fc["uabs"][I]
    # north
    vaf[I, jm-1] = ramp * (fc["vabn"][I]
                           + rfn * np.sqrt(grav / d[I, jm-2])
                           * (el[I, jm-2] - fc["eln"][I]))
    uaf[I, jm-1] = fc["uabn"][I]
    return uaf * dum, vaf * dvm


def mode_external_substep_ref(c, aux, fc, g, cfg, iext):
    """One external (2-D) leapfrog substep oracle (advance.f:205-353) for
    the bcond idx1/2 family.  ``c`` is the carry dict; returns the updated
    carry."""
    im, jm = c["el"].shape
    h, dx, dy, art = g["h"], g["dx"], g["dy"], g["art"]
    d = h + c["el"]
    fluxua = np.zeros((im, jm))
    fluxva = np.zeros((im, jm))
    for j in range(1, jm):
        for i in range(1, im):
            fluxua[i, j] = (0.25 * (d[i, j] + d[i-1, j])
                            * (dy[i, j] + dy[i-1, j]) * c["ua"][i, j])
            fluxva[i, j] = (0.25 * (d[i, j] + d[i, j-1])
                            * (dx[i, j] + dx[i, j-1]) * c["va"][i, j])
    elf = np.zeros((im, jm))
    for j in range(1, jm - 1):
        for i in range(1, im - 1):
            elf[i, j] = (c["elb"][i, j]
                         + cfg.dte2 * (-(fluxua[i+1, j] - fluxua[i, j]
                                         + fluxva[i, j+1] - fluxva[i, j])
                                       / art[i, j]
                                       - fc["vflux"][i, j]))
    elf = bcond_el_ref(elf, g["fsm"])

    advua, advva = c["advua"], c["advva"]
    wubot, wvbot = c["wubot"], c["wvbot"]
    if iext % cfg.ispadv == 0:
        advua, advva, wubot, wvbot = advave_ref(
            d, c["ua"], c["va"], c["uab"], c["vab"], aux["aam2d"],
            wubot, wvbot, g["cbc"], dx, dy, g["aru"], g["arv"], cfg.mode)

    alpha = cfg.alpha
    uaf = np.zeros((im, jm))
    vaf = np.zeros((im, jm))
    for j in range(1, jm - 1):
        for i in range(1, im):
            uaf[i, j] = (aux["adx2d"][i, j] + advua[i, j]
                         - g["aru"][i, j] * 0.25
                         * (g["cor"][i, j] * d[i, j]
                            * (c["va"][i, j+1] + c["va"][i, j])
                            + g["cor"][i-1, j] * d[i-1, j]
                            * (c["va"][i-1, j+1] + c["va"][i-1, j]))
                         + 0.25 * cfg.grav * (dy[i, j] + dy[i-1, j])
                         * (d[i, j] + d[i-1, j])
                         * ((1.0 - 2.0 * alpha)
                            * (c["el"][i, j] - c["el"][i-1, j])
                            + alpha * (c["elb"][i, j] - c["elb"][i-1, j]
                                       + elf[i, j] - elf[i-1, j])
                            + fc["e_atmos"][i, j] - fc["e_atmos"][i-1, j])
                         + aux["drx2d"][i, j]
                         + g["aru"][i, j] * (fc["wusurf"][i, j]
                                             - wubot[i, j]))
            uaf[i, j] = (((h[i, j] + c["elb"][i, j] + h[i-1, j]
                           + c["elb"][i-1, j]) * g["aru"][i, j]
                          * c["uab"][i, j]
                          - 4.0 * cfg.dte * uaf[i, j])
                         / ((h[i, j] + elf[i, j] + h[i-1, j]
                             + elf[i-1, j]) * g["aru"][i, j]))
    for j in range(1, jm):
        for i in range(1, im - 1):
            vaf[i, j] = (aux["ady2d"][i, j] + advva[i, j]
                         + g["arv"][i, j] * 0.25
                         * (g["cor"][i, j] * d[i, j]
                            * (c["ua"][i+1, j] + c["ua"][i, j])
                            + g["cor"][i, j-1] * d[i, j-1]
                            * (c["ua"][i+1, j-1] + c["ua"][i, j-1]))
                         + 0.25 * cfg.grav * (dx[i, j] + dx[i, j-1])
                         * (d[i, j] + d[i, j-1])
                         * ((1.0 - 2.0 * alpha)
                            * (c["el"][i, j] - c["el"][i, j-1])
                            + alpha * (c["elb"][i, j] - c["elb"][i, j-1]
                                       + elf[i, j] - elf[i, j-1])
                            + fc["e_atmos"][i, j] - fc["e_atmos"][i, j-1])
                         + aux["dry2d"][i, j]
                         + g["arv"][i, j] * (fc["wvsurf"][i, j]
                                             - wvbot[i, j]))
            vaf[i, j] = (((h[i, j] + c["elb"][i, j] + h[i, j-1]
                           + c["elb"][i, j-1]) * g["arv"][i, j]
                          * c["vab"][i, j]
                          - 4.0 * cfg.dte * vaf[i, j])
                         / ((h[i, j] + elf[i, j] + h[i, j-1]
                             + elf[i, j-1]) * g["arv"][i, j]))
    uaf, vaf = bcond_vel2d_ref(uaf, vaf, c["el"], d, fc, g["dum"],
                               g["dvm"], cfg.grav, fc["ramp"],
                               cfg.rfe, cfg.rfw, cfg.rfn, cfg.rfs)

    etf = c["etf"].copy()
    if iext == cfg.isplit - 2:
        etf = 0.25 * cfg.smoth * elf
    elif iext == cfg.isplit - 1:
        etf = etf + 0.5 * (1.0 - 0.5 * cfg.smoth) * elf
    elif iext == cfg.isplit:
        etf = (etf + 0.5 * elf) * g["fsm"]

    ua = c["ua"] + 0.5 * cfg.smoth * (c["uab"] - 2.0 * c["ua"] + uaf)
    va = c["va"] + 0.5 * cfg.smoth * (c["vab"] - 2.0 * c["va"] + vaf)
    el = c["el"] + 0.5 * cfg.smoth * (c["elb"] - 2.0 * c["el"] + elf)
    elb, el = el, elf
    d = h + el
    uab, ua = ua, uaf
    vab, va = va, vaf

    egf, utf, vtf = c["egf"].copy(), c["utf"].copy(), c["vtf"].copy()
    if iext != cfg.isplit:
        egf = egf + el * cfg.ispi
        for j in range(jm):
            for i in range(1, im):
                utf[i, j] += ua[i, j] * (d[i, j] + d[i-1, j]) * cfg.isp2i
        for j in range(1, jm):
            for i in range(im):
                vtf[i, j] += va[i, j] * (d[i, j] + d[i, j-1]) * cfg.isp2i
    return dict(el=el, elb=elb, ua=ua, uab=uab, va=va, vab=vab, etf=etf,
                egf=egf, utf=utf, vtf=vtf, advua=advua, advva=advva,
                wubot=wubot, wvbot=wvbot)
