"""The port's full-step oracles (tests/test_fullstep_oracle.py for the
port): given the same inputs (state, external-mode carry, lateral terms,
forcing), the loop-based NumPy composition of tests/reference/pom_ref.py
reproduces the port's internal mode (``stepper.mode_internal``, the
extpom scheme) and its external loop under the file scheme
(``stepper.mode_external_substep``, every substep), within 1e-10 of
max(1, max |oracle|), in float64 on the CPU."""

import os
import sys

import numpy as np
import torch

from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.core import stepper
from extpom_tpu_torch.kernels import phases

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "reference"))
import pom_ref  # noqa: E402

torch.set_num_threads(1)


def _prologue(m):
    """The state after three steps of ``m``, the next step's forcing, its
    lateral terms and the external carry before the loop, as ``step``
    forms them."""
    m.run_segment(3)
    st, grid, cfg = m.state, m.grid, m.cfg
    fc = m.forcing_at(m.iint + 1)
    lat = phases.phase_lat(grid, cfg, st.u, st.v, st.ub, st.vb, st.aam,
                           st.rho, m.rmean, grid.h + st.et, grid.h + st.el,
                           fc.ramp)
    (adx2d, ady2d, drx2d, dry2d, aam2d, advua, advva, wubot, wvbot,
     egf, utf, vtf) = stepper.mode_interaction(grid, cfg, st, *lat)
    c = stepper.ExtCarry(el=st.el, elb=st.elb, ua=st.ua, uab=st.uab,
                         va=st.va, vab=st.vab, etf=st.etf, egf=egf,
                         utf=utf, vtf=vtf, advua=advua, advva=advva,
                         wubot=wubot, wvbot=wvbot)
    return st, grid, cfg, fc, lat, c, (adx2d, ady2d, drx2d, dry2d, aam2d)


def _check(got: dict, want: dict) -> None:
    for name, a in got.items():
        b = want[name]
        tol = 1e-10 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def test_mode_internal_matches_oracle():
    m = seamount_model(device="cpu", im=20, jm=18, kb=8, dtype="float64")
    st, grid, cfg, fc, lat, c, aux = _prologue(m)
    for i in range(1, cfg.isplit + 1):
        c = stepper.mode_external_substep(grid, cfg, c, i, fc, aux)
    got = stepper.mode_internal(grid, cfg, st, fc, c, *lat, m.tclim,
                                m.sclim, first=False)

    A = lambda x: x.numpy()
    st_d = {n: A(getattr(st, n)) for n in
            ("u", "ub", "v", "vb", "w", "t", "tb", "s", "sb", "rho",
             "q2", "q2b", "q2l", "q2lb", "km", "kh", "kq", "l",
             "et", "etb", "utb", "vtb", "egb", "vfluxb")}
    st_d.update(tclim=A(m.tclim), sclim=A(m.sclim))
    carry_d = {n: A(getattr(c, n)) for n in
               ("etf", "egf", "utf", "vtf", "wubot", "wvbot")}
    aux_d = dict(zip(("aam", "advx", "advy", "drhox", "drhoy"),
                     (A(x) for x in lat)))
    fc_d = {n: A(getattr(fc, n)) for n in
            ("vflux", "wusurf", "wvsurf", "wtsurf", "wssurf", "swrad",
             "tsurf", "ssurf", "e_atmos", "tbe", "tbw", "tbs", "tbn",
             "sbe", "sbw", "sbs", "sbn")}
    g_d = {n: A(getattr(grid, n)) for n in
           ("h", "dx", "dy", "art", "aru", "arv", "cor", "cbc",
            "dum", "dvm", "fsm", "z", "zz", "dz", "dzz")}
    want = pom_ref.mode_internal_ref(st_d, carry_d, aux_d, fc_d, g_d, cfg)
    _check({n: A(getattr(got, n)) for n in
            ("u", "ub", "v", "vb", "w", "t", "tb", "s", "sb", "rho",
             "q2", "q2b", "q2l", "q2lb", "km", "kh", "kq", "l",
             "wubot", "wvbot", "etb", "et", "utb", "vtb")}, want)


def test_mode_external_loop_matches_oracle():
    """Every substep of the external loop under the file scheme against
    the loop oracle, the etf tail averaging and the last substep's
    accumulator skip included."""
    m = seamount_model(device="cpu", im=20, jm=18, kb=8, dtype="float64",
                       bc_scheme="file", isplit=10)
    st, grid, cfg, fc, lat, c, aux = _prologue(m)
    A = lambda x: x.numpy()
    c_ref = {n: A(getattr(c, n)) for n in c._fields}
    aux_ref = dict(zip(("adx2d", "ady2d", "drx2d", "dry2d", "aam2d"),
                       (A(x) for x in aux)))
    fc_ref = {n: A(getattr(fc, n)) for n in
              ("vflux", "e_atmos", "wusurf", "wvsurf", "elw", "ele",
               "els", "eln", "uabw", "uabe", "vabw", "vabe", "uabs",
               "uabn", "vabs", "vabn")}
    fc_ref["ramp"] = float(fc.ramp)
    g_ref = {n: A(getattr(grid, n)) for n in
             ("h", "dx", "dy", "art", "aru", "arv", "cor", "cbc",
              "fsm", "dum", "dvm")}
    for iext in range(1, cfg.isplit + 1):
        c = stepper.mode_external_substep(grid, cfg, c, iext, fc, aux)
        c_ref = pom_ref.mode_external_substep_ref(c_ref, aux_ref, fc_ref,
                                                  g_ref, cfg, iext)
    _check({n: A(getattr(c, n)) for n in c._fields}, c_ref)
