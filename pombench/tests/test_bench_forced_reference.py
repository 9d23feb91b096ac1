"""The reference's forced parts against their loop transcriptions
(``pom_forcing_ref.py`` beside this file): bcond(3), the interior restoring
and the forcing of a step from its series give the loop functions' answer
on random fields with land points, within 1e-12 of their scale, in float64
on the CPU."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pombench.reference import kernels as K
from pombench.reference import model as ref
from pombench.tests import pom_forcing_ref as loops
from pombench.tests.test_bench_reference import KB, IM, JM, Fields, T, same

SEEDS = (1, 2, 3)


def _profiles(f, names, lo=-0.5, hi=0.5):
    return {n: f.r.uniform(lo, hi, (KB, JM if n[-1] in "ew" else IM))
            for n in names}


@pytest.mark.parametrize("seed", SEEDS)
def test_bcond_vel3d(seed):
    f = Fields(seed)
    fc = _profiles(f, ("ube", "ubw", "ubs", "ubn", "vbe", "vbw", "vbs",
                       "vbn"))
    d = f.f2(100, 4000)
    args = (f.f3(), f.f3(), f.f3(), f.f3(), d)
    rest = (float(d.max()) * 1.1, f.mask(), f.mask(), KB - 1)
    got = K.bcond_vel3d(*map(T, args), {k: T(v) for k, v in fc.items()},
                        *[T(a) if isinstance(a, np.ndarray) else a
                          for a in rest])
    same(got, loops.bcond_vel3d_ref(*args, fc, *rest))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rate", ("field", "one"))
def test_restore_interior(seed, rate):
    f = Fields(seed)
    tau = f.f3(0, 0.5) if rate == "field" else np.full((1, 1, 1), 1 / 30)
    args = (f.f3(5, 25), f.f3(5, 25), f.f3(30, 36), f.f3(30, 36),
            f.f3(5, 25), f.f3(30, 36), tau, f.mask(), 360.0, KB - 1)
    got = K.restore_interior(*[T(a) if isinstance(a, np.ndarray) else a
                               for a in args])
    same(got, loops.restore_interior_ref(*args))


def _series(f, nrec, taurstr):
    """Random series of every name a case may give, ``nrec`` records."""
    r = f.r
    s = {n: r.uniform(-0.3, 0.3, (nrec, JM if n[-1] in "ew" else IM))
         for n in ("elw", "ele", "els", "eln")}
    s.update({n: r.uniform(-0.5, 0.5, (nrec, KB, JM if n[-1] in "ew"
                                       else IM))
              for n in (f"{v}b{side}" for v in "tsuv" for side in "wesn")})
    s.update({n: r.uniform(-1e-4, 1e-4, (nrec, IM, JM))
              for n in ("wusurf", "wvsurf", "wtsurf", "swrad", "tsurf",
                        "ssurf")})
    s.update({n: r.uniform(5, 25, (nrec, KB, IM, JM))
              for n in ("trstr", "srstr")})
    if taurstr:
        s["taurstr"] = r.uniform(0, 0.1, (nrec, KB, IM, JM))
    return s


# the steps followed: inside the first lateral record, the last step of
# it, the step that crosses into the second, the step that crosses a
# surface record, and a step past the series' end
STEPS = (4, 18, 19, 59, 400)


@pytest.mark.parametrize("iint", STEPS)
@pytest.mark.parametrize("taurstr", (True, False))
def test_forcing_at(iint, taurstr):
    f = Fields(iint)
    nrec = 6
    series = _series(f, nrec, taurstr)
    cadences = {n: (1 / 24 if n[:2] in ("el", "tb", "sb", "ub", "vb")
                    else 30.0 if n in ("trstr", "srstr", "taurstr")
                    else 0.125) for n in series}
    p = ref.params(dict(kb=KB, dte=6.0, isplit=30, do_restore=True))
    h = torch.zeros(IM, JM, dtype=torch.float64)
    g = SimpleNamespace(h=h, dz64=f.dz)
    base = {n: None for n in ("uabw", "uabe", "vabs", "vabn", "taurstr")}
    got = ref.forcing_at(p, g, base, series, cadences, iint)
    want = loops.forcing_ref(series, cadences, p.dti, iint, f.dz, KB - 1,
                             True)
    assert set(want) <= set(got)
    for n, w in want.items():
        same(got[n].reshape(w.shape), w)


def test_forcing_at_without_series_is_the_base():
    p = ref.params(dict(kb=KB))
    base = {"elw": T(np.zeros(JM))}
    assert ref.forcing_at(p, None, base, {}, {}, 7) is base


def test_restoring_needs_its_series():
    p = ref.params(dict(kb=KB, do_restore=True))
    with pytest.raises(ValueError, match="trstr and srstr"):
        ref.forcing_at(p, None, {}, {"elw": np.zeros((2, JM))},
                       {"elw": 1 / 24}, 3)


@pytest.mark.parametrize("namelist", [{"mode": 2},
                                      {"bc_scheme": "orlanski"}])
def test_params_refuses_what_it_does_not_step(namelist):
    with pytest.raises(NotImplementedError, match="mode 3"):
        ref.params(namelist)


@pytest.mark.parametrize("namelist", [{"bc_scheme": "file"},
                                      {"do_restore": True},
                                      {"bc_scheme": "file",
                                       "do_restore": True}])
def test_params_takes_the_forced_options(namelist):
    p = ref.params(dict(namelist, kb=KB))
    assert (p.bc_scheme, p.do_restore) == (
        namelist.get("bc_scheme", "extpom"), namelist.get("do_restore",
                                                          False))
