"""The reference's kernels against the loop oracle they were written from
(``pom_ref.py`` beside this file, a frozen copy of the repository's NumPy
oracle): each vectorised kernel of ``pombench.reference.kernels`` gives
the loop function's answer on random fields, within 1e-12 of its scale, in
float64 on the CPU."""

import numpy as np
import pytest
import torch

from pombench.reference import kernels as K
from pombench.tests import pom_ref

KB, IM, JM = 7, 11, 9


class Fields:
    """Random fields of one seed: 3-D (kb, im, jm), 2-D (im, jm), levels."""

    def __init__(self, seed):
        self.r = np.random.default_rng(seed)
        z = -np.sort(np.concatenate([[0.0, 1.0],
                                     self.r.uniform(0.05, 0.95, KB - 2)]))
        zz = np.append(0.5 * (z[:-1] + z[1:]), 0.0)
        zz[-1] = 2.0 * zz[-2] - zz[-3]
        self.z, self.zz = z, zz
        self.dz = np.append(z[:-1] - z[1:], 0.0)
        self.dzz = np.append(zz[:-1] - zz[1:], 0.0)

    def f3(self, lo=-1.0, hi=1.0):
        return self.r.uniform(lo, hi, (KB, IM, JM))

    def f2(self, lo=-1.0, hi=1.0):
        return self.r.uniform(lo, hi, (IM, JM))

    def mask(self):
        m = np.ones((IM, JM))
        m[self.r.integers(1, IM - 1, 4), self.r.integers(1, JM - 1, 4)] = 0.0
        return m


T = lambda a: torch.as_tensor(np.asarray(a, np.float64))


def same(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        w = np.asarray(w)
        tol = 1e-12 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)


def call(name, *args, **kw):
    """The vectorised kernel ``name`` and its loop oracle on ``args``
    (numpy arrays, handed to the kernel as tensors)."""
    tens = [T(a) if isinstance(a, np.ndarray) else a for a in args]
    kwt = {k: T(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = getattr(K, name)(*tens, **kwt)
    want = getattr(pom_ref, name + "_ref")(*args, **kw)
    same(got, want)


SEEDS = (1, 2, 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_dens(seed):
    f = Fields(seed)
    call("dens", f.f3(30, 36) - 20.0, f.f3(2, 25) - 10.0, f.zz,
         f.f2(100, 4000), f.mask(), 10.0, 20.0, 9.806, 1025.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_baropg(seed):
    f = Fields(seed)
    call("baropg", f.f3(-1e-3, 1e-3), f.f3(-1e-3, 1e-3), f.f2(100, 4000),
         f.mask(), f.mask(), f.f2(3e3, 5e3), f.f2(3e3, 5e3), f.zz, 9.806,
         0.7, KB - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_baropg_mcc(seed):
    f = Fields(seed)
    call("baropg_mcc", f.f3(-1e-3, 1e-3), f.f3(-1e-3, 1e-3),
         f.f2(100, 4000), f.f2(100, 4000), f.mask(), f.mask(),
         f.f2(3e3, 5e3), f.f2(3e3, 5e3), f.zz, f.dzz, 9.806, 0.7, KB - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_vertvl(seed):
    f = Fields(seed)
    call("vertvl", f.f3(), f.f3(), f.f3(), f.f2(100, 4000), f.f2(), f.f2(),
         f.f2(), f.f2(), f.f2(3e3, 5e3), f.f2(3e3, 5e3), f.dz, 360.0, KB - 1)


@pytest.mark.parametrize("nbc", (1, 2, 3, 4))
def test_proft(nbc):
    f = Fields(nbc)
    call("proft", f.f3(), f.f2(), f.f2(), nbc, f.f3(0, 1e-2),
         f.f2(-0.5, 0.5), f.f2(-1e-4, 0), f.f2(10, 100), f.z, f.dz, f.dzz,
         360.0, 2e-5, 2, KB)


@pytest.mark.parametrize("seed", SEEDS)
def test_advt1(seed):
    f = Fields(seed)
    call("advt1", f.f3(), f.f3(), f.f3(), f.f3(), f.f3(), f.f3(-1e-3, 1e-3),
         f.f3(0, 500), f.f2(100, 4000), f.f2(-0.5, 0.5), f.f2(-0.5, 0.5),
         f.f2(100, 4000), f.mask(), f.mask(), f.f2(3e3, 5e3),
         f.f2(3e3, 5e3), f.f2(9e6, 2e7), f.dz, 360.0, 0.1, KB - 1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", ("profu", "profv"))
def test_prof_vel(seed, which):
    f = Fields(seed)
    call(which, f.f3(), f.f3(), f.f3(), f.f3(0, 1e-2), f.f2(-0.5, 0.5),
         f.f2(-1e-4, 1e-4), f.f2(10, 100), f.f2(2e-3, 1e-2), f.mask(), f.dz,
         f.dzz, 360.0, 2e-5, KB)


@pytest.mark.parametrize("seed", SEEDS)
def test_advave(seed):
    f = Fields(seed)
    call("advave", f.f2(100, 4000), f.f2(), f.f2(), f.f2(), f.f2(),
         f.f2(0, 500), f.f2(), f.f2(), f.f2(2e-3, 1e-2), f.f2(3e3, 5e3),
         f.f2(3e3, 5e3), f.f2(9e6, 2e7), f.f2(9e6, 2e7), 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_advct(seed):
    f = Fields(seed)
    call("advct", f.f3(), f.f3(), f.f3(), f.f3(), f.f3(0, 500),
         f.f2(100, 4000), f.f2(3e3, 5e3), f.f2(3e3, 5e3), f.f2(9e6, 2e7),
         f.f2(9e6, 2e7), KB - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_advq(seed):
    f = Fields(seed)
    call("advq", f.f3(0, 1e-3), f.f3(0, 1e-3), f.f3(), f.f3(),
         f.f3(-1e-3, 1e-3), f.f3(0, 500), f.f2(100, 4000), f.f2(-0.5, 0.5),
         f.f2(-0.5, 0.5), f.f2(100, 4000), f.mask(), f.mask(),
         f.f2(3e3, 5e3), f.f2(3e3, 5e3), f.f2(9e6, 2e7), f.dz, 360.0, KB - 1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", ("advu", "advv"))
def test_adv_vel(seed, which):
    f = Fields(seed)
    call(which, f.f3(), f.f3(), f.f3(), f.f3(-1e-3, 1e-3), f.f3(), f.f3(),
         f.f2(100, 4000), f.f2(), f.f2(), f.f2(), f.f2(-0.5, 0.5),
         f.f2(-0.5, 0.5), f.f2(100, 4000), f.f2(3e3, 5e3), f.f2(9e6, 2e7),
         f.f2(-1e-4, 1e-4), f.dz, 9.806, 360.0, KB - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_smol_adif(seed):
    f = Fields(seed)
    ff = f.f3(0, 1)
    ff[ff < 0.05] = 1e-10          # some cells under value_min
    call("smol_adif", f.f3(-1e5, 1e5), f.f3(-1e5, 1e5), f.f3(-1e3, 1e3),
         ff, f.f2(100, 4000), f.f2(9e6, 2e7), f.f2(9e6, 2e7), f.dzz,
         f.mask(), 360.0, 0.5, KB - 1)


@pytest.mark.parametrize("nitera", (1, 2, 3))
def test_advt2(nitera):
    f = Fields(nitera)
    call("advt2", f.f3(5, 25), f.f3(5, 25), f.f3(5, 25), f.f3(-0.3, 0.3),
         f.f3(-0.3, 0.3), f.f3(-1e-3, 1e-3), f.f3(0, 500), f.f2(100, 4000),
         f.f2(-0.5, 0.5), f.f2(-0.5, 0.5), f.f2(100, 4000), f.mask(),
         f.mask(), f.mask(), f.f2(3e3, 5e3), f.f2(3e3, 5e3),
         f.f2(9e6, 2e7), f.f2(9e6, 2e7), f.f2(9e6, 2e7), f.dz, f.dzz, 360.0,
         0.1, 0.5, nitera, KB - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_profq(seed):
    f = Fields(seed)
    call("profq", f.f3(0, 1e-4), f.f3(0, 1e-4), f.f3(1e-8, 1e-4),
         f.f3(-1e-4, 1e-4), f.f3(-1e-4, 1e-4), f.f3(), f.f3(), f.f3(5, 25),
         f.f3(14, 16), f.f3(-1e-3, 1e-3), f.f3(0, 1e-2), f.f3(0, 1e-2),
         f.f3(0, 1e-2), f.f3(0, 10), f.f2(-0.5, 0.5), f.f2(-1e-4, 1e-4),
         f.f2(-1e-4, 1e-4), f.f2(-1e-4, 1e-4), f.f2(-1e-4, 1e-4),
         f.f2(100, 4000), f.mask(), f.z, f.zz, f.dz, f.dzz, 360.0, 2e-5,
         9.806, 0.4, 10.0, 20.0, 1025.0, 1e-9, KB)


@pytest.mark.parametrize("seed", SEEDS)
def test_bcond_ts(seed):
    f = Fields(seed)
    fc = {k: f.r.uniform(5, 25, (KB, JM if k[2] in "ew" else IM))
          for k in ("tbe", "tbw", "tbs", "tbn", "sbe", "sbw", "sbs", "sbn")}
    args = (f.f3(5, 25), f.f3(5, 25), f.f3(5, 25), f.f3(5, 25), f.f3(),
            f.f3(), f.f3(-1e-3, 1e-3), f.f2(100, 4000))
    rest = (f.f2(3e3, 5e3), f.f2(3e3, 5e3), f.zz, f.mask(), 180.0, KB - 1)
    got = K.bcond_ts(*map(T, args), {k: T(v) for k, v in fc.items()},
                     *[T(a) if isinstance(a, np.ndarray) else a
                       for a in rest])
    same(got, pom_ref.bcond_ts_ref(*args, fc, *rest))


@pytest.mark.parametrize("seed", SEEDS)
def test_bcond_turb(seed):
    f = Fields(seed)
    call("bcond_turb", f.f3(), f.f3(), f.f3(0, 1e-3), f.f3(0, 1e-3), f.f3(),
         f.f3(), f.f2(3e3, 5e3), f.f2(3e3, 5e3), f.mask(), 180.0, 1e-9)


@pytest.mark.parametrize("seed", SEEDS)
def test_bcondorl_vel3d(seed):
    f = Fields(seed)
    uf = f.f3()
    uf[0, -2, 3] = 0.0      # a zero denominator somewhere
    call("bcondorl_vel3d", uf, f.f3(), f.f3(), f.f3(), f.f3(), f.f3(),
         f.mask(), f.mask(), KB - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_bcond_2d(seed):
    f = Fields(seed)
    call("bcond_el", f.f2(), f.mask())
    fc = {k: f.r.uniform(-1, 1, JM if k[-1] in "ew" else IM)
          for k in ("uabw", "uabe", "vabw", "vabe", "vabs", "vabn", "uabs",
                    "uabn", "elw", "ele", "els", "eln")}
    args = (f.f2(), f.f2(), f.f2(), f.f2(100, 4000))
    rest = (f.mask(), f.mask(), 9.806, 0.5, 1.0, 0.9, 0.8, 0.7)
    got = K.bcond_vel2d(*map(T, args), {k: T(v) for k, v in fc.items()},
                        *[T(a) if isinstance(a, np.ndarray) else a
                          for a in rest])
    same(got, pom_ref.bcond_vel2d_ref(*args, fc, *rest))
