"""The port's plain external loop (kernels/extloop.py:
run_external_loop_plain, what the CUDA chain csrc/extloop.cu is held against
on the card) against the JAX package's Pallas kernel
extpom_tpu/pallas/extloop.py:run_external_loop in interpret mode, at
32x48x7 with isplit=6 in float64 (atol 1e-12 times each field's scale).

The carry comes from a seamount cold start plus noise drawn from a numpy
seed, so every edge row and column carries a value of its own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extpom_tpu.cases.seamount import seamount_model as jx_model
from extpom_tpu.core import stepper as jx_stepper
from extpom_tpu.pallas import extloop as jx_extloop

from extpom_tpu_torch import kernels
from extpom_tpu_torch.cases.seamount import seamount_case as pt_case
from extpom_tpu_torch.core import stepper
from extpom_tpu_torch.core.state import Forcing as PtForcing
from extpom_tpu_torch.kernels import extloop

torch.set_num_threads(1)

KW = dict(im=32, jm=48, kb=7, dtype="float64", isplit=6)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def loop():
    m = jx_model(donate=False, **KW)
    cfg, grid, st = m.cfg, m.grid, m.state
    fc = m.forcing_at(1).replace(ramp=jnp.asarray(0.8))
    rng = np.random.default_rng(21)
    noise = lambda s: jnp.asarray(s * rng.standard_normal(st.el.shape))
    st = st.replace(el=st.el + noise(0.01), elb=st.elb + noise(0.01),
                    ua=st.ua + noise(0.05), uab=st.uab + noise(0.05),
                    va=st.va + noise(0.05), vab=st.vab + noise(0.05),
                    etf=st.etf + noise(0.01))
    fc = fc.replace(vflux=noise(1e-6), e_atmos=noise(1e-3),
                    wusurf=noise(1e-4), wvsurf=noise(1e-4),
                    uabw=fc.uabw + 0.03, vabs=fc.vabs - 0.02)
    aam = st.aam + 50.0
    advx = noise(1e-3)[None] * jnp.ones_like(st.u)
    advy = noise(1e-3)[None] * jnp.ones_like(st.u)
    (adx2d, ady2d, drx2d, dry2d, aam2d, advua, advva, wubot, wvbot,
     egf, utf, vtf) = jx_stepper.mode_interaction(
        grid, cfg, st, aam, advx, advy, advx * 0.1, advy * 0.1)
    c0 = jx_stepper.ExtCarry(st.el, st.elb, st.ua, st.uab, st.va, st.vab,
                             st.etf, egf, utf, vtf, advua, advva,
                             wubot + noise(1e-5), wvbot + noise(1e-5))
    aux = (adx2d, ady2d, drx2d, dry2d, aam2d)
    want = jax.jit(lambda c, a: jx_extloop.run_external_loop(
        grid, cfg, c, fc, a, interpret=True))(c0, aux)
    pcfg, pgrid, _ = pt_case(device="cpu", **KW)
    pfc = PtForcing(**{f.name: _t(getattr(fc, f.name))
                       for f in dataclasses.fields(PtForcing)})
    pc0 = stepper.ExtCarry(*(_t(x) for x in c0))
    paux = tuple(_t(x) for x in aux)
    return dict(want=want, args=(pgrid, pcfg, pc0, pfc, paux),
                jax=(grid, cfg, c0, fc, aux))


def test_plain_loop_matches_pallas_kernel(loop):
    before = kernels.LAUNCHES["extloop"]
    got = extloop.run_external_loop(*loop["args"])
    assert kernels.LAUNCHES["extloop"] == before
    for name, g, w in zip(extloop.CARRY_FIELDS, got, loop["want"]):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * scale,
                                   err_msg=name)


def test_carry_order_matches_tpu_kernel():
    """The C entry point takes the carry in CARRY_FIELDS order."""
    assert extloop.CARRY_FIELDS == jx_extloop.CARRY_FIELDS
    assert stepper.ExtCarry._fields == jx_extloop.CARRY_FIELDS
    assert extloop.GRID_FIELDS == jx_extloop.GRID_FIELDS
    assert extloop.AUX_FIELDS == jx_extloop.AUX_FIELDS
    assert extloop.FC_2D_FIELDS == jx_extloop.FC_2D_FIELDS
    assert extloop.FC_1D_J == jx_extloop.FC_1D_J
    assert extloop.FC_1D_I == jx_extloop.FC_1D_I


def test_rejects_dtype(loop):
    grid, cfg, c0, fc, aux = loop["args"]
    bad = stepper.ExtCarry(*(x.to(torch.float16) for x in c0))
    with pytest.raises(TypeError):
        extloop.run_external_loop(grid, cfg, bad, fc, aux)


def test_rejects_shape(loop):
    grid, cfg, c0, fc, aux = loop["args"]
    with pytest.raises(ValueError):
        extloop.run_external_loop(grid, cfg, c0._replace(el=c0.el[:-1]),
                                  fc, aux)
    with pytest.raises(ValueError):
        extloop.run_external_loop(grid, cfg, c0, fc.replace(elw=fc.elw[:-1]),
                                  aux)


def test_rejects_noncontiguous(loop):
    grid, cfg, c0, fc, aux = loop["args"]
    wus = fc.wusurf.t().contiguous().t()
    assert not wus.is_contiguous()
    with pytest.raises(ValueError):
        extloop.run_external_loop(grid, cfg, c0, fc.replace(wusurf=wus), aux)


def test_orlanski_loop_matches_jax(loop):
    """Under the orlanski scheme (orl_el, orl_vel2d) the plain loop gives
    the JAX package's Pallas kernel's carry (interpret mode)."""
    grid, cfg, c0, fc, aux = loop["args"]
    jgrid, jcfg, jc0, jfc, jaux = loop["jax"]
    jcfg = jcfg.replace(bc_scheme="orlanski")
    want = jax.jit(lambda c, a: jx_extloop.run_external_loop(
        jgrid, jcfg, c, jfc, a, interpret=True))(jc0, jaux)
    got = extloop.run_external_loop(grid, cfg.replace(bc_scheme="orlanski"),
                                    c0, fc, aux)
    for name, g, w in zip(extloop.CARRY_FIELDS, got, want):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("cells,sms,threads", [
    (65536, 132, 512),      # 256x256: 128 blocks, one per SM
    (23312, 132, 192),      # a 188x124 block of the 256² mesh: 122 blocks
    (203840, 132, 512),     # 520x392: capped, the cells visited grid-stride
    (1536, 132, 32),        # 32x48: one warp per block
    (1, 132, 32),
])
def test_block_threads(cells, sms, threads):
    """The fewest whole warps per block with which one block per SM covers
    the cells, at most MAX_THREADS."""
    assert extloop.block_threads(cells, sms) == threads
    assert threads % 32 == 0 and threads <= extloop.MAX_THREADS
    if threads < extloop.MAX_THREADS:
        assert -(-cells // threads) <= sms


@pytest.mark.parametrize("cells,threads,per_sm,sms,blocks", [
    (65536, 256, 2, 132, 256),      # 256x256: one cell per thread
    (203840, 256, 2, 132, 264),     # 520x392: every resident block
    (23312, 256, 4, 132, 92),       # a 188x124 block of the 256² mesh
    (1536, 512, 1, 132, 3),         # 32x48
    (1, 128, 8, 132, 1),
])
def test_persistent_grid(cells, threads, per_sm, sms, blocks):
    """A cooperative launch takes the blocks the card holds at once, and no
    more than one cell per thread needs."""
    assert extloop.persistent_grid(cells, threads, per_sm, sms) == blocks


def test_persistent_grid_refuses_a_block_that_does_not_fit():
    with pytest.raises(RuntimeError):
        extloop.persistent_grid(65536, 512, 0, 132)


def test_scratch_holds_metrics_and_four_level_slots():
    """The kernel's scratch: the metrics, elf/uaf/vaf (the third slot of
    each time level) and the fourth slots of el, ua and va."""
    assert extloop.N_SCRATCH == 13 + 3 + 3
    assert extloop.N_SUBSTEP == 3 and extloop.N_SLOTS == 3
