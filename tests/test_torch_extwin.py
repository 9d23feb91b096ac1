"""The port's halo-window external loop (kernels/extwin.py) on the CPU.

* Its plain version, what the CUDA kernel csrc/extwin.cu is held against on
  the card, against the JAX package's Pallas window kernel
  extpom_tpu/pallas/extwin.py:run_external_loop_windowed in interpret mode:
  64x48x7, isplit=6, float64, C in {2, 3}, ispadv in {1, 2}, atol 1e-12
  times each field's scale.  The carry comes from a seamount cold start plus
  noise drawn from a numpy seed, so every edge row and column carries a
  value of its own.
* The kernel's geometry (shared memory, threads, C against isplit and the
  ring chunk) and the chain/window dispatch.
* The substep's stencil radius, on which the kernel's halo of 2 cells per
  substep rests.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extpom_tpu.cases.seamount import seamount_model as jx_model
from extpom_tpu.core import stepper as jx_stepper
from extpom_tpu.pallas import extwin as jx_extwin

from extpom_tpu_torch import kernels
from extpom_tpu_torch.cases.seamount import seamount_case as pt_case
from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.core import stepper
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.state import Forcing as PtForcing
from extpom_tpu_torch.kernels import extloop, extwin, phases
from extpom_tpu_torch.mesh import extchunk

torch.set_num_threads(1)

KW = dict(im=64, jm=48, kb=7, dtype="float64", isplit=6)
L2_H100 = 50 * 2 ** 20


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def operands():
    """The JAX model and loop operands, and their port counterparts."""
    m = jx_model(donate=False, pallas_ext="off", pallas_phases="off",
                 pallas_extwin="on", **KW)
    cfg, grid, st = m.cfg, m.grid, m.state
    fc = m.forcing_at(1).replace(ramp=jnp.asarray(0.8))
    rng = np.random.default_rng(23)
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
    pcfg, pgrid, _ = pt_case(device="cpu", **KW)
    pfc = PtForcing(**{f.name: _t(getattr(fc, f.name))
                       for f in dataclasses.fields(PtForcing)})
    pc0 = stepper.ExtCarry(*(_t(x) for x in c0))
    paux = tuple(_t(x) for x in aux)
    return dict(jax=(grid, cfg, c0, fc, aux),
                port=(pgrid, pcfg, pc0, pfc, paux))


@pytest.mark.parametrize("ispadv", [1, 2])
@pytest.mark.parametrize("chunk", [2, 3])
def test_plain_matches_pallas_window_kernel(operands, chunk, ispadv):
    grid, cfg, c0, fc, aux = operands["jax"]
    cfg = dataclasses.replace(cfg, extwin_chunk=chunk, ispadv=ispadv)
    C, _, _, ok = jx_extwin.chunk_geometry(cfg)
    assert ok and C == chunk
    want = jax.jit(lambda c, a: jx_extwin.run_external_loop_windowed(
        grid, cfg, c, fc, a, interpret=True))(c0, aux)
    pgrid, pcfg, pc0, pfc, paux = operands["port"]
    pcfg = pcfg.replace(ispadv=ispadv)
    before = dict(kernels.LAUNCHES)
    got = extwin.run_external_loop_windowed(pgrid, pcfg, pc0, pfc, paux)
    assert kernels.LAUNCHES == before     # the CPU runs the plain version
    plain = extwin.run_external_loop_windowed_plain(pgrid, pcfg, pc0, pfc,
                                                    paux)
    for name, g, p, w in zip(extloop.CARRY_FIELDS, got, plain, want):
        assert torch.equal(g, p), name
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * scale,
                                   err_msg=name)


def test_rejects_bad_operands(operands):
    grid, cfg, c0, fc, aux = operands["port"]
    with pytest.raises(TypeError, match="extwin"):
        extwin.run_external_loop_windowed(
            grid, cfg, stepper.ExtCarry(*(x.half() for x in c0)), fc, aux)
    with pytest.raises(ValueError, match="extwin"):
        extwin.run_external_loop_windowed(
            grid, cfg, c0._replace(el=c0.el[:-1]), fc, aux)
    with pytest.raises(TypeError, match="extwin"):
        extwin.run_external_loop_windowed(
            grid, cfg, c0._replace(el=c0.el.to("meta")), fc, aux)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("im,jm", [(256, 256), (2048, 2048), (520, 392)])
def test_chunk_geometry(im, jm, itemsize):
    cfg = Config(im=im, jm=jm, kb=41, isplit=30)
    geo = extwin.chunk_geometry(cfg, itemsize)
    assert cfg.isplit % geo.C == 0 and geo.C > 1
    assert geo.H >= extwin.RADIUS * geo.C
    assert geo.ti >= 1 and geo.tj >= 1
    assert geo.threads % 32 == 0 and geo.threads <= 512
    assert geo.smem == (extwin.N_SHARED * (geo.ti + 2 * geo.H)
                        * (geo.tj + 2 * geo.H) * itemsize)
    assert geo.smem <= 227 * 1024


@pytest.mark.parametrize("isplit,C", [(30, 2), (6, 2), (5, 1), (1, 1)])
def test_chunk_divides_isplit(isplit, C):
    """C is the largest divisor of isplit up to C_MAX."""
    geo = extwin.chunk_geometry(Config(im=64, jm=48, kb=7, isplit=isplit), 8)
    assert geo.C == C and isplit % geo.C == 0


@pytest.mark.parametrize("itemsize", [4, 8])
def test_dispatch_chain_below_l2_window_above(itemsize):
    assert not extwin.use_windowed(256, 256, itemsize, L2_H100)
    assert extwin.use_windowed(2048, 2048, itemsize, L2_H100)
    # the rule is the working set against the L2, nothing else
    n = extwin.working_set_bytes(2048, 2048, itemsize)
    assert not extwin.use_windowed(2048, 2048, itemsize, n)
    assert extwin.use_windowed(2048, 2048, itemsize, n - 1)


@pytest.fixture(scope="module")
def radius_case():
    """A 24x20 external-loop carry of a seamount run with noise, on the
    CPU in float64."""
    m = seamount_model(device="cpu", im=24, jm=20, kb=5, dtype="float64",
                       isplit=6)
    m.run_segment(1)
    g, cfg, st, fc = m.grid, m.cfg, m.state, m.base_forcing
    lat = phases.phase_lat(g, cfg, st.u, st.v, st.ub, st.vb, st.aam, st.rho,
                           m.rmean, g.h + st.et, g.h + st.el, fc.ramp)
    out = stepper.mode_interaction(g, cfg, st, *lat)
    rng = np.random.default_rng(31)
    c0 = stepper.ExtCarry(st.el, st.elb, st.ua, st.uab, st.va, st.vab,
                          st.etf, out[9], out[10], out[11], out[5], out[6],
                          out[7], out[8])
    c0 = stepper.ExtCarry(*(x + torch.from_numpy(
        1e-3 * rng.standard_normal(tuple(x.shape))) for x in c0))
    return g, cfg, c0, fc, tuple(out[:5])


@pytest.mark.parametrize("iext0", [1, 4])
@pytest.mark.parametrize("cell", [(12, 10), (1, 1), (0, 9), (2, 18)])
@pytest.mark.parametrize("C", [1, 2, 3])
def test_substep_radius(radius_case, C, cell, iext0):
    """A change of the carry at one cell reaches no cell more than 2C away
    after C substeps of the plain loop: the window kernel's halo H = 2C
    covers them.  One substep reaches exactly 2 cells from an interior
    cell."""
    g, cfg, c0, fc, aux = radius_case
    em = stepper.ext_precompute(g)

    def run(c):
        for s in range(C):
            c = stepper.mode_external_substep(g, cfg, c, iext0 + s, fc, aux,
                                              em=em)
        return c

    base = run(c0)
    pert = stepper.ExtCarry(*(x.clone() for x in c0))
    for x in pert:
        x[cell] += 1e-2
    got = run(pert)
    ii, jj = np.meshgrid(np.arange(cfg.im), np.arange(cfg.jm), indexing="ij")
    dist = np.maximum(np.abs(ii - cell[0]), np.abs(jj - cell[1]))
    reach = max((int(dist[(a != b).numpy()].max())
                 for a, b in zip(base, got) if bool((a != b).any())),
                default=0)
    assert 1 <= reach <= extwin.RADIUS * C
    if C == 1 and cell == (12, 10):
        assert reach == extwin.RADIUS


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n_substeps", [1, 2, 3, 5, 6, 10, 15, 30])
def test_win_geometry_fits(n_substeps, itemsize):
    """Every geometry the wrappers can pick fits a block's shared memory,
    gives each window column a thread, and divides the substeps it runs."""
    geo = extwin.win_geometry(n_substeps, itemsize)
    assert n_substeps % geo.C == 0 and 1 <= geo.C <= extwin.C_MAX
    assert geo.H == extwin.RADIUS * geo.C
    assert geo.smem == (extwin.N_SHARED * (geo.ti + 2 * geo.H)
                        * (geo.tj + 2 * geo.H) * itemsize)
    assert geo.smem <= extwin.SMEM_BYTES
    assert geo.tj + 2 * geo.H <= geo.threads <= 512 and geo.threads % 32 == 0


@pytest.mark.parametrize("itemsize", [4, 8])
def test_sweep_geometries_fit_or_raise(itemsize):
    """``extwin.geometry`` refuses what the kernel cannot run and returns
    the shared bytes it launches with otherwise, over the sweep's grid."""
    from extpom_tpu_torch.tools.extwin_sweep import CS, THREADS, TILES
    fits = 0
    for C, (ti, tj), threads in itertools.product(CS, TILES, THREADS):
        H = extwin.RADIUS * C
        smem = extwin.N_SHARED * (ti + 2 * H) * (tj + 2 * H) * itemsize
        ok = smem <= extwin.SMEM_BYTES and threads >= tj + 2 * H
        if ok:
            assert extwin.geometry(C, ti, tj, threads, itemsize).smem == smem
            fits += 1
        else:
            with pytest.raises(ValueError, match="extwin"):
                extwin.geometry(C, ti, tj, threads, itemsize)
    assert fits > 0


MESH_GRIDS = {2048: 41, 256: 31}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [2048, 256])
def test_ring_chunk_geometry(n, itemsize):
    """On config5's 2x4 mesh the kernel's C divides the ring chunk (the
    substeps per exchange, mesh/extchunk.py) and isplit."""
    cfg = Config(im=n, jm=n, kb=MESH_GRIDS[n], isplit=30)
    plan = extchunk.chunk_plan(cfg, 2, 4, n // 2, n // 4, "cpu", itemsize)
    geo = extwin.win_geometry(plan.C, itemsize)
    assert plan.C % geo.C == 0 and cfg.isplit % geo.C == 0
    assert geo.smem <= extwin.SMEM_BYTES


@pytest.mark.parametrize("kw", [dict(bc_scheme="orlanski"), dict(mode=2),
                                dict(mode=2, bc_scheme="orlanski")],
                         ids=["orlanski", "mode2", "mode2-orlanski"])
@pytest.mark.parametrize("cell", [(12, 10), (1, 1), (0, 9), (2, 18),
                                  (21, 10), (12, 17)])
@pytest.mark.parametrize("C", [1, 2])
def test_substep_radius_options(radius_case, C, cell, kw):
    """Under the options a change of the carry at one cell reaches no cell
    more than R C away after C substeps, R the halo per substep of the
    kernel of those options (extwin.geometry: 3 under the orlanski scheme,
    whose edge value forms the interior value one cell in; 2 in mode 2)."""
    g, cfg, c0, fc, aux = radius_case
    cfg = cfg.replace(**kw)
    em = stepper.ext_precompute(g)

    def run(c):
        for s in range(C):
            c = stepper.mode_external_substep(g, cfg, c, 1 + s, fc, aux,
                                              em=em)
        return c

    base = run(c0)
    pert = stepper.ExtCarry(*(x.clone() for x in c0))
    for x in pert:
        x[cell] += 1e-2
    got = run(pert)
    ii, jj = np.meshgrid(np.arange(cfg.im), np.arange(cfg.jm), indexing="ij")
    dist = np.maximum(np.abs(ii - cell[0]), np.abs(jj - cell[1]))
    reach = max((int(dist[(a != b).numpy()].max())
                 for a, b in zip(base, got) if bool((a != b).any())),
                default=0)
    geo = extwin.win_geometry(C, 8, extloop.ext_flags(cfg))
    assert geo.H == (extwin.RADIUS_ORL if cfg.bc_scheme == "orlanski"
                     else extwin.RADIUS) * C
    assert 1 <= reach <= geo.H


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("flags", [2, 4, 6])
def test_win_geometry_options_fit(flags, itemsize):
    """The window of each option's kernel fits a block's shared memory and
    gives each window column a thread: mode 2 keeps the bottom stress in
    the window (19 fields), the orlanski scheme a halo of 3 per substep."""
    geo = extwin.win_geometry(30, itemsize, flags)
    fields = extwin.N_SHARED_MODE2 if flags & 4 else extwin.N_SHARED
    assert geo.H == (3 if flags & 2 else 2) * geo.C
    assert geo.smem == fields * (geo.ti + 2 * geo.H) * (
        geo.tj + 2 * geo.H) * itemsize <= extwin.SMEM_BYTES
    assert geo.threads >= geo.tj + 2 * geo.H
