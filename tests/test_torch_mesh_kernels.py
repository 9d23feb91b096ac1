"""The plain versions of the decomposed step's block kernels on the CPU in
float64, block by block:

* (rows 7 and 6 of PERF.md's kernel table) the plain chunk
  ``kernels/extloop.py:run_external_chunk_plain`` against the JAX package's
  ``run_external_chunk_vmem`` and ``run_external_chunk_windowed``
  (``extpom_tpu/pallas/extloop.py:_chunk_kernel``, ``pallas/extwin.py:
  _kernel`` with ``has_off``), called directly in interpret mode on the
  same ring-extended operands: a corner, an edge and an interior block of
  a 3x3 mesh, each with C = 2 and 3 and ispadv = 1 and 2, 1e-12 of each
  field's scale;
* (row 4) each phase run on ring-extended blocks with their global offset
  (``phase_<p>(..., off=...)``) and trimmed, against the JAX single-device
  phase (``extpom_tpu/core/stepper.py``) on the whole grid, 1e-12.

The operands come from a seamount state after two steps; the rings follow
the fill rules of mesh/extchunk.py."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extpom_tpu.cases.seamount import seamount_model as jx_model
from extpom_tpu.core import stepper as jx_stepper
from extpom_tpu.core.config import Config as JxConfig
from extpom_tpu.pallas import extloop as jx_extloop, extwin as jx_extwin

from extpom_tpu_torch.cases.seamount import seamount_model as pt_model
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.core.convert import from_numpy
from extpom_tpu_torch.core.grid import Grid as PtGrid
from extpom_tpu_torch.core.state import Forcing as PtForcing, State as PtState
from extpom_tpu_torch.kernels import extloop, phases
from extpom_tpu_torch.mesh import extchunk
from extpom_tpu_torch.mesh.shardmap import Blocks, Mesh, _split

torch.set_num_threads(1)

ATOL = 1e-12
EXT_KW = dict(im=72, jm=48, kb=5, isplit=6, dtype="float64")
BLOCKS = {"corner": (0, 0), "edge": (0, 1), "interior": (1, 1)}


def _close(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=ATOL * scale,
                                   err_msg=f"{what} output {k}")


# ---------------------------------------------------------------------------
# the external chunks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ext_case():
    """The operands of the external loop of the third step of a 3x3
    decomposed seamount run: the blocks, the carry and aux by block."""
    rec = {}
    orig = extchunk.run_external_loop_chunked

    def spy(blocks, cfg, carry, aux, fc):
        rec.update(blocks=blocks, carry=carry, aux=aux, ramp=fc.ramp)
        return orig(blocks, cfg, carry, aux, fc)

    m = pt_model(device="cpu", **EXT_KW).shard(Mesh(3, 3, device="cpu"))
    m.run_segment(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(extchunk, "run_external_loop_chunked", spy)
        m.run_segment(1)
    return rec


def _chunk_operands(ext_case, b, h):
    """Block ``b``'s external-loop operands extended by ``h``."""
    from extpom_tpu_torch.core.stepper import ExtCarry
    B = ext_case["blocks"]
    ring = lambda vals: B.ext(vals, b, h)
    c = ExtCarry(*(ring({q: ext_case["carry"][q][k] for q in B.ids})
                   for k in range(len(ExtCarry._fields))))
    aux = tuple(ring({q: ext_case["aux"][q][k] for q in B.ids})
                for k in range(5))
    return (B.grid_ext(b, h), c, B.fc_ext(b, h).replace(
        ramp=ext_case["ramp"]), aux, B.goff(b, h))


def _jax_chunk_operands(grid, c, fc, aux):
    J = lambda x: jnp.asarray(x.numpy())
    g = SimpleNamespace(**{f: J(getattr(grid, f))
                           for f in jx_extloop.GRID_FIELDS})
    f = SimpleNamespace(**{n: J(getattr(fc, n)) for n in (
        jx_extloop.FC_2D_FIELDS + jx_extloop.FC_1D_J + jx_extloop.FC_1D_I
        + ("ramp",))})
    return g, jx_stepper.ExtCarry(*(J(x) for x in c)), f, tuple(map(J, aux))


@pytest.mark.parametrize("block,C,ispadv", [
    ("corner", 2, 1), ("corner", 3, 2), ("edge", 2, 2), ("edge", 3, 1),
    ("interior", 2, 1), ("interior", 3, 2)])
def test_plain_chunk_matches_jax_vmem_chunk(ext_case, block, C, ispadv):
    """Row 7: the last chunk of the loop (the etf tail and the skip of the
    accumulators on the last substep), ring 3 C on each split side."""
    cfg = Config(**EXT_KW, ispadv=ispadv)
    grid, c, fc, aux, off = _chunk_operands(ext_case, BLOCKS[block],
                                            (3 * C, 3 * C))
    iext0 = cfg.isplit - C + 1
    got = extloop.run_external_chunk_plain(grid, cfg, c, fc, aux, C, iext0,
                                           off)
    g, jc, f, ja = _jax_chunk_operands(grid, c, fc, aux)
    want = jx_extloop.run_external_chunk_vmem(
        g, JxConfig(**EXT_KW, ispadv=ispadv), jc, f, ja, C, iext0, off,
        interpret=True)
    _close(got, want, f"chunk {block} C={C} ispadv={ispadv}")


@pytest.mark.parametrize("block,C,ispadv", [
    ("corner", 2, 2), ("edge", 3, 1), ("interior", 2, 1)])
def test_plain_chunk_matches_jax_window_chunk(ext_case, block, C, ispadv):
    """Row 6: the JAX window kernel stripes the block in windows of 8-row
    multiples, so its ring along i is 3 C rounded up to 8 rows; the first
    chunk of the loop with C = 2, the last (the etf tail and the skip of
    the accumulators) with C = 3."""
    cfg = Config(**EXT_KW, ispadv=ispadv)
    jcfg = JxConfig(**EXT_KW, ispadv=ispadv)
    h = (-(-3 * C // 8) * 8, 3 * C)
    grid, c, fc, aux, off = _chunk_operands(ext_case, BLOCKS[block], h)
    assert jx_extwin.win_geometry(jcfg, *c.el.shape, C)[2]
    iext0 = 1 if C == 2 else cfg.isplit - C + 1
    got = extloop.run_external_chunk_plain(grid, cfg, c, fc, aux, C, iext0,
                                           off)
    g, jc, f, ja = _jax_chunk_operands(grid, c, fc, aux)
    want = jx_extwin.run_external_chunk_windowed(
        g, jcfg, jc, f, ja, C, iext0, off, cfg.im, cfg.jm, interpret=True)
    _close(got, want, f"window chunk {block} C={C} ispadv={ispadv}")


# ---------------------------------------------------------------------------
# the phases
# ---------------------------------------------------------------------------

PH_KW = dict(im=48, jm=48, kb=7, isplit=6, dtype="float64")
PH_MESH = (3, 3)
# each port phase's operands after (grid, cfg) ("FC": the Forcing, "RAMP":
# its ramp), and the JAX phase's
ARGS = {
    "lat": ("u", "v", "ub", "vb", "aam", "rho", "rmean", "dt", "d", "RAMP"),
    "uvw": ("u", "v", "w", "dt", "utb", "vtb", "utf", "vtf", "etb", "etf",
            "vfluxb", "vflux"),
    "tke": ("q2", "q2b", "q2l", "q2lb", "u", "v", "w", "aam", "t", "s", "rho",
            "km", "kh", "kq", "dt", "etb", "etf", "wubot", "wvbot", "FC"),
    "tracer": ("t", "tb", "s", "sb", "tclim", "sclim", "u", "v", "w", "aam",
               "kh", "dt", "etb", "etf", "FC"),
    "mom": ("u", "ub", "v", "vb", "w", "advx", "advy", "drhox", "drhoy", "km",
            "dt", "egf", "egb", "etb", "etf", "d", "FC"),
}
JX_ARGS = {
    "lat": ("u", "v", "ub", "vb", "aam", "rho", "rmean", "dt", "d", "RAMP"),
    "uvw": ARGS["uvw"],
    "tke": ("q2", "q2b", "q2l", "q2lb", "u", "v", "w", "aam", "t", "s", "rho",
            "km", "kh", "kq", "l", "dt", "etb", "etf", "wubot", "wvbot",
            "FC"),
    "tracer": ("t", "tb", "s", "sb", "tclim", "sclim", "u", "ub", "v", "w",
               "aam", "kh", "dt", "etb", "etf", "FC"),
    "mom": ARGS["mom"],
}


@pytest.fixture(scope="module")
def phase_case():
    """A seamount state after two steps (the port's plain path: the JAX
    step would add a compile) with seeded perturbations (so that both
    branches of the open boundaries occur), as numpy fields ``f``, the JAX
    grid, config and forcing, and the port's blocks of it on a 3x3
    mesh."""
    m = jx_model(donate=False, **PH_KW)
    pm = pt_model(device="cpu", **PH_KW)
    pm.run_segment(2)
    rng = np.random.default_rng(23)
    kb, im, jm = PH_KW["kb"], PH_KW["im"], PH_KW["jm"]
    n3 = lambda s: s * rng.standard_normal((kb, im, jm))
    n2 = lambda s: s * rng.standard_normal((im, jm))
    np_ = lambda obj, cls: {n: np.array(getattr(obj, n))
                            for n in cls.__dataclass_fields__}
    st, gd = np_(pm.state, PtState), np_(m.grid, PtGrid)
    fc = np_(m.forcing_at(3), PtForcing)
    for name, scale in (("u", 0.05), ("ub", 0.05), ("v", 0.05), ("vb", 0.05),
                        ("w", 1e-5), ("t", 0.1), ("tb", 0.1), ("s", 0.01),
                        ("sb", 0.01)):
        st[name] = st[name] + n3(scale)
    for name in ("km", "kh", "kq", "aam"):
        st[name] = st[name] + np.abs(n3(1e-3))
    for name in ("q2", "q2l"):
        st[name] = st[name] + np.abs(n3(1e-6))
    for name in ("q2b", "q2lb"):
        st[name] = st[name] + n3(1e-6)
    for name, scale in (("wusurf", 1e-4), ("wvsurf", 1e-4), ("wtsurf", 1e-5),
                        ("wssurf", 1e-6), ("vflux", 1e-6), ("e_atmos", 1e-3)):
        fc[name] = fc[name] + n2(scale)
    f = dict(st)
    f.update(dt=gd["h"] + st["et"], d=gd["h"] + st["el"],
             utf=st["utb"] + n2(1.0), vtf=st["vtb"] + n2(1.0),
             etf=st["et"] + n2(1e-3), egf=st["egb"] + n2(1e-3),
             vflux=fc["vflux"], advx=n3(1e-3), advy=n3(1e-3),
             drhox=n3(1e-3), drhoy=n3(1e-3), wubot=n2(1e-5), wvbot=n2(1e-5),
             rmean=np.array(m.rmean), tclim=np.array(m.tclim),
             sclim=np.array(m.sclim))
    pcfg = Config(**{n: getattr(m.cfg, n)
                     for n in Config.__dataclass_fields__})
    pgrid, pst, pfc, rmean, tclim, sclim = from_numpy(
        pcfg, gd, st, fc, f["rmean"], f["tclim"], f["sclim"], device="cpu")
    blocks = Blocks(Mesh(*PH_MESH, device="cpu"), pcfg, pgrid, pst, pfc,
                    rmean, tclim, sclim)
    jfc = m.forcing_at(3).replace(**{k: jnp.asarray(v)
                                     for k, v in fc.items()})
    return dict(f=f, jgrid=m.grid, jcfg=m.cfg, jfc=jfc, pcfg=pcfg,
                blocks=blocks)


@pytest.mark.parametrize("phase", list(ARGS))
def test_block_phase_matches_jax_single_device(phase_case, phase):
    """Every block of a 3x3 mesh (corners, edges, the interior), ring 8."""
    f, B, cfg = phase_case["f"], phase_case["blocks"], phase_case["pcfg"]
    jfc = phase_case["jfc"]

    def jx_arg(a):
        if a == "FC":
            return jfc
        return jfc.ramp if a == "RAMP" else jnp.asarray(f[a])

    want = jax.jit(lambda *v: getattr(jx_stepper, f"phase_{phase}")(
        phase_case["jgrid"], phase_case["jcfg"], *v))(
        *[jx_arg(a) for a in JX_ARGS[phase]])
    h = B.ring(8)
    for b in B.ids:
        fcb = B.fc_ext(b, h)
        args = []
        for a in ARGS[phase]:
            if a == "FC":
                args.append(fcb)
            elif a == "RAMP":
                args.append(fcb.ramp)
            else:
                x = torch.from_numpy(np.array(f[a]))
                args.append(B.ext({q: _split(x, q, B.ni, B.nj)
                                   for q in B.ids}, b, h))
        got = getattr(phases, f"phase_{phase}")(
            B.grid_ext(b, h), cfg, *args, off=B.goff(b, h))
        got = [B.trim(x, h) for x in got]
        _close(got, [_split(torch.from_numpy(np.array(w)), b, B.ni, B.nj)
                     for w in want], f"{phase} block {b}")
