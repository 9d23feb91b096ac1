"""The port's CUDA kernels on the card against their plain PyTorch
versions, and the kernel path against the CPU path.  They need an NVIDIA
card and skip without one; on a machine with one, run

    python -m pytest tests/test_torch_cuda.py -q -n 0 -m cuda
"""

import itertools

import numpy as np
import pytest
import torch

from extpom_tpu_torch import kernels
from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.core import dispatch, stepper
from extpom_tpu_torch.forcing import provider as prov
from extpom_tpu_torch.kernels import extloop, extwin, phases, tridiag
from extpom_tpu_torch.mesh.shardmap import Mesh
from extpom_tpu_torch.ops.stencil import domain_of

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# the options the external, tke and tracer kernels compile in
OPTIONS = [dict(bc_scheme="orlanski"), dict(mode=2),
           dict(mode=2, bc_scheme="orlanski")]
OPTION_IDS = ["orlanski", "mode2", "mode2-orlanski"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, tol, floor=0.0):
    """max |got - want| <= tol * max(floor, max |want|): with no floor a
    kernel output is held to its own scale, so a field of small values
    (w, wubot, the velocities of a cold start) is checked as closely as a
    large one."""
    scale = max(floor, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol * scale or err == 0.0, (err, tol * scale)


@pytest.mark.parametrize("form", ["full", "scalar", "row"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("k0,k_last", [(1, 7), (1, 8), (2, 8)])
def test_tridiag_kernel_matches_plain(card, dtype, k0, k_last, form):
    """The kernel gives thomas_plain's bits, with 2-D operands as (im, jm)
    arrays, as 0-d scalars (ee0, db, mask) and broadcast along a row or a
    column (gg0 a row, rb a column, cl a level of a), which it reads by
    stride; at kb 9 and at config5's 41 on a ragged grid."""
    rng = np.random.default_rng(5)
    for kb, im, jm in ((9, 13, 17), (41, 37, 70)):
        r3 = lambda s, o: o + s * rng.random((kb, im, jm))
        r2 = lambda s, o: o + s * rng.random((im, jm))
        ops = [-r3(0.5, 0.1), -r3(0.5, 0.1), r3(0.2, 1.0), r3(2.0, -1.0),
               r2(0.5, 0.0), r2(1.0, 0.0), r2(0.3, -0.4), r2(1.0, 0.0),
               r2(0.5, -1.5), (rng.random((im, jm)) > 0.3).astype(float)]
        ops = [torch.tensor(x, dtype=dtype, device=card) for x in ops]
        kl = k_last + kb - 9
        if form == "scalar":
            for i, x in ((4, 0.25), (8, -1.2), (9, 1.0)):
                ops[i] = torch.tensor(x, dtype=dtype, device=card)
        if form == "row":
            ops[5], ops[7], ops[6] = ops[5][0], ops[7][:, :1], ops[0][kl]
        before = kernels.LAUNCHES["tridiag"]
        got = tridiag.thomas(*ops, k0, kl)
        assert kernels.LAUNCHES["tridiag"] == before + 1
        ops = [x if i < 4 else torch.broadcast_to(x, (im, jm))
               for i, x in enumerate(ops)]
        assert torch.equal(got, tridiag.thomas_plain(*ops, k0, kl)), kb


# the persistent kernel's grid-stride loop: a few cells per thread (32x48),
# a ragged grid with an odd substep count (37x53, isplit 5: the first pass
# moves the carry's levels to the second pair of slots), and more cells
# than the grid has threads (520x392)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ispadv", [1, 2])
@pytest.mark.parametrize("shape", [(32, 48, 6), (37, 53, 5), (520, 392, 6)],
                         ids=["32x48", "37x53", "520x392"])
def test_extloop_kernel_matches_plain(card, shape, ispadv, dtype):
    im, jm, isplit = shape
    m = seamount_model(device=card, im=im, jm=jm, kb=7, dtype="float64",
                       isplit=isplit)
    m.run_segment(1)
    g, cfg, st = m.grid, m.cfg, m.state
    fc = m.base_forcing
    aam, advx, advy, drhox, drhoy = phases.phase_lat(
        g, cfg, st.u, st.v, st.ub, st.vb, st.aam, st.rho, m.rmean,
        g.h + st.et, g.h + st.el, fc.ramp)
    out = stepper.mode_interaction(g, cfg, st, aam, advx, advy, drhox,
                                   drhoy)
    c0 = stepper.ExtCarry(st.el, st.elb, st.ua, st.uab, st.va, st.vab,
                          st.etf, out[9], out[10], out[11], out[5], out[6],
                          out[7], out[8])
    cast = lambda x: x.to(dtype).contiguous()
    g = g.__class__(**{k: cast(v) for k, v in vars(g).items()})
    fc = fc.__class__(**{k: cast(v) for k, v in vars(fc).items()})
    c0 = stepper.ExtCarry(*(cast(x) for x in c0))
    aux = tuple(cast(x) for x in out[:5])
    cfg = cfg.replace(dtype=str(dtype).split(".")[1], ispadv=ispadv)
    threads, blocks = extloop.plan_grid(dtype, im * jm)
    if shape[0] == 520:
        assert im * jm > threads * blocks
    before = kernels.LAUNCHES["extloop"]
    got = extloop.run_external_loop(g, cfg, c0, fc, aux)
    assert kernels.LAUNCHES["extloop"] == before + 1
    want = extloop.run_external_loop_plain(g, cfg, c0, fc, aux)
    for name, a, b in zip(extloop.CARRY_FIELDS, got, want):
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b), name


def test_extloop_refused_launch_raises(card, monkeypatch):
    """A cooperative launch of more blocks than the card holds at once is
    refused, and the wrapper raises: no other path computes the loop."""
    g, cfg, c0, fc, aux = _ext_operands(card, 37, 53, torch.float32)
    monkeypatch.setattr(extloop, "persistent_grid", lambda *a: 100_000)
    before = (extloop.device_launches(), kernels.LAUNCHES["extloop"])
    with pytest.raises(RuntimeError):
        extloop.run_external_loop(g, cfg, c0, fc, aux)
    assert (extloop.device_launches(),
            kernels.LAUNCHES["extloop"]) == before
    monkeypatch.undo()
    extloop.run_external_loop(g, cfg, c0, fc, aux)   # the next one runs
    assert extloop.device_launches() == before[0] + 1


def test_extloop_one_device_launch(card):
    """One call of either wrapper is one kernel launch of the library (the
    library counts them; the profiler records no device events on some
    machines)."""
    g, cfg, c0, fc, aux = _ext_operands(card, 37, 53, torch.float32)
    before = extloop.device_launches()
    extloop.run_external_loop(g, cfg, c0, fc, aux)
    assert extloop.device_launches() == before + 1
    rec = _mesh_calls()
    (g, cfg, c, fc, aux, C, iext0, off), _ = rec["calls"]["chunk"][0]
    g, c, fc = (_to_any(x, card, torch.float32) for x in (g, c, fc))
    aux = tuple(_to(x, card, torch.float32) for x in aux)
    cfg = cfg.replace(dtype="float32")
    before = extloop.device_launches()
    extloop.run_external_chunk(g, cfg, c, fc, aux, C, iext0, off)
    assert extloop.device_launches() == before + 1


def _ext_operands(card, im, jm, dtype, steps=1):
    """External-loop operands at step ``steps`` + 1 of a float64 seamount
    run on the card, cast to ``dtype``: (grid, cfg, carry, forcing, aux).
    The lateral viscosity (aam2d) is 0 before the third step."""
    m = seamount_model(device=card, im=im, jm=jm, kb=5, dtype="float64")
    m.run_segment(steps)
    g, cfg, st = m.grid, m.cfg, m.state
    fc = m.base_forcing.replace(ramp=torch.tensor(0.7, dtype=torch.float64,
                                                  device=card))
    rng = np.random.default_rng(11)
    n2 = lambda s: torch.from_numpy(s * rng.standard_normal((im, jm))).to(card)
    aam, advx, advy, drhox, drhoy = phases.phase_lat(
        g, cfg, st.u, st.v, st.ub, st.vb, st.aam, st.rho, m.rmean,
        g.h + st.et, g.h + st.el, fc.ramp)
    out = stepper.mode_interaction(g, cfg, st, aam, advx, advy, drhox,
                                   drhoy)
    c0 = stepper.ExtCarry(st.el + n2(1e-2), st.elb, st.ua + n2(5e-2), st.uab,
                          st.va + n2(5e-2), st.vab, st.etf, out[9], out[10],
                          out[11], out[5], out[6], out[7], out[8])
    cast = lambda x: x.to(dtype).contiguous()
    g = g.__class__(**{k: cast(v) for k, v in vars(g).items()})
    fc = fc.__class__(**{k: cast(v) for k, v in vars(fc).items()})
    return (g, cfg.replace(dtype=str(dtype).split(".")[1]),
            stepper.ExtCarry(*(cast(x) for x in c0)), fc,
            tuple(cast(x) for x in out[:5]))


@pytest.mark.parametrize("ispadv", [1, 2])
@pytest.mark.parametrize("shape", [(37, 53), (70, 45)])
def test_extwin_kernel_matches_plain(card, shape, ispadv):
    g, cfg, c0, fc, aux = _ext_operands(card, *shape, torch.float64)
    cfg = cfg.replace(ispadv=ispadv)
    n_chunks = cfg.isplit // extwin.chunk_geometry(cfg, 8).C
    before = kernels.LAUNCHES["extwin"]
    got = extwin.run_external_loop_windowed(g, cfg, c0, fc, aux)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["extwin"] == before + n_chunks
    want = extwin.run_external_loop_windowed_plain(g, cfg, c0, fc, aux)
    assert kernels.LAUNCHES["extwin"] == before + n_chunks
    for name, a, b in zip(extloop.CARRY_FIELDS, got, want):
        assert bool(torch.isfinite(a).all()), name
        _close(a, b, 1e-10)
    # the chain and the window share their per-point arithmetic
    for a, b in zip(got, extloop.run_external_loop(g, cfg, c0, fc, aux)):
        assert torch.equal(a, b)


# at the default 8x32 tiles: a ragged last row and column (520x392); a few
# tiles (40x56); two by two tiles, every one touching the domain's edges
# (14x60)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(520, 392), (40, 56), (14, 60)])
def test_extwin_kernel_bit_equal(card, shape, dtype):
    """The window kernel at its default geometry gives the chain's and the
    plain loop's bits, at the third step, where advave's viscous terms are
    not 0."""
    g, cfg, c0, fc, aux = _ext_operands(card, *shape, dtype, steps=2)
    assert bool((aux[4] != 0).any())
    got = extwin.run_external_loop_windowed(g, cfg, c0, fc, aux)
    chain = extloop.run_external_loop(g, cfg, c0, fc, aux)
    plain = extwin.run_external_loop_windowed_plain(g, cfg, c0, fc, aux)
    for name, a, b, p in zip(extloop.CARRY_FIELDS, got, chain, plain):
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b), name
        assert torch.equal(a, p), name


def test_extwin_kernel_raises(card):
    """The options compute (the window kernel held to the plain loop), and
    operands on two devices raise."""
    g, cfg, c0, fc, aux = _ext_operands(card, 37, 53, torch.float64)
    for kw in OPTIONS:
        got = extwin.run_external_loop_windowed(g, cfg.replace(**kw), c0, fc,
                                                aux)
        want = extwin.run_external_loop_windowed_plain(g, cfg.replace(**kw),
                                                       c0, fc, aux)
        for a, b in zip(got, want):
            assert torch.equal(a, b), kw
    with pytest.raises(TypeError):        # a CPU operand among CUDA ones
        extwin.run_external_loop_windowed(
            g, cfg, c0._replace(uab=c0.uab.cpu()), fc, aux)
    with pytest.raises(TypeError):        # CUDA operands among CPU ones
        cpu = lambda x: x.cpu()
        extwin.run_external_loop_windowed(
            g.__class__(**{k: cpu(v) for k, v in vars(g).items()}), cfg,
            stepper.ExtCarry(*(cpu(x) for x in c0)),
            fc.__class__(**{k: cpu(v) for k, v in vars(fc).items()}),
            aux)


def test_window_path_matches_cpu_path(card, monkeypatch):
    """The model with its external loop forced onto the window kernel on
    the card against the CPU path, over 3 steps (float64, 40x56x7)."""
    monkeypatch.setattr(extwin, "use_windowed", lambda *a: True)
    kw = dict(im=40, jm=56, kb=7, dtype="float64")
    gpu = seamount_model(device=card, **kw)
    cpu = seamount_model(device="cpu", **kw)
    chunks = gpu.cfg.isplit // extwin.chunk_geometry(gpu.cfg, 8).C
    before = kernels.LAUNCHES["extwin"]
    gpu.run_segment(3)
    cpu.run_segment(3)
    assert kernels.LAUNCHES["extwin"] == before + 3 * chunks
    for name in cpu.state.field_names():
        _close(getattr(gpu.state, name).cpu(), getattr(cpu.state, name),
               1e-10, floor=1.0)


def test_card_path_matches_cpu_path(card):
    kw = dict(im=17, jm=23, kb=7, dtype="float64")
    gpu = seamount_model(device=card, **kw)
    cpu = seamount_model(device="cpu", **kw)
    gpu.run_segment(3)
    cpu.run_segment(3)
    for name in cpu.state.field_names():
        # whole-model comparisons take the floor of 1 of test_golden.py
        _close(getattr(gpu.state, name).cpu(), getattr(cpu.state, name),
               1e-10, floor=1.0)


@pytest.mark.parametrize("kw", OPTIONS, ids=OPTION_IDS)
def test_orlanski_card_path_matches_cpu_path(card, kw):
    """The seamount under the options on the card (kernels) against the
    CPU (plain), over 3 steps, float64."""
    m = dict(im=24, jm=40, kb=7, dtype="float64", **kw)
    gpu = seamount_model(device=card, **m)
    cpu = seamount_model(device="cpu", **m)
    gpu.run_segment(3)
    cpu.run_segment(3)
    for name in cpu.state.field_names():
        _close(getattr(gpu.state, name).cpu(), getattr(cpu.state, name),
               1e-10, floor=1.0)


@pytest.mark.parametrize("window", [False, True], ids=["loop", "window"])
def test_basin_card_path_matches_cpu_path(card, window, monkeypatch):
    """The basin (mode 2, orlanski, a land ring) on the card, through the
    whole-grid loop or the window kernel, against the CPU over 20 steps."""
    from extpom_tpu_torch.cases.basin import basin_model
    monkeypatch.setattr(extwin, "use_windowed", lambda *a: window)
    m = dict(im=41, jm=33, kb=4, dtype="float64")
    gpu = basin_model(device=card, **m)
    cpu = basin_model(device="cpu", **m)
    gpu.run_segment(20)
    cpu.run_segment(20)
    for name in ("el", "ua", "va", "uab", "vab", "wubot", "wvbot", "advua"):
        _close(getattr(gpu.state, name).cpu(), getattr(cpu.state, name),
               1e-10, floor=1.0)


# shapes with a one-row (41) and a one-column (65) last tile of the window
# kernel, whose Orlanski edges read cells one and two in
@pytest.mark.parametrize("kw", OPTIONS, ids=OPTION_IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(40, 56), (41, 41), (33, 65), (14, 60)])
def test_external_kernels_options_bit_equal(card, shape, dtype, kw):
    """Under the options, the whole-grid loop and the window kernel give
    the plain loop's bits."""
    g, cfg, c0, fc, aux = _ext_operands(card, *shape, dtype, steps=2)
    cfg = cfg.replace(**kw)
    chain = extloop.run_external_loop(g, cfg, c0, fc, aux)
    win = extwin.run_external_loop_windowed(g, cfg, c0, fc, aux)
    plain = extwin.run_external_loop_windowed_plain(g, cfg, c0, fc, aux)
    for name, a, b, p in zip(extloop.CARRY_FIELDS, chain, win, plain):
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, p), name
        assert torch.equal(b, p), name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(24, 24, 7), (33, 65, 9), (17, 33, 4)],
                         ids=["square", "ragged", "kb4"])
@pytest.mark.parametrize("phase", ["tke", "tracer"])
def test_phase_kernel_orlanski_matches_plain(card, phase, shape, dtype):
    """orl_turb and orl_ts in the tke and tracer kernels (tracer: the tile
    launch, then the perimeter launch) against the plain phases."""
    g, cfg, args = _phase_case(*shape)
    g = _to(g, card, dtype)
    cfg = cfg.replace(dtype=str(dtype).split(".")[1], bc_scheme="orlanski")
    args = [_to(x, card, dtype) for x in args[phase]]
    kw = {}
    if phase == "tracer":
        kw["ub"] = args[6] - 0.02     # the old u, with inflow and outflow
    name = f"phase_{phase}"
    before = kernels.LAUNCHES[name]
    got = getattr(phases, name)(g, cfg, *args, **kw)
    assert kernels.LAUNCHES[name] == before + 1
    want = getattr(phases, name + "_plain")(g, cfg, *args, **kw)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        _close(a, b, PHASE_TOL[dtype])


PHASE_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
# phase kernels held to their plain versions bit for bit: their math is
# +, -, *, / and sqrt, each correctly rounded on the card
BIT_EQUAL = ("lat", "uvw", "mom")
_PHASE_CASES = {}


def _phase_case(im, jm, kb):
    """Operands of each phase at the third step of a float64 seamount run
    on the CPU, with seeded perturbations so both branches of the open
    boundaries occur: (grid, cfg, {phase: argument tuple})."""
    if (im, jm, kb) not in _PHASE_CASES:
        m = seamount_model(device="cpu", im=im, jm=jm, kb=kb,
                           dtype="float64", isplit=6)
        m.run_segment(2)
        g, cfg, st = m.grid, m.cfg, m.state
        fc = m.base_forcing.replace(ramp=torch.tensor(0.7,
                                                      dtype=torch.float64))
        rng = np.random.default_rng(3)
        n3 = lambda s: torch.from_numpy(s * rng.standard_normal((kb, im, jm)))
        n2 = lambda s: torch.from_numpy(s * rng.standard_normal((im, jm)))
        u, ub, v, vb = (x + n3(0.05) for x in (st.u, st.ub, st.v, st.vb))
        w = st.w + n3(1e-5)
        dt = g.h + st.et
        etf = st.et + n2(1e-3)
        lat = (u, v, ub, vb, st.aam, st.rho, m.rmean, dt, g.h + st.el,
               fc.ramp)
        aam, advx, advy, drhox, drhoy = phases.phase_lat_plain(g, cfg, *lat)
        _PHASE_CASES[(im, jm, kb)] = (g, cfg, {
            "lat": lat,
            "uvw": (u, v, w, dt, st.utb, st.vtb, st.utb + n2(1.0),
                    st.vtb + n2(1.0), st.etb, etf, st.vfluxb, fc.vflux),
            "tracer": (st.t + n3(0.1), st.tb, st.s + n3(0.01), st.sb,
                       m.tclim, m.sclim, u, v, w, aam,
                       st.kh + n3(1e-4).abs(), dt, st.etb, etf, fc),
            "mom": (u, ub, v, vb, w, advx, advy, drhox, drhoy,
                    st.km + n3(1e-4).abs(), dt, st.egb + n2(1e-3), st.egb,
                    st.etb, etf, g.h + st.el + n2(1e-3), fc),
            "tke": (st.q2 + n3(1e-6).abs(), st.q2b + n3(1e-6),
                    st.q2l + n3(1e-6).abs(), st.q2lb + n3(1e-6), u, v, w,
                    aam, st.t, st.s, st.rho, st.km, st.kh,
                    st.kq + n3(1e-4).abs(), dt, st.etb, etf, n2(1e-5),
                    n2(1e-5), fc),
        })
    return _PHASE_CASES[(im, jm, kb)]


def _to(x, card, dtype):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device=card, dtype=dtype).contiguous()
    return x.__class__(**{k: _to(v, card, dtype) for k, v in vars(x).items()})


# square, non-square; a one-row last tile and a one-column last tile of the
# tke/tracer kernels (im = 1 mod TI, jm = 1 mod TJ: profq's edge push
# crosses into them); the smallest solve; config5's depth
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(24, 24, 7), (40, 56, 9), (33, 65, 9),
                                   (17, 33, 4), (24, 40, 41)],
                         ids=["square", "nonsquare", "ragged", "kb4", "kb41"])
@pytest.mark.parametrize("phase", ["lat", "uvw", "tke", "tracer", "mom"])
def test_phase_kernel_matches_plain(card, phase, shape, dtype):
    g, cfg, args = _phase_case(*shape)
    g = _to(g, card, dtype)
    cfg = cfg.replace(dtype=str(dtype).split(".")[1])
    args = [_to(x, card, dtype) for x in args[phase]]
    name = f"phase_{phase}"
    before = kernels.LAUNCHES[name]
    got = getattr(phases, name)(g, cfg, *args)
    assert kernels.LAUNCHES[name] == before + 1
    launched = dict(kernels.LAUNCHES)
    want = getattr(phases, name + "_plain")(g, cfg, *args)
    assert kernels.LAUNCHES == launched     # the plain phase launches none
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        _close(a, b, PHASE_TOL[dtype])
        if phase in BIT_EQUAL:
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nbc", [(2, 3), (4, 4)], ids=["nbc2-3", "nbc4"])
def test_tracer_kernel_surface_conditions(card, nbc, dtype):
    """proft's shortwave (exp) and prescribed-value surface conditions in
    the tracer kernel, on a ragged grid with shortwave radiation."""
    g, cfg, args = _phase_case(33, 65, 9)
    rng = np.random.default_rng(23)
    fc = args["tracer"][-1]
    fc = fc.replace(swrad=fc.swrad + torch.from_numpy(
        1e-5 * rng.standard_normal(tuple(fc.swrad.shape))))
    g = _to(g, card, dtype)
    cfg = cfg.replace(dtype=str(dtype).split(".")[1], nbct=nbc[0],
                      nbcs=nbc[1])
    args = [_to(x, card, dtype) for x in args["tracer"][:-1] + (fc,)]
    got = phases.phase_tracer(g, cfg, *args)
    want = phases.phase_tracer_plain(g, cfg, *args)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        _close(a, b, PHASE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(33, 65, 9), (24, 40, 41), (17, 33, 4)],
                         ids=["ragged", "kb41", "kb4"])
@pytest.mark.parametrize("phase", ["lat", "uvw", "tke", "tracer", "mom"])
def test_column_tiles_agree(card, phase, shape, dtype):
    """Every tile of the sweep (tools/phase_sweep.py TILES) that fits gives
    the default tile's bits, and uvw's and mom's with and without their
    levels kept in shared memory, on a ragged grid and at kb 41 and 4; the
    card gives the planned tile the shared memory the planner counted, and
    in f32 at least 16 warps per SM."""
    from extpom_tpu_torch.tools.phase_sweep import TILES
    g, cfg, args = _phase_case(*shape)
    g = _to(g, card, dtype)
    cfg = cfg.replace(dtype=str(dtype).split(".")[1])
    args = [_to(x, card, dtype) for x in args[phase]]
    fn = getattr(phases, f"phase_{phase}")
    want = fn(g, cfg, *args)
    for ti, tj in TILES:
        for keep in ((False, True) if phase in ("uvw", "mom")
                     else (None,)):
            try:
                tile = phases.column_tile(cfg.kb, dtype, phase, ti, tj, keep)
            except ValueError:
                continue
            if phases.tile_info(phase, dtype, tile)["blocks_per_sm"] < 1:
                continue
            for a, b in zip(fn(g, cfg, *args, tile=tile), want):
                assert torch.equal(a, b), (ti, tj, keep)
    tile = phases.column_tile(cfg.kb, dtype, phase)
    info = phases.tile_info(phase, dtype, tile)
    assert info["dynamic_smem"] == tile.smem
    assert info["blocks_per_sm"] >= 1
    if dtype == torch.float32:
        assert info["blocks_per_sm"] * tile.ti * tile.tj >= 16 * 32


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(96, 80, 41), (40, 72, 31)],
                         ids=["kb41", "kb31"])
def test_uvw_tiles_bit_equal(card, shape, dtype):
    """uvw's every tile of the sweep, with and without its levels kept, is
    the plain phase bit for bit at config5's depth on a ragged 96x80 grid
    and at the main path's kb 31, one device launch each."""
    from extpom_tpu_torch.tools.phase_sweep import TILES
    g, cfg, args = _phase_case(*shape)
    g = _to(g, card, dtype)
    cfg = cfg.replace(dtype=str(dtype).split(".")[1])
    args = [_to(x, card, dtype) for x in args["uvw"]]
    want = phases.phase_uvw_plain(g, cfg, *args)
    ran = 0
    for (ti, tj), keep in itertools.product(TILES, (False, True)):
        try:
            tile = phases.column_tile(cfg.kb, dtype, "uvw", ti, tj, keep)
        except ValueError:
            continue
        if phases.tile_info("uvw", dtype, tile)["blocks_per_sm"] < 1:
            continue
        before = phases.uvw_device_launches()
        got = phases.phase_uvw(g, cfg, *args, tile=tile)
        assert phases.uvw_device_launches() == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), (ti, tj, keep)
        ran += 1
    assert ran >= len(TILES)


def test_uvw_one_device_launch(card):
    """One call of phase_uvw, on the grid or on a block, is one kernel
    launch of the library (the library counts them)."""
    g, cfg, args = _phase_case(33, 65, 9)
    g = _to(g, card, torch.float32)
    cfg = cfg.replace(dtype="float32")
    args = [_to(x, card, torch.float32) for x in args["uvw"]]
    before = phases.uvw_device_launches()
    phases.phase_uvw(g, cfg, *args)
    assert phases.uvw_device_launches() == before + 1
    rec = _mesh_calls()
    (g, cfg, *args), kw = rec["calls"]["uvw"][0]
    g = _to(g, card, torch.float32)
    cfg = cfg.replace(dtype="float32")
    args = [_to(x, card, torch.float32) for x in args]
    before = phases.uvw_device_launches()
    phases.phase_uvw(g, cfg, *args, **kw)
    assert phases.uvw_device_launches() == before + 1


# ---- the decomposed step's block kernels (extchunk, extwin_chunk and
# phase_<p>_mesh) ----

MESH_KW = dict(im=32, jm=48, kb=6, isplit=6, dtype="float64")
_MESH_CALLS = {}


def _mesh_calls():
    """Every call of a block-kernel wrapper in the third step of a float64
    seamount run decomposed 2x4 on the CPU (blocks 16x12, rings of 8 for
    the phases and 9 for chunks of 3 substeps): {"blocks": the Blocks,
    "calls": {"lat", ..., "chunk": [(args, kwargs)]}}."""
    if not _MESH_CALLS:
        calls = {}

        def spy(name, fn):
            def wrapper(*a, **k):
                calls.setdefault(name, []).append((a, k))
                return fn(*a, **k)
            return wrapper

        m = seamount_model(device="cpu", **MESH_KW).shard(
            Mesh(2, 4, device="cpu"))
        m.run_segment(2)
        with pytest.MonkeyPatch.context() as mp:
            for p in dispatch.PHASES:
                mp.setattr(phases, f"phase_{p}",
                           spy(p, getattr(phases, f"phase_{p}")))
            mp.setattr(extloop, "run_external_chunk",
                       spy("chunk", extloop.run_external_chunk))
            m.run_segment(1)
        _MESH_CALLS.update(blocks=m.blocks, calls=calls)
    return _MESH_CALLS


def _trim(blocks, x):
    """The block's own cells of an extended (.., R, L) tensor."""
    h = ((x.shape[-2] - blocks.ni) // 2, (x.shape[-1] - blocks.nj) // 2)
    return blocks.trim(x, h)


def _to_any(x, card, dtype):
    if isinstance(x, tuple):
        return type(x)(*(_to_any(y, card, dtype) for y in x))
    return _to(x, card, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("phase", ["lat", "uvw", "tke", "tracer", "mom"])
def test_phase_mesh_kernel_matches_plain(card, phase, dtype):
    """Each block's phase on the card (phase_<p>_mesh) against the plain
    phase on the same block, on the block's own cells: every block of the
    2x4 mesh, its four corners among them."""
    rec = _mesh_calls()
    name = f"phase_{phase}_mesh"
    for (g, cfg, *args), kw in rec["calls"][phase]:
        g = _to(g, card, dtype)
        cfg = cfg.replace(dtype=str(dtype).split(".")[1])
        args = [_to(x, card, dtype) for x in args]
        before = dict(kernels.LAUNCHES)
        got = getattr(phases, f"phase_{phase}")(g, cfg, *args, **kw)
        assert kernels.LAUNCHES == {**before, name: before[name] + 1}
        want = phases._plain(phase, g, cfg, args, kw["off"])
        for a, b in zip(got, want):
            a, b = _trim(rec["blocks"], a), _trim(rec["blocks"], b)
            assert bool(torch.isfinite(a).all())
            _close(a, b, PHASE_TOL[dtype])
            if phase in BIT_EQUAL:
                assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ispadv", [1, 2])
@pytest.mark.parametrize("kernel", ["extchunk", "extwin_chunk"])
def test_chunk_kernel_matches_plain(card, kernel, ispadv, dtype):
    """Each block's first and last chunk of external substeps on the card
    against the plain chunk, on the block's own cells; the window kernel
    with 8x16 tiles, so that a block takes several."""
    rec = _mesh_calls()
    calls = rec["calls"]["chunk"]
    for (g, cfg, c, fc, aux, C, iext0, off), _ in calls[:8] + calls[-8:]:
        g, c, fc = (_to_any(x, card, dtype) for x in (g, c, fc))
        aux = tuple(_to(x, card, dtype) for x in aux)
        cfg = cfg.replace(dtype=str(dtype).split(".")[1], ispadv=ispadv)
        before = kernels.LAUNCHES[kernel]
        if kernel == "extchunk":
            got = extloop.run_external_chunk(g, cfg, c, fc, aux, C, iext0,
                                             off)
        else:
            geo = extwin.win_geometry(C, c.el.element_size())
            got = extwin.run_external_chunk_windowed(
                g, cfg, c, fc, aux, C, iext0, off,
                geo=geo._replace(ti=8, tj=16))
        assert kernels.LAUNCHES[kernel] == before + 1
        want = extloop.run_external_chunk_plain(g, cfg, c, fc, aux, C, iext0,
                                                off)
        for a, b in zip(got, want):
            a, b = _trim(rec["blocks"], a), _trim(rec["blocks"], b)
            assert bool(torch.isfinite(a).all())
            _close(a, b, PHASE_TOL[dtype])
            if kernel == "extchunk":
                assert torch.equal(a, b)


@pytest.mark.parametrize("window", [False, True], ids=["chain", "window"])
def test_mesh_card_path_matches_cpu_path(card, monkeypatch, window):
    """The decomposed step on the card (2x4, every block kernel) against
    the CPU's over 3 steps in float64, with the launches it should make."""
    monkeypatch.setattr(extwin, "use_win_chunk", lambda *a: window)
    gpu = seamount_model(device=card, **MESH_KW).shard(Mesh(2, 4,
                                                            device=card))
    cpu = seamount_model(device="cpu", **MESH_KW).shard(Mesh(2, 4,
                                                             device="cpu"))
    kernels.reset_launches()
    gpu.run_segment(3)
    cpu.run_segment(3)
    n_chunks = 3 * (MESH_KW["isplit"] // 3) * 8    # C = 3, 8 blocks
    assert kernels.LAUNCHES == {
        **{k: 0 for k in kernels.LAUNCHES},
        "extwin_chunk" if window else "extchunk": n_chunks,
        "phase_lat_mesh": 3 * 8,
        **{f"phase_{p}_mesh": 2 * 8 for p in ("uvw", "tke", "tracer",
                                              "mom")}}
    want, got = cpu.gathered_state(), gpu.gathered_state()
    for name in want.field_names():
        _close(getattr(got, name).cpu(), getattr(want, name), 1e-10,
               floor=1.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("tile", [(4, 4, 32), (8, 16, 64)])
def test_chunk_window_bit_equal(card, tile, dtype):
    """extwin_chunk gives extchunk's bits on every block's own cells of a
    2x4 mesh, with tiles smaller than a block's ring and larger."""
    rec = _mesh_calls()
    blocks = rec["blocks"]
    for (g, cfg, c, fc, aux, C, iext0, off), _ in rec["calls"]["chunk"][:8]:
        g, c, fc = (_to_any(x, card, dtype) for x in (g, c, fc))
        aux = tuple(_to(x, card, dtype) for x in aux)
        cfg = cfg.replace(dtype=str(dtype).split(".")[1])
        geo = extwin.geometry(extwin.win_geometry(C, 8).C, *tile,
                              c.el.element_size())
        got = extwin.run_external_chunk_windowed(g, cfg, c, fc, aux, C,
                                                 iext0, off, geo=geo)
        want = extloop.run_external_chunk(g, cfg, c, fc, aux, C, iext0, off)
        for a, b in zip(got, want):
            assert torch.equal(_trim(blocks, a), _trim(blocks, b))


@pytest.mark.parametrize("kw", OPTIONS, ids=OPTION_IDS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chunk_kernels_options_match_plain(card, dtype, kw):
    """extchunk and extwin_chunk (8x16 tiles, several per block) under the
    options against the plain chunk, bit for bit on each block's own
    cells: the first and last chunks of every block of the 2x4 mesh."""
    rec = _mesh_calls()
    calls = rec["calls"]["chunk"]
    for (g, cfg, c, fc, aux, C, iext0, off), _ in calls[:8] + calls[-8:]:
        g, c, fc = (_to_any(x, card, dtype) for x in (g, c, fc))
        aux = tuple(_to(x, card, dtype) for x in aux)
        cfg = cfg.replace(dtype=str(dtype).split(".")[1], **kw)
        want = extloop.run_external_chunk_plain(g, cfg, c, fc, aux, C, iext0,
                                                off)
        geo = extwin.win_geometry(C, c.el.element_size(),
                                  extloop.ext_flags(cfg))
        for got in (extloop.run_external_chunk(g, cfg, c, fc, aux, C, iext0,
                                               off),
                    extwin.run_external_chunk_windowed(
                        g, cfg, c, fc, aux, C, iext0, off,
                        geo=geo._replace(ti=8, tj=16))):
            for a, b in zip(got, want):
                assert torch.equal(_trim(rec["blocks"], a),
                                   _trim(rec["blocks"], b))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("phase", ["tke", "tracer"])
def test_phase_mesh_kernel_orlanski_matches_plain(card, phase, dtype):
    """phase_tke_mesh and phase_tracer_mesh under orlanski against the
    plain phase on each block of the 2x4 mesh, on the block's own cells."""
    rec = _mesh_calls()
    for (g, cfg, *args), kw in rec["calls"][phase]:
        g = _to(g, card, dtype)
        cfg = cfg.replace(dtype=str(dtype).split(".")[1],
                          bc_scheme="orlanski")
        args = [_to(x, card, dtype) for x in args]
        if phase == "tracer":
            kw = dict(kw, ub=args[6] - 0.02)
        got = getattr(phases, f"phase_{phase}")(g, cfg, *args, **kw)
        want = phases._plain(phase, g, cfg, args, kw["off"],
                             **({"ub": kw["ub"]} if phase == "tracer"
                                else {}))
        for a, b in zip(got, want):
            a, b = _trim(rec["blocks"], a), _trim(rec["blocks"], b)
            assert bool(torch.isfinite(a).all())
            _close(a, b, PHASE_TOL[dtype])


# ---- the phase options: McCalpin (lat), MPDATA and restoring (tracer),
# bc_vel3d (mom) ----

# phase, options; the ragged grid has a one-row and a one-column last tile
# (im = 1 mod TI, jm = 1 mod TJ)
PHASE_OPTIONS = [("lat", dict(npg=2)), ("tracer", dict(nadv=2, nitera=1)),
                 ("tracer", dict(nadv=2, nitera=2)),
                 ("tracer", dict(nadv=2, nitera=3, do_restore=True)),
                 ("tracer", dict(do_restore=True)),
                 ("mom", dict(bc_scheme="file"))]
PHASE_OPTION_IDS = ["lat-npg2", "tracer-mpdata1", "tracer-mpdata2",
                    "tracer-mpdata3-restore", "tracer-restore", "mom-file"]


def _with_options(phase, args, kw, seed=29):
    """The phase's operands with what the options read: the depth d where
    the caller's step formed none (dt = h + et, perturbed), the restoring
    series (full fields, taurstr one value when ``tau1``), the file
    scheme's velocity profiles, positive T for MPDATA's antidiffusion."""
    rng = np.random.default_rng(seed)
    args = list(args)
    names = phases._ARGS[phase]
    if ("d" in names and args[names.index("d")] is None
            and (kw.get("npg") == 2 or kw.get("bc_scheme") == "file")):
        dt = args[names.index("dt")]
        args[names.index("d")] = dt + 1e-3 * torch.from_numpy(
            rng.standard_normal(tuple(dt.shape)))
    if phase not in ("tracer", "mom"):
        return args
    fc = args[-1]
    kb, R, L = args[0].shape
    noise = lambda *s: torch.from_numpy(rng.standard_normal(s))
    upd = {}
    if kw.get("do_restore"):
        upd.update(trstr=args[0] + 0.5 * noise(kb, R, L),
                   srstr=args[2] + 0.05 * noise(kb, R, L),
                   taurstr=(100.0 * noise(kb, R, L)).abs())
    if kw.get("bc_scheme") == "file":
        for n in ("ubw", "ube", "vbw", "vbe"):
            upd[n] = 0.05 * noise(kb, L)
        for n in ("ubs", "ubn", "vbs", "vbn"):
            upd[n] = 0.05 * noise(kb, R)
    if phase == "tracer" and kw.get("nadv") == 2:
        args[0], args[1] = args[0] + 20.0, args[1] + 20.0
    args[-1] = fc.replace(**upd)
    return args


def _hold(phase, got, want, dtype):
    """lat's and mom's outputs bit for bit; tracer's t, tb, s, sb bit for
    bit and rho (CUDA's pow) within tolerance."""
    for k, (a, b) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(a).all()), k
        _close(a, b, PHASE_TOL[dtype])
        if phase != "tracer" or k < 4:
            assert torch.equal(a, b), (phase, k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(33, 65, 9), (17, 33, 4)],
                         ids=["ragged", "kb4"])
@pytest.mark.parametrize("phase,kw", PHASE_OPTIONS, ids=PHASE_OPTION_IDS)
def test_phase_option_kernel_matches_plain(card, phase, kw, shape, dtype):
    """Each option's kernel against its plain phase, with the launches the
    wrapper counts: one launch of the option's instantiation, under its
    own name, and MPDATA's planned launches before it."""
    g, cfg, args = _phase_case(*shape)
    cfg = cfg.replace(dtype=str(dtype).split(".")[1], **kw)
    args = _with_options(phase, args[phase], kw)
    g = _to(g, card, dtype)
    args = [_to(x, card, dtype) for x in args]
    before = dict(kernels.LAUNCHES)
    got = getattr(phases, f"phase_{phase}")(g, cfg, *args)
    mp = (phases.mpdata_plan(cfg.nitera, dtype, shape[2], *shape[:2])
          .launches
          if cfg.nadv == 2 and phase == "tracer" else 0)
    name = phases.counter(phase, cfg)
    assert name != f"phase_{phase}"
    assert kernels.LAUNCHES == {
        **before, name: before[name] + 1,
        "phase_tracer_mpdata": before["phase_tracer_mpdata"] + mp}
    want = getattr(phases, f"phase_{phase}_plain")(g, cfg, *args)
    _hold(phase, got, want, dtype)


# grids no MPDATA tile divides (the kernel's tiles are 16x32 in f32, 8x32
# in f64), (im, jm, kb)
MPDATA_SHAPES = {"ragged": (33, 65, 9), "wide": (257, 131, 31)}
MPDATA_NITERA = [1, 2, 3, 4, 8]


def _mpdata_operands(args, cutoff=False):
    """MPDATA's operands (t, tb, s, sb, u, v, w, dt, etb, etf) among the
    tracer phase's, T positive; with ``cutoff`` T and S cross value_min as
    tests/test_torch_options.py:_mpdata_inputs(cutoff=True) makes them (a
    field in [0, 1) with 30 % of its points 0)."""
    t, tb, s, sb, _, _, u, v, w, _, _, dt, etb, etf, _ = _with_options(
        "tracer", args, dict(nadv=2))
    if cutoff:
        rng = np.random.default_rng(3)
        fb = torch.from_numpy(np.where(rng.random(t.shape) < 0.3, 0.0,
                                       rng.random(t.shape)))
        t, tb, s, sb = fb, fb, 2.0 * fb, 2.0 * fb
    return t, tb, s, sb, u, v, w, dt, etb, etf


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nitera", MPDATA_NITERA)
@pytest.mark.parametrize("case", ["ragged", "wide", "cutoff"])
def test_mpdata_kernels_match_plain(card, case, nitera, dtype):
    """MPDATA's upstream steps on the card give mpdata_plain's bits, T and
    S, in the plan's launches (nitera 8 crosses a group boundary in both
    dtypes): on grids no tile divides, and on fields that cross
    value_min."""
    shape = MPDATA_SHAPES.get(case, MPDATA_SHAPES["ragged"])
    g, cfg, args = _phase_case(*shape)
    cfg = cfg.replace(dtype=str(dtype).split(".")[1], nadv=2, nitera=nitera)
    ops = [_to(x, card, dtype)
           for x in _mpdata_operands(args["tracer"], case == "cutoff")]
    g = _to(g, card, dtype)
    plan = phases.mpdata_launch_plan(cfg, ops[0])
    assert sum(plan.groups) == nitera
    before = kernels.LAUNCHES["phase_tracer_mpdata"]
    got = phases.mpdata(g, cfg, *ops)
    assert (kernels.LAUNCHES["phase_tracer_mpdata"]
            == before + plan.launches)
    want = phases.mpdata_plain(g, cfg, *ops)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nitera", MPDATA_NITERA)
def test_mpdata_mesh_kernels_match_plain(card, nitera, dtype):
    """MPDATA's block variant on every ring-extended block of the 2x4 mesh
    (each at its offset) against mpdata_plain on the block, on the
    block's own cells, in the plan's launches."""
    rec = _mesh_calls()
    for (g, cfg, *args), kwb in rec["calls"]["tracer"]:
        cfg = cfg.replace(dtype=str(dtype).split(".")[1], nadv=2,
                          nitera=nitera)
        ops = [_to(x, card, dtype) for x in _mpdata_operands(args)]
        g = _to(g, card, dtype)
        off = kwb["off"]
        plan = phases.mpdata_launch_plan(cfg, ops[0], True)
        before = kernels.LAUNCHES["phase_tracer_mpdata_mesh"]
        got = phases.mpdata(g, cfg, *ops, off=off)
        assert (kernels.LAUNCHES["phase_tracer_mpdata_mesh"]
                == before + plan.launches)
        with domain_of(cfg, off):
            want = phases.mpdata_plain(g, cfg, *ops)
        for a, b in zip(got, want):
            assert torch.equal(_trim(rec["blocks"], a),
                               _trim(rec["blocks"], b))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("phase,kw", PHASE_OPTIONS + [
    ("tracer", dict(bc_scheme="orlanski", nadv=2, nitera=2,
                    do_restore=True))],
    ids=PHASE_OPTION_IDS + ["tracer-orlanski-mpdata-restore"])
def test_phase_option_mesh_kernel_matches_plain(card, phase, kw, dtype):
    """Each option's block kernel (phase_<p>_mesh, MPDATA's _mesh steps)
    against the plain phase on every block of the 2x4 mesh, on the
    block's own cells."""
    rec = _mesh_calls()
    for (g, cfg, *args), kwb in rec["calls"][phase]:
        cfg = cfg.replace(dtype=str(dtype).split(".")[1], **kw)
        args = _with_options(phase, args, kw)
        g = _to(g, card, dtype)
        args = [_to(x, card, dtype) for x in args]
        kwb = {k: _to(x, card, dtype) if isinstance(x, torch.Tensor) else x
               for k, x in kwb.items()}
        if cfg.bc_scheme == "orlanski":
            kwb = dict(kwb, ub=args[6] - 0.02)
        before = dict(kernels.LAUNCHES)
        got = getattr(phases, f"phase_{phase}")(g, cfg, *args, **kwb)
        name = f"{phases.counter(phase, cfg)}_mesh"
        mp = (phases.mpdata_plan(cfg.nitera, dtype, *args[0].shape)
              .launches if cfg.nadv == 2 and phase == "tracer" else 0)
        assert kernels.LAUNCHES == {
            **before, name: before[name] + 1,
            "phase_tracer_mpdata_mesh":
                before["phase_tracer_mpdata_mesh"] + mp}
        want = phases._plain(phase, g, cfg, args, kwb["off"],
                             **({"ub": kwb["ub"]} if "ub" in kwb else {}))
        _hold(phase, [_trim(rec["blocks"], a) for a in got],
              [_trim(rec["blocks"], b) for b in want], dtype)


OPTION_PATHS = [dict(npg=2, nadv=2, nitera=2), dict(bc_scheme="file")]


@pytest.mark.parametrize("kw", OPTION_PATHS, ids=["npg2-mpdata", "file"])
def test_option_card_path_matches_cpu_path(card, kw):
    """The seamount under the options on the card (every kernel) against
    the CPU over 4 steps in float64, with the launches it should make."""
    shape = dict(im=33, jm=41, kb=7, dtype="float64", isplit=6)
    gpu = seamount_model(device=card, **shape, **kw)
    cpu = seamount_model(device="cpu", **shape, **kw)
    kernels.reset_launches()
    gpu.run_segment(4)
    cpu.run_segment(4)
    mp = (3 * phases.mpdata_plan(gpu.cfg.nitera, torch.float64, 7, 33,
                                 41).launches if gpu.cfg.nadv == 2 else 0)
    name = lambda p: phases.counter(p, gpu.cfg)
    assert kernels.LAUNCHES == {
        **{k: 0 for k in kernels.LAUNCHES}, "extloop": 4, name("lat"): 4,
        **{name(p): 3 for p in ("uvw", "tke", "tracer", "mom")},
        "phase_tracer_mpdata": mp}
    for name in gpu.state.field_names():
        _close(getattr(gpu.state, name).cpu(), getattr(cpu.state, name),
               1e-10, floor=1.0)


def test_restore_card_path_matches_cpu_path(card):
    """The tidal channel under the file scheme with interior restoring
    from staged series (default taurstr) on the card against the CPU
    over 6 steps in float64."""
    from extpom_tpu_torch.cases.channel import channel_model
    runs = []
    for device in (card, "cpu"):
        m = channel_model(device=device, im=40, jm=18, kb=6,
                          dtype="float64", bc_scheme="file",
                          do_restore=True)
        rng = np.random.default_rng(41)
        t0 = m.state.t.cpu().numpy()
        src = m.forcing_fn.source
        data = dict(src.data, trstr=np.stack(
            [t0 + 0.5 * rng.random(t0.shape) for _ in range(2)]),
            srstr=np.stack([m.state.s.cpu().numpy()] * 2))
        m.forcing_fn = prov.ForcingProvider(
            m.grid, m.cfg, m.base_forcing, prov.ArraySource(data),
            prefetch=False)
        m.run_segment(6)
        runs.append(m.state)
    for name in runs[1].field_names():
        _close(getattr(runs[0], name).cpu(), getattr(runs[1], name),
               1e-10, floor=1.0)


@pytest.mark.parametrize("kw", [dict(npg=2), dict(nadv=2, nitera=2)],
                         ids=["npg2", "mpdata"])
def test_option_mesh_card_path_bit_equal(card, kw):
    """The 2x4 decomposed step under the options on the card gives the
    single-device card run's bits after 3 steps in float32."""
    shape = dict(MESH_KW, dtype="float32")
    one = seamount_model(device=card, **shape, **kw)
    one.run_segment(3)
    mesh = seamount_model(device=card, **shape, **kw).shard(
        Mesh(2, 4, device=card))
    mesh.run_segment(3)
    got = mesh.gathered_state()
    for name in got.field_names():
        assert torch.equal(getattr(got, name), getattr(one.state, name)), \
            name


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_diag_sums_kernel_matches_plain(card, dtype):
    """The print's sums on the card (kernels/diagsum.py) against the plain
    sums of the same state: every total within 2 ulp of theirs, taver and
    saver, ratios of two totals, within 4, eaver, whose numerator cancels,
    within 1e-15 of the sum of |et darea| over atot; the same bits on two calls, and the block form of the 2x4
    mesh's blocks within the same."""
    import math
    from extpom_tpu_torch.diag import stats
    m = seamount_model(im=32, jm=48, kb=7, dtype=dtype, device=card)
    m.run_segment(3)
    ulp = lambda a, b: 0 if a == b else abs(a - b) / math.ulp(max(abs(a),
                                                                  abs(b)))
    want = {k: float(v) for k, v in
            stats.domain_stats_plain(m.grid, m.cfg, m.state).items()}
    cells = stats.block_cells(m.grid, m.state, m.cfg,
                              stats._regions(*m.cfg.active), (0, 0),
                              tuple(m.state.et.shape))["eavg"]
    cancel = float(sum(c.abs().sum() for c in cells))
    a = stats.domain_stats(m.grid, m.cfg, m.state)
    b = stats.domain_stats(m.grid, m.cfg, m.state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    m.shard(Mesh(2, 4, device=card))
    blocks = stats.domain_stats_blocks(m.blocks, m.cfg)
    for got in ({k: float(v) for k, v in a.items()},
                {k: float(v) for k, v in blocks.items()}):
        for k in want:
            if k == "eaver":
                assert abs(got[k] - want[k]) * want["atot"] <= 1e-15 * cancel
            else:
                limit = 4 if k in ("taver", "saver") else 2
                assert ulp(got[k], want[k]) <= limit, (k, got[k], want[k])
