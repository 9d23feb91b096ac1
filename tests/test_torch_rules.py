"""Rules of the PyTorch port: it imports neither JAX, the JAX package nor
tensorstore (its Zarr store is its own), its entry points run on the card
unless the caller asks for the CPU, and what is not ported yet raises
instead of running something else."""

import ast
import pathlib

import pytest
import torch

from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.kernels import build

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "extpom_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "extpom_tpu", "tensorstore")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        seamount_model(im=9, jm=9, kb=5)


def test_config_matches_jax_fields():
    """Config keeps the JAX package's physics and numerics fields, with the
    same defaults, so both packages build from the same kwargs."""
    from extpom_tpu.core.config import Config as JxConfig
    import dataclasses
    jx = {f.name: f.default for f in dataclasses.fields(JxConfig)}
    for f in dataclasses.fields(Config):
        assert f.name in jx, f.name
        assert f.default == jx[f.name], f.name
    cfg = Config(im=9, jm=9, kb=5, dtype="float64")
    jcfg = JxConfig(im=9, jm=9, kb=5, dtype="float64")
    for prop in ("dti", "dte2", "dti2", "iend", "iprint", "iswtch",
                 "iprint2", "irestart", "ispi", "isp2i", "kbm1", "kbm2"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop


@pytest.mark.parametrize("kw", [dict(mode=2), dict(bc_scheme="orlanski"),
                                dict(npg=2), dict(nadv=2, nitera=2),
                                dict(bc_scheme="file")],
                         ids=["mode=2", "bc_scheme=orlanski", "npg=2",
                              "nadv=2", "file"])
def test_ported_options_match_jax(kw):
    """mode=2, the orlanski scheme, McCalpin's pressure gradient, MPDATA
    and the file scheme run in the port as in the JAX package: three steps
    of the 9x9x5 seamount within 1e-10 of scale."""
    import numpy as np
    from extpom_tpu.cases.seamount import seamount_model as jx_model
    jm = jx_model(donate=False, im=9, jm=9, kb=5, dtype="float64", **kw)
    for _ in range(3):
        jm.step_once()
    m = seamount_model(device="cpu", im=9, jm=9, kb=5, dtype="float64", **kw)
    m.run_segment(3)
    for name in ("el", "ua", "va", "u", "t", "q2"):
        want = np.asarray(getattr(jm.state, name))
        tol = 1e-10 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(getattr(m.state, name).numpy(), want,
                                   rtol=0, atol=tol, err_msg=name)


def test_kernels_not_built_at_import():
    """Importing the kernel modules builds nothing; the build needs nvcc,
    which only the machine with the card has."""
    import extpom_tpu_torch.core.dispatch  # noqa: F401
    import extpom_tpu_torch.kernels.extloop  # noqa: F401
    import extpom_tpu_torch.kernels.extwin  # noqa: F401
    import extpom_tpu_torch.kernels.phases  # noqa: F401
    import extpom_tpu_torch.kernels.tridiag  # noqa: F401
    import extpom_tpu_torch.tools.extwin_sweep  # noqa: F401
    assert build._lib is None


def _phase_operands(phase: str):
    """Valid CPU operands of one phase wrapper, from a small float64
    seamount state: (wrapper, grid, cfg, argument list)."""
    from extpom_tpu_torch.kernels import phases
    m = seamount_model(device="cpu", im=9, jm=11, kb=5, dtype="float64")
    g, cfg, st, fc = m.grid, m.cfg, m.state, m.base_forcing
    dt = g.h + st.et
    args = {
        "lat": (st.u, st.v, st.ub, st.vb, st.aam, st.rho, m.rmean, dt,
                g.h + st.el, fc.ramp),
        "uvw": (st.u, st.v, st.w, dt, st.utb, st.vtb, st.utb, st.vtb,
                st.etb, st.et, st.vfluxb, fc.vflux),
        "tke": (st.q2, st.q2b, st.q2l, st.q2lb, st.u, st.v, st.w, st.aam,
                st.t, st.s, st.rho, st.km, st.kh, st.kq, dt, st.etb, st.et,
                st.wubot, st.wvbot, fc),
        "tracer": (st.t, st.tb, st.s, st.sb, m.tclim, m.sclim, st.u, st.v,
                   st.w, st.aam, st.kh, dt, st.etb, st.et, fc),
        "mom": (st.u, st.ub, st.v, st.vb, st.w, st.u, st.v, st.u, st.v,
                st.km, dt, st.egb, st.egb, st.etb, st.et, g.h + st.el, fc),
    }[phase]
    return getattr(phases, f"phase_{phase}"), g, cfg, list(args)


PHASES = ("lat", "uvw", "tke", "tracer", "mom")


@pytest.mark.parametrize("phase", PHASES)
def test_phase_wrappers_reject_bad_operands(phase):
    fn, g, cfg, args = _phase_operands(phase)
    fn(g, cfg, *args)                         # the valid call runs

    bad = list(args)
    bad[1] = bad[1].to(torch.float16)         # a dtype no kernel takes
    with pytest.raises(TypeError):
        fn(g, cfg, *bad)
    bad = [a.float() if isinstance(a, torch.Tensor) else a for a in args]
    bad[0] = bad[0].double()                  # mixed dtypes
    with pytest.raises(TypeError):
        fn(g, cfg, *bad)
    bad = list(args)
    bad[1] = bad[1][:, :-1]                   # a 3-D operand of wrong shape
    with pytest.raises(ValueError):
        fn(g, cfg, *bad)
    bad = list(args)
    k2 = next(k for k, a in enumerate(args)
              if isinstance(a, torch.Tensor) and a.dim() == 2)
    bad[k2] = bad[k2][:-1]                    # a 2-D operand of wrong shape
    with pytest.raises(ValueError):
        fn(g, cfg, *bad)
    bad = list(args)
    bad[0] = bad[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        fn(g, cfg, *bad)
    # a device that is neither the CPU nor the card never reaches the plain
    # version
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    g_meta = g.__class__(**{k: v.to("meta") for k, v in vars(g).items()})
    if phase in ("tke", "tracer", "mom"):
        fc = meta[-1]
        meta[-1] = fc.__class__(**{k: v.to("meta")
                                   for k, v in vars(fc).items()})
    with pytest.raises(TypeError):
        fn(g_meta, cfg, *meta)


@pytest.mark.parametrize("mode", [3, 4])
def test_mode4_skips_the_tracer_phase(mode, monkeypatch):
    """mode=4 freezes T/S: the step never calls the tracer phase."""
    from extpom_tpu_torch.kernels import phases
    calls = []
    real = phases.phase_tracer
    monkeypatch.setattr(phases, "phase_tracer",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    m = seamount_model(device="cpu", im=9, jm=9, kb=5, dtype="float64",
                       mode=mode)
    t0 = m.state.t.clone()
    m.run_segment(2)
    assert len(calls) == (0 if mode == 4 else 1)
    assert torch.equal(m.state.t, t0) == (mode == 4)


@pytest.mark.parametrize("phase", ["tke", "tracer"])
def test_phase_orlanski_boundaries_match_jax(phase):
    """Under bc_scheme='orlanski' the phase runs orl_turb/orl_ts, as the
    JAX stepper's phase does, on a cold start's operands."""
    import numpy as np
    from extpom_tpu.cases.seamount import seamount_model as jx_model
    from extpom_tpu.core import stepper as jx_stepper
    from extpom_tpu.ops import stencil as jx_stencil
    fn, g, cfg, args = _phase_operands(phase)
    cfg = cfg.replace(bc_scheme="orlanski")
    jm = jx_model(donate=False, im=9, jm=11, kb=5, dtype="float64",
                  bc_scheme="orlanski")
    st, jfc = jm.state, jm.base_forcing
    jargs = {
        "tke": (st.q2, st.q2b, st.q2l, st.q2lb, st.u, st.v, st.w, st.aam,
                st.t, st.s, st.rho, st.km, st.kh, st.kq, st.l,
                jm.grid.h + st.et, st.etb, st.et, st.wubot, st.wvbot),
        "tracer": (st.t, st.tb, st.s, st.sb, jm.tclim, jm.sclim, st.u,
                   st.ub, st.v, st.w, st.aam, st.kh, jm.grid.h + st.et,
                   st.etb, st.et),
    }[phase]
    with jx_stencil.domain_of(jm.cfg):
        want = getattr(jx_stepper, f"phase_{phase}")(jm.grid, jm.cfg,
                                                     *jargs, jfc)
    kw = {"ub": args[6]} if phase == "tracer" else {}
    got = fn(g, cfg, *args, **kw)
    for k, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(b).max()),
                                   err_msg=f"{phase} output {k}")
