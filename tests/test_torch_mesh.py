"""The port's decomposed step (``Model.shard`` + ``run_segment``, mesh/
shardmap.py) on the CPU in float64, with every block on the CPU: against
the JAX single-device Model and the JAX shard_map Model after 3 steps, at
1e-10 of each field's scale on tests/test_phases_mesh.py's CHECK fields.

The JAX shard_map path passes ``check_rep`` to ``shard_map``, which the
installed jax calls ``check_vma``; the fixture ``jax_shard_map`` renames the
keyword for the duration of one JAX run, inside this module only."""

import numpy as np
import pytest
import torch

from extpom_tpu.cases.seamount import seamount_model as jx_model
from extpom_tpu.mesh import shardmap as jx_shardmap
from extpom_tpu.mesh.sharding import make_mesh

from extpom_tpu_torch import kernels
from extpom_tpu_torch.cases.seamount import seamount_model as pt_model
from extpom_tpu_torch.core import dispatch
from extpom_tpu_torch.core.config import Config
from extpom_tpu_torch.diag import stats
from extpom_tpu_torch.mesh.shardmap import Mesh

torch.set_num_threads(1)

CHECK = ("el", "ua", "va", "u", "v", "w", "t", "s", "rho",
         "q2", "q2l", "km", "kh", "l", "wubot", "wvbot")
N = 3
TOL = 1e-10
SIZES = {"32x64": dict(im=32, jm=64, kb=7, isplit=6, dtype="float64"),
         "64x64": dict(im=64, jm=64, kb=7, isplit=6, dtype="float64")}
# meshes of tests/test_phases_mesh.py: an 8-cell phase ring needs blocks of
# at least 8 cells on a split axis
MESHES = [("32x64", 2, 4), ("32x64", 4, 2), ("64x64", 1, 8), ("64x64", 8, 1)]


def _compare(got: dict, want: dict, tol: float = TOL):
    for name in CHECK:
        a, b = want[name], got[name]
        atol = tol * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=name)


def _numpy(state) -> dict:
    return {n: np.array(getattr(state, n)) for n in CHECK}


@pytest.fixture(scope="module")
def jax_single():
    """The JAX single-device states after N steps, by size."""
    out = {}
    for size, kw in SIZES.items():
        m = jx_model(donate=False, **kw)
        m.run_segment(N)
        out[size] = _numpy(m.state)
    return out


@pytest.fixture(scope="module")
def port_mesh():
    """The port's decomposed models after N steps, by (size, px, py), and
    under (size, px, py, 1) their CHECK fields after the first step."""
    out = {}
    for size, px, py in MESHES:
        m = pt_model(device="cpu", **SIZES[size])
        m.shard(Mesh(px, py, device="cpu"))
        m.run_segment(1)
        out[(size, px, py, 1)] = _numpy(m.gathered_state())
        m.run_segment(N - 1)
        out[(size, px, py)] = m
    return out


@pytest.fixture
def jax_shard_map(monkeypatch):
    """Run the JAX shard_map path on the installed jax: its ``check_rep``
    keyword becomes ``check_vma``."""
    orig = jx_shardmap.shard_map

    def shard_map(*a, check_rep=None, **k):
        if check_rep is not None:
            k["check_vma"] = check_rep
        return orig(*a, **k)

    monkeypatch.setattr(jx_shardmap, "shard_map", shard_map)


@pytest.mark.parametrize("size,px,py", MESHES,
                         ids=[f"{s}-{px}x{py}" for s, px, py in MESHES])
def test_mesh_matches_jax_single_device(jax_single, port_mesh, size, px, py):
    m = port_mesh[(size, px, py)]
    assert m.state is None and len(m.blocks.ids) == px * py
    _compare(_numpy(m.gathered_state()), jax_single[size])


@pytest.mark.parametrize("knobs,steps", [
    (dict(pallas_phases="on", phase_block=8, phase_halo=8, pallas_ext="on"),
     N),
    (dict(pallas_ext="off", pallas_extwin="on"), 1)],
    ids=["phases+vmem-chunk", "window-chunk"])
def test_mesh_matches_jax_shard_map(jax_shard_map, port_mesh, knobs, steps):
    """The JAX decomposed step, its Pallas kernels in interpret mode: the
    mesh phases and the whole-block chunk (rows 4 and 7 of PERF.md's kernel
    table) over N steps, or the window chunk (row 6) over the first step,
    which runs the external loop and skips the internal phases (each JAX
    step variant in interpret mode compiles for 15-40 s on the CPU)."""
    m = jx_model(donate=False, **SIZES["32x64"], **knobs)
    m.shard(make_mesh(2, 4), mode="shardmap")
    m.run_segment(steps)
    got = (_numpy(port_mesh[("32x64", 2, 4)].gathered_state())
           if steps == N else port_mesh[("32x64", 2, 4, 1)])
    _compare(got, _numpy(m.state))


def test_mesh_diagnostics_match_single_device(port_mesh):
    """domain_stats, check_velocity and cfl_min of a decomposed model are
    those of its gathered state and grid; saver stays at 15."""
    m = port_mesh[("32x64", 2, 4)]
    ref = pt_model(device="cpu", **SIZES["32x64"])
    ref.run_segment(N)
    st = m.gathered_state()
    got = stats.domain_stats(m.grid, m.cfg, st)
    want = stats.domain_stats(ref.grid, ref.cfg, ref.state)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-12), k
    assert abs(float(got["saver"]) - 15.0) < 1e-6
    vmax, (i, j) = stats.check_velocity(m.cfg, st.va)
    assert float(vmax) == float(stats.check_velocity(ref.cfg,
                                                     ref.state.va)[0])
    assert float(stats.cfl_min(m.grid, m.cfg)) == float(
        stats.cfl_min(ref.grid, ref.cfg))


def test_mesh_on_the_cpu_launches_no_kernel():
    before = dict(kernels.LAUNCHES)
    m = pt_model(device="cpu", im=16, jm=16, kb=5, isplit=4,
                 dtype="float64").shard(Mesh(2, 2, device="cpu"))
    m.run_segment(2)
    assert kernels.LAUNCHES == before


def test_one_block_mesh_is_the_single_device_path():
    kw = dict(im=16, jm=24, kb=5, isplit=4, dtype="float64", device="cpu")
    ref = pt_model(**kw)
    ref.run_segment(2)
    m = pt_model(**kw).shard(Mesh(1, 1, device="cpu"))
    assert m.blocks is None
    m.run_segment(2)
    for name in CHECK:
        assert torch.equal(getattr(m.state, name), getattr(ref.state, name))


def test_run_returns_the_state_on_a_mesh():
    """Model.run on a 2x4 mesh returns the State, as on one device: the
    gathered one, bit-equal to the single-device run; run_segment gathers
    nothing and returns None there."""
    import dataclasses
    from extpom_tpu_torch.core.state import State
    kw = dict(im=32, jm=64, kb=5, isplit=4, dtype="float64", device="cpu")
    want = pt_model(**kw).run(n_steps=2)
    m = pt_model(**kw).shard(Mesh(2, 4, device="cpu"))
    got = m.run(n_steps=2)
    assert isinstance(got, State) and m.state is None
    gathered = m.gathered_state()
    for f in dataclasses.fields(State):
        assert torch.equal(getattr(got, f.name), getattr(gathered, f.name)), \
            f.name
    for name in CHECK:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert m.run_segment(1) is None and m.state is None


@pytest.mark.parametrize("kw", [dict(ext_halo_sub=9), dict(phase_halo=9),
                                dict(phase_halo=3)],
                         ids=["ext-ring", "phase-ring", "phase-margin"])
def test_block_narrower_than_its_ring_raises(kw):
    """A ring wider than the (16, 8) blocks it is read from raises before
    any strip is read (the JAX package asserts it in _halo_shift), and so
    does a phase ring narrower than the cells the phase kernels skip."""
    m = pt_model(device="cpu", im=32, jm=64, kb=5, dtype="float64", **kw)
    with pytest.raises(ValueError, match="wider than|phase kernels skip"):
        m.shard(Mesh(2, 8, device="cpu"))


def test_ring_radii(monkeypatch):
    """mode_interaction reads 2 cells away (advave reads d at i-2): its ring
    of 2 reproduces the single-device step, a ring of 1 does not; the
    phases are exact with the narrowest ring their kernels allow."""
    from extpom_tpu_torch.core import stepper
    kw = dict(im=24, jm=24, kb=5, isplit=4, dtype="float64", device="cpu")
    ref = pt_model(**kw)
    ref.run_segment(2)
    want = _numpy(ref.state)

    def run(**cfg):
        m = pt_model(**kw, **cfg).shard(Mesh(3, 3, device="cpu"))
        m.run_segment(2)
        return _numpy(m.gathered_state())

    _compare(run(phase_halo=4), want, tol=0.0)
    monkeypatch.setattr(stepper, "INTERACTION_RADIUS", 1)
    with pytest.raises(AssertionError):
        _compare(run(), want)


def test_one_substep_per_exchange():
    """ext_local_chunk="off" exchanges the ring after every external
    substep (C = 1 on a ring of 3, where the default takes C = 2 on the
    8-cell blocks): the state is still the single-device step's, bit for
    bit."""
    kw = dict(im=24, jm=24, kb=5, isplit=4, dtype="float64")
    ref = pt_model(device="cpu", **kw)
    ref.run_segment(2)
    mesh = Mesh(3, 3, device="cpu")
    for chunk, C in (("auto", 2), ("off", 1)):
        rep = dispatch.dispatch_report(Config(**kw, ext_local_chunk=chunk),
                                       torch.float64, "cpu", mesh=mesh)
        assert rep["external"]["C"] == C
        assert rep["external"]["ring"] == (3 * C, 3 * C)
    m = pt_model(device="cpu", **kw, ext_local_chunk="off").shard(mesh)
    m.run_segment(2)
    _compare(_numpy(m.gathered_state()), _numpy(ref.state), tol=0.0)


def test_what_the_mesh_cannot_run_raises():
    """Time-varying forcing on a grid the mesh pads (the JAX package cannot
    run it either), blocks on several devices, another parallel mode."""
    from extpom_tpu_torch.cases.channel import channel_model
    m = channel_model(device="cpu", im=30, jm=16, kb=5, dtype="float64")
    with pytest.raises(NotImplementedError, match="padded grid"):
        m.shard(Mesh(4, 4, device="cpu"))
    m = pt_model(device="cpu", im=30, jm=64, kb=5, dtype="float64")
    with pytest.raises(NotImplementedError, match="several devices"):
        Mesh(1, 2, devices=["cpu", "meta"]).device
    with pytest.raises(NotImplementedError):
        m.shard(Mesh(2, 2, device="cpu"), mode="gspmd")


def test_dispatch_report_of_config5_on_a_2x4_mesh():
    """config5_2048's geometry (2048x2048x41 f32 on its 2x4 mesh): C=10
    substeps per ring of 30 cells, extended blocks 1084x572, local tile
    1024x512x41, phase rings of 8."""
    cfg = Config(im=2048, jm=2048, kb=41, isplit=30)
    rep = dispatch.dispatch_report(cfg, torch.float32, "cpu",
                                   mesh={"px": 2, "py": 4, "mode": "shardmap"})
    assert rep["external"] == {"machine": "plain", "C": 10, "ring": (30, 30),
                               "block": (1084, 572), "chunks_per_step": 3}
    assert all(d == {"machine": "plain", "ring": (8, 8)}
               for d in rep["phases"].values())
    text = dispatch.format_report(rep)
    assert "mesh: 2x4 shardmap on 1 device  local tile 1024x512x41" in text
    assert "ring=(30, 30) block=(1084, 572)" in text
