"""Time-varying forcing on a mesh (``Model.shard`` + a forcing_fn,
``mesh/shardmap.py:Blocks.host_forcing``) on the CPU in
float64:

* the tidal channel at 32x64x7 on 2x4, 1x8 and 4x2 through
  ``run_segment`` (two segments), its series staged whole and a window
  per segment (``forcing_hbm_mb`` 0), against the port's single-device run
  bit for bit on every State field, and on 2x4 against the JAX package's
  shard_map run at 1e-10 of each field's scale;
* the host path (``Model.run`` with a plain forcing_fn, cut to the blocks
  at every step) on 2x4, bit for bit, under the extpom and the orlanski
  boundary schemes; a field that changed and that a stage does not name
  reaches it as None, never as the static value;
* the file scheme with interior restoring from an lbry-like
  ``ArraySource`` (the four sides' velocity profiles and trstr/srstr,
  changing from step to step) on 2x4, staged and host-assembled, bit for
  bit;
* a forced model on a padded grid raises ``NotImplementedError`` in the
  port, because the JAX package's forced padded run fails with
  ``TypeError`` (its records are served at the active extents and nothing
  pads them): ``test_reference_cannot_run_forcing_on_a_padded_grid`` fails
  once the reference runs it, and the port can then follow.

The JAX shard_map path passes ``check_rep`` to ``shard_map``, which the
installed jax calls ``check_vma``; the fixture ``jax_shard_map`` renames the
keyword for the duration of one JAX run, inside this module only."""

import numpy as np
import pytest
import torch

from extpom_tpu.cases.channel import channel_model as jx_channel
from extpom_tpu.mesh import padding as jx_padding
from extpom_tpu.mesh import shardmap as jx_shardmap
from extpom_tpu.mesh.sharding import make_mesh

from extpom_tpu_torch.cases.channel import channel_model as pt_channel
from extpom_tpu_torch.core.state import State
from extpom_tpu_torch.forcing import provider as prov
from extpom_tpu_torch.mesh.padding import pad_model
from extpom_tpu_torch.mesh.shardmap import Mesh

torch.set_num_threads(1)

KW = dict(im=32, jm=64, kb=7, dtype="float64")
SEG = (2, 2)
STAGING = {"whole": 512, "windowed": 0}
MESHES = [(2, 4), (1, 8), (4, 2)]
CHECK = ("el", "ua", "va", "u", "v", "w", "t", "s", "rho", "q2", "q2l",
         "km", "kh", "l", "wubot", "wvbot")


def _equal(got: State, want: State):
    for name in State.field_names():
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _segments(m):
    for n in SEG:
        m.run_segment(n)
    return m


@pytest.fixture(scope="module")
def single():
    """The port's single-device channel after the segments, by staging."""
    return {k: _segments(pt_channel(device="cpu", forcing_hbm_mb=mb, **KW))
            for k, mb in STAGING.items()}


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


@pytest.mark.parametrize("staging", list(STAGING))
@pytest.mark.parametrize("px,py", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_staged_forcing_on_a_mesh_is_bit_equal(single, px, py, staging):
    m = pt_channel(device="cpu", forcing_hbm_mb=STAGING[staging], **KW)
    m.shard(Mesh(px, py, device="cpu"))
    _segments(m)
    assert m.state is None and len(m.blocks.ids) == px * py
    _equal(m.gathered_state(), single[staging].state)
    assert float(single[staging].state.el.abs().max()) > 1e-3


def test_staged_forcing_on_a_mesh_matches_jax_shard_map(single,
                                                        jax_shard_map):
    jm = jx_channel(**KW)
    jm.shard(make_mesh(2, 4), mode="shardmap")
    for n in SEG:
        jm.run_segment(n)
    m = _segments(pt_channel(device="cpu", **KW).shard(
        Mesh(2, 4, device="cpu")))
    st = m.gathered_state()
    for name in CHECK:
        want = np.asarray(getattr(jm.state, name))
        atol = 1e-10 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(getattr(st, name).numpy(), want, rtol=0,
                                   atol=atol, err_msg=name)


def _host_forcing(model, iint):
    """A forcing_fn that is not a ForcingProvider: a west-end elevation
    and a wind stress that change at every step."""
    fc = model.base_forcing
    a = 0.3 * np.sin(0.7 * iint)
    j = torch.arange(fc.elw.shape[-1], dtype=fc.elw.dtype)
    return fc.replace(elw=a * (1.0 + 0.01 * j),
                      wusurf=torch.full_like(fc.wusurf, 1e-5 * a),
                      wvsurf=torch.full_like(fc.wvsurf, -2e-5 * a))


@pytest.mark.parametrize("scheme,el_min", [("extpom", 1e-3),
                                           ("orlanski", 1e-5)])
def test_host_forcing_on_a_mesh_is_bit_equal(scheme, el_min):
    runs = []
    for mesh in (None, Mesh(2, 4, device="cpu")):
        m = pt_channel(device="cpu", bc_scheme=scheme, **KW)
        m.forcing_fn = _host_forcing
        if mesh is not None:
            m.shard(mesh)
        runs.append(m.run(4))
    _equal(runs[1], runs[0])
    assert float(runs[0].el.abs().max()) > el_min


def test_a_changed_field_a_stage_does_not_name_is_none():
    m = pt_channel(device="cpu", **KW).shard(Mesh(2, 4, device="cpu"))
    B, b, h = m.blocks, (1, 2), (3, 3)
    want = _host_forcing(m, 5)
    fc = B.host_forcing(want)
    got = fc.ext(b, h, ("vflux", "wusurf"))
    assert got.elw is None and got.wvsurf is None
    assert torch.equal(got.wusurf, B.window("wusurf", want.wusurf, b, h))
    assert got.vflux is B.fc_ext(b, h).vflux
    assert torch.equal(fc.ext(b, h).elw, B.window("elw", want.elw, b, h))


def _lbry(m, rng) -> dict:
    """The channel's own series plus an lbry file's for the file scheme
    with restoring: each side's velocity profiles and trstr/srstr as two
    records, seeded."""
    kb, im, jm = m.state.t.shape
    side = lambda n: 0.02 + 0.01 * rng.standard_normal((2, kb, n))
    data = {f"{v}b{s}": side(jm if s in ("w", "e") else im)
            for v in ("u", "v") for s in ("w", "e", "s", "n")}
    t0, s0 = m.state.t.numpy(), m.state.s.numpy()
    data["trstr"] = np.stack([t0 + 0.5 * rng.random(t0.shape)
                              for _ in range(2)])
    data["srstr"] = np.stack([s0 - 0.5 * rng.random(s0.shape)
                              for _ in range(2)])
    data.update(m.forcing_fn.source.data)
    return data


@pytest.mark.parametrize("path", ["staged", "host"])
def test_file_scheme_with_restoring_on_a_mesh_is_bit_equal(path):
    runs = []
    for mesh in (None, Mesh(2, 4, device="cpu")):
        m = pt_channel(device="cpu", bc_scheme="file", do_restore=True,
                       **KW)
        m.forcing_fn = prov.ForcingProvider(
            m.grid, m.cfg, m.base_forcing,
            prov.ArraySource(_lbry(m, np.random.default_rng(13))),
            prefetch=False, restore_cadence_days=0.01)
        if mesh is not None:
            m.shard(mesh)
        if path == "staged":
            m.run_segment(3)
        else:
            for _ in range(3):
                m.step_once()
        runs.append(m.gathered_state())
    _equal(runs[1], runs[0])


def test_forcing_on_a_padded_grid_raises():
    m = pt_channel(device="cpu", im=33, jm=17, kb=7, dtype="float64")
    with pytest.raises(NotImplementedError, match="padded grid"):
        m.shard(Mesh(2, 4, device="cpu"))
    with pytest.raises(NotImplementedError, match="padded grid"):
        pad_model(m, 2, 4)
    m = pt_channel(device="cpu", im=33, jm=17, kb=7, dtype="float64")
    fn, m.forcing_fn = m.forcing_fn, None
    pad_model(m, 2, 4)
    m.forcing_fn = fn
    for run in (lambda: m.run_segment(2), m.step_once):
        with pytest.raises(NotImplementedError, match="padded grid"):
            run()


def test_reference_cannot_run_forcing_on_a_padded_grid():
    """The JAX package's gap that the port's raise follows: its provider
    serves records at the active extents and nothing pads them.  This test
    fails once the reference runs a forced padded model."""
    m = jx_channel(im=33, jm=17, kb=7, dtype="float64")
    jx_padding.pad_model(m, 2, 4)
    with pytest.raises(TypeError, match="incompatible shapes"):
        m.run_segment(4)
