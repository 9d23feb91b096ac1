"""The column-tile planner of the phase kernels
(kernels/phases.py:column_tile): every depth the configurations use fits a
Hopper block with the planned tile, the planner raises where nothing fits,
and its shared-memory count is the one the card reports for the kernels'
own layout (csrc/phase_{lat,uvw,tke,tracer,mom}.cu ``layout``)."""

import pathlib

import pytest
import torch

from extpom_tpu_torch.kernels import build, phases

CSRC = pathlib.Path(phases.__file__).resolve().parent.parent / "csrc"
TILED = ["lat", "uvw", "tke", "tracer", "mom"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kb", [4, 7, 31, 41, 64])
@pytest.mark.parametrize("phase", TILED)
def test_column_tile_fits_a_block(phase, kb, dtype):
    tile = phases.column_tile(kb, dtype, phase)
    c = phases.layout_constants(phase)
    item = torch.finfo(dtype).bits // 8
    assert tile.tj % 32 == 0
    assert 32 <= tile.ti * tile.tj <= c["kMaxThreads"]
    assert 0 < tile.smem <= phases.SMEM_BYTES
    assert tile.kb == kb
    # ee/gg are kb x kScratch rows of the tile's columns in device scratch
    # (none for lat and uvw, which solve nothing), so the block's shared
    # memory is the same at every depth unless the tile keeps its levels
    # (mom, uvw)
    assert tile.scratch == kb * c["kScratch"] * tile.ti * tile.tj * item
    assert (tile.scratch > 0) == (phase not in ("lat", "uvw"))
    assert not tile.keep
    assert tile.smem == phases.column_tile(4, dtype, phase).smem
    kept = phases.column_tile(kb, dtype, phase, keep=True)
    assert kept.keep == (phase in ("uvw", "mom"))
    if phase == "uvw":   # the ring of face pairs is kb-1 levels deep
        fp = (tile.ti + 1) * tile.tj + tile.ti * (tile.tj + 1)
        assert kept.smem == tile.smem + (kb - 1 - c["kStages"]) * fp * item
    else:
        assert kept.smem == \
            tile.smem + c["kKeep"] * kb * tile.ti * tile.tj * item


@pytest.mark.parametrize("shape,keep", [((256, 256), True),
                                        ((2048, 2048), False),
                                        ((144, 80), True)],
                         ids=["main-path", "config5", "mesh-block"])
def test_mom_keeps_its_levels_where_one_wave_runs_the_grid(monkeypatch,
                                                           shape, keep):
    """The planner keeps mom's levels in shared memory where the blocks an
    SM then holds (two 8x32 f32 tiles with 31 kept levels, 98,240 bytes
    each, as the H100 reports) cover every tile at once: the main path's
    256 tiles and a mesh block's 54, not config5's 16,384; lat never keeps
    any.  tile_info is the card's answer, here a stand-in with the H100's
    132 SMs and its occupancy by shared memory."""
    def tile_info(phase, dtype, tile, mesh=False, device=None):
        return {"blocks_per_sm": min(4, phases.SMEM_BYTES // tile.smem),
                "sms": 132}

    monkeypatch.setattr(phases, "tile_info", tile_info)
    plan = phases.plan_tile.__wrapped__
    tile, blocks = plan("mom", torch.float32, 31, *shape, device="cpu")
    assert tile.keep == keep
    tiles = -(-shape[0] // 8) * -(-shape[1] // 32)
    assert blocks == min(tiles, (2 if keep else 4) * 132)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        phases.column_tile(64, torch.float64, "mom", ti=8, tj=32, keep=True)
    assert not plan("lat", torch.float32, 31, *shape, device="cpu")[0].keep


@pytest.mark.parametrize("phase", TILED)
def test_column_tile_raises_where_nothing_fits(phase):
    with pytest.raises(ValueError, match="multiple of 32"):
        phases.column_tile(31, torch.float32, phase, ti=4, tj=48)
    with pytest.raises(ValueError, match="at most 256"):
        phases.column_tile(31, torch.float32, phase, ti=16, tj=32)
    # the one-row tile has the widest window of all 256-column tiles
    wide = phases.column_tile(31, torch.float32, phase, ti=1, tj=256)
    assert wide.smem <= phases.SMEM_BYTES


def test_column_tile_raises_where_shared_memory_runs_out():
    # tke's ring of four levels of 14 fields over a 1x256 tile's 3x258
    # window is 280,176 bytes in f64
    with pytest.raises(ValueError, match="280176 bytes of shared memory"):
        phases.column_tile(41, torch.float64, "tke", ti=1, tj=256)


def test_column_tile_raises_for_other_phases():
    with pytest.raises(ValueError, match="no tile kernel"):
        phases.column_tile(31, torch.float32, "extloop")


def test_lat_counts_its_two_cell_window():
    """lat's layout: a ring of two levels of seven one-cell windows, eleven
    arrays on the one-cell window, dt/dx/dy on the two-cell window and two
    face pairs; an 8x32 tile in f32 is 43,600 bytes."""
    c = phases.layout_constants("lat")
    assert (c["kStages"], c["kHalo"], c["kOwn"], c["k2D"], c["kWide"],
            c["kFaces"], c["kScratch"], c["kKeep"]) == (2, 7, 0, 11, 3, 2,
                                                         0, 0)
    hc, w2 = 10 * 34, 12 * 36
    faces = 2 * (9 * 32 + 8 * 33)
    assert phases.column_tile(41, torch.float32, "lat").smem == \
        (2 * 7 * hc + 11 * hc + 3 * w2 + faces) * 4 == 43_600


def test_uvw_counts_its_face_pairs():
    """uvw's layout: no level ring, the depth sums on one face pair (u at
    the tile's (TI+1) x TJ x faces, v at its TI x (TJ+1) y faces), and with
    keep kb-1 levels of the face pair; a 2x64 tile in f32 is 1,288 bytes,
    and 52,808 at kb 41 with its levels kept."""
    c = phases.layout_constants("uvw")
    assert (c["kStages"], c["kHalo"], c["kOwn"], c["k2D"], c["kWide"],
            c["kFaces"], c["kStageFaces"], c["kScratch"], c["kKeep"],
            c["kKeepRing"]) == (0, 0, 0, 0, 0, 1, 1, 0, 0, 1)
    fp = 3 * 64 + 2 * 65
    assert phases.column_tile(41, torch.float32, "uvw").smem == \
        fp * 4 == 1_288
    assert phases.column_tile(41, torch.float32, "uvw", keep=True).smem == \
        (40 + 1) * fp * 4 == 52_808


@pytest.mark.parametrize("dtype,kb,keep", [(torch.float32, 31, True),
                                           (torch.float32, 41, True),
                                           (torch.float32, 100, False),
                                           (torch.float64, 31, True),
                                           (torch.float64, 41, True),
                                           (torch.float64, 64, False)])
@pytest.mark.parametrize("shape", [(256, 256), (2048, 2048), (144, 80)],
                         ids=["main-path", "config5", "mesh-block"])
def test_uvw_keeps_its_levels_where_two_blocks_fit(monkeypatch, shape, dtype,
                                                   kb, keep):
    """The planner keeps uvw's levels where two blocks of the kept tile fit
    an SM, whatever the grid: f32 (2x64 tiles, 39,928 bytes at kb 31 and
    52,808 at kb 41) and f64 (4x32, 72,416 and 95,776 bytes), not at kb 100
    in f32 (128,800 bytes) or 64 in f64 (149,504), where one block fits and
    pass 2 reads u and v again.  It launches one block per tile.  tile_info
    is the card's answer, here a stand-in with the H100's 132 SMs and its
    occupancy by shared memory."""
    def tile_info(phase, dtype, tile, mesh=False, device=None):
        return {"blocks_per_sm": min(4, phases.SMEM_BYTES // tile.smem),
                "sms": 132}

    monkeypatch.setattr(phases, "tile_info", tile_info)
    tile, blocks = phases.plan_tile.__wrapped__("uvw", dtype, kb, *shape,
                                                device="cpu")
    assert tile.keep == keep
    assert blocks == -(-shape[0] // tile.ti) * -(-shape[1] // tile.tj)


# dynamic shared bytes the H100 reported for the default tiles at kb=41
# through the kernels' own layout (chip_smoke.py [phases], tile_info's
# dynamic_smem)
CARD_SMEM = {("tke", torch.float32): 79_328, ("tke", torch.float64): 88_832,
             ("tracer", torch.float32): 55_440,
             ("tracer", torch.float64): 64_672,
             ("lat", torch.float32): 43_600, ("lat", torch.float64): 52_384,
             ("mom", torch.float32): 34_752, ("mom", torch.float64): 38_016,
             ("uvw", torch.float32): 1_288, ("uvw", torch.float64): 2_336}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("phase", TILED)
def test_planner_counts_the_kernel_layout(phase, dtype):
    """The planner's bytes, counted from the constants it reads from the
    kernel's source, are the bytes the kernel's own layout gave the card."""
    assert phases.column_tile(41, dtype, phase).smem == \
        CARD_SMEM[phase, dtype]


@pytest.mark.parametrize("phase", TILED)
def test_tile_entry_points_take_the_geometry(phase):
    """The C signatures carry TI, TJ and the block count after the phase
    options (pointer and parameter tables; kb, im, jm, two options, TI, TJ,
    blocks; the stream; a block's adds R, L, oi, oj), and the info entry
    exists."""
    for t in ("f32", "f64"):
        assert len(build.SIGNATURES[f"extpom_phase_{phase}_{t}"]) == 11
        assert len(build.SIGNATURES[f"extpom_phase_{phase}_mesh_{t}"]) == 15
    assert f"extpom_phase_{phase}_info" in build.SIGNATURES
    src = (CSRC / f"phase_{phase}.cu").read_text()
    assert f'extern "C" int extpom_phase_{phase}_info(' in src
