"""The column-tile planner of the tke and tracer kernels
(kernels/phases.py:column_tile): every depth the configurations use fits a
Hopper block with the planned tile, the planner raises where nothing fits,
and its shared-memory count is the one the card reports for the kernels'
own layout (csrc/phase_{tke,tracer}.cu ``layout``)."""

import pathlib

import pytest
import torch

from extpom_tpu_torch.kernels import build, phases

CSRC = pathlib.Path(phases.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kb", [4, 7, 31, 41, 64])
@pytest.mark.parametrize("phase", ["tke", "tracer"])
def test_column_tile_fits_a_block(phase, kb, dtype):
    tile = phases.column_tile(kb, dtype, phase)
    item = torch.finfo(dtype).bits // 8
    assert tile.tj % 32 == 0
    assert 32 <= tile.ti * tile.tj <= \
        phases.layout_constants(phase)["kMaxThreads"]
    assert 0 < tile.smem <= phases.SMEM_BYTES
    # ee/gg are kb x 4 rows of the tile's columns in device scratch, so the
    # block's shared memory is the same at every depth
    assert tile.scratch == kb * 4 * tile.ti * tile.tj * item
    assert tile.smem == phases.column_tile(4, dtype, phase).smem


@pytest.mark.parametrize("phase", ["tke", "tracer"])
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
        phases.column_tile(31, torch.float32, "mom")


# dynamic shared bytes the H100 reported for the default tiles through the
# kernels' own layout (chip_smoke.py [phases], tile_info's dynamic_smem)
CARD_SMEM = {("tke", torch.float32): 79_328, ("tke", torch.float64): 88_832,
             ("tracer", torch.float32): 55_440,
             ("tracer", torch.float64): 64_672}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("phase", ["tke", "tracer"])
def test_planner_counts_the_kernel_layout(phase, dtype):
    """The planner's bytes, counted from the constants it reads from the
    kernel's source, are the bytes the kernel's own layout gave the card."""
    assert phases.column_tile(41, dtype, phase).smem == \
        CARD_SMEM[phase, dtype]


@pytest.mark.parametrize("phase", ["tke", "tracer"])
def test_tile_entry_points_take_the_geometry(phase):
    """The C signatures carry TI, TJ and the block count after the phase
    options, and the info entry exists."""
    plain = build.SIGNATURES["extpom_phase_lat_f32"]
    for t in ("f32", "f64"):
        assert len(build.SIGNATURES[f"extpom_phase_{phase}_{t}"]) == \
            len(plain) + 3
        assert len(build.SIGNATURES[f"extpom_phase_{phase}_mesh_{t}"]) == \
            len(build.SIGNATURES["extpom_phase_lat_mesh_f32"]) + 3
    assert f"extpom_phase_{phase}_info" in build.SIGNATURES
    src = (CSRC / f"phase_{phase}.cu").read_text()
    assert f'extern "C" int extpom_phase_{phase}_info(' in src
