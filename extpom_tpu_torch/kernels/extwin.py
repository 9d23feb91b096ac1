"""Halo-window external loop: the CUDA kernel ``csrc/extwin.cu`` (the
counterpart of ``extpom_tpu/pallas/extwin.py:_kernel``), its dispatch and
its plain PyTorch version.

The whole-grid chain of :mod:`extpom_tpu_torch.kernels.extloop` passes over
every 2-D field three times per substep.  While the loop's working set fits
the card's L2 those passes are L2 hits; beyond it they stream from device
memory.  The window kernel runs C substeps per launch on 2-D tiles kept in
shared memory, so it reads the carry from device memory ``isplit / C``
times per step instead.  :func:`use_windowed` picks the machine.

:func:`run_external_chunk_windowed` is the decomposed step's variant (the
counterpart of ``extpom_tpu/pallas/extwin.py:_kernel`` with ``has_off``,
via ``run_external_chunk_windowed``): C substeps on one ring-extended block,
as C / ``win_geometry(...).C`` window launches of the same source built for
blocks.  The ring's C (substeps per exchange, ``mesh/extchunk.py``) and the
kernel's C per launch (at most :data:`C_MAX`, set by shared memory) are
separate: one ring of width 3 C serves all the launches of a chunk.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from extpom_tpu_torch import kernels
from extpom_tpu_torch.kernels import build, extloop
from extpom_tpu_torch.kernels.extloop import (
    CARRY_FIELDS, GRID_FIELDS, AUX_FIELDS, FC_2D_FIELDS, FC_1D_J, FC_1D_I,
    N_METRICS, N_SUBSTEP)

RADIUS = 2          # cells a substep's new carry reads of the old one
RADIUS_ORL = 3      # ... under the orlanski scheme (csrc/extstep.cuh)
C_MAX = 2           # substeps per launch, at most
THREADS = 512       # threads of a window block (csrc/extwin.cu allows 512)
TILE = (8, 32)      # (ti, tj), j fastest, in both variants and dtypes
# window fields of csrc/extwin.cu in shared memory: eight carry fields,
# elf, d = h + el, the tps sums of aam2d and six faces; mode 2 keeps the
# bottom stress too (N_SHARED_MODE2)
N_SHARED = 17
N_SHARED_MODE2 = 19
SMEM_BYTES = 232_448    # shared memory a block may use on Hopper (227 KB)
# fields of (im, jm) the loop keeps live: carry, grid, aux, 2-D forcing,
# metrics and the substep's elf/uaf/vaf
N_WORKING = (len(CARRY_FIELDS) + len(GRID_FIELDS) + len(AUX_FIELDS)
             + len(FC_2D_FIELDS) + N_METRICS + N_SUBSTEP)


class Geometry(NamedTuple):
    """C substeps per launch, halo H, tile (ti, tj), threads per block and
    the block's shared memory in bytes."""
    C: int
    H: int
    ti: int
    tj: int
    threads: int
    smem: int


def chunk_geometry(cfg, itemsize: int) -> Geometry:
    """The window kernel's geometry for ``cfg`` in a dtype of ``itemsize``
    bytes: C is the largest divisor of ``isplit`` up to :data:`C_MAX`, H
    covers C substeps of radius :data:`RADIUS`, and the tile (j fastest)
    and the threads are :data:`TILE` and :data:`THREADS`, the fastest of a
    sweep of C, tile and block size at 2048x2048 and on a 1084x572 block of
    its 2x4 mesh on the H100
    (``python -m extpom_tpu_torch.tools.extwin_sweep``)."""
    return win_geometry(cfg.isplit, itemsize, extloop.ext_flags(cfg))


def geometry(C: int, ti: int, tj: int, threads: int, itemsize: int,
             flags: int = 0) -> Geometry:
    """The :class:`Geometry` of C substeps per launch on ti x tj tiles of
    the kernel of the options ``flags`` (``extloop.ext_flags``); raises
    where the window does not fit a block's shared memory or a window row
    has more cells than the block has threads (a thread owns one column of
    the window)."""
    H = (RADIUS_ORL if flags & extloop.ORL else RADIUS) * C
    fields = N_SHARED_MODE2 if flags & extloop.MODE2 else N_SHARED
    smem = fields * (ti + 2 * H) * (tj + 2 * H) * itemsize
    if smem > SMEM_BYTES:
        raise ValueError(f"extwin: a {ti}x{tj} tile with halo {H} needs "
                         f"{smem} bytes of shared memory")
    if threads < tj + 2 * H:
        raise ValueError(f"extwin: {threads} threads for a window row of "
                         f"{tj + 2 * H} cells")
    return Geometry(C, H, ti, tj, threads, smem)


def win_geometry(n_substeps: int, itemsize: int,
                 flags: int = 0) -> Geometry:
    """:func:`chunk_geometry` for a run of ``n_substeps`` substeps (a whole
    loop, or one ring chunk of the decomposed step) of the kernel of the
    options ``flags``."""
    C = max(c for c in range(1, min(C_MAX, n_substeps) + 1)
            if n_substeps % c == 0)
    return geometry(C, *TILE, THREADS, itemsize, flags)


def window_info(dtype: torch.dtype, geo: Geometry, block: bool = False,
                device=None, flags: int = 0) -> dict:
    """What the compiler and the card give ``k_window`` (the block
    variant with ``block``, the options ``flags``) at ``geo``: registers
    per thread, static and dynamic shared bytes, resident blocks per SM,
    spill bytes per thread and the SMs of the card
    (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  Builds the
    kernels; needs a CUDA device."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        status = build.library().extpom_extwin_info(
            int(dtype == torch.float64), int(block), flags, geo.threads,
            geo.smem, ctypes.cast(out, ctypes.c_void_p))
    build.check(status, "extwin info")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "blocks_per_sm", "spill_bytes", "sms"), out))


def working_set_bytes(im: int, jm: int, itemsize: int) -> int:
    """Bytes of the external loop's working set: the 2-D fields it keeps
    live and the 1-D boundary series."""
    return (N_WORKING * im * jm + len(FC_1D_J) * jm
            + len(FC_1D_I) * im) * itemsize


def use_windowed(im: int, jm: int, itemsize: int, l2_bytes: int) -> bool:
    """The dispatch: the whole-grid chain while the loop's working set fits
    the card's L2 (``l2_bytes``), the window kernel beyond it.  The
    decomposed step asks the same of a ring-extended (R, L) block
    (``use_win_chunk``)."""
    return working_set_bytes(im, jm, itemsize) > l2_bytes


use_win_chunk = use_windowed


@functools.lru_cache(maxsize=None)
def l2_bytes(device: torch.device) -> int:
    """L2 size of a CUDA device."""
    return torch.cuda.get_device_properties(device).L2_cache_size


def run_external_loop_windowed_plain(grid, cfg, c0, fc, aux):
    """All isplit substeps in plain PyTorch: the function the window kernel
    computes, whatever its C."""
    return extloop.run_external_loop_plain(grid, cfg, c0, fc, aux)


def run_external_chunk_windowed(grid, cfg, c0, fc, aux, C: int, iext0: int,
                                off, geo=None):
    """Substeps iext0 .. iext0+C-1 on a ring-extended (R, L) block whose
    cell (0, 0) is global ``off``, as C / geo.C window launches; the
    contract of ``extloop.run_external_chunk``.  ``geo`` is the kernel's
    :class:`Geometry`, ``win_geometry(C, ...)`` by default.  CUDA tensors
    launch the kernel, CPU tensors run its plain version, which is the
    chain's, ``extloop.run_external_chunk_plain``, whatever C per
    launch."""
    extloop.check_chunk(grid, cfg, c0, fc, aux, C, iext0, off,
                        "extwin_chunk")
    if c0[0].device.type == "cpu":
        return extloop.run_external_chunk_plain(grid, cfg, c0, fc, aux, C,
                                                iext0, off)
    geo = geo or win_geometry(C, c0[0].element_size(),
                              extloop.ext_flags(cfg))
    if C % geo.C:
        raise ValueError(f"extwin_chunk: {geo.C} substeps per launch do not "
                         f"divide the chunk's {C}")
    return _launch(grid, cfg, c0, fc, aux, geo, (C, iext0, *off))


def run_external_loop_windowed(grid, cfg, c0, fc, aux, geo=None):
    """All isplit substeps as isplit/C window launches; CUDA tensors launch
    the kernel, CPU tensors run :func:`run_external_loop_windowed_plain`.
    Same contract as ``extloop.run_external_loop``; ``geo`` is the kernel's
    :class:`Geometry`, :func:`chunk_geometry`'s by default."""
    extloop.check_operands(grid, cfg, c0, fc, aux, "extwin")
    device = c0[0].device
    if device.type == "cpu":
        return run_external_loop_windowed_plain(grid, cfg, c0, fc, aux)
    if device.type != "cuda":
        raise TypeError(f"extwin: unsupported device {device}")
    kernels.whole_grid_only(cfg, "extwin")
    return _launch(grid, cfg, c0, fc, aux, geo)


def _launch(grid, cfg, c0, fc, aux, geo, chunk=None):
    """Launch the whole loop, or with ``chunk`` = (C, iext0, oi, oj) the
    block variant (``extpom_extwin_chunk_*``)."""
    from extpom_tpu_torch.core.stepper import ExtCarry
    el = c0[0]
    R, L = el.shape
    geo = geo or chunk_geometry(cfg, el.element_size())
    # two carry buffers: each launch reads one and writes the other
    carry = torch.empty((2, len(CARRY_FIELDS), R, L), dtype=el.dtype,
                        device=el.device)
    for k, x in enumerate(c0):
        carry[0, k].copy_(x)
    metrics = torch.empty((N_METRICS, R, L), dtype=el.dtype,
                          device=el.device)
    tensors = ([carry[0], carry[1]]
               + [getattr(grid, f) for f in GRID_FIELDS]
               + list(aux)
               + [getattr(fc, f) for f in FC_2D_FIELDS + FC_1D_J + FC_1D_I]
               + [fc.ramp]
               + list(metrics))
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    prm = (ctypes.c_double * 9)(cfg.dte, cfg.grav, cfg.smoth, cfg.alpha,
                                float(cfg.isplit), cfg.rfe, cfg.rfw,
                                cfg.rfn, cfg.rfs)
    lib = build.library()
    suffix = "f32" if el.dtype == torch.float32 else "f64"
    name = "extwin" if chunk is None else "extwin_chunk"
    fn = getattr(lib, f"extpom_{name}_{suffix}")
    block = () if chunk is None else (R, L, *chunk)
    stream = torch.cuda.current_stream(el.device).cuda_stream
    with torch.cuda.device(el.device):
        status = fn(ctypes.cast(ptrs, ctypes.c_void_p),
                    ctypes.cast(prm, ctypes.c_void_p),
                    *cfg.active, *block, cfg.isplit, cfg.ispadv,
                    extloop.ext_flags(cfg), geo.C, geo.H, geo.ti, geo.tj, geo.threads, stream)
    build.check(status, f"{name} kernel")
    n_launch = (cfg.isplit if chunk is None else chunk[0]) // geo.C
    # the whole loop counts its launches; the block variant its calls
    kernels.LAUNCHES[name] += n_launch if chunk is None else 1
    return ExtCarry(*carry[n_launch % 2].unbind(0))
