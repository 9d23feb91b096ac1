"""External-mode loop: the persistent CUDA kernel ``csrc/extloop.cu`` (the
counterpart of ``extpom_tpu/pallas/extloop.py:_kernel``) and its plain
PyTorch version, the Python loop over ``stepper.mode_external_substep``.

One call runs all ``isplit`` substeps of an internal step in one cooperative
launch and returns the final
:class:`~extpom_tpu_torch.core.stepper.ExtCarry`.  The ``orlanski`` scheme's
edges and mode 2's advave are compile-time options of the kernel
(:func:`ext_flags`).

:func:`run_external_chunk` is the decomposed step's variant (the
counterpart of ``extpom_tpu/pallas/extloop.py:_chunk_kernel``, via
``run_external_chunk_vmem``): C substeps on one ring-extended block, the
same kernel built for blocks.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from extpom_tpu_torch import kernels
from extpom_tpu_torch.kernels import build

# operand order of extpom_extloop_run (csrc/extloop.cu) and of the TPU
# kernel (extpom_tpu/pallas/extloop.py:48-57)
CARRY_FIELDS = ("el", "elb", "ua", "uab", "va", "vab", "etf", "egf",
                "utf", "vtf", "advua", "advva", "wubot", "wvbot")
GRID_FIELDS = ("h", "dx", "dy", "art", "aru", "arv", "cor",
               "fsm", "dum", "dvm", "cbc")
AUX_FIELDS = ("adx2d", "ady2d", "drx2d", "dry2d", "aam2d")
FC_2D_FIELDS = ("wusurf", "wvsurf", "vflux", "e_atmos")
FC_1D_J = ("elw", "ele", "uabw", "uabe", "vabw", "vabe")
FC_1D_I = ("els", "eln", "vabs", "vabn", "uabs", "uabn")
N_METRICS = 13      # ext_precompute fields
N_SUBSTEP = 3       # elf, uaf, vaf
N_SLOTS = 3         # the fourth time-level slots of el, ua, va (extloop.cu)
N_SCRATCH = N_METRICS + N_SUBSTEP + N_SLOTS
MAX_THREADS = 512   # threads of a block, at most (csrc/extloop.cu)
BARRIERS = 2        # grid-wide barriers per substep (csrc/extloop.cu)
# the options of the external kernels, compile-time flags of
# csrc/extstep.cuh (kOrl, kMode2)
ORL, MODE2 = 2, 4

_DTYPES = (torch.float32, torch.float64)


def run_external_loop_plain(grid, cfg, c0, fc, aux):
    """All isplit substeps in plain PyTorch."""
    return run_external_chunk_plain(grid, cfg, c0, fc, aux, cfg.isplit, 1)


def run_external_chunk_plain(grid, cfg, c0, fc, aux, C: int, iext0: int,
                             off=None):
    """Substeps iext0 .. iext0+C-1 in plain PyTorch; on a block whose cell
    (0, 0) is global ``off`` when it is given (the XLA chunk body of
    ``extpom_tpu/mesh/extchunk.py``)."""
    from extpom_tpu_torch.core import stepper
    from extpom_tpu_torch.ops.stencil import domain_of
    with domain_of(cfg, off):
        em = stepper.ext_precompute(grid)
        c = c0
        for iext in range(iext0, iext0 + C):
            c = stepper.mode_external_substep(grid, cfg, c, iext, fc, aux,
                                              em=em)
    return c


def ext_flags(cfg) -> int:
    """The options of ``cfg`` that the external kernels compile in: the
    orlanski scheme's edges (orl_el, orl_vel2d) and mode 2's advave."""
    return ((ORL if cfg.bc_scheme == "orlanski" else 0)
            | (MODE2 if cfg.mode == 2 else 0))


def check_operands(grid, cfg, c0, fc, aux, what: str = "extloop",
                   block: bool = False):
    """Validate the operands of an external-loop wrapper before any device
    dispatch; ``what`` names the wrapper in the errors.  The horizontal
    extents are the grid's, or with ``block`` the carry's own (R, L)."""
    el = c0[0]
    im, jm = el.shape if block else (cfg.im, cfg.jm)
    dtype, device = el.dtype, el.device
    if dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {dtype} not supported")
    if len(c0) != len(CARRY_FIELDS) or len(aux) != len(AUX_FIELDS):
        raise ValueError(f"{what}: carry or aux has the wrong length")
    named = (list(zip(CARRY_FIELDS, c0))
             + [(f, getattr(grid, f)) for f in GRID_FIELDS]
             + list(zip(AUX_FIELDS, aux))
             + [(f, getattr(fc, f)) for f in FC_2D_FIELDS])
    for name, x in named:
        if x.shape != (im, jm):
            raise ValueError(f"{what}: {name} is {tuple(x.shape)}, "
                             f"expected ({im}, {jm})")
    series = ([(f, getattr(fc, f), jm) for f in FC_1D_J]
              + [(f, getattr(fc, f), im) for f in FC_1D_I])
    for name, x, n in series:
        if x.shape != (n,):
            raise ValueError(f"{what}: {name} is {tuple(x.shape)}, "
                             f"expected ({n},)")
    if fc.ramp.numel() != 1:
        raise ValueError(f"{what}: ramp must be a scalar")
    for name, x in named + [(f, x) for f, x, _ in series] + [("ramp", fc.ramp)]:
        if x.dtype != dtype or x.device != device:
            raise TypeError(f"{what}: {name} differs in dtype or device")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def run_external_loop(grid, cfg, c0, fc, aux, threads=None):
    """All isplit substeps; CUDA tensors launch the persistent kernel (with
    ``threads`` per block, or as :func:`plan_grid` plans), CPU tensors run
    :func:`run_external_loop_plain`."""
    check_operands(grid, cfg, c0, fc, aux)
    device = c0[0].device
    if device.type == "cpu":
        return run_external_loop_plain(grid, cfg, c0, fc, aux)
    if device.type != "cuda":
        raise TypeError(f"extloop: unsupported device {device}")
    kernels.whole_grid_only(cfg, "extloop")
    return _launch(grid, cfg, c0, fc, aux, threads=threads)


def run_external_chunk(grid, cfg, c0, fc, aux, C: int, iext0: int, off,
                       threads=None):
    """Substeps iext0 .. iext0+C-1 on a ring-extended (R, L) block whose
    cell (0, 0) is global ``off``: every 2-D operand is (R, L), the j-side
    series (L,) and the i-side series (R,), ``cfg``'s active extents are
    the domain's.  Only the cells the ring covers come out right (the
    caller trims the rest).  CUDA tensors launch the kernel of
    ``csrc/extloop.cu`` built for blocks, CPU tensors run
    :func:`run_external_chunk_plain`."""
    check_chunk(grid, cfg, c0, fc, aux, C, iext0, off, "extchunk")
    if c0[0].device.type == "cpu":
        return run_external_chunk_plain(grid, cfg, c0, fc, aux, C, iext0,
                                        off)
    return _launch(grid, cfg, c0, fc, aux, (C, iext0, *off), threads)


def check_chunk(grid, cfg, c0, fc, aux, C, iext0, off, what):
    """Validate a chunk wrapper's operands (see :func:`run_external_chunk`)
    before any device dispatch."""
    check_operands(grid, cfg, c0, fc, aux, what, block=True)
    if not (1 <= iext0 and C >= 1 and iext0 + C - 1 <= cfg.isplit):
        raise ValueError(f"{what}: substeps {iext0}..{iext0 + C - 1} "
                         f"outside 1..{cfg.isplit}")
    if len(off) != 2 or not all(isinstance(o, int) for o in off):
        raise TypeError(f"{what}: off must be two ints")
    device = c0[0].device
    if device.type not in ("cpu", "cuda"):
        raise TypeError(f"{what}: unsupported device {device}")


def block_threads(cells: int, sms: int) -> int:
    """Threads of a block: the fewest (whole warps) with which one block
    per SM covers ``cells`` cells, at most ``MAX_THREADS``.  Fewer blocks
    pass a grid barrier sooner, and one block per SM spreads the cells
    over the card (``tools/extloop_sweep.py --threads``; PERF.md §6)."""
    return min(MAX_THREADS, 32 * -(-cells // (32 * sms)))


def persistent_grid(cells: int, threads: int, blocks_per_sm: int,
                    sms: int) -> int:
    """Blocks of a cooperative launch over ``cells`` cells: as many as the
    card holds at once, and no more than one cell per thread needs; the
    blocks visit the cells grid-stride."""
    if blocks_per_sm < 1:
        raise RuntimeError(f"extloop: a block of {threads} threads does not "
                           f"fit an SM")
    return min(blocks_per_sm * sms, -(-cells // threads))


@functools.lru_cache(maxsize=None)
def _loop_info(f64: bool, block: bool, threads: int, index: int,
               flags: int) -> tuple:
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(index):
        status = build.library().extpom_extloop_info(
            int(f64), int(block), flags, threads,
            ctypes.cast(out, ctypes.c_void_p))
    build.check(status, "extloop info")
    return tuple(zip(("registers", "static_smem", "dynamic_smem",
                      "blocks_per_sm", "spill_bytes", "sms"), out))


def _index(device) -> int:
    device = torch.device("cuda" if device is None else device)
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def loop_info(dtype: torch.dtype, block: bool, threads: int,
              device=None, flags: int = 0) -> dict:
    """What the compiler and the card give ``k_extloop`` (the block variant
    with ``block``, the options ``flags`` of :func:`ext_flags`) at
    ``threads`` threads per block: registers per thread, static and dynamic
    shared bytes, resident blocks per SM, spill bytes per thread and the
    SMs of the card.  Builds the kernels; needs a CUDA device."""
    return dict(_loop_info(dtype == torch.float64, block, threads,
                           _index(device), flags))


def plan_grid(dtype: torch.dtype, cells: int, block: bool = False,
              device=None, threads=None, flags: int = 0) -> tuple:
    """(threads, blocks) of the launch over ``cells`` cells: ``threads``
    per block, or :func:`block_threads`; the blocks from
    :func:`persistent_grid` for the kernel of the options ``flags``."""
    index = _index(device)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    threads = threads or block_threads(cells, sms)
    info = loop_info(dtype, block, threads, index, flags)
    return threads, persistent_grid(cells, threads, info["blocks_per_sm"],
                                    info["sms"])


def device_launches() -> int:
    """Kernels launched by the external-loop entry points of the library
    so far (one per call of either wrapper)."""
    return build.library().extpom_extloop_launches()


def _launch(grid, cfg, c0, fc, aux, chunk=None, threads=None):
    """Launch the whole loop, or with ``chunk`` = (C, iext0, oi, oj) the
    block variant (``extpom_extchunk_*``)."""
    from extpom_tpu_torch.core.stepper import ExtCarry
    el = c0[0]
    R, L = el.shape
    # the kernel updates the carry in place: work on a fresh copy so the
    # caller's state tensors are left as they were
    carry = torch.stack(list(c0))
    scratch = torch.empty((N_SCRATCH, R, L), dtype=el.dtype,
                          device=el.device)
    tensors = (list(carry)
               + [getattr(grid, f) for f in GRID_FIELDS]
               + list(aux)
               + [getattr(fc, f) for f in FC_2D_FIELDS + FC_1D_J + FC_1D_I]
               + [fc.ramp]
               + list(scratch))
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    prm = (ctypes.c_double * 9)(cfg.dte, cfg.grav, cfg.smoth, cfg.alpha,
                                float(cfg.isplit), cfg.rfe, cfg.rfw,
                                cfg.rfn, cfg.rfs)
    lib = build.library()
    suffix = "f32" if el.dtype == torch.float32 else "f64"
    name = "extloop" if chunk is None else "extchunk"
    fn = getattr(lib, f"extpom_{name}_{suffix}")
    block = () if chunk is None else (R, L, *chunk)
    flags = ext_flags(cfg)
    threads, blocks = plan_grid(el.dtype, R * L, chunk is not None,
                                el.device, threads, flags)
    stream = torch.cuda.current_stream(el.device).cuda_stream
    with torch.cuda.device(el.device):
        status = fn(ctypes.cast(ptrs, ctypes.c_void_p),
                    ctypes.cast(prm, ctypes.c_void_p),
                    *cfg.active, *block, cfg.isplit, cfg.ispadv,
                    flags,
                    threads, blocks, stream)
    build.check(status, f"{name} kernel")
    kernels.LAUNCHES[name] += 1
    return ExtCarry(*carry.unbind(0))


def barrier_floor(device, threads: int, blocks: int, n: int,
                  counter: torch.Tensor | None = None) -> None:
    """Launch the empty persistent kernel of ``csrc/extloop.cu`` that only
    passes ``n`` grid-wide barriers on ``blocks`` blocks of ``threads``:
    cooperative_groups' grid sync, or with ``counter`` (one zeroed int32 on
    the card) the hand-written barrier."""
    lib = build.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    ptr = 0 if counter is None else counter.data_ptr()
    with torch.cuda.device(device):
        status = lib.extpom_extloop_floor(threads, blocks, n,
                                          int(counter is not None), ptr,
                                          stream)
    build.check(status, "barrier floor")
