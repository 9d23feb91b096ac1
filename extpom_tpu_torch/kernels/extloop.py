"""External-mode loop: the CUDA kernel chain ``csrc/extloop.cu`` (the
counterpart of ``extpom_tpu/pallas/extloop.py:_kernel``) and its plain
PyTorch version, the Python loop over ``stepper.mode_external_substep``.

One call runs all ``isplit`` substeps of an internal step and returns the
final :class:`~extpom_tpu_torch.core.stepper.ExtCarry`.
"""

from __future__ import annotations

import ctypes

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

_DTYPES = (torch.float32, torch.float64)


def run_external_loop_plain(grid, cfg, c0, fc, aux):
    """All isplit substeps in plain PyTorch."""
    from extpom_tpu_torch.core import stepper
    em = stepper.ext_precompute(grid)
    c = c0
    for iext in range(1, cfg.isplit + 1):
        c = stepper.mode_external_substep(grid, cfg, c, iext, fc, aux, em=em)
    return c


def check_operands(grid, cfg, c0, fc, aux, what: str = "extloop"):
    """Validate the operands of an external-loop wrapper before any device
    dispatch; ``what`` names the wrapper in the errors."""
    im, jm = cfg.im, cfg.jm
    el = c0[0]
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


def run_external_loop(grid, cfg, c0, fc, aux):
    """All isplit substeps; CUDA tensors launch the kernel chain, CPU
    tensors run :func:`run_external_loop_plain`."""
    check_operands(grid, cfg, c0, fc, aux)
    device = c0[0].device
    if device.type == "cpu":
        return run_external_loop_plain(grid, cfg, c0, fc, aux)
    if device.type != "cuda":
        raise TypeError(f"extloop: unsupported device {device}")
    if cfg.mode == 2:
        raise NotImplementedError("extloop kernel: mode=2 is not ported yet")
    if cfg.bc_scheme == "orlanski":
        raise NotImplementedError("extloop kernel: bc_scheme='orlanski' "
                                  "(orl_el/orl_vel2d) is not ported yet")
    return _launch(grid, cfg, c0, fc, aux)


def _launch(grid, cfg, c0, fc, aux):
    from extpom_tpu_torch.core.stepper import ExtCarry
    el = c0[0]
    im, jm = cfg.im, cfg.jm
    # the kernel updates the carry in place: work on a fresh copy so the
    # caller's state tensors are left as they were
    carry = torch.stack(list(c0))
    scratch = torch.empty((N_METRICS + N_SUBSTEP, im, jm), dtype=el.dtype,
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
    fn = lib.extpom_extloop_f32 if el.dtype == torch.float32 \
        else lib.extpom_extloop_f64
    stream = torch.cuda.current_stream(el.device).cuda_stream
    with torch.cuda.device(el.device):
        status = fn(ctypes.cast(ptrs, ctypes.c_void_p),
                    ctypes.cast(prm, ctypes.c_void_p),
                    im, jm, cfg.isplit, cfg.ispadv, stream)
    build.check(status, "extloop kernel")
    kernels.LAUNCHES["extloop"] += 1
    return ExtCarry(*carry.unbind(0))
