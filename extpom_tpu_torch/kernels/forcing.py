"""The forcing of one internal step on the card: the CUDA kernel
``csrc/forcing.cu`` (``k_forcing_interp``) behind
``forcing/device.py:forcing_at``.

One launch forms every interpolated series of the step from its two staged
records and weights (:func:`rows`: the records by pointer, in the plan's
order), each into a contiguous output of its own, and the four barotropic
edge values, each edge profile's interpolation depth-integrated in
ascending k; it counts one in ``kernels.LAUNCHES["forcing"]``.  A
piecewise-constant series stays a view of its record.  The plain version
is ``forcing/device.py:forcing_at_plain``, which the CPU runs and which
the kernel equals bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from extpom_tpu_torch import kernels
from extpom_tpu_torch.forcing import provider as prov
from extpom_tpu_torch.kernels import build


def rows(picks: list, kbm1: int) -> list:
    """The kernel's table for ``picks`` (``forcing/device.py:picks``):
    (output name, pick, levels) of every interpolated series in their
    order, levels 0, then of each side whose normal profile is staged
    (always interpolated) its barotropic value, the profile integrated over
    ``kbm1`` levels, in ``BRY_SIDES`` order."""
    table = [(p.name, p, 0) for p in picks if p.f is not None]
    interp = {p.name: p for _, p, _ in table}
    for side in prov.BRY_SIDES:
        un, tn = prov.barotropic_name(side)
        if un in interp:
            table.append((tn, interp[un], kbm1))
    return table


@functools.lru_cache(maxsize=None)
def _info(f64: bool, device: int) -> dict:
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        status = build.library().extpom_forcing_info(
            int(f64), ctypes.cast(out, ctypes.c_void_p))
    build.check(status, "forcing info")
    return dict(zip(("threads", "entries", "registers", "static_smem",
                     "dynamic_smem", "blocks_per_sm", "spill_bytes", "sms"),
                    out))


def kernel_info(dtype: torch.dtype, device=None) -> dict:
    """What the compiler and the card give ``k_forcing_interp`` in
    ``dtype``: threads per block, table entries per launch, registers,
    static and dynamic shared bytes, resident blocks per SM, spill bytes,
    SMs.  Builds the kernels; needs a CUDA device."""
    device = torch.device("cuda" if device is None else device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _info(dtype == torch.float64, index)


def launch(picks: list, dz: Optional[torch.Tensor], kbm1: int) -> dict:
    """One launch of ``k_forcing_interp`` over the :func:`rows` of
    ``picks`` (at most ``kernel_info()["entries"]``): output name -> its
    new tensor.  Raises where a record or ``dz`` is of another dtype or
    device than the first record, or the dtype is neither float32 nor
    float64."""
    table = rows(picks, kbm1)
    if not table:
        return {}
    x = table[0][1].b
    if x.device.type != "cuda" or x.dtype not in (torch.float32,
                                                  torch.float64):
        raise TypeError(f"forcing kernel: records of {x.dtype} on "
                        f"{x.device}; it takes float32 or float64 on a "
                        f"CUDA device")
    out, ptrs, ns, ws, levels = {}, [], [], [], []
    for name, p, lev in table:
        for r in (p.b, p.f):
            if r.dtype != x.dtype or r.device != x.device:
                raise TypeError(f"forcing kernel: a record of {p.name} is "
                                f"{r.dtype} on {r.device}, not {x.dtype} "
                                f"on {x.device}")
        if p.b.shape != p.f.shape or not (p.b.is_contiguous()
                                          and p.f.is_contiguous()):
            raise ValueError(f"forcing kernel: records of {p.name} differ "
                             f"in shape or are not contiguous")
        if lev:
            if p.b.dim() != 2 or not 1 <= lev <= p.b.shape[0]:
                raise ValueError(f"forcing kernel: {name} integrates "
                                 f"{lev} levels of {tuple(p.b.shape)}")
            o = torch.empty(p.b.shape[1:], dtype=x.dtype, device=x.device)
        else:
            o = torch.empty_like(p.b)
        out[name] = o
        ptrs += [p.b.data_ptr(), p.f.data_ptr(), o.data_ptr()]
        ns.append(o.numel())
        ws += [p.w0, p.w1]
        levels.append(lev)
    if any(levels):
        if dz is None or dz.dtype != x.dtype or dz.device != x.device:
            raise TypeError(f"forcing kernel: the edge integrals need dz "
                            f"in {x.dtype} on {x.device}")
        dz = dz.contiguous()
    lib = build.library()
    fn = lib.extpom_forcing_f32 if x.dtype == torch.float32 \
        else lib.extpom_forcing_f64
    with torch.cuda.device(x.device):
        status = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
                    (ctypes.c_longlong * len(ns))(*ns),
                    (ctypes.c_double * len(ws))(*ws),
                    (ctypes.c_int * len(levels))(*levels), len(table),
                    dz.data_ptr() if any(levels) else None,
                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "forcing kernel")
    kernels.LAUNCHES["forcing"] += 1
    return out


def interpolate(picks: list, dz: torch.Tensor, kbm1: int) -> dict:
    """The Forcing fields of the step from ``picks``
    (``forcing/device.py:picks``): name -> tensor, the interpolated series
    and the barotropic edge values from one launch, a piecewise-constant
    series its record."""
    return {**{p.name: p.b for p in picks if p.f is None},
            **launch(picks, dz, kbm1)}
