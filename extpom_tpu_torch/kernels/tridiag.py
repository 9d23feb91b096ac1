"""Vertical Thomas solve: the CUDA kernel ``csrc/tridiag.cu`` (the
counterpart of ``extpom_tpu/pallas/tridiag.py:_kernel``) and its plain
PyTorch version.

One solve: forward elimination from the seeds ``ee0``/``gg0`` at ``k0-1``,
the closed-form bottom row

    f[k_last] = (cl gg[k_last-1] + rb) / (cl (1 - ee[k_last-1]) + db) * mask,

back substitution to k=0 with every level times ``mask`` (0/1, so this
equals masking once at the end), and rows > ``k_last`` zero.  3-D operands
are (kb, im, jm); 2-D operands are anything that broadcasts to (im, jm).
The kernel reads a 2-D operand where the caller keeps it, through its
strides (0 along a broadcast axis), and keeps its elimination stacks in
shared memory: a launch allocates its output and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch

from extpom_tpu_torch import kernels
from extpom_tpu_torch.kernels import build

_DTYPES = (torch.float32, torch.float64)


def _forward(a, c, den, r, ee0, gg0, k0: int):
    """Forward elimination: for k >= k0,
    g = 1/(a[k] + c[k]*(1-ee[k-1]) - den[k]); ee[k] = a[k]*g;
    gg[k] = (r[k] + c[k]*gg[k-1]) * g, with ee[k0-1]=ee0, gg[k0-1]=gg0.
    Returns full-kb (ee, gg) stacks; rows below k0-1 are zero."""
    ee, gg = ee0, gg0
    ee_l, gg_l = [], []
    for k in range(k0, a.shape[0]):
        g_ = 1.0 / (a[k] + c[k] * (1.0 - ee) - den[k])
        ee = a[k] * g_
        gg = (r[k] + c[k] * gg) * g_
        ee_l.append(ee)
        gg_l.append(gg)
    lead_e = [torch.zeros_like(ee0)] * (k0 - 1) + [ee0]
    lead_g = [torch.zeros_like(gg0)] * (k0 - 1) + [gg0]
    return torch.stack(lead_e + ee_l, dim=0), torch.stack(lead_g + gg_l, dim=0)


def _backward(ee, gg, f_last, k_last: int):
    """Back substitution f[k] = ee[k]*f[k+1] + gg[k] for k = k_last-1..0,
    seeded with f[k_last] = f_last.  Returns the stack f[0..k_last]."""
    f, fs = f_last, []
    for k in range(k_last - 1, -1, -1):
        f = ee[k] * f + gg[k]
        fs.append(f)
    return torch.stack(fs[::-1] + [f_last], dim=0)


def thomas_plain(a, c, den, rhs, ee0, gg0, cl, rb, db, mask,
                 k0: int, k_last: int) -> torch.Tensor:
    """The solve in plain PyTorch (``extpom_tpu/ops/vertical.py:_solve``'s
    scan pair)."""
    kb = a.shape[0]
    ee, gg = _forward(a, c, den, rhs, ee0, gg0, k0)
    f_last = ((cl * gg[k_last - 1] + rb)
              / (cl * (1.0 - ee[k_last - 1]) + db))
    f = _backward(ee, gg, f_last, k_last) * mask
    if k_last + 1 < kb:
        f = torch.cat([f, torch.zeros((kb - k_last - 1,) + f.shape[1:],
                                      dtype=f.dtype, device=f.device)], dim=0)
    return f


def _check(a, c, den, rhs, ee0, gg0, cl, rb, db, mask, k0, k_last):
    """Validate operands; returns (3-D tuple, 2-D tuple broadcast to
    (im, jm))."""
    three = (a, c, den, rhs)
    if not all(isinstance(x, torch.Tensor) for x in three):
        raise TypeError("thomas: a, c, den, rhs must be tensors")
    if a.dim() != 3:
        raise ValueError(f"thomas: a must be (kb, im, jm), got {tuple(a.shape)}")
    kb, im, jm = a.shape
    dtype, device = a.dtype, a.device
    if dtype not in _DTYPES:
        raise TypeError(f"thomas: dtype {dtype} not supported")
    for x in three:
        if x.shape != a.shape:
            raise ValueError(f"thomas: 3-D operand {tuple(x.shape)} != "
                             f"{tuple(a.shape)}")
        if x.dtype != dtype or x.device != device:
            raise TypeError("thomas: operands differ in dtype or device")
        if not x.is_contiguous():
            raise ValueError("thomas: 3-D operands must be contiguous")
    if not 1 <= k0 < k_last <= kb - 1:
        raise ValueError(f"thomas: need 1 <= k0 < k_last <= kb-1, got "
                         f"k0={k0} k_last={k_last} kb={kb}")
    two = []
    for x in (ee0, gg0, cl, rb, db, mask):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(x, dtype=dtype, device=device)
        if x.dtype != dtype or x.device != device:
            raise TypeError("thomas: operands differ in dtype or device")
        try:
            x = torch.broadcast_to(x, (im, jm))
        except RuntimeError:
            raise ValueError(f"thomas: 2-D operand {tuple(x.shape)} does not "
                             f"broadcast to ({im}, {jm})") from None
        two.append(x)
    return three, tuple(two)


def thomas(a, c, den, rhs, ee0, gg0, cl, rb, db, mask,
           k0: int, k_last: int) -> torch.Tensor:
    """One vertical Thomas solve; CUDA tensors launch the kernel, CPU
    tensors run :func:`thomas_plain`."""
    three, two = _check(a, c, den, rhs, ee0, gg0, cl, rb, db, mask, k0,
                        k_last)
    if a.device.type == "cpu":
        return thomas_plain(*three, *two, k0, k_last)
    if a.device.type != "cuda":
        raise TypeError(f"thomas: unsupported device {a.device}")
    return _launch(three, two, k0, k_last)


SM_SMEM = 233_472      # shared memory of an SM on Hopper (228 KB)
BLOCK_SMEM = 232_448   # ... of which one block may use (227 KB)
SMEM_RESERVED = 1_024  # the runtime's share of each resident block
THREADS = (256, 128, 64, 32)


@functools.lru_cache(maxsize=None)
def ring_levels() -> int:
    """Levels of the coefficient ring of ``csrc/tridiag.cu`` (kStages)."""
    src = (build.CSRC / "tridiag.cu").read_text()
    return int(re.search(r"constexpr int kStages = (\d+);", src).group(1))


def smem_bytes(kb: int, dtype: torch.dtype, threads: int) -> int:
    """Shared bytes of a block of ``threads`` columns: ee and gg, kb rows
    each, and the ring of four coefficients (the kernel's smem_elems)."""
    item = torch.finfo(dtype).bits // 8
    return (2 * kb + 4 * ring_levels()) * threads * item


def block_threads(kb: int, dtype: torch.dtype) -> int:
    """Threads per block of the kernel: the most of :data:`THREADS` with
    which two blocks fit an SM's shared memory, else one that fits a block.
    Raises ValueError where the stacks of 32 columns do not fit."""
    for blocks in (2, 1):
        for t in THREADS:
            smem = smem_bytes(kb, dtype, t)
            if (smem <= BLOCK_SMEM
                    and blocks * (smem + SMEM_RESERVED) <= SM_SMEM):
                return t
    raise ValueError(f"thomas: the elimination stacks of kb={kb} in {dtype} "
                     f"do not fit a block's shared memory")


def operand_table(three, two, out) -> tuple:
    """(pointers, strides) of a launch: a, c, den, rhs, the six 2-D
    operands and ``out`` by address, and each 2-D operand's element
    strides along i and j, 0 along an axis it is broadcast on (the views
    ``_check`` made, which share the caller's memory)."""
    ptrs = [x.data_ptr() for x in (*three, *two, out)]
    strides = [s for x in two for s in x.stride()]
    return ptrs, strides


def _launch(three, two, k0, k_last):
    a = three[0]
    kb, im, jm = a.shape
    out = torch.empty_like(a)
    ptrs, strides = operand_table(three, two, out)
    lib = build.library()
    fn = lib.extpom_tridiag_f32 if a.dtype == torch.float32 \
        else lib.extpom_tridiag_f64
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        status = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
                    (ctypes.c_longlong * len(strides))(*strides), kb, im, jm,
                    k0, k_last, block_threads(kb, a.dtype), stream)
    build.check(status, "tridiag kernel")
    kernels.LAUNCHES["tridiag"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _info(f64: bool, threads: int, kb: int, device: int) -> dict:
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        status = build.library().extpom_tridiag_info(
            int(f64), threads, kb, ctypes.cast(out, ctypes.c_void_p))
    build.check(status, "tridiag info")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "blocks_per_sm", "spill_bytes", "sms"), out))


def kernel_info(kb: int, dtype: torch.dtype, device=None) -> dict:
    """The threads per block of a launch at ``kb`` levels in ``dtype`` and
    what the compiler and the card give the kernel there: registers,
    static and dynamic shared bytes, resident blocks per SM, spill bytes,
    SMs.  Builds the kernels; needs a CUDA device."""
    device = torch.device("cuda" if device is None else device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    threads = block_threads(kb, dtype)
    return dict(threads=threads, **_info(dtype == torch.float64, threads, kb,
                                         index))
