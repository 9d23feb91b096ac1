"""ctypes binding of the native record store ``native/recordio.cpp``
(``extpom_tpu/native/recordio.py``).

:class:`NativeRecordSource` is a forcing record source over a directory of
``.efr`` files (one per series; mmap'd, with the time interpolation fused
in C++ and the next record prefetched by the OS); :func:`write_records`
writes such files.  The library is built from the repository's
``native/recordio.cpp`` with ``g++`` into ``build/native/`` at first use
(``-ffp-contract=off``, so the fused interpolation rounds as numpy's).

File format "EFR1": [magic u32][dtype u32: 0=f32 1=f64][ndim u32]
[shape u64 x ndim, shape[0] = nrec][raw C-order data].
"""

from __future__ import annotations

import ctypes
import os
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from extpom_tpu_torch.native import BUILD, build_library

_MAGIC = 0x31524645
ROOT = Path(__file__).resolve().parent.parent.parent
SRC = ROOT / "native" / "recordio.cpp"
LIB = BUILD / "librecordio.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared",
             "-ffp-contract=off"]

_lib = None


def _build() -> Optional[Path]:
    return build_library(SRC, LIB, CXX_FLAGS)


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.efr_open.restype = ctypes.c_void_p
    lib.efr_open.argtypes = [ctypes.c_char_p]
    lib.efr_info.restype = ctypes.c_int
    lib.efr_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                             ctypes.POINTER(ctypes.c_uint64),
                             ctypes.POINTER(ctypes.c_int)]
    lib.efr_read.restype = ctypes.c_int
    lib.efr_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                             ctypes.c_void_p]
    lib.efr_interp.restype = ctypes.c_int
    lib.efr_interp.argtypes = [ctypes.c_void_p, ctypes.c_double,
                               ctypes.c_void_p, ctypes.c_int]
    lib.efr_close.restype = None
    lib.efr_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def write_records(root: str, data: Dict[str, np.ndarray]) -> None:
    """Write one EFR file per variable (record dimension leading)."""
    os.makedirs(root, exist_ok=True)
    for name, arr in data.items():
        a = np.ascontiguousarray(arr)
        if a.dtype != np.float32:
            a = a.astype(np.float64)
        code = 0 if a.dtype == np.float32 else 1
        with open(os.path.join(root, name + ".efr"), "wb") as f:
            f.write(struct.pack("<III", _MAGIC, code, a.ndim))
            f.write(struct.pack(f"<{a.ndim}Q", *a.shape))
            f.write(a.tobytes())


class NativeRecordSource:
    """mmap-backed record source with the provider's protocol and a fused
    C++ ``interp`` (hold-last at the series' end)."""

    def __init__(self, root: str, nthreads: int = 4):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError(
                f"{root} holds EFR records but the record store cannot be "
                f"built (no g++ or no native/recordio.cpp)")
        self.root = root
        self.nthreads = nthreads
        self._handles: Dict[str, int] = {}
        self._meta: Dict[str, tuple] = {}
        for fn in sorted(os.listdir(root)):
            if not fn.endswith(".efr"):
                continue
            path = os.path.join(root, fn)
            h = self.lib.efr_open(path.encode())
            if not h:
                raise IOError(f"bad EFR file {path}")
            nrec, ne, dt = (ctypes.c_uint64(), ctypes.c_uint64(),
                            ctypes.c_int())
            self.lib.efr_info(h, ctypes.byref(nrec), ctypes.byref(ne),
                              ctypes.byref(dt))
            with open(path, "rb") as f:
                _, _, ndim = struct.unpack("<III", f.read(12))
                shape = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
            self._handles[fn[:-4]] = h
            self._meta[fn[:-4]] = (int(nrec.value), shape[1:],
                                   np.float32 if dt.value == 0
                                   else np.float64)

    def names(self):
        return list(self._handles)

    def nrec(self, name: str) -> int:
        return self._meta[name][0]

    def read(self, name: str, n: int) -> np.ndarray:
        nrec, shape, dtype = self._meta[name]
        out = np.empty(shape, dtype)
        rc = self.lib.efr_read(self._handles[name], min(max(n, 0), nrec - 1),
                               out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise IOError(f"EFR read of {name!r} record {n} failed")
        return out

    def interp(self, name: str, x: float) -> np.ndarray:
        """(1-frac)*rec[n] + frac*rec[n+1] for x = n + frac, in C++."""
        _, shape, dtype = self._meta[name]
        out = np.empty(shape, dtype)
        rc = self.lib.efr_interp(self._handles[name], float(x),
                                 out.ctypes.data_as(ctypes.c_void_p),
                                 self.nthreads)
        if rc != 0:
            raise IOError(f"EFR interpolation of {name!r} failed")
        return out

    def close(self):
        handles = getattr(self, "_handles", {})     # none if __init__ raised
        for h in handles.values():
            self.lib.efr_close(h)
        handles.clear()

    __del__ = close
