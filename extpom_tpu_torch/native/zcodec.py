"""ctypes binding of ``zcodec.cpp``, the blosc1/LZ4 chunk decoder of the
Zarr store (``io/zarr.py``).

The library is built from the source beside this file with ``g++`` into
the repository's git-ignored ``build/native/`` at first use
(``native.build_library``); nothing builds at import.
:func:`decode` checks a frame's header here, and raises
``NotImplementedError`` naming a codec or flag the decoder does not
implement (any codec but LZ4, bitshuffle) before the library is asked.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from extpom_tpu_torch.native import BUILD, build_library

SRC = Path(__file__).resolve().with_name("zcodec.cpp")
LIB = BUILD / "libzcodec.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
# the codec of a frame, flags >> 5 (blosc.h's *_FORMAT numbers)
CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
MEMCPYED, BITSHUFFLE = 0x02, 0x04

_lib = None


def _build() -> Optional[Path]:
    return build_library(SRC, LIB, CXX_FLAGS)


def get_lib():
    global _lib
    if _lib is None:
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.zc_blosc_decode.restype = ctypes.c_int64
        lib.zc_blosc_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        _lib = lib
    return _lib


def header(frame: bytes) -> tuple:
    """(flags, typesize, nbytes, blocksize, cbytes) of a blosc1 frame."""
    if len(frame) < 16:
        raise ValueError(f"a blosc frame of {len(frame)} bytes")
    return (frame[2], frame[3]) + struct.unpack_from("<III", frame, 4)


def decode(frame: bytes, nbytes: int, where: str = "chunk") -> np.ndarray:
    """The ``nbytes`` bytes (uint8) that the blosc1 ``frame`` holds."""
    flags, _, size, _, _ = header(frame)
    if not flags & MEMCPYED:
        codec = CODECS.get(flags >> 5, f"codec {flags >> 5}")
        if codec != "lz4":
            raise NotImplementedError(
                f"{where}: blosc cname {codec!r}; the store decodes lz4 only")
        if flags & BITSHUFFLE:
            raise NotImplementedError(
                f"{where}: blosc bitshuffle; the store decodes byte shuffle "
                f"or none")
    if size != nbytes:
        raise ValueError(f"{where}: a blosc frame of {size} bytes where the "
                         f"chunk holds {nbytes}")
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"{where} is blosc-compressed, and the decoder "
                           f"{SRC.name} cannot be built (no g++?)")
    out = np.empty(nbytes, np.uint8)
    rc = lib.zc_blosc_decode(frame, len(frame),
                             out.ctypes.data_as(ctypes.c_void_p), nbytes)
    if rc != nbytes:
        raise ValueError(f"{where}: a malformed blosc frame (code {rc})")
    return out
