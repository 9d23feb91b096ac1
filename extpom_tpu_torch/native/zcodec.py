"""ctypes binding of ``zcodec.cpp``, the blosc1/LZ4 chunk codec of the
Zarr store (``io/zarr.py``).

The library is built from the source beside this file with ``g++`` into
the repository's git-ignored ``build/native/`` at first use
(``native.build_library``); nothing builds at import.  Where it cannot be
built, :func:`encode` and :func:`decode` raise ``RuntimeError``: nothing
falls back to raw chunks.

* :func:`encode` writes one frame as c-blosc writes tensorstore's default
  compressor (lz4, clevel 5, byte shuffle wherever the type is wider than
  a byte: a reader takes the shuffle from the frame), its blocks on
  several threads;
  ctypes releases the GIL for the call, so a writer thread encodes while
  the caller's thread runs.  :data:`ENCODED` sums the calls' seconds and
  bytes.
* :func:`decode` checks a frame's header here, and raises
  ``NotImplementedError`` naming a codec or flag the decoder does not
  implement (any codec but LZ4, bitshuffle) before the library is asked.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from extpom_tpu_torch.native import BUILD, build_library

SRC = Path(__file__).resolve().with_name("zcodec.cpp")
LIB = BUILD / "libzcodec.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]
# the codec of a frame, flags >> 5 (blosc.h's *_FORMAT numbers)
CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
MEMCPYED, BITSHUFFLE = 0x02, 0x04
HEADER = 16
# blosc1's largest buffer (BLOSC_MAX_BUFFERSIZE)
MAX_NBYTES = 2**31 - 1 - HEADER
# threads per encode: half the host's cores, the rest left to the threads
# that step the model
THREADS = max(1, (os.cpu_count() or 2) // 2)

_lib = None


class Encoded:
    """What :func:`encode` did in this process: frames, seconds in the
    library, raw bytes in and frame bytes out, summed over the calling
    threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.frames, self.seconds = 0, 0.0
        self.raw_bytes = self.frame_bytes = 0

    def add(self, seconds: float, raw: int, frame: int) -> None:
        with self._lock:
            self.frames += 1
            self.seconds += seconds
            self.raw_bytes += raw
            self.frame_bytes += frame

    def totals(self) -> tuple:
        """(frames, seconds, raw bytes, frame bytes)."""
        with self._lock:
            return (self.frames, self.seconds, self.raw_bytes,
                    self.frame_bytes)


ENCODED = Encoded()


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
        lib.zc_blosc_bound.restype = ctypes.c_size_t
        lib.zc_blosc_bound.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.zc_blosc_encode.restype = ctypes.c_int64
        lib.zc_blosc_encode.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_size_t, ctypes.c_void_p,
                                        ctypes.c_size_t, ctypes.c_int]
        _lib = lib
    return _lib


def header(frame: bytes) -> tuple:
    """(flags, typesize, nbytes, blocksize, cbytes) of a blosc1 frame."""
    if len(frame) < 16:
        raise ValueError(f"a blosc frame of {len(frame)} bytes")
    return (frame[2], frame[3]) + struct.unpack_from("<III", frame, 4)


def encode(buf, typesize: int, threads: int = THREADS) -> bytes:
    """The bytes of ``buf`` (any C-contiguous buffer) as one blosc1 frame:
    LZ4 blocks of elements of ``typesize`` bytes, byte-shuffled, encoded on
    up to ``threads`` threads (the frame is the same for any number)."""
    src = np.frombuffer(memoryview(buf).cast("B"), np.uint8)
    if not 1 <= typesize <= 255:
        raise ValueError(f"a blosc typesize of {typesize}")
    if src.size > MAX_NBYTES:
        raise ValueError(f"a blosc frame of {src.size} bytes; blosc1 holds "
                         f"at most {MAX_NBYTES}")
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"a blosc chunk cannot be written: the encoder "
                           f"{SRC.name} cannot be built (no g++?)")
    out = np.empty(lib.zc_blosc_bound(src.size, typesize), np.uint8)
    t0 = time.perf_counter()
    rc = lib.zc_blosc_encode(src.ctypes.data_as(ctypes.c_void_p), src.size,
                             typesize, out.ctypes.data_as(ctypes.c_void_p),
                             out.size,
                             threads)
    if rc < 0:
        raise RuntimeError(f"blosc encoder failed (code {rc})")
    ENCODED.add(time.perf_counter() - t0, src.size, rc)
    return out[:rc].tobytes()


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
