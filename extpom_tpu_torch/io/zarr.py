"""A Zarr v2 array store on the local file system (numpy, json and os).

An array is a directory holding ``.zarray`` (its metadata, JSON) and one
file per chunk, named by the chunk's indices joined by ``.`` (``i.j.k``).
The store reads and writes the stores of tensorstore's ``zarr`` driver,
which the JAX package writes, so either side reads the other's:

* :meth:`Array.create` writes ``.zarray`` as tensorstore writes it by
  default (:data:`BLOSC`: blosc1, lz4, clevel 5, byte shuffle; fill value
  null), byte for byte; ``compressor=None`` writes a raw store instead.
  Creating an array deletes the chunk files already in its directory
  (tensorstore's ``delete_existing``), so no stale chunk outlives a re-run.
* :meth:`Array.write` writes whole chunks only (an edge chunk full-size,
  padded with the fill value): each chunk is encoded as one blosc1 frame
  by ``native/zcodec.cpp`` (or kept raw in a raw store), written whole to a
  temporary name in its directory, then renamed into place.  Writers of
  disjoint chunks therefore never touch one file, which the cooperative
  writes of several processes (``io/zarrstore.py``) rely on.  Where the
  encoder cannot be built, a write to a blosc store raises; nothing writes
  raw chunks in its place.
* :meth:`Array.read` returns any hyperslab, across any chunk grid.  A
  missing chunk reads as the fill value (0 under ``null``, as tensorstore
  reads it).  Chunks are raw, or blosc1 frames with ``cname`` ``lz4`` and
  byte shuffle or none (tensorstore's default compressor), decoded by
  ``native/zcodec.cpp``.  Any other compressor, a filter or Fortran order
  raises ``NotImplementedError`` naming it; nothing falls back to another
  format or library.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import threading
from typing import Optional, Sequence

import numpy as np

ZARRAY = ".zarray"
# tensorstore's default compressor entry, which the JAX package's stores hold
BLOSC = {"blocksize": 0, "clevel": 5, "cname": "lz4", "id": "blosc",
         "shuffle": -1}
_CHUNK_KEY = re.compile(r"^\d+(\.\d+)*$")
_TMP_PREFIX = ".tmp-"


def _write_file(path: str, data) -> None:
    """``data`` (bytes-like) as the file ``path``: written whole under a
    temporary name in its directory (this process's and thread's), then
    renamed into place."""
    d, base = os.path.split(path)
    tmp = os.path.join(d, f"{_TMP_PREFIX}{base}.{os.getpid()}."
                          f"{threading.get_ident()}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class Array:
    """One Zarr v2 array at ``path`` (a directory with ``.zarray``)."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, ZARRAY)) as f:
            meta = json.load(f)
        if meta.get("zarr_format") != 2:
            raise NotImplementedError(
                f"{path}: zarr_format {meta.get('zarr_format')!r}; the store "
                f"reads Zarr v2")
        if meta.get("order", "C") != "C":
            raise NotImplementedError(f"{path}: order {meta['order']!r}; the "
                                      f"store reads C order")
        if meta.get("filters"):
            raise NotImplementedError(f"{path}: filters {meta['filters']!r}; "
                                      f"the store reads none")
        if meta.get("dimension_separator", ".") != ".":
            raise NotImplementedError(
                f"{path}: dimension_separator "
                f"{meta['dimension_separator']!r}; the store reads '.'")
        comp = meta.get("compressor")
        if comp is not None:
            if comp.get("id") != "blosc":
                raise NotImplementedError(
                    f"{path}: compressor {comp.get('id')!r}; the store reads "
                    f"raw chunks and blosc lz4")
            if comp.get("cname") != "lz4":
                raise NotImplementedError(
                    f"{path}: blosc cname {comp.get('cname')!r}; the store "
                    f"decodes lz4 only")
            if comp.get("shuffle", -1) == 2:
                raise NotImplementedError(
                    f"{path}: blosc bitshuffle (shuffle 2); the store decodes "
                    f"byte shuffle or none")
        self.blosc = comp is not None
        self.shape = tuple(int(n) for n in meta["shape"])
        self.chunks = tuple(int(n) for n in meta["chunks"])
        if len(self.chunks) != len(self.shape):
            raise ValueError(f"{path}: chunks {self.chunks} for shape "
                             f"{self.shape}")
        self.dtype = np.dtype(meta["dtype"])
        fill = meta.get("fill_value")    # a number, "NaN" or "Infinity"
        self.fill = self.dtype.type(0 if fill is None else fill)
        self.chunk_nbytes = math.prod(self.chunks) * self.dtype.itemsize

    @classmethod
    def create(cls, path: str, shape: Sequence[int], dtype,
               chunks: Optional[Sequence[int]] = None,
               compressor: Optional[dict] = BLOSC) -> "Array":
        """A new empty array at ``path`` (fill value null), its chunks
        blosc-lz4 (:data:`BLOSC`) or, with ``compressor=None``, raw; the
        chunk files, temporaries and ``.zattrs`` already there are
        deleted.  ``chunks`` defaults to the whole array."""
        if compressor is not None and compressor != BLOSC:
            raise NotImplementedError(f"compressor {compressor!r}; the store "
                                      f"writes {BLOSC!r} or raw chunks")
        shape = tuple(int(n) for n in shape)
        chunks = shape if chunks is None else tuple(int(n) for n in chunks)
        if len(chunks) != len(shape) or any(c < 1 for c in chunks):
            raise ValueError(f"chunks {chunks} for shape {shape}")
        os.makedirs(path, exist_ok=True)
        for name in os.listdir(path):
            if (_CHUNK_KEY.match(name) or name.startswith(_TMP_PREFIX)
                    or name == ".zattrs"):
                os.unlink(os.path.join(path, name))
        meta = {"chunks": list(chunks),
                "compressor": None if compressor is None else dict(BLOSC),
                "dimension_separator": ".", "dtype": np.dtype(dtype).str,
                "fill_value": None, "filters": None, "order": "C",
                "shape": list(shape), "zarr_format": 2}
        _write_file(os.path.join(path, ZARRAY),
                    json.dumps(meta, separators=(",", ":"),
                               sort_keys=True).encode())
        return cls(path)

    # -- the chunk grid -----------------------------------------------------

    def _key(self, idx: tuple) -> str:
        return ".".join(map(str, idx)) if idx else "0"

    def _span(self, idx: tuple) -> tuple:
        """The cells of chunk ``idx`` inside the array, per axis."""
        return tuple((i * c, min((i + 1) * c, n))
                     for i, c, n in zip(idx, self.chunks, self.shape))

    def _region(self, key) -> tuple:
        """((start, stop) per axis, the axes an integer index drops) of a
        basic numpy index (integers, unit-step slices, one Ellipsis)."""
        key = key if isinstance(key, tuple) else (key,)
        if sum(k is Ellipsis for k in key) > 1:
            raise IndexError("an index with two Ellipses")
        if Ellipsis in key:
            e = key.index(Ellipsis)
            fill = (slice(None),) * (len(self.shape) - len(key) + 1)
            key = key[:e] + fill + key[e + 1:]
        if len(key) > len(self.shape):
            raise IndexError(f"{len(key)} indices for {len(self.shape)} axes")
        key = key + (slice(None),) * (len(self.shape) - len(key))
        spans, drop = [], []
        for ax, (k, n) in enumerate(zip(key, self.shape)):
            if isinstance(k, slice):
                start, stop, step = k.indices(n)
                if step != 1:
                    raise IndexError("the store reads unit-step slices")
                spans.append((start, max(start, stop)))
            else:
                i = int(k)
                if not -n <= i < n:
                    raise IndexError(f"index {i} on an axis of {n}")
                i %= n
                spans.append((i, i + 1))
                drop.append(ax)
        return tuple(spans), tuple(drop)

    def _chunks_of(self, spans: tuple):
        """The indices of the chunks that ``spans`` meets."""
        return itertools.product(*(
            range(a // c, -(-b // c)) if b > a else range(0)
            for (a, b), c in zip(spans, self.chunks)))

    # -- reads --------------------------------------------------------------

    def read_chunk(self, idx: tuple) -> Optional[np.ndarray]:
        """Chunk ``idx`` as a full-size array, or None where its file is
        missing."""
        where = os.path.join(self.path, self._key(idx))
        try:
            with open(where, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        if self.blosc:
            from extpom_tpu_torch.native import zcodec
            buf = zcodec.decode(raw, self.chunk_nbytes, where)
        else:
            if len(raw) != self.chunk_nbytes:
                raise ValueError(f"{where}: {len(raw)} bytes where a raw "
                                 f"chunk holds {self.chunk_nbytes}")
            buf = raw
        return np.frombuffer(buf, self.dtype).reshape(self.chunks)

    def read(self, key=Ellipsis) -> np.ndarray:
        """The hyperslab ``key`` (a basic numpy index) as a new array."""
        spans, drop = self._region(key)
        out = np.empty(tuple(b - a for a, b in spans), self.dtype)
        for idx in self._chunks_of(spans):
            cut = [(max(a, s0), min(b, s1)) for (a, b), (s0, s1)
                   in zip(spans, self._span(idx))]
            dst = tuple(slice(lo - a, hi - a)
                        for (lo, hi), (a, _) in zip(cut, spans))
            chunk = self.read_chunk(idx)
            if chunk is None:
                out[dst] = self.fill
            else:
                out[dst] = chunk[tuple(
                    slice(lo - i * c, hi - i * c)
                    for (lo, hi), i, c in zip(cut, idx, self.chunks))]
        return out.reshape(tuple(n for ax, n in enumerate(out.shape)
                                 if ax not in drop))

    __getitem__ = read

    # -- writes -------------------------------------------------------------

    def chunk_index(self, key) -> tuple:
        """The index of the chunk that the region ``key`` is exactly (an
        edge chunk: its cells inside the array); raise where it is not one
        whole chunk."""
        spans, _ = self._region(key)
        idx = tuple(a // c for (a, _), c in zip(spans, self.chunks))
        if self._span(idx) != spans:
            raise ValueError(f"{self.path}: region {spans} is not one chunk "
                             f"of {self.chunks} in {self.shape}")
        return idx

    def write_chunk(self, idx: tuple, data) -> None:
        """Chunk ``idx`` from ``data``, its cells inside the array; an edge
        chunk is padded to full size with the fill value.  A blosc store's
        chunk is encoded as one frame."""
        span = self._span(idx)
        data = np.asarray(data, dtype=self.dtype)
        want = tuple(b - a for a, b in span)
        if data.shape != want:
            raise ValueError(f"chunk {idx}: data of shape {data.shape} for "
                             f"{want}")
        if want != self.chunks:
            full = np.full(self.chunks, self.fill, self.dtype)
            full[tuple(slice(0, n) for n in want)] = data
            data = full
        payload = np.ascontiguousarray(data).data
        if self.blosc:
            from extpom_tpu_torch.native import zcodec
            payload = zcodec.encode(payload, self.dtype.itemsize)
        _write_file(os.path.join(self.path, self._key(idx)), payload)

    def write(self, data, key=Ellipsis) -> None:
        """``data`` into the region ``key``, which must be made of whole
        chunks (edge chunks to the array's end)."""
        spans, drop = self._region(key)
        if drop:
            raise IndexError("a write takes slices, not integer indices")
        data = np.asarray(data)
        if data.shape != tuple(b - a for a, b in spans):
            raise ValueError(f"data of shape {data.shape} for region {spans}")
        for idx in self._chunks_of(spans):
            span = self._span(idx)
            if any(s0 < a or s1 > b for (s0, s1), (a, b) in zip(span, spans)):
                raise ValueError(f"{self.path}: region {spans} cuts chunk "
                                 f"{idx} of {self.chunks}")
            self.write_chunk(idx, data[tuple(
                slice(s0 - a, s1 - a) for (s0, s1), (a, _) in zip(span,
                                                                   spans))])
