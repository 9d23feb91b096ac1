"""The port's Zarr v2 store (``extpom_tpu_torch/io/zarr.py``) against
tensorstore and the JAX package on the CPU, both ways and bit for bit.

* ``.zarray`` as tensorstore writes it, by default (blosc lz4) and raw;
  what the port writes, tensorstore and the JAX package read;
* the port's blosc1/LZ4 encoder (``native/zcodec.cpp``): its frames read
  back bit-equal by tensorstore's c-blosc and by the port's decoder over
  every dtype and sample kind, at 1-64 bytes (the LZ4 block's end rules,
  checked stream by stream), on the 31x256x256 chunk of the main path (a
  short last block), on data that does not compress (raw streams, the
  memcpyed frame); without the encoder a write raises;
* what tensorstore writes, by default (blosc1, lz4, byte shuffle, decoded
  by ``native/zcodec.cpp``) and raw, the port reads: random, smooth,
  constant and periodic data (LZ4 matches that overlap their own output),
  f32, f64 and int64, many chunk shapes, the 31x256x256 chunk of the main
  path (a short last blosc block);
* hyperslabs across chunk edges against numpy slicing, missing chunks,
  0-d arrays, creation over a stale store, whole-chunk writes, and every
  codec the store does not decode raising ``NotImplementedError`` that
  names it;
* a port restart and snapshot read by ``extpom_tpu.io.zarrstore``, a
  restart of the JAX driver resumed by the port's driver, and a JAX store
  chunked at 256 read into 2x2 blocks whose edges are not chunk edges.
"""

import contextlib
import io
import json
import os
import shutil
import struct
import sys
import tempfile
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from extpom_tpu.io import zarrstore as jx_zarr
from extpom_tpu.run import main as jx_main

from extpom_tpu_torch import run as ptrun
from extpom_tpu_torch.cases.seamount import seamount_model
from extpom_tpu_torch.core.state import State
from extpom_tpu_torch.diag import stats
from extpom_tpu_torch.io import zarr
from extpom_tpu_torch.io import zarrstore as zio
from extpom_tpu_torch.mesh import distributed
from extpom_tpu_torch.mesh.shardmap import Mesh
from extpom_tpu_torch.native import zcodec

ts = pytest.importorskip("tensorstore")
torch.set_num_threads(1)

DTYPES = ("float32", "float64", "int64")
QUICK = settings(max_examples=40, deadline=None, derandomize=True,
                 database=None)


def ts_write(path, a, chunks, compressor="default"):
    """``a`` as a tensorstore zarr array; ``compressor`` None is raw, a
    dict a codec, "default" tensorstore's own (blosc lz4)."""
    spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": path},
            "metadata": {"chunks": list(chunks)}}
    if compressor != "default":
        spec["metadata"]["compressor"] = compressor
    h = ts.open(spec, create=True, delete_existing=True,
                dtype=a.dtype.name, shape=list(a.shape)).result()
    h[...] = a


def ts_read(path):
    spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": path}}
    return np.asarray(ts.open(spec).result().read().result())


def bits_equal(a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


def sample(kind: str, shape, dtype, seed: int) -> np.ndarray:
    """Data of one kind: random, smooth, constant or periodic bytes."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    dt = np.dtype(dtype)
    if kind == "random":
        a = (rng.integers(-2**40, 2**40, n) if dt.kind == "i"
             else rng.standard_normal(n))
    elif kind == "smooth":
        a = (np.arange(n) // 3 if dt.kind == "i"
             else np.sin(np.linspace(0.0, 7.0, n)) * 50.0 + 10.0)
    elif kind == "constant":
        a = np.full(n, 3)
    else:     # a short random byte pattern repeated: overlapping matches
        period = int(rng.integers(1, 13))
        raw = np.tile(rng.integers(0, 256, period, dtype=np.uint8),
                      n * dt.itemsize // period + 1)[:n * dt.itemsize]
        return raw.view(dt).reshape(shape)
    return a.astype(dt).reshape(shape)


@st.composite
def layouts(draw, max_dims=3, max_side=24):
    """(shape, chunks) of 1 to ``max_dims`` axes."""
    nd = draw(st.integers(1, max_dims))
    shape = tuple(draw(st.integers(1, max_side)) for _ in range(nd))
    chunks = tuple(draw(st.integers(1, s)) for s in shape)
    return shape, chunks


# -- metadata and the two directions -----------------------------------------

def port_create(path, shape, dtype, chunks, comp="default"):
    """``zarr.Array.create`` with the store's default compressor, or with
    ``compressor=None`` where ``comp`` is None."""
    kw = {} if comp == "default" else {"compressor": comp}
    return zarr.Array.create(str(path), shape, dtype, chunks, **kw)


@pytest.mark.parametrize("comp", ("default", None))
@pytest.mark.parametrize("dtype", DTYPES)
def test_zarray_as_tensorstore_writes_it(tmp_path, dtype, comp):
    a = np.zeros((4, 5), dtype)
    ts_write(str(tmp_path / "ts"), a, (2, 3), compressor=comp)
    port_create(tmp_path / "pt", (4, 5), dtype, (2, 3), comp)
    assert ((tmp_path / "pt" / ".zarray").read_text()
            == (tmp_path / "ts" / ".zarray").read_text())
    assert json.loads((tmp_path / "pt" / ".zarray").read_text())[
        "compressor"] == (zarr.BLOSC if comp == "default" else None)


def chunk_files(path) -> list:
    files = sorted(os.listdir(path))
    assert files[0] == ".zarray"
    return [os.path.join(path, f) for f in files[1:]]


@pytest.mark.parametrize("comp", ("default", None))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,chunks", [
    ((7,), (3,)), ((4, 5), (2, 3)), ((31, 40, 33), (31, 16, 16)),
    ((5, 9, 11), (2, 4, 5)), ((3, 17, 13), (3, 17, 13))])
def test_port_writes_tensorstore_reads(tmp_path, dtype, shape, chunks, comp):
    """Edge chunks included (full-size chunks); the JAX reader agrees.  A
    raw chunk file holds the chunk's bytes, a blosc one a frame of them
    whose cbytes is the file's size."""
    a = sample("random", shape, dtype, 1)
    z = port_create(tmp_path / "a", shape, dtype, chunks, comp)
    z.write(a)
    assert bits_equal(ts_read(str(tmp_path / "a")), a)
    assert bits_equal(jx_zarr.read_array(str(tmp_path), "a"), a)
    n = int(np.prod([-(-s // c) for s, c in zip(shape, chunks)]))
    files = chunk_files(tmp_path / "a")
    assert len(files) == n
    nbytes = int(np.prod(chunks)) * a.itemsize
    for f in files:
        if comp is None:
            assert os.path.getsize(f) == nbytes
        else:
            frame = open(f, "rb").read()
            _, typesize, size, _, cbytes = zcodec.header(frame)
            assert (typesize, size, cbytes) == (a.itemsize, nbytes,
                                                len(frame))


@QUICK
@given(layouts(), st.sampled_from(DTYPES),
       st.sampled_from(("random", "smooth", "constant", "periodic")),
       st.sampled_from(("default", None)), st.integers(0, 2**16))
def test_tensorstore_writes_port_reads(layout, dtype, kind, comp, seed):
    shape, chunks = layout
    a = sample(kind, shape, dtype, seed)
    with tempfile.TemporaryDirectory() as tmp:
        ts_write(tmp, a, chunks, comp)
        assert bits_equal(zarr.Array(tmp).read(), a)


@pytest.mark.parametrize("dtype,kind", [
    ("float32", "smooth"), ("float32", "random"), ("float32", "periodic"),
    ("float64", "smooth"), ("int64", "smooth"), ("int64", "periodic")])
def test_main_path_chunk_decodes(tmp_path, dtype, kind):
    """tensorstore's blosc frame of a 31x256x256 chunk (blocks of 512 KiB
    at f32, and a short last block) decodes bit-equal."""
    shape = (31, 256, 256) if dtype == "float32" else (31, 256, 128)
    a = sample(kind, shape, dtype, 7)
    ts_write(str(tmp_path / "a"), a, shape)
    frame = (tmp_path / "a" / "0.0.0").read_bytes()
    flags, typesize, nbytes, blocksize, cbytes = zcodec.header(frame)
    assert flags >> 5 == 1 and (typesize, nbytes) == (a.itemsize, a.nbytes)
    assert nbytes % blocksize and cbytes == len(frame)
    assert bits_equal(zarr.Array(str(tmp_path / "a")).read(), a)


@QUICK
@given(st.integers(1, 40), st.integers(1, 300), st.sampled_from(DTYPES),
       st.integers(0, 2**16))
def test_lz4_overlapping_matches(period, reps, dtype, seed):
    """Byte patterns of every period repeated: each LZ4 match starts
    within its own output."""
    rng = np.random.default_rng(seed)
    item = np.dtype(dtype).itemsize
    raw = np.tile(rng.integers(0, 256, period, dtype=np.uint8), reps * item)
    a = raw[:len(raw) // item * item].view(dtype)
    with tempfile.TemporaryDirectory() as tmp:
        ts_write(tmp, a, (max(1, len(a) // 2),))
        assert bits_equal(zarr.Array(tmp).read(), a)


# -- the port's encoder -------------------------------------------------------

def lz4_block(block: bytes, n: int) -> bytes:
    """The ``n`` bytes of an LZ4 block, decoded here with the format's end
    rules asserted as LZ4's and c-blosc's decoders enforce them: a match
    starts at least 12 bytes before the end, ends at least 5 before it,
    and has an offset into the output so far."""
    out, i = bytearray(), 0

    def length(i, v):
        if v == 15:
            while True:
                b = block[i]
                i, v = i + 1, v + b
                if b != 255:
                    break
        return i, v

    while True:
        token = block[i]
        i, lit = length(i + 1, token >> 4)
        out += block[i:i + lit]
        i += lit
        if i == len(block):             # the last sequence: literals only
            break
        assert len(out) <= n - 12, ("a match within the last 12 bytes",
                                    len(out), n)
        off = block[i] | block[i + 1] << 8
        i, ml = length(i + 2, token & 15)
        assert 1 <= off <= len(out), ("an offset out of the output", off)
        for _ in range(ml + 4):
            out.append(out[-off])
        assert len(out) <= n - 5, ("a match in the last 5 bytes", len(out),
                                   n)
    assert len(out) == n, (len(out), n)
    return bytes(out)


def frame_streams(frame: bytes) -> list:
    """Each stream of a blosc1 frame, checked against the block layout the
    header gives: (its bytes, whether it is stored raw)."""
    flags, typesize, nbytes, blocksize, cbytes = zcodec.header(frame)
    assert cbytes == len(frame) and flags >> 5 == 1
    if flags & zcodec.MEMCPYED:
        assert cbytes == nbytes + 16
        return []
    nblocks = -(-nbytes // blocksize)
    starts = struct.unpack_from(f"<{nblocks}I", frame, 16)
    assert starts[0] == 16 + 4 * nblocks
    streams, pos = [], starts[0]
    for b in range(nblocks):
        assert starts[b] == pos
        bsize = min(blocksize, nbytes - b * blocksize)
        nsplits = (typesize if not flags & 0x10 and bsize == blocksize
                   else 1)
        for _ in range(nsplits):
            cs = struct.unpack_from("<I", frame, pos)[0]
            body = frame[pos + 4:pos + 4 + cs]
            n = bsize // nsplits
            streams.append((body, True) if cs == n
                           else (lz4_block(body, n), False))
            pos += 4 + cs
    assert pos == cbytes
    return streams


def encoded_store(path, a: np.ndarray) -> list:
    """``a`` as a one-chunk port store at ``path``; its frame's streams."""
    port_create(path, a.shape, a.dtype, a.shape or (1,)).write(a)
    (chunk,) = chunk_files(path)
    return frame_streams(open(chunk, "rb").read())


@QUICK
@given(st.sampled_from(DTYPES + ("uint8",)),
       st.sampled_from(("random", "smooth", "constant", "periodic")),
       st.integers(1, 64), st.integers(0, 2**16))
def test_encode_small_frames(dtype, kind, nbytes, seed):
    """1-64 bytes, where a block is one LZ4 stream and the end rules decide
    every match: tensorstore and the port's decoder read the frame
    bit-equal, and every stream keeps the rules."""
    n = max(1, nbytes // np.dtype(dtype).itemsize)
    a = sample(kind, (n,), dtype, seed)
    with tempfile.TemporaryDirectory() as tmp:
        encoded_store(tmp, a)
        assert bits_equal(ts_read(tmp), a)
        assert bits_equal(zarr.Array(tmp).read(), a)


@QUICK
@given(layouts(max_side=40), st.sampled_from(DTYPES),
       st.sampled_from(("random", "smooth", "constant", "periodic")),
       st.integers(0, 2**16))
def test_encode_round_trip(layout, dtype, kind, seed):
    """Any layout, dtype and kind of data, through the port's writes:
    tensorstore, the JAX reader and the port read it back bit-equal."""
    shape, chunks = layout
    a = sample(kind, shape, dtype, seed)
    with tempfile.TemporaryDirectory() as tmp:
        port_create(os.path.join(tmp, "a"), shape, dtype, chunks).write(a)
        assert bits_equal(ts_read(os.path.join(tmp, "a")), a)
        assert bits_equal(jx_zarr.read_array(tmp, "a"), a)
        assert bits_equal(zarr.Array(os.path.join(tmp, "a")).read(), a)


def test_encode_end_rules_at_every_length():
    """Every length from 1 to 600 bytes of constant, periodic and smooth
    bytes (one stream, matches up to the last bytes allowed): each stream
    keeps the end rules and tensorstore reads each frame."""
    rng = np.random.default_rng(3)
    for n in range(1, 601):
        for a in (np.full(n, 7, np.uint8),
                  np.tile(rng.integers(0, 256, 3, dtype=np.uint8), n)[:n],
                  (np.arange(n) // 5).astype(np.uint8)):
            with tempfile.TemporaryDirectory() as tmp:
                streams = encoded_store(tmp, a)
                assert bits_equal(ts_read(tmp), a), n
            if n >= 64:
                assert streams and not streams[0][1], n   # compressed


@pytest.mark.parametrize("dtype,kind", [
    ("float32", "smooth"), ("float32", "random"), ("float32", "periodic"),
    ("float64", "smooth"), ("int64", "smooth"), ("int64", "periodic")])
def test_main_path_chunk_encodes(tmp_path, dtype, kind):
    """The port's frame of a 31x256x256 chunk (blocks of 512 KiB at f32,
    1 MiB at 8 bytes, and a short last block): split, shuffled and read
    back bit-equal by tensorstore and the port, within 5 % of the bytes
    of tensorstore's own frame of the same chunk."""
    shape = (31, 256, 256) if dtype == "float32" else (31, 256, 128)
    a = sample(kind, shape, dtype, 7)
    port_create(tmp_path / "a", shape, dtype, shape).write(a)
    frame = (tmp_path / "a" / "0.0.0").read_bytes()
    flags, typesize, nbytes, blocksize, cbytes = zcodec.header(frame)
    assert (typesize, nbytes, cbytes) == (a.itemsize, a.nbytes, len(frame))
    assert blocksize == 2**17 * a.itemsize and nbytes % blocksize
    assert flags == 0x01 | 1 << 5          # byte shuffle, split, lz4
    assert bits_equal(ts_read(str(tmp_path / "a")), a)
    assert bits_equal(zarr.Array(str(tmp_path / "a")).read(), a)
    ts_write(str(tmp_path / "t"), a, shape)
    assert cbytes <= 1.05 * os.path.getsize(tmp_path / "t" / "0.0.0")


def test_encode_incompressible(tmp_path):
    """Random floats: the mantissa streams stay raw under their own size
    and the exponent streams compress; random bytes: the memcpyed frame.
    Both read back bit-equal."""
    a = sample("random", (64, 1024), "float32", 5)
    streams = encoded_store(tmp_path / "f", a)
    raw = [body for body, is_raw in streams if is_raw]
    assert raw and len(raw) < len(streams)
    assert bits_equal(ts_read(str(tmp_path / "f")), a)
    b = np.random.default_rng(6).integers(0, 256, 70000, dtype=np.uint8)
    assert encoded_store(tmp_path / "b", b) == []
    flags = zcodec.header((tmp_path / "b" / "0").read_bytes())[0]
    assert flags & zcodec.MEMCPYED
    assert bits_equal(ts_read(str(tmp_path / "b")), b)
    assert bits_equal(zarr.Array(str(tmp_path / "b")).read(), b)


def test_encode_threads_agree():
    """One frame whatever the number of threads, and the counts of
    ``ENCODED`` add up."""
    a = sample("smooth", (31, 64, 256), "float32", 0)
    frames = [zcodec.encode(a, 4, threads=t) for t in (1, 3, 8)]
    assert frames[0] == frames[1] == frames[2]
    before = zcodec.ENCODED.totals()
    zcodec.encode(a, 4)
    n, s, raw, out = (y - x for x, y in zip(before, zcodec.ENCODED.totals()))
    assert (n, raw, out) == (1, a.nbytes, len(frames[0])) and s >= 0


@QUICK
@given(layouts(max_side=20), st.sampled_from(("default", None, "port")),
       st.data())
def test_hyperslabs_cross_chunk_edges(layout, comp, data):
    """Slices and integer indices against numpy on the same array."""
    shape, chunks = layout
    a = sample("random", shape, "float64", len(shape))
    key = []
    for n in shape:
        if data.draw(st.booleans()):
            lo = data.draw(st.integers(-n, n))
            hi = data.draw(st.integers(-n, n + 3))
            key.append(slice(lo, hi))
        else:
            key.append(data.draw(st.integers(-n, n - 1)))
    key = tuple(key)
    with tempfile.TemporaryDirectory() as tmp:
        if comp == "port":
            zarr.Array.create(tmp, shape, a.dtype, chunks).write(a)
        else:
            ts_write(tmp, a, chunks, comp)
        z = zarr.Array(tmp)
        assert bits_equal(z[key], a[key])
        assert bits_equal(z[..., -1], a[..., -1])


def test_missing_chunks_read_as_fill(tmp_path):
    a = sample("random", (6, 9), "float32", 3)
    ts_write(str(tmp_path / "a"), a, (4, 4))
    for key in ("0.1", "1.2"):
        os.unlink(tmp_path / "a" / key)
    got = zarr.Array(str(tmp_path / "a")).read()
    assert bits_equal(got, ts_read(str(tmp_path / "a")))
    assert not got[:4, 4:8].any() and not got[4:, 8:].any()
    z = zarr.Array.create(str(tmp_path / "b"), (5, 5), "float64", (2, 2))
    z.write(np.ones((2, 2)), (slice(2, 4), slice(0, 2)))
    want = np.zeros((5, 5))
    want[2:4, :2] = 1.0
    assert bits_equal(z.read(), want)
    assert bits_equal(ts_read(str(tmp_path / "b")), want)


def test_zero_d_arrays(tmp_path):
    """A 0-d tensorstore array reads; the port's write_array stores a 0-d
    array as shape (1,), as the JAX package does, and both read it."""
    ts_write(str(tmp_path / "t"), np.array(2.5), ())
    assert bits_equal(zarr.Array(str(tmp_path / "t")).read(), np.array(2.5))
    zio.write_array(str(tmp_path), "p", np.float64(-1.25))
    assert bits_equal(zio.read_array(str(tmp_path), "p"),
                      np.array([-1.25]))
    assert bits_equal(jx_zarr.read_array(str(tmp_path), "p"),
                      np.array([-1.25]))
    z = zarr.Array.create(str(tmp_path / "z"), (), "int64")
    z.write(np.array(7))
    assert bits_equal(ts_read(str(tmp_path / "z")), np.array(7))


@pytest.mark.parametrize("comp,name", [
    ({"id": "blosc", "cname": "zstd", "clevel": 5, "shuffle": 1}, "zstd"),
    ({"id": "blosc", "cname": "blosclz", "clevel": 5, "shuffle": 1},
     "blosclz"),
    ({"id": "blosc", "cname": "lz4hc", "clevel": 5, "shuffle": 1}, "lz4hc"),
    ({"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 2},
     "bitshuffle"),
    ({"id": "zlib", "level": 5}, "zlib"), ({"id": "zstd", "level": 3},
                                           "zstd"),
    ({"id": "bz2", "level": 5}, "bz2")])
def test_unsupported_codec_raises(tmp_path, comp, name):
    ts_write(str(tmp_path / "a"), np.ones((4, 4), np.float32), (2, 2), comp)
    with pytest.raises(NotImplementedError, match=name):
        zarr.Array(str(tmp_path / "a")).read()


def test_unsupported_frames_and_metadata_raise(tmp_path):
    """A zstd frame met in an lz4 store, filters and Fortran order raise
    NotImplementedError naming them."""
    a = sample("smooth", (64, 64), "float32", 0)
    ts_write(str(tmp_path / "z"), a, (64, 64),
             {"id": "blosc", "cname": "zstd", "clevel": 5, "shuffle": 1})
    ts_write(str(tmp_path / "l"), a, (64, 64))
    shutil.copy(tmp_path / "z" / "0.0", tmp_path / "l" / "0.0")
    with pytest.raises(NotImplementedError, match="zstd"):
        zarr.Array(str(tmp_path / "l")).read()
    meta = json.loads((tmp_path / "l" / ".zarray").read_text())
    for key, value, word in (("filters", [{"id": "delta"}], "delta"),
                             ("order", "F", "order")):
        (tmp_path / "l" / ".zarray").write_text(json.dumps(
            {**meta, key: value}))
        with pytest.raises(NotImplementedError, match=word):
            zarr.Array(str(tmp_path / "l"))


def test_blosc_write_without_codec_raises(tmp_path, monkeypatch):
    """Where the encoder cannot be built a write raises, and no chunk is
    written raw in its place; a raw store is still written."""
    a = sample("smooth", (8, 8), "float64", 0)
    monkeypatch.setattr(zcodec, "_lib", None)
    monkeypatch.setattr(zcodec, "_build", lambda: None)
    z = zarr.Array.create(str(tmp_path / "b"), (8, 8), "float64", (4, 4))
    with pytest.raises(RuntimeError, match="cannot be built"):
        z.write(a)
    with pytest.raises(RuntimeError, match="cannot be built"):
        zio.write_array(str(tmp_path), "c", a)
    assert chunk_files(tmp_path / "b") == chunk_files(tmp_path / "c") == []
    zarr.Array.create(str(tmp_path / "r"), (8, 8), "float64", (4, 4),
                      compressor=None).write(a)
    assert bits_equal(ts_read(str(tmp_path / "r")), a)


def test_blosc_without_codec_raises(tmp_path, monkeypatch):
    """Where the decoder cannot be built a blosc chunk raises; raw stores
    read all the same."""
    a = sample("smooth", (8, 8), "float64", 0)
    ts_write(str(tmp_path / "b"), a, (4, 4))
    ts_write(str(tmp_path / "r"), a, (4, 4), None)
    monkeypatch.setattr(zcodec, "_lib", None)
    monkeypatch.setattr(zcodec, "_build", lambda: None)
    with pytest.raises(RuntimeError, match="cannot be built"):
        zarr.Array(str(tmp_path / "b")).read()
    assert bits_equal(zarr.Array(str(tmp_path / "r")).read(), a)


def test_create_deletes_stale_chunks(tmp_path):
    """A store created over another leaves none of its chunks, its
    attributes or a temporary behind: no stale chunk outlives a re-run."""
    path = tmp_path / "a"
    ts_write(str(path), np.ones((8, 8)), (4, 4))
    (path / ".zattrs").write_text("{}")
    (path / ".tmp-0.0.1.2").write_bytes(b"x")
    z = zarr.Array.create(str(path), (8, 8), "float64", (4, 4))
    assert sorted(os.listdir(path)) == [".zarray"]
    assert not z.read().any() and not ts_read(str(path)).any()


def test_writes_take_whole_chunks(tmp_path):
    """A region that cuts a chunk is refused, an edge chunk (its cells
    inside the array) is one chunk, and each file is renamed into place
    (no temporary left)."""
    z = zarr.Array.create(str(tmp_path / "a"), (3, 15, 15), "float32",
                          (3, 8, 4))
    with pytest.raises(ValueError, match="cuts chunk"):
        z.write(np.zeros((3, 4, 4), np.float32),
                (slice(None), slice(0, 4), slice(0, 4)))
    with pytest.raises(ValueError, match="not one chunk"):
        z.chunk_index((..., slice(0, 8), slice(0, 8)))
    assert z.chunk_index((..., slice(8, 15), slice(12, 15))) == (0, 1, 3)
    a = sample("random", (3, 15, 15), "float32", 5)
    z.write(a)
    assert bits_equal(ts_read(str(tmp_path / "a")), a)
    assert not [f for f in os.listdir(tmp_path / "a") if f.startswith(".t")]


def test_cooperative_write_takes_one_chunk_per_piece(tmp_path):
    """``_write_slabs`` (one process) writes pieces that are each one
    chunk, the partial edge chunks of a ragged region included, and
    refuses a piece that is not one chunk."""
    a = sample("random", (3, 15, 13), "float64", 9)
    pieces = {((i0, min(i0 + 8, 15)), (j0, min(j0 + 4, 13))):
              torch.from_numpy(a[:, i0:i0 + 8, j0:j0 + 4])
              for i0 in (0, 8) for j0 in (0, 4, 8, 12)}
    zio.write_array(str(tmp_path), "a", distributed.Slabs(
        (3, 15, 13), "float64", (3, 8, 4), pieces))
    assert bits_equal(ts_read(str(tmp_path / "a")), a)
    bad = {((0, 8), (0, 8)): torch.from_numpy(a[:, :8, :8].copy())}
    with pytest.raises(ValueError, match="not one chunk"):
        zio.write_array(str(tmp_path), "b", distributed.Slabs(
            (3, 15, 13), "float64", (3, 8, 4), bad))


# -- the datasets against the JAX package ------------------------------------

KW = dict(im=17, jm=13, kb=7)


def test_port_restart_and_snapshot_read_by_jax(tmp_path):
    from extpom_tpu.cases.seamount import seamount_case as jx_case
    m = seamount_model(device="cpu", dtype="float64", **KW)
    m.run_segment(3)
    zio.write_restart(str(tmp_path / "rst"), m.state, m.iint, 0.25)
    jcfg, _, _ = jx_case(dtype="float64", **KW)
    jst, iint, time0 = jx_zarr.read_restart(str(tmp_path / "rst"), jcfg)
    assert (iint, time0) == (3, 0.25)
    for name in State.field_names():
        assert bits_equal(np.asarray(getattr(jst, name)),
                          getattr(m.state, name).numpy()), name
    s = {k: float(v) for k, v in
         stats.domain_stats(m.grid, m.cfg, m.state).items()}
    zio.write_output(str(tmp_path / "out"), m.grid, m.cfg, m.state, 0.5, s)
    snap = jx_zarr.read_output(str(tmp_path / "out"))
    for name in jx_zarr.OUTPUT_2D + jx_zarr.OUTPUT_3D:
        assert bits_equal(snap[name], getattr(m.state, name).numpy()), name
    for name in jx_zarr.OUTPUT_GRID_VARS:
        assert bits_equal(snap[name], getattr(m.grid, name).numpy()), name
    assert snap["attrs"]["stats"] == s


def _diagnostics(text: str) -> np.ndarray:
    import re
    return np.array([[float(x) for x in re.findall(r"= *([-\d.e+]+)", line)]
                     for line in text.splitlines()
                     if line.startswith("time =")])


def test_jax_driver_restart_resumes_in_port_driver(tmp_path, monkeypatch):
    """The JAX driver's Zarr restart at step 8 (tensorstore's blosc
    chunks) resumes in the port's driver, with tensorstore masked there,
    to step 16: the prints to 1e-9 of the JAX run's, the step-16 snapshot
    to 1e-10 of each field's scale (tests/test_torch_run.py's
    tolerances)."""
    dti = 180.0
    conf = {"run_name": "sm", "case": "seamount",
            "case_args": {"im": 17, "jm": 17, "kb": 7},
            "config": {"days": 16 * dti / 86400, "prtd1": 4 * dti / 86400,
                       "write_rst": 8 * dti / 86400, "dtype": "float64"},
            "out_dir": str(tmp_path / "jx"), "out_format": "zarr"}
    (tmp_path / "jx.json").write_text(json.dumps(conf))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jx_main([str(tmp_path / "jx.json")]) == 0
    rst = str(tmp_path / "jx" / "sm.rst.000008")
    assert json.loads(open(os.path.join(rst, "el", ".zarray")).read())[
        "compressor"]["id"] == "blosc"
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    lines = []
    res = ptrun.execute(dict(conf, out_dir=str(tmp_path / "pt"), nread_rst=1,
                             read_rst_path=rst), "cpu", log=lines.append)
    assert res.rc == 0 and res.steps == 8 and res.model.iint == 16
    got = _diagnostics("\n".join(lines))
    want = _diagnostics(buf.getvalue())
    assert got.shape == (2, 6) and want.shape == (4, 6)
    np.testing.assert_allclose(got, want[2:], rtol=1e-9, atol=0)
    a = zio.read_output(str(tmp_path / "pt" / "sm.000016"))
    b = zio.read_output(str(tmp_path / "jx" / "sm.000016"))
    for name in zio.OUTPUT_GRID_VARS + zio.OUTPUT_FIELDS:
        scale = max(1.0, float(np.abs(b[name]).max()))
        assert np.abs(a[name] - b[name]).max() <= 1e-10 * scale, name


def test_jax_store_read_into_blocks(tmp_path, monkeypatch):
    """A JAX restart of a 264x264x3 state (chunks of 256) read into the
    132x132 blocks of a 2x2 mesh: every block's every field bit-equal to
    its hyperslab."""
    m = seamount_model(device="cpu", dtype="float64", im=264, jm=264, kb=3)
    rng = np.random.default_rng(11)
    fields = {n: rng.standard_normal(tuple(getattr(m.state, n).shape))
              for n in State.field_names()}
    jx_zarr.write_restart(str(tmp_path / "rst"),
                          types.SimpleNamespace(**fields), 5, 0.5)
    assert json.loads((tmp_path / "rst" / "t" / ".zarray").read_text())[
        "chunks"] == [3, 256, 256]
    m.shard(Mesh(2, 2, device="cpu"))
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    st_, iint, time0 = zio.read_restart(str(tmp_path / "rst"), m.cfg, "cpu",
                                        blocks=m.blocks)
    assert st_ is None and (iint, time0) == (5, 0.5)
    for b in m.blocks.ids:
        (i0, i1), (j0, j1) = m.blocks.active_span(b)
        assert (i1 - i0, j1 - j0) == (132, 132)
        for n in State.field_names():
            assert bits_equal(getattr(m.blocks.state[b], n).numpy(),
                              fields[n][..., i0:i1, j0:j1]), (b, n)
