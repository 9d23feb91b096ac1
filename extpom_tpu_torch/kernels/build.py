"""Build and load the CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into ``build/kernels/
libextpom_kernels.so`` at the repository root, which is loaded with
``ctypes``.  Nothing happens at import: :func:`library` builds on its first
call and reuses the library after that while no file under ``csrc/``
(sources and the headers they include) is newer than it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG.parent / "build" / "kernels"
LIB = BUILD / "libextpom_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the column-tile phase kernels: every phase
TILED = ("lat", "uvw", "tke", "tracer", "mom")
# C entry points: (argument types); each returns a cudaError_t as int
SIGNATURES = {
    # pointer table (a, c, den, rhs, ee0, gg0, cl, rb, db, mask, out),
    # stride table (i and j strides of the six 2-D operands); kb, im, jm,
    # k0, k_last, threads; stream
    "extpom_tridiag_f32": [_P, _P] + [_I] * 6 + [_P],
    "extpom_tridiag_f64": [_P, _P] + [_I] * 6 + [_P],
    # f64, threads, kb; the six ints of column.cuh tile_info
    "extpom_tridiag_info": [_I] * 3 + [_P],
    # pointer table, parameter table; im, jm, isplit, ispadv, the options
    # (csrc/extstep.cuh kOrl | kMode2), threads, blocks; stream
    "extpom_extloop_f32": [_P, _P] + [_I] * 7 + [_P],
    "extpom_extloop_f64": [_P, _P] + [_I] * 7 + [_P],
    # f64, block variant, options, threads; the six ints of column.cuh
    # tile_info
    "extpom_extloop_info": [_I] * 4 + [_P],
    # kernels launched by the two entries above and extchunk's
    "extpom_extloop_launches": [],
    # threads, blocks, barriers, hand-written; counter, stream
    "extpom_extloop_floor": [_I] * 4 + [_P, _P],
    # pointer table, parameter table; im, jm, isplit, ispadv, options, C,
    # H, ti, tj, threads; stream
    "extpom_extwin_f32": [_P, _P] + [_I] * 10 + [_P],
    "extpom_extwin_f64": [_P, _P] + [_I] * 10 + [_P],
    # extloop's on a block: pointer table, parameter table; im, jm, R, L, C,
    # iext0, oi, oj, isplit, ispadv, options, threads, blocks; stream
    "extpom_extchunk_f32": [_P, _P] + [_I] * 13 + [_P],
    "extpom_extchunk_f64": [_P, _P] + [_I] * 13 + [_P],
    # extwin's on a block: pointer table, parameter table; im, jm, R, L, C,
    # iext0, oi, oj, isplit, ispadv, options, C per launch, H, ti, tj,
    # threads; stream
    "extpom_extwin_chunk_f32": [_P, _P] + [_I] * 16 + [_P],
    "extpom_extwin_chunk_f64": [_P, _P] + [_I] * 16 + [_P],
    # pointer table, parameter table; kb, im, jm, two phase options, then
    # the tile: TI, TJ, blocks; stream
    **{f"extpom_phase_{ph}_{t}": [_P, _P] + [_I] * 8 + [_P]
       for ph in TILED for t in ("f32", "f64")},
    # on a block: kb, im, jm, R, L, oi, oj, two phase options, TI, TJ,
    # blocks; stream
    **{f"extpom_phase_{ph}_mesh_{t}": [_P, _P] + [_I] * 12 + [_P]
       for ph in TILED for t in ("f32", "f64")},
    # MPDATA's steps of the tracer phase (csrc/phase_mpdata.cu): pointer
    # table, parameter table; kb, im, jm, steps in the launch, threads, TI,
    # TJ, chunks of levels; stream; on a block kb, im, jm, R, L, oi, oj,
    # steps, threads, TI, TJ, chunks; stream
    **{f"extpom_phase_tracer_mpdata_{t}": [_P, _P] + [_I] * 8 + [_P]
       for t in ("f32", "f64")},
    **{f"extpom_phase_tracer_mpdata_mesh_{t}": [_P, _P] + [_I] * 12 + [_P]
       for t in ("f32", "f64")},
    # f64, block variant, steps, halo, threads, dynamic shared bytes; the
    # six ints of column.cuh tile_info
    "extpom_phase_tracer_mpdata_info": [_I] * 6 + [_P],
    # f64, block variant, TI, TJ, kb, keep (bit 0: mom's and uvw's keep,
    # tke's and tracer's orlanski variant; bit 1: lat's and tracer's option
    # variant); the six ints of column.cuh tile_info
    **{f"extpom_phase_{ph}_info": [_I] * 6 + [_P] for ph in TILED},
    # kernels launched by the uvw entries since the library loaded
    "extpom_phase_uvw_launches": [],
    # f64, block variant, options, threads, dynamic shared bytes; the six
    # ints of column.cuh tile_info
    "extpom_extwin_info": [_I] * 5 + [_P],
    # a print's compensated sums (csrc/diagsum.cu): pointer table, stride
    # table, region table; rhoref, levels, blocks; stream
    "extpom_diag_sums_f32": [_P, _P, _P, _D, _I, _I, _P],
    "extpom_diag_sums_f64": [_P, _P, _P, _D, _I, _I, _P],
    # partials, rows, out; stream
    "extpom_diag_finish": [_P, _I, _P, _P],
    # f64; threads per block and the six ints of column.cuh tile_info
    "extpom_diag_sums_info": [_I, _P],
    # the step's forcing (csrc/forcing.cu): pointer table (b, f, out an
    # entry), element counts, weights (w0, w1 an entry), levels; entries,
    # dz; stream
    "extpom_forcing_f32": [_P, _P, _P, _P, _I, _P, _P],
    "extpom_forcing_f64": [_P, _P, _P, _P, _I, _P, _P],
    # f64; threads per block, entries per launch and the six ints of
    # column.cuh tile_info
    "extpom_forcing_info": [_I, _P],
    "extpom_error_string": [_I],
}

_lib = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _stale() -> bool:
    if not LIB.exists():
        return True
    t = LIB.stat().st_mtime
    return any(p.stat().st_mtime > t for p in CSRC.rglob("*") if p.is_file())


def build(verbose: bool = False) -> float:
    """Compile every source in parallel and link the library; returns the
    wall seconds taken."""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs, procs = [], []
        extra = ["-Xptxas", "-v"] if verbose else []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            if verbose and out:
                print(out, flush=True)
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB.name
        subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                        str(tmp_lib), *map(str, objs)], check=True)
        os.replace(tmp_lib, LIB)
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first when missing or stale."""
    global _lib
    if _lib is None:
        if _stale():
            build()
        lib = ctypes.CDLL(str(LIB))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        lib.extpom_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(status: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if status != 0:
        msg = library().extpom_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
