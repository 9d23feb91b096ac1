"""Host-side C++ libraries of the port, bound with ctypes and built with
``g++`` into the repository's git-ignored ``build/native/`` at first use."""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

BUILD = Path(__file__).resolve().parent.parent.parent / "build" / "native"


def build_library(src: Path, lib: Path,
                  flags: Sequence[str]) -> Optional[Path]:
    """Build ``src`` into the shared library ``lib`` unless ``lib`` is newer
    than it; None when there is no source, no ``g++`` or the build fails.
    The library is written under a temporary name and renamed into place,
    so processes that build at once agree."""
    if not src.exists():
        return None
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        subprocess.run([cxx, *flags, str(src), "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, lib)
    except (OSError, subprocess.CalledProcessError):
        os.unlink(tmp)
        return None
    return lib
