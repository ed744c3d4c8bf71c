"""Build a host-side C++ source with ``g++`` and load it with ctypes.

The PNG unfilter (``data/png_unfilter.cpp``) and the RLE kernel
(``native/rle/rle.cpp``, read and never written) are compiled at first use
into ``build/handnet_tpu_torch/<name>/<hash>/lib<name>.so`` beside the
package, keyed by a hash of the source and the flags. A build writes a
temporary file and renames it into place, so processes that build at the
same time each load a whole library. Nothing runs at import time, and a
missing ``g++`` or a failed build raises :class:`HostBuildError`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "handnet_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class HostBuildError(RuntimeError):
    """A host C++ library could not be built or loaded."""


@functools.lru_cache(maxsize=None)
def load(name: str, source: str) -> ctypes.CDLL:
    """The library built from ``source`` (a path), cached per process."""
    src = Path(source)
    try:
        text = src.read_bytes()
    except OSError as e:
        raise HostBuildError(f"{name}: cannot read {src}: {e}") from e
    key = hashlib.sha256(text + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / name / key
    lib = out_dir / f"lib{name}.so"
    if not lib.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise HostBuildError(f"{name}: no g++ on the PATH to build {src}")
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise HostBuildError(f"{name}: g++ failed on {src}:\n{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    try:
        return ctypes.CDLL(str(lib))
    except OSError as e:
        raise HostBuildError(f"{name}: cannot load {lib}: {e}") from e
