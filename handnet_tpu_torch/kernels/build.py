"""Compile ``handnet_tpu_torch/csrc/*.cu`` with ``nvcc`` and load it with ctypes.

All CUDA sources build into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds): one ``nvcc -gencode
arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c`` per
``.cu`` file, all started together, then one link. The library goes to
``build/handnet_tpu_torch/<hash>/`` beside the package, keyed by a hash of
the sources, headers and flags, and is built at first use. Nothing here runs
at import time.

There is no fallback: a missing ``nvcc`` or a failed build raises
:class:`KernelBuildError`; the callers (``ops/cuda_*.py``) never swap in the
plain PyTorch version for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "handnet_tpu_torch"
LIB_NAME = "libhandnet_tpu_torch_kernels.so"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared", "-ldl")  # dlsym finds libcuda's tensor-map encoders
# an entry point's return code from here up is this plus the CUresult of a
# failed cuTensorMapEncode* (kEncodeFailed in csrc/int8_conv.cu)
ENCODE_FAILED = 10000

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# C entry points of csrc/*.cu: name -> argtypes. Every entry returns the
# cudaError_t of its launch (cudaGetLastError) as an int.
ENTRY_POINTS = {
    # x, out, partials (or null), counters (or null), batch, hw, channels,
    # groups, cp, rows, splits, per_split, dtype code, stream
    "hn_gn_group_stats": (_P, _P, _P, _P, *(_I64,) * 8, _INT, _P),
    # x, stats, scale, bias, out, batch, hw, channels, groups, cp, rows,
    # splits, per_split, eps, relu, dtype code, scale/bias dtype code, stream
    "hn_gn_apply": (_P, _P, _P, _P, _P, *(_I64,) * 8, ctypes.c_float, _INT, _INT, _INT, _P),
    # x, dy, stats, scale, bias, sums, dparams, work, counters, batch, hw,
    # channels, groups, cp, rows, splits, per_split, image_fold, eps, relu,
    # dtype code, scale/bias dtype code, stream
    "hn_gn_backward_sums": (*(_P,) * 9, *(_I64,) * 9, ctypes.c_float, _INT, _INT, _INT, _P),
    # x, dy, stats, scale, bias, sums, dx, batch, hw, channels, groups, cp,
    # rows, splits, per_split, eps, 1/n, relu, dtype code, scale/bias dtype
    # code, stream
    "hn_gn_backward_dx": (*(_P,) * 7, *(_I64,) * 8, ctypes.c_float, ctypes.c_float, _INT, _INT,
                          _INT, _P),
    # cls, reg, depth, anchors, out, partials (or null), counters (or null),
    # batch, n, p, vec, rows, splits, per_split, chunk, dtype code, stream
    "hn_a2j_decode": (_P, _P, _P, _P, _P, _P, _P, *(_I64,) * 8, _INT, _P),
    # K1xy: cls, reg, anchors, out, partials (or null), counters (or null),
    # batch, n, p, vec, rows, splits, per_split, chunk, dtype code, stream
    "hn_a2j_decode_xy": (_P, _P, _P, _P, _P, _P, *(_I64,) * 8, _INT, _P),
    # x, sx, sx stride, q, batch, elements per sample, dtype code, stream
    "hn_int8_quantize": (_P, _P, _I64, _P, _I64, _I64, _INT, _P),
    # q, wq, sx, sx stride, sw, bias (or null), out, batch, h, w, cin, cout,
    # ho, wo, kh, kw, stride (h, w), dilation (h, w), im2col box lower (h, w)
    # and upper (h, w) corners, dtype code, stream
    "hn_int8_conv_gemm": (_P, _P, _P, _I64, _P, _P, _P, *(_I64,) * 17, _INT, _P),
    # q, wq, batch, h, w, cin, cout, kh, kw, stride (h, w), lower (h, w),
    # upper (h, w)
    "hn_int8_conv_encode_maps": (_P, _P, *(_I64,) * 13),
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


class BuildResult(NamedTuple):
    path: Path        # the shared library
    seconds: float    # nvcc wall time (0.0 when the library was already built)
    log: str          # nvcc's output, including the -Xptxas -v register report


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises :class:`KernelBuildError` if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(DEFAULT_NVCC)
    for cand in candidates:
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the handnet_tpu_torch CUDA kernels build only where the CUDA toolkit "
        "is installed. CPU tensors take the plain PyTorch versions without "
        "building anything.")


def _sources():
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def _build_dir(sources) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in [*sources, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build_library() -> BuildResult:
    """Build the kernels' shared library unless this exact build exists."""
    sources = _sources()
    out_dir = _build_dir(sources)
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib_path.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return BuildResult(lib_path, 0.0, log)
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_path = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    objects = [out_dir / f".{src.stem}.{os.getpid()}.o" for src in sources]
    start = time.perf_counter()
    log = ""
    try:
        # one compiler per source, all at once: the slowest file sets the time
        compiles = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
                    for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                                for src, obj in zip(sources, objects))]
        results = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in compiles]
        link = [nvcc, *LINK_FLAGS, "-o", str(tmp_path), *map(str, objects)]
        for cmd, out, code in results:
            log += out
            if code != 0:
                raise KernelBuildError(f"nvcc failed ({code}): {' '.join(cmd)}\n{out}")
        proc = subprocess.run(link, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}): {' '.join(link)}\n{log}")
    except BaseException:
        tmp_path.unlink(missing_ok=True)
        raise
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - start
    log_path.write_text(log)
    os.replace(tmp_path, lib_path)  # atomic: a reader never sees half a file
    return BuildResult(lib_path, seconds, log)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry's
    ``argtypes``/``restype`` (pointers and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(str(build_library().path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.hn_error_string.argtypes = (ctypes.c_int,)
    lib.hn_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch (a
    refused launch never runs, and a later synchronize would not say so)."""
    if code >= ENCODE_FAILED:
        raise RuntimeError(f"{name}: cuTensorMapEncode failed: CUresult {code - ENCODE_FAILED}")
    if code != 0:
        what = load_library().hn_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError_t {code} ({what})")
