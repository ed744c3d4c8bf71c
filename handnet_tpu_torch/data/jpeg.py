"""The port's baseline JPEG codec: what ``cv2.imread`` and ``cv2.imwrite``
do with DexYCB's and 100DOH's colour frames, without ``cv2``.

:func:`decode_jpeg` returns what ``cv2.imread(path)`` returns for a baseline
or extended-sequential Huffman file (8-bit, 1 or 3 components, the luma
sampled 1x1, 2x1 or 2x2 and the chroma 1x1, restart intervals allowed):
``uint8 [H, W, 3]`` in BGR order, a greyscale file's one channel repeated
three times, turned by its EXIF orientation as OpenCV turns it. A
progressive, arithmetic-coded, lossless, hierarchical, 12-bit, 2- or
4-component file, or another sampling, raises ``ValueError`` naming the
field; nothing decodes it some other way.

:func:`encode_jpeg` writes what ``cv2.imwrite(path, image)`` writes for a
BGR frame at its defaults: baseline, JFIF 1.01, quality 95 (or another),
the Annex K tables, the chroma at 4:2:0.

Both run in ``data/jpeg_codec.cpp``, built with ``g++`` at first use
(``data/host_build.py``) and loaded with ``ctypes.CDLL``, so a call
releases the GIL and the loader's threads decode in parallel. A failed
build raises. The C++ copies libjpeg-turbo's integer routines one for one
(its header names each source file: ``jdhuff.c``, ``jidctint.c``,
``jdsample.c``, ``jdcolor.c`` to decode; ``jccolor.c``, ``jcsample.c``,
``jfdctint.c``, ``jcdctmgr.c``, ``jccoefct.c``, ``jchuff.c`` and
``jcparam.c`` to encode), so a decode equals OpenCV's bit for bit and an
encode is byte-equal to OpenCV's file (the tests hold both against the
installed ``cv2``). On one core of the H100 machine's host a 480x640
4:2:0 frame decodes in 5.4-7.2 ms and encodes in 9.8-16.3 ms over five
runs of ``chip_smoke.py``'s ``[fcos_apps]`` phase, which prints them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from handnet_tpu_torch.data import host_build

_SRC = Path(__file__).resolve().parent / "jpeg_codec.cpp"
_ERRLEN = 256


def _lib() -> ctypes.CDLL:
    lib = host_build.load("jpeg_codec", str(_SRC))
    if not getattr(lib, "_typed", False):
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.jpeg_header.restype = i64
        lib.jpeg_header.argtypes = (p, i64, p, p, i64)
        lib.jpeg_decode.restype = i64
        lib.jpeg_decode.argtypes = (p, i64, p, p, i64)
        lib.jpeg_encode.restype = i64
        lib.jpeg_encode.argtypes = (p, i64, i64, i64, p, i64, p, i64)
        lib._typed = True
    return lib


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation``: 2 flips left-right, 3 turns 180
    degrees, 4 flips up-down, 5 transposes, 6 transposes then flips
    left-right (90 degrees clockwise), 7 transposes then turns 180 degrees,
    8 transposes then flips up-down (90 degrees counter-clockwise)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _info(data: bytes):
    """``(height, width, components, exif_orientation)`` from the header."""
    info = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().jpeg_header(data, len(data), info.ctypes.data, err, _ERRLEN):
        raise ValueError(err.value.decode())
    width, height, comps, orientation = (int(v) for v in info)
    return height, width, comps, orientation


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> ``uint8 [H, W, 3]`` BGR, EXIF orientation applied."""
    data = bytes(data)
    height, width, _, orientation = _info(data)
    out = np.empty((height, width, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().jpeg_decode(data, len(data), out.ctypes.data, err, _ERRLEN):
        raise ValueError(err.value.decode())
    return out if orientation == 1 else _orient(out, orientation)


def read_jpeg(path) -> np.ndarray:
    """The JPEG at ``path`` as ``cv2.imread(path)`` returns it. A missing
    file raises ``FileNotFoundError`` (``cv2`` returns None)."""
    return decode_jpeg(Path(path).read_bytes())


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """``uint8 [H, W, 3]`` BGR -> the bytes ``cv2.imencode(".jpg", image,
    [cv2.IMWRITE_JPEG_QUALITY, quality])`` gives."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"JPEG: writes uint8 [H, W, 3] BGR, got {image.dtype} {image.shape}")
    height, width = image.shape[:2]
    lib = _lib()
    err = ctypes.create_string_buffer(_ERRLEN)
    cap = height * width * 3 // 2 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(image.ctypes.data, height, width, int(quality), out.ctypes.data,
                            cap, err, _ERRLEN)
        if n < 0:
            raise ValueError(err.value.decode())
        if n <= cap:
            return out[:n].tobytes()
        cap = n


def write_jpeg(path, image: np.ndarray, quality: int = 95) -> None:
    """Write ``image`` as :func:`encode_jpeg` encodes it."""
    Path(path).write_bytes(encode_jpeg(image, quality))
