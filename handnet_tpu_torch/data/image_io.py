"""The port's image I/O: greyscale and colour PNG, colour JPEG
(:func:`imread_color`, :func:`imwrite_jpeg` through ``data/jpeg.py``), a
writer by extension (:func:`imwrite`) and ``cv2``'s fixed-point bilinear
resize (:func:`resize_linear_u8`).

PNG: non-interlaced greyscale at 8 and 16 bits, and 8-bit RGB.

DexYCB's depth frames are 16-bit greyscale PNGs (millimetres, big-endian
samples). :func:`read_png` returns the array that ``cv2.imread(path,
cv2.IMREAD_ANYDEPTH)`` returns for such a file: ``uint16`` (or ``uint8``
at 8 bits), ``[height, width]``. :func:`write_png` writes one that ``cv2``
reads back bit for bit. An 8-bit RGB file (colour type 2) reads as
``cv2.imread(path)`` reads it, ``uint8 [height, width, 3]`` in BGR order,
and a ``uint8 [height, width, 3]`` BGR array is written as such a file, as
``cv2.imwrite`` writes it (the demo's overlays, skeleton images). Any
other PNG (palette, alpha, interlaced, another bit depth, another
compression or filter method) raises ``ValueError`` naming the header
field; nothing decodes it some other way. A chunk whose CRC does not match
raises too, as libpng does for critical chunks.

The scanline filters take one of two routes:

* None, Sub and Up: numpy over whole runs of rows. A run of rows filtered
  None or Sub depends on no other row (Sub is a cumulative sum mod 256
  along each byte lane of the row); a run of Up rows is its first row's
  predecessor plus a cumulative sum down the run.
* Average and Paeth read the byte just reconstructed to their left, so a
  row is sequential: when any row uses either, ``data/png_unfilter.cpp``
  (built with ``g++`` at first use, ``data/host_build.py``) unfilters the
  whole image. A failed build raises. :func:`unfilter_reference` is its
  plain numpy transcription, which the tests hold it against.

On one core of the H100 machine's host, a 480x640 16-bit depth frame
decodes in 0.68 ms filtered None, 1.47 Sub, 2.42 Up, 1.89 Average and
2.24 Paeth (``chip_smoke.py``'s ``[a2j_apps]`` phase prints these).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from handnet_tpu_torch.data import host_build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_UNFILTER_SRC = Path(__file__).resolve().parent / "png_unfilter.cpp"
FILTER_NAMES = ("None", "Sub", "Up", "Average", "Paeth")


def _unfilter_lib() -> ctypes.CDLL:
    lib = host_build.load("png_unfilter", str(_UNFILTER_SRC))
    lib.png_unfilter.restype = ctypes.c_int64
    lib.png_unfilter.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int64)
    return lib


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("PNG: bad signature")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"PNG: chunk {kind!r} is cut short")
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG: no IEND chunk")


def _header(body: bytes):
    if len(body) != 13:
        raise ValueError("PNG: IHDR length")
    width, height, depth, colour, compression, method, interlace = struct.unpack(
        ">IIBBBBB", body)
    if colour not in (0, 2):
        raise ValueError(f"PNG: colour type {colour} (only greyscale, 0, and RGB, 2, are "
                         "read)")
    if depth not in ((8, 16) if colour == 0 else (8,)):
        raise ValueError(f"PNG: bit depth {depth} of colour type {colour} (greyscale is "
                         "read at 8 and 16 bits, RGB at 8)")
    if interlace != 0:
        raise ValueError(f"PNG: interlace method {interlace} (only 0 is read)")
    if compression != 0:
        raise ValueError(f"PNG: compression method {compression}")
    if method != 0:
        raise ValueError(f"PNG: filter method {method}")
    if width == 0 or height == 0:
        raise ValueError("PNG: width or height 0")
    return width, height, depth, 1 if colour == 0 else 3


def unfilter_reference(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Plain transcription of ``png_unfilter.cpp``, byte by byte: ``raw``
    holds ``rows * (stride + 1)`` bytes, each row led by its filter type.
    Slow; the tests' reference."""
    raw = np.asarray(raw, np.uint8).reshape(rows, stride + 1)
    out = np.zeros((rows, stride), np.uint8)
    for r in range(rows):
        kind = int(raw[r, 0])
        if kind > 4:
            raise ValueError(f"PNG: filter type {kind} in row {r}")
        for i in range(stride):
            a = int(out[r, i - bpp]) if i >= bpp else 0
            b = int(out[r - 1, i]) if r > 0 else 0
            c = int(out[r - 1, i - bpp]) if r > 0 and i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[r, i] = (int(raw[r, 1 + i]) + pred) & 0xFF
    return out


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    filt = raw.reshape(rows, stride + 1)
    kinds = filt[:, 0]
    if kinds.max() > 4:
        r = int(np.argmax(kinds > 4))
        raise ValueError(f"PNG: filter type {int(kinds[r])} in row {r}")
    if kinds.max() >= 3:
        out = np.empty((rows, stride), np.uint8)
        src = np.ascontiguousarray(raw)
        bad = _unfilter_lib().png_unfilter(src.ctypes.data, out.ctypes.data, rows, stride, bpp)
        if bad:
            raise ValueError(f"PNG: filter type in row {bad - 1}")
        return out
    body = filt[:, 1:]
    out = np.empty((rows, stride), np.uint8)
    # runs of rows with one route: None/Sub (independent rows) or Up
    up = kinds == 2
    edges = np.flatnonzero(np.diff(up.astype(np.int8))) + 1
    for start, stop in zip(np.r_[0, edges], np.r_[edges, rows]):
        block = body[start:stop]
        if up[start]:
            acc = np.cumsum(block, axis=0, dtype=np.uint8)
            if start > 0:
                acc += out[start - 1]
            out[start:stop] = acc
        else:
            sub = kinds[start:stop] == 1
            out[start:stop] = block
            if sub.any():
                lanes = block[sub].reshape(int(sub.sum()), stride // bpp, bpp)
                out[start:stop][sub] = np.cumsum(lanes, axis=1, dtype=np.uint8).reshape(-1, stride)
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``[height, width]`` ``uint8`` or ``uint16`` (native
    order), or ``uint8 [height, width, 3]`` in BGR order for an RGB file."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            raise ValueError("PNG: a PLTE chunk in a greyscale or RGB image")
    if header is None or not idat:
        raise ValueError("PNG: no IHDR or no IDAT chunk")
    width, height, depth, channels = header
    bpp = depth // 8 * channels
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError("PNG: image data shorter than its header says")
    pixels = _unfilter(raw[:height * (stride + 1)], height, stride, bpp)
    if channels == 3:
        return pixels.reshape(height, width, 3)[:, :, ::-1].copy()
    if depth == 8:
        return pixels.reshape(height, width)
    return pixels.view(">u2").reshape(height, width).astype(np.uint16)


def read_png(path) -> np.ndarray:
    """The greyscale PNG at ``path``, as ``cv2.imread(path,
    cv2.IMREAD_ANYDEPTH)`` returns it (an RGB file as ``cv2.imread(path)``
    does, BGR). A missing file raises ``FileNotFoundError`` (``cv2`` returns
    None)."""
    return decode_png(Path(path).read_bytes())


def _filter_rows(x: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """Filter every row of the ``[rows, stride]`` bytes ``x`` with type
    ``kind``, from the unfiltered neighbours (so it vectorises)."""
    x = x.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    elif kind == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"PNG: filter type {kind}")
    return ((x - pred) & 0xFF).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(image: np.ndarray, filter_type=1) -> bytes:
    """A ``[height, width]`` ``uint16`` or ``uint8`` array as greyscale PNG
    bytes, or a ``uint8 [height, width, 3]`` BGR array as RGB PNG bytes
    (``cv2.imwrite``'s channel order), deflated at zlib level 1 as
    ``cv2.imwrite`` does by default. ``filter_type``: one type (0-4) for
    every row (the default, Sub, is what ``cv2.imwrite`` uses), or one per
    row."""
    image = np.asarray(image)
    rgb = image.ndim == 3 and image.shape[2] == 3 and image.dtype == np.uint8
    if not rgb and (image.ndim != 2 or image.dtype not in (np.uint8, np.uint16)):
        raise ValueError(f"PNG: writes 2-D uint8 or uint16 and [H, W, 3] uint8 only, got "
                         f"{image.dtype} {image.shape}")
    height, width = image.shape[:2]
    if rgb:
        image = image[:, :, ::-1]
    bpp = image.dtype.itemsize * (3 if rgb else 1)
    data = np.ascontiguousarray(image.astype(">u2" if image.dtype.itemsize == 2 else np.uint8)
                                ).view(np.uint8).reshape(height, -1)
    kinds = np.broadcast_to(np.asarray(filter_type, np.uint8), (height,))
    rows = np.empty((height, width * bpp + 1), np.uint8)
    rows[:, 0] = kinds
    for kind in np.unique(kinds):
        sel = kinds == kind
        rows[sel, 1:] = _filter_rows(data, int(kind), bpp)[sel]
    header = struct.pack(">IIBBBBB", width, height, 8 * image.dtype.itemsize, 2 if rgb else 0,
                         0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray, filter_type=1) -> None:
    """Write ``image`` (``uint16`` or ``uint8``, 2-D) as a greyscale PNG, or
    ``uint8 [H, W, 3]`` BGR as an RGB PNG."""
    Path(path).write_bytes(encode_png(image, filter_type))


def imwrite(path, image: np.ndarray) -> None:
    """``cv2.imwrite(path, image)`` for the formats the port writes, chosen
    by the extension as OpenCV chooses: ``.jpg``/``.jpeg`` through
    :func:`imwrite_jpeg` (``uint8 [H, W, 3]`` BGR), ``.png`` through
    :func:`write_png`. Another extension raises ``ValueError``."""
    suffix = Path(path).suffix.lower()
    if suffix in (".jpg", ".jpeg"):
        imwrite_jpeg(path, image)
    elif suffix == ".png":
        write_png(path, image)
    else:
        raise ValueError(f"imwrite: {suffix!r} (the port writes .jpg, .jpeg and .png)")


# ---------------------------------------------------------------------------
# Colour frames: JPEG (data/jpeg.py) and cv2's fixed-point bilinear resize.

def imread_color(path) -> np.ndarray:
    """The colour frame at ``path`` as ``cv2.imread(path)`` returns it:
    ``uint8 [H, W, 3]`` in BGR order (callers flip to RGB themselves, as
    the JAX package does with ``[:, :, ::-1]``). JPEG only, through
    ``data/jpeg.py``; a missing file raises ``FileNotFoundError``."""
    from handnet_tpu_torch.data import jpeg

    return jpeg.read_jpeg(path)


def imwrite_jpeg(path, image: np.ndarray, quality: int = 95) -> None:
    """Write ``uint8 [H, W, 3]`` BGR as ``cv2.imwrite`` does for a ``.jpg``
    path (quality 95, 4:2:0)."""
    from handnet_tpu_torch.data import jpeg

    jpeg.write_jpeg(path, image, quality)


def _linear_taps(src: int, dst: int):
    """OpenCV's per-output source index and 11-bit weight pair along one
    axis (``resize.cpp``: ``f = (float)((d + 0.5) * scale - 0.5)``, ``s =
    floor(f)``, weights ``saturate_cast<short>((1 - f, f) * 2048)``). An
    index left of 0 or right of ``src - 1`` is pinned there with ``f = 0``
    (the horizontal pass does so; the vertical one pins only the rows, so
    its weights keep ``f``)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    return s, f


def _weights(f: np.ndarray) -> np.ndarray:
    """``[n, 2]`` int32 ``saturate_cast<short>(cbuf * 2048)`` (round half to
    even, in float32)."""
    one = np.float32(1.0)
    w = np.stack([(one - f) * np.float32(2048), f * np.float32(2048)], axis=1)
    return np.rint(w).astype(np.int32)


def resize_linear_u8(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(image, (width, height))`` (INTER_LINEAR) of ``uint8
    [H, W]`` or ``[H, W, C]``, in OpenCV's fixed point.

    * the same size is a copy; a halving of both sides is INTER_AREA's
      2x2 mean, ``(a + b + c + d + 2) >> 2``, as OpenCV switches to it;
    * otherwise a horizontal pass of 11-bit weights into int32
      (``HResizeLinear``: ``S[x] * a0 + S[x + 1] * a1``), then a vertical
      one with the rounding of OpenCV's vector loop
      (``VResizeLinearVec_32s8u``): ``(((S0 >> 4) * b0 >> 16) + ((S1 >>
      4) * b1 >> 16) + 2) >> 2`` for every byte of a row. (Its scalar
      loop, ``FixedPtCast<int, uchar, 22>``, would round ``(S0 * b0 + S1 *
      b1 + 2^21) >> 22``, which differs by 1 now and then; neither cv2 5.0
      nor cv2 4.13 takes it for a row's last bytes.)
    """
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3):
        raise ValueError(f"resize_linear_u8: uint8 [H, W] or [H, W, C], got {image.dtype} "
                         f"{image.shape}")
    squeeze = image.ndim == 2
    src = image[:, :, None] if squeeze else image
    sh, sw, cn = src.shape
    if width < 1 or height < 1:
        raise ValueError(f"resize_linear_u8: output size {width}x{height}")
    if (sh, sw) == (height, width):
        out = src.copy()
    elif sw == 2 * width and sh == 2 * height:
        s = src.astype(np.int32)
        out = ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2) >> 2
               ).astype(np.uint8)
    else:
        sx, fx = _linear_taps(sw, width)
        left = sx < 0
        fx[left], sx[left] = 0, 0
        right = sx >= sw - 1
        fx[right], sx[right] = 0, sw - 1
        alpha = _weights(fx)
        sx1 = np.minimum(sx + 1, sw - 1)
        sy, fy = _linear_taps(sh, height)
        beta = _weights(fy)
        r0 = np.clip(sy, 0, sh - 1)
        r1 = np.clip(sy + 1, 0, sh - 1)
        # the horizontal pass over the source rows the output reads (int32:
        # at most 255 * 2048 per value, and a vertical sum below 2^31)
        rows = np.unique(np.concatenate([r0, r1]))
        s = src[rows].astype(np.int32)
        hbuf = s[:, sx] * alpha[None, :, 0, None]
        hbuf += s[:, sx1] * alpha[None, :, 1, None]
        hbuf = hbuf.reshape(len(rows), -1)
        s0 = hbuf[np.searchsorted(rows, r0)]
        s1 = hbuf[np.searchsorted(rows, r1)]
        b0, b1 = beta[:, :1], beta[:, 1:]
        v0, v1 = s0, s1
        v0 >>= 4
        v0 *= b0
        v0 >>= 16
        v1 >>= 4
        v1 *= b1
        v1 >>= 16
        v0 += v1
        v0 += 2
        v0 >>= 2
        out = np.clip(v0, 0, 255).astype(np.uint8).reshape(height, width, cn)
    return out[:, :, 0] if squeeze else out
