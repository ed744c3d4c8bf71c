"""The port's JPEG codec (``data/jpeg.py``, ``data/jpeg_codec.cpp``) and
its fixed-point bilinear resize (``image_io.resize_linear_u8``) against the
installed ``cv2``, on the CPU.

Every comparison here is bit for bit (tolerance 0), as measured: the
decoder equals ``cv2.imread`` on every file below, the encoder's bytes
equal ``cv2.imencode``'s, and the resize equals ``cv2.resize`` and a
per-pixel transcription of OpenCV's loops (cv2 4.13 on the H100 machine's
host agrees with both: ``chip_smoke.py``'s ``[fcos_apps]`` phase).
"""

import struct

import cv2
import numpy as np
import pytest
import torch

from handnet_tpu.data.synthetic import make_synthetic_dexycb as jax_synthetic
from handnet_tpu_torch.data import image_io, jpeg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame(h, w, seed=0):
    """Smooth colour content plus noise: coefficients of every size."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, size=(h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR)
    return np.clip(img.astype(np.int16) + rng.integers(-20, 21, size=img.shape),
                   0, 255).astype(np.uint8)


def _cv2_bytes(img, *params):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _cv2_decode(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


SIZES = [(1, 1), (17, 33), (479, 641)]
SAMPLINGS = {"444": 0x111111, "422": 0x211111, "420": 0x221111}


def test_decode_equals_cv2_on_the_jax_tree(tmp_path):
    """JAX's synthetic tree's colour frames (cv2.imwrite at 480x640)."""
    jax_synthetic(str(tmp_path), n_sequences=1, n_frames=3, seed=5, difficulty="hard")
    files = sorted(tmp_path.rglob("color_*.jpg"))
    assert len(files) == 3
    for f in files:
        got = jpeg.read_jpeg(f)
        assert got.dtype == np.uint8 and got.shape == (480, 640, 3)
        np.testing.assert_array_equal(got, cv2.imread(str(f)))
        np.testing.assert_array_equal(image_io.imread_color(f), got)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_decode_equals_cv2(size, sampling):
    img = _frame(*size, seed=size[1])
    for quality in (50, 75, 95, 100):
        data = _cv2_bytes(img, cv2.IMWRITE_JPEG_QUALITY, quality,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling])
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), _cv2_decode(data),
                                      err_msg=f"quality {quality}")


@pytest.mark.parametrize("size", SIZES + [(480, 640)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_greyscale_and_restarts_equal_cv2(size):
    img = _frame(*size, seed=7)
    grey = _cv2_bytes(img[:, :, 1])
    np.testing.assert_array_equal(jpeg.decode_jpeg(grey), _cv2_decode(grey))
    restarts = _cv2_bytes(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 3)
    assert b"\xff\xdd" in restarts   # a DRI marker
    np.testing.assert_array_equal(jpeg.decode_jpeg(restarts), _cv2_decode(restarts))


def _without_jfif_ids_rgb(data: bytes) -> bytes:
    """cv2's file with its JFIF segment dropped and the component ids 1, 2,
    3 renamed 'R', 'G', 'B' in the frame and the scan headers."""
    assert data[2:4] == b"\xff\xe0"
    data = data[:2] + data[4 + int.from_bytes(data[4:6], "big"):]
    for marker, first in ((b"\xff\xc0", 10), (b"\xff\xda", 5)):
        at = data.index(marker)
        step = 3 if marker == b"\xff\xc0" else 2
        body = bytearray(data)
        for i, cid in enumerate(b"RGB"):
            body[at + first + step * i] = cid
        data = bytes(body)
    return data


def test_component_ids_rgb_decode_as_cv2():
    """With no JFIF segment, ids 'R', 'G', 'B' mean no colour transform
    (jdapimin.c), and ids 1, 2, 3 mean YCbCr: both as cv2 decodes them."""
    img = _frame(24, 40, seed=9)
    for sampling in SAMPLINGS.values():
        data = _cv2_bytes(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling)
        rgb = _without_jfif_ids_rgb(data)
        want = _cv2_decode(rgb)
        assert want is not None and not np.array_equal(want, _cv2_decode(data))
        np.testing.assert_array_equal(jpeg.decode_jpeg(rgb), want)
        no_jfif = data[:2] + data[4 + int.from_bytes(data[4:6], "big"):]
        np.testing.assert_array_equal(jpeg.decode_jpeg(no_jfif), _cv2_decode(no_jfif))


def test_truncated_file_decodes_as_cv2(tmp_path):
    """libjpeg reads zero bits past the data, then grey MCUs, and
    ``cv2.imread`` returns the frame; so does the port."""
    data = _cv2_bytes(_frame(40, 56))
    for cut in (50, 200, 500):
        path = tmp_path / f"cut{cut}.jpg"
        path.write_bytes(data[:len(data) - cut])
        want = cv2.imread(str(path))
        assert want is not None
        np.testing.assert_array_equal(jpeg.read_jpeg(path), want)


def _with_exif(data: bytes, orientation: int, little_endian: bool) -> bytes:
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2_applies_it(tmp_path, orientation):
    data = _cv2_bytes(_frame(24, 40, seed=orientation))
    for le in (True, False):
        path = tmp_path / f"o{orientation}{le}.jpg"
        path.write_bytes(_with_exif(data, orientation, le))
        want = cv2.imread(str(path))
        got = jpeg.read_jpeg(path)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _patched_sof(data: bytes, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` after the SOF0 marker set."""
    at = data.index(b"\xff\xc0") + offset
    return data[:at] + bytes([value]) + data[at + 1:]


def test_unread_files_raise_naming_the_field(tmp_path):
    img = _frame(32, 48)
    progressive = _cv2_bytes(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    with pytest.raises(ValueError, match="progressive"):
        jpeg.decode_jpeg(progressive)
    base = _cv2_bytes(img)
    with pytest.raises(ValueError, match="precision 12"):
        jpeg.decode_jpeg(_patched_sof(base, 4, 12))
    with pytest.raises(ValueError, match="4 components"):      # CMYK/YCCK
        jpeg.decode_jpeg(_patched_sof(base, 9, 4))
    with pytest.raises(ValueError, match="arithmetic"):
        jpeg.decode_jpeg(base.replace(b"\xff\xc0", b"\xff\xc9", 1))
    with pytest.raises(ValueError, match="lossless"):
        jpeg.decode_jpeg(base.replace(b"\xff\xc0", b"\xff\xc3", 1))
    with pytest.raises(ValueError, match="sampling factors 4x1"):
        jpeg.decode_jpeg(_cv2_bytes(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x411111))
    with pytest.raises(ValueError, match="SOI"):
        jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(FileNotFoundError):
        image_io.imread_color(tmp_path / "missing.jpg")


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (17, 33), (30, 30), (479, 641), (480, 640)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_encoder_bytes_equal_cv2(size, tmp_path):
    """The port's file is cv2's byte for byte (so cv2 decodes both alike),
    at quality 95 (cv2's default) and three others."""
    img = _frame(*size, seed=size[0])
    for quality in (95, 50, 75, 100):
        want = _cv2_bytes(img, cv2.IMWRITE_JPEG_QUALITY, quality)
        got = jpeg.encode_jpeg(img, quality)
        np.testing.assert_array_equal(_cv2_decode(got), _cv2_decode(want))
        assert got == want, f"quality {quality}"
    with pytest.raises(ValueError, match="BGR"):
        jpeg.encode_jpeg(img[:, :, 0])
    path = tmp_path / "w.jpg"
    image_io.imwrite_jpeg(path, img)
    cv2.imwrite(str(tmp_path / "c.jpg"), img)
    assert path.read_bytes() == (tmp_path / "c.jpg").read_bytes()
    np.testing.assert_array_equal(image_io.imread_color(path), cv2.imread(str(path)))


# ---------------------------------------------------------------------------
# resize_linear_u8


def _resize_transcription(src, dw, dh):
    """OpenCV's INTER_LINEAR for uint8, pixel by pixel (resize.cpp:
    ``resize`` -> the same-size copy, the 2x ``INTER_AREA`` switch, or
    ``resizeGeneric_`` with ``HResizeLinear`` and ``VResizeLinear``, every
    byte with ``VResizeLinearVec_32s8u``'s rounding)."""
    sh, sw, cn = src.shape
    if (sh, sw) == (dh, dw):
        return src.copy()
    if sw == 2 * dw and sh == 2 * dh:
        out = np.zeros((dh, dw, cn), np.uint8)
        for y in range(dh):
            for x in range(dw):
                for c in range(cn):
                    s = (int(src[2 * y, 2 * x, c]) + int(src[2 * y, 2 * x + 1, c])
                         + int(src[2 * y + 1, 2 * x, c]) + int(src[2 * y + 1, 2 * x + 1, c]))
                    out[y, x, c] = (s + 2) >> 2
        return out
    scale_x, scale_y = 1.0 / (dw / sw), 1.0 / (dh / sh)

    def coef(f):
        return (int(np.rint(np.float32(np.float32(1.0) - f) * np.float32(2048))),
                int(np.rint(np.float32(f * np.float32(2048)))))

    xofs, alpha = [], []
    for dx in range(dw):
        fx = np.float32((dx + 0.5) * scale_x - 0.5)
        sx = int(np.floor(fx))
        fx = np.float32(fx - np.float32(sx))
        if sx < 0:
            fx, sx = np.float32(0), 0
        if sx >= sw - 1:
            fx, sx = np.float32(0), sw - 1
        xofs.append(sx)
        alpha.append(coef(fx))
    out = np.zeros((dh, dw, cn), np.uint8)
    for dy in range(dh):
        fy = np.float32((dy + 0.5) * scale_y - 0.5)
        sy = int(np.floor(fy))
        fy = np.float32(fy - np.float32(sy))
        b0, b1 = coef(fy)
        rows = []
        for k in (0, 1):
            r = min(max(sy + k, 0), sh - 1)
            hrow = []
            for dx in range(dw):
                sx, (a0, a1) = xofs[dx], alpha[dx]
                for c in range(cn):
                    hrow.append(int(src[r, sx, c]) * a0
                                + int(src[r, min(sx + 1, sw - 1), c]) * a1)
            rows.append(hrow)
        for x in range(dw * cn):
            s0, s1 = rows[0][x], rows[1][x]
            v = ((((s0 >> 4) * b0) >> 16) + (((s1 >> 4) * b1) >> 16) + 2) >> 2
            out[dy, x // cn, x % cn] = min(max(v, 0), 255)
    return out


def test_resize_linear_equals_its_transcription():
    rng = np.random.default_rng(3)
    pairs = [((3, 4), (12, 16)), ((12, 16), (5, 7)), ((6, 8), (3, 4)), ((9, 9), (9, 9)),
             ((1, 5), (4, 3)), ((7, 3), (11, 13)), ((10, 14), (10, 29))]
    for (sh, sw), (dh, dw) in pairs:
        for cn in (1, 3):
            src = rng.integers(0, 256, size=(sh, sw, cn)).astype(np.uint8)
            want = _resize_transcription(src, dw, dh)
            np.testing.assert_array_equal(image_io.resize_linear_u8(src, dw, dh), want,
                                          err_msg=f"{(sh, sw)} -> {(dh, dw)} x{cn}")


def test_resize_linear_equals_cv2():
    """Up and down, odd and even, 1 and 3 channels: bit-equal to the
    installed cv2 (0 values differ over all of these)."""
    rng = np.random.default_rng(11)
    pairs = [((12, 16), (480, 640)), ((480, 640), (800, 1067)), ((600, 800), (800, 1067)),
             ((480, 640), (64, 85)), ((480, 640), (240, 320)), ((17, 33), (5, 7)),
             ((7, 5), (31, 29)), ((1, 1), (4, 4)), ((100, 60), (100, 61))]
    pairs += [((int(rng.integers(1, 200)), int(rng.integers(1, 200))),
               (int(rng.integers(1, 300)), int(rng.integers(1, 300)))) for _ in range(30)]
    for (sh, sw), (dh, dw) in pairs:
        for shape in ((sh, sw), (sh, sw, 3)):
            src = rng.integers(0, 256, size=shape).astype(np.uint8)
            np.testing.assert_array_equal(image_io.resize_linear_u8(src, dw, dh),
                                          cv2.resize(src, (dw, dh)),
                                          err_msg=f"{shape} -> {(dh, dw)}")
