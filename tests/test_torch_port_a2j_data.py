"""The port's A2J data path (``handnet_tpu_torch/data``, ``eval/hpe.py``,
``utils/{meters,monitoring}.py``, the numpy geometry) against the JAX
package's, and its readers against ``cv2`` and ``yaml``, on the CPU.

The JAX package reads and writes its tree through ``cv2`` and ``yaml``; the
port reads it with ``image_io`` and ``yaml_lite`` and writes its own tree
with them. Inputs come from numpy seeds; one torch thread.

Tolerances: everything is bit-equal except where cv2 itself is the other
side of the augmented crop's rotation. The port's warp is OpenCV 4's
(samples on a 1/32-pixel grid): it is held bit for bit against a scalar
transcription of OpenCV 4's loops, and so is a whole augmented sample
against the JAX package's with that transcription in place of cv2. cv2
5.x places its samples in floating point instead, up to 1/64 pixel away
on each axis, so against the installed cv2 the bound is
``_grid_bound``: 1/32 of the largest step between neighbouring pixels of
the zero-bordered image (measured against cv2 5.0: 0.74 of the bound on random images,
4.6e-2 against 6.2e-2; 0.53 on depth scenes, 3.3e-2 m against 6.25e-2 m,
on the augmented samples too).
"""

import os
import pickle
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from handnet_tpu.data import a2j_data as ja2j
from handnet_tpu.data import dexycb as jdex
from handnet_tpu.data import loader as jloader
from handnet_tpu.data import rle as jrle
from handnet_tpu.data import synthetic as jsyn
from handnet_tpu.eval import hpe as jhpe
from handnet_tpu.ops import geometry as jgeo
from handnet_tpu.utils import meters as jmeters
from handnet_tpu.utils import monitoring as jmon
from handnet_tpu_torch.data import a2j_data as pa2j
from handnet_tpu_torch.data import dexycb as pdex
from handnet_tpu_torch.data import host_build, image_io, yaml_lite
from handnet_tpu_torch.data import loader as ploader
from handnet_tpu_torch.data import rle as prle
from handnet_tpu_torch.data import synthetic as psyn
from handnet_tpu_torch.eval import hpe as phpe
from handnet_tpu_torch.ops import geometry as pgeo
from handnet_tpu_torch.utils import meters as pmeters
from handnet_tpu_torch.utils import monitoring as pmon

REPO = Path(__file__).resolve().parents[1]
SAMPLE = pa2j.A2JSampleConfig(crop_w=48, crop_h=48)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The JAX writer's tree and the port's, at one seed (2 sequences of 3
    frames, 480x640), easy and hard."""
    out = {}
    for difficulty in ("easy", "hard"):
        base = tmp_path_factory.mktemp(f"dexycb_{difficulty}")
        out[difficulty] = {}
        for name, make in (("jax", jsyn.make_synthetic_dexycb),
                           ("port", psyn.make_synthetic_dexycb)):
            root = str(base / name)
            info = make(root, n_sequences=2, n_frames=3, seed=5, difficulty=difficulty)
            out[difficulty][name] = (root, info)
    return out


def _files(root, suffix):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob(f"*{suffix}"))


# ---------------------------------------------------------------------------
# image_io


def test_png_reader_matches_cv2_on_the_jax_tree(trees):
    root, _ = trees["easy"]["jax"]
    pngs = _files(root, ".png")
    assert len(pngs) == 6
    for rel in pngs:
        want = cv2.imread(os.path.join(root, rel), cv2.IMREAD_ANYDEPTH)
        got = image_io.read_png(os.path.join(root, rel))
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, "mixed"])
def test_png_filters_round_trip_through_cv2(tmp_path, dtype, filter_type):
    """A PNG of each filter type (and one row of each in turn): ``cv2``
    reads the writer's file as the array written, and the reader returns
    what ``cv2`` returns, bit for bit."""
    rng = np.random.default_rng(7)
    image = rng.integers(0, np.iinfo(dtype).max, size=(23, 37), endpoint=True).astype(dtype)
    image[5:12, 8:30] = image[5, 8]            # flat runs beside noise
    kinds = np.arange(23) % 5 if filter_type == "mixed" else filter_type
    path = tmp_path / "f.png"
    image_io.write_png(path, image, kinds)
    want = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH)
    np.testing.assert_array_equal(want, image)
    got = image_io.read_png(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_png_written_by_cv2_reads_back(tmp_path):
    rng = np.random.default_rng(8)
    for dtype in (np.uint8, np.uint16):
        image = rng.integers(0, np.iinfo(dtype).max, size=(31, 17)).astype(dtype)
        cv2.imwrite(str(tmp_path / "c.png"), image)
        np.testing.assert_array_equal(image_io.read_png(tmp_path / "c.png"), image)


def test_unfilter_kernel_matches_its_plain_version():
    """The C++ unfilter and the numpy routes against the byte-by-byte
    transcription, on random filtered bytes with every filter type, at one
    and two bytes per pixel."""
    rng = np.random.default_rng(9)
    for bpp, kinds in ((1, np.arange(40) % 5), (2, np.arange(40) % 5), (2, np.arange(40) % 3)):
        rows, stride = len(kinds), 18 * bpp
        raw = rng.integers(0, 256, size=(rows, stride + 1)).astype(np.uint8)
        raw[:, 0] = kinds
        want = image_io.unfilter_reference(raw.ravel(), rows, stride, bpp)
        got = image_io._unfilter(raw.ravel(), rows, stride, bpp)
        np.testing.assert_array_equal(got, want)
    raw[3, 0] = 7
    with pytest.raises(ValueError, match="filter type 7 in row 3"):
        image_io._unfilter(raw.ravel(), rows, stride, 2)


def _with_header(data: bytes, **fields) -> bytes:
    """``data`` with IHDR fields replaced (and its CRC made right)."""
    names = ("width", "height", "depth", "colour", "compression", "method", "interlace")
    values = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    values.update(fields)
    body = struct.pack(">IIBBBBB", *(values[n] for n in names))
    return (data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + data[33:])


def test_png_outside_the_subset_raises(tmp_path):
    rng = np.random.default_rng(10)
    # 8-bit RGB reads (tests/test_torch_port_vis_utils.py); 16-bit RGB does not
    cv2.imwrite(str(tmp_path / "rgb.png"), rng.integers(0, 65535, size=(8, 9, 3)).astype(np.uint16))
    with pytest.raises(ValueError, match="colour type 2"):
        image_io.read_png(tmp_path / "rgb.png")
    grey = image_io.encode_png(rng.integers(0, 65535, size=(8, 9)).astype(np.uint16))
    with pytest.raises(ValueError, match="interlace method 1"):
        image_io.decode_png(_with_header(grey, interlace=1))
    with pytest.raises(ValueError, match="colour type 3"):
        image_io.decode_png(_with_header(grey, colour=3))
    with pytest.raises(ValueError, match="bit depth 4"):
        image_io.decode_png(_with_header(grey, depth=4))
    broken = bytearray(grey)
    broken[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        image_io.decode_png(bytes(broken))
    with pytest.raises(ValueError, match="signature"):
        image_io.decode_png(b"GIF89a" + grey[6:])


# ---------------------------------------------------------------------------
# yaml_lite

DEXYCB_SAMPLES = [
    # meta.yml as DexYCB ships it: flow lists, quoted serials
    "serials: ['836212060125', '839512060362', '840412060917']\n"
    "num_frames: 72\nycb_ids: [11, 6, 1, 20]\nycb_grasp_ind: 3\n"
    "mano_sides: [right]\nmano_calib: ['20200709-subject-01']\n"
    "pcd_file: \"data/x.pcd\"   # a comment\n",
    # intrinsics with exponents, nested maps
    "color:\n  fx: 615.6326293945312\n  fy: 6.1e+2\n  ppx: 3.2e2\n  ppy: -1.5e-05\n"
    "depth:\n    fx: 385.0\n    ok: true\n    none: ~\n",
    # betas in both block-list styles
    "betas:\n- 0.6993994116783142\n- -0.16909725964069366\n- 1.0e-05\n"
    "other:\n  - .5\n  - [1, [2, 'a, b']]\n  - - x\n    - y\n  - a: 1\n    b: null\n",
    "k: 'it''s'\nd: \"tab\\there\"\ne: []\nf: {}\ng:\nh: 0\n",
]


def test_yaml_lite_reads_what_yaml_reads(trees):
    root, _ = trees["easy"]["jax"]
    ymls = _files(root, ".yml")
    assert len(ymls) == 4
    for rel in ymls:
        text = Path(root, rel).read_text()
        assert yaml_lite.loads(text) == yaml.safe_load(text), rel
    for text in DEXYCB_SAMPLES:
        assert yaml_lite.loads(text) == yaml.safe_load(text), text


def test_yaml_lite_writes_what_yaml_reads():
    objs = [yaml.safe_load(t) for t in DEXYCB_SAMPLES] + [
        {"serial": "836212060125", "odd": ["yes", "010", "a: b", "- x", "", " pad", "#c"],
         "floats": [1e-05, 1e20, -0.0, float("inf")], "nested": [{"a": [1, 2]}, [[3]]]}]
    for obj in objs:
        text = yaml_lite.dumps(obj)
        assert yaml.safe_load(text) == obj, text
        assert yaml_lite.loads(text) == obj, text
        assert yaml_lite.loads(yaml.safe_dump(obj)) == obj


@pytest.mark.parametrize("text, line", [
    ("a: 1\nb: |\n  x\n", 2), ("a: &x 1\n", 1), ("a: *x\n", 1), ("a: !!str 1\n", 1),
    ("a: 0x1f\n", 1), ("a: 017\n", 1), ("a: 1:30\n", 1), ("a: 2001-12-14\n", 1),
    ("a: {b: 1}\n", 1), ("a: b\n  c\n", 2), ("a:\n\tb: 1\n", 2), ("a: [1, 2\n", 1),
    ("a: 'x\n", 1), ("a: 1\n---\nb: 2\n", 2),
])
def test_yaml_lite_refuses_what_it_does_not_read(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        yaml_lite.loads(text)


# ---------------------------------------------------------------------------
# rle


def _masks(seed):
    rng = np.random.default_rng(seed)
    out = [np.zeros((30, 40), np.uint8), np.ones((30, 40), np.uint8)]
    for _ in range(4):
        m = np.zeros((30, 40), np.uint8)
        y, x = rng.integers(0, 25), rng.integers(0, 35)
        m[y:y + rng.integers(1, 10), x:x + rng.integers(1, 10)] = 1
        out.append(m)
    out.append((rng.uniform(size=(30, 40)) > 0.7).astype(np.uint8))
    return out


def test_rle_matches_the_jax_module():
    masks = _masks(11)
    for native in (True, False):
        rles = [prle.encode(m, native=native) for m in masks]
        assert rles == [jrle.encode(m) for m in masks]
        for r, m in zip(rles, masks):
            np.testing.assert_array_equal(prle.decode(r, native=native), m)
            np.testing.assert_array_equal(prle.toBbox(r, native=native), jrle.toBbox(r))
            assert prle.area(r, native=native) == jrle.area(r) == int(m.sum())
        crowd = [i % 2 for i in range(len(rles))]
        np.testing.assert_array_equal(prle.iou(rles, rles, crowd, native=native),
                                      jrle.iou(rles, rles, crowd))
        for intersect in (False, True):
            assert (prle.merge(rles[2:], intersect, native=native)
                    == jrle.merge(rles[2:], intersect))
    stack = np.asfortranarray(np.stack(masks, axis=2))
    assert prle.encode(stack) == jrle.encode(stack)
    counts = np.random.default_rng(12).integers(0, 5000, size=50)
    assert prle.counts_to_string(counts) == jrle.counts_to_string(counts)
    text = prle.counts_to_string(counts)
    np.testing.assert_array_equal(prle.string_to_counts(text), jrle.string_to_counts(text))


def test_rle_builds_outside_native(monkeypatch):
    """The port builds ``native/rle/rle.cpp`` into ``build/`` and writes
    nothing under ``native/``."""
    before = sorted(p.name for p in (REPO / "native").rglob("*"))
    compiled = []
    run = host_build.subprocess.run
    monkeypatch.setattr(host_build.subprocess, "run",
                        lambda cmd, **kw: compiled.append(cmd) or run(cmd, **kw))
    host_build.load.cache_clear()
    lib = prle._lib()
    assert Path(lib._name).resolve().is_relative_to(host_build.BUILD_ROOT / "rle")
    for cmd in compiled:
        out = Path(cmd[cmd.index("-o") + 1]).resolve()
        assert out.is_relative_to(host_build.BUILD_ROOT), cmd
    assert sorted(p.name for p in (REPO / "native").rglob("*")) == before


# ---------------------------------------------------------------------------
# DexYCB and the synthetic tree


def _dataset_equal(pds, jds):
    assert len(pds) == len(jds) > 0
    for i in range(len(jds)):
        assert pds[i] == jds[i]


def test_dexycb_reader_matches_the_jax_reader(trees, tmp_path):
    root, _ = trees["easy"]["jax"]
    for split in ("train", "val", "test"):
        pds, jds = pdex.DexYCBDataset("s0", split, root), jdex.DexYCBDataset("s0", split, root)
        assert len(pds) == len(jds)
        if len(jds):
            _dataset_equal(pds, jds)
    pds, jds = pdex.get_dataset("s0_train", root), jdex.DexYCBDataset("s0", "train", root)
    _dataset_equal(pds, jds)
    cache = str(tmp_path / "cache" / "idx.pkl")
    keep = pdex.refine_indices(pds, cache_path=cache)
    assert keep == jdex.refine_indices(jds)
    with open(cache, "rb") as f:
        assert pickle.load(f) == keep
    assert pdex.refine_indices(pds, cache_path=cache) == keep
    pgt, jgt = pdex.hpe_ground_truth(pds), jdex.hpe_ground_truth(jds)
    assert pgt.keys() == jgt.keys()
    for k in jgt:
        np.testing.assert_array_equal(pgt[k], jgt[k])
    np.testing.assert_array_equal(pdex.paras_from_intrinsics(pds[0]["intrinsics"]),
                                  jdex.paras_from_intrinsics(jds[0]["intrinsics"]))


@pytest.mark.parametrize("difficulty", ["easy", "hard"])
def test_port_tree_equals_the_jax_tree(trees, difficulty):
    """At one seed the port's writer makes the JAX writer's depth, labels,
    YAML contents and info dict, and its colour JPEGs byte for byte, and the
    JAX package's own reader and A2JDataSource read both trees alike."""
    (jroot, jinfo), (proot, pinfo) = trees[difficulty]["jax"], trees[difficulty]["port"]
    assert pinfo.keys() == jinfo.keys()
    for key in jinfo:
        assert pinfo[key].keys() == jinfo[key].keys()
        for field in jinfo[key]:
            np.testing.assert_array_equal(pinfo[key][field], jinfo[key][field])
    assert _files(proot, ".png") == _files(jroot, ".png")
    assert _files(proot, ".jpg") == _files(jroot, ".jpg") != []
    for rel in _files(jroot, ".jpg"):
        assert Path(proot, rel).read_bytes() == Path(jroot, rel).read_bytes(), rel
    for rel in _files(jroot, ".png"):
        np.testing.assert_array_equal(cv2.imread(os.path.join(proot, rel), cv2.IMREAD_ANYDEPTH),
                                      cv2.imread(os.path.join(jroot, rel), cv2.IMREAD_ANYDEPTH))
    for rel in _files(jroot, ".npz"):
        a, b = np.load(os.path.join(proot, rel)), np.load(os.path.join(jroot, rel))
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert _files(proot, ".yml") == _files(jroot, ".yml")
    for rel in _files(jroot, ".yml"):
        assert (yaml.safe_load(Path(proot, rel).read_text())
                == yaml.safe_load(Path(jroot, rel).read_text()))
    jds, pds = jdex.DexYCBDataset("s0", "train", jroot), jdex.DexYCBDataset("s0", "train", proot)
    for augment in (False, True):
        srcs = [ja2j.A2JDataSource(ds, jdex.refine_indices(ds), augment, SAMPLE, seed=3)
                for ds in (jds, pds)]
        for i in range(len(srcs[0])):
            a, b = srcs[0][i], srcs[1][i]
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# A2J samples


def _depth_scene(rng, h=120, w=160):
    """A depth map in metres: background, an object and a hand with bumps,
    and its seg."""
    depth = np.full((h, w), 2.0, np.float32)
    seg = np.zeros((h, w), np.uint8)
    depth[h // 12:h // 4, w // 16:w // 4] = 1.5
    seg[h // 12:h // 4, w // 16:w // 4] = 1
    y, x = rng.integers(h // 4, h // 2), rng.integers(w // 4, w // 2)
    size = int(rng.integers(h // 5, h // 3))
    depth[y:y + size, x:x + size] = rng.uniform(0.4, 0.8)
    seg[y:y + size, x:x + size] = 255
    depth[y:y + size, x:x + size] -= rng.uniform(0, 0.03, size=(size, size)).astype(np.float32)
    joints = np.stack([rng.uniform(x, x + size, 21), rng.uniform(y, y + size, 21),
                       np.full(21, float(depth[y, x]))], axis=1)
    paras = np.array([300.0, 300.0, w / 2, h / 2], np.float32)
    xyz = joints.copy()
    xyz[:, :2] = (joints[:, :2] - paras[2:]) * joints[:, 2:] / paras[:2]
    return depth, seg, xyz.astype(np.float32), paras


def test_build_sample_without_augmentation_is_exact():
    rng = np.random.default_rng(13)
    for _ in range(5):
        depth, seg, xyz, paras = _depth_scene(rng)
        a = pa2j.build_a2j_sample(depth, seg, xyz, paras, cfg=SAMPLE)
        b = ja2j.build_a2j_sample(depth, seg, xyz, paras, cfg=SAMPLE)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(pa2j.xyz2uvd_np(xyz, paras), ja2j.xyz2uvd_np(xyz, paras))
    np.testing.assert_array_equal(pa2j.hand_bbox_from_seg(seg), ja2j.hand_bbox_from_seg(seg))
    assert pa2j.hand_bbox_from_seg(np.zeros_like(seg)) is None


def _grid_bound(img) -> float:
    """How far OpenCV 4's bilinear sample (on the 1/32-pixel grid) can be
    from cv2 5's (at the float coordinate): 1/64 pixel on each axis times
    the largest step between neighbouring pixels of the zero-bordered
    image, plus float32 rounding."""
    padded = np.pad(np.asarray(img, np.float64), 1)
    step = max(np.abs(np.diff(padded, axis=a)).max() for a in (0, 1))
    return step / 32 * (1 + 1e-5)


@pytest.fixture
def jax_warp_opencv4(monkeypatch):
    """The JAX package's augmentation with OpenCV 4's warp (a scalar
    transcription) where it calls ``cv2.warpAffine``."""
    monkeypatch.setattr(ja2j, "_warp_affine_nearest", _warp_opencv4)


def test_build_sample_with_augmentation(jax_warp_opencv4):
    """Same draws, so the box and ``jt_uvd`` are exact, and with OpenCV 4's
    warp on the JAX side the depth is too."""
    for seed in range(12):
        rng = np.random.default_rng(100 + seed)
        depth, seg, xyz, paras = _depth_scene(rng)
        cfg = pa2j.A2JSampleConfig(crop_w=48, crop_h=48, rand_scale_frac=0.2 * (seed % 2))
        a = pa2j.build_a2j_sample(depth, seg, xyz, paras, augment=True,
                                  rng=np.random.default_rng(seed), cfg=cfg)
        b = ja2j.build_a2j_sample(depth, seg, xyz, paras, augment=True,
                                  rng=np.random.default_rng(seed), cfg=cfg)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_build_sample_against_cv2_installed():
    """Against the JAX package's own cv2 route: the box and ``jt_uvd``
    exact, the depth within ``_grid_bound`` of its crop."""
    for seed in range(12):
        rng = np.random.default_rng(100 + seed)
        depth, seg, xyz, paras = _depth_scene(rng)
        a = pa2j.build_a2j_sample(depth, seg, xyz, paras, augment=True,
                                  rng=np.random.default_rng(seed), cfg=SAMPLE)
        b = ja2j.build_a2j_sample(depth, seg, xyz, paras, augment=True,
                                  rng=np.random.default_rng(seed), cfg=SAMPLE)
        for k in ("jt_uvd", "box", "paras"):
            np.testing.assert_array_equal(a[k], b[k])
        assert np.abs(a["depth"] - b["depth"]).max() <= _grid_bound(depth)


def test_warp_matches_cv2_over_many_angles():
    """Against the installed cv2 over 37 angles, on a depth scene, noise and
    a colour image: within ``_grid_bound`` (bit-equal where cv2 is 4.x)."""
    rng = np.random.default_rng(14)
    depth, *_ = _depth_scene(rng, 48, 64)
    noise = rng.uniform(0, 2, size=(48, 64)).astype(np.float32)
    colour = rng.uniform(0, 255, size=(48, 64, 3)).astype(np.float32)
    for angle in np.linspace(-180, 179, 37):
        m = pa2j._rotation_matrix(32.0, 24.0, float(angle))
        for img in (depth, noise, colour):
            err = np.abs(pa2j.warp_affine_bilinear(img, m, 64, 48)
                         - cv2.warpAffine(img, m, (64, 48))).max()
            assert err <= _grid_bound(img), (angle, err)


def _warp_opencv4(img, m, out_w, out_h):
    """OpenCV 4's WarpAffineInvoker and remapBilinear for a float32 image,
    pixel by pixel: the inverse map in 10-bit fixed point (rounded half to
    even), shifted to a 1/32-pixel grid, the table's float32 weights, 0
    outside the image."""
    inv = cv2.invertAffineTransform(m)
    h, w = img.shape
    out = np.zeros((out_h, out_w), np.float32)
    one = np.float32(1)
    for y in range(out_h):
        x_row = round((inv[0, 1] * y + inv[0, 2]) * 1024) + 16
        y_row = round((inv[1, 1] * y + inv[1, 2]) * 1024) + 16
        for x in range(out_w):
            sx = (x_row + round(inv[0, 0] * x * 1024)) >> 5
            sy = (y_row + round(inv[1, 0] * x * 1024)) >> 5
            fx, fy = np.float32((sx & 31) / 32), np.float32((sy & 31) / 32)
            sx, sy = sx >> 5, sy >> 5
            taps = [img[j, i] if 0 <= i < w and 0 <= j < h else np.float32(0)
                    for j, i in ((sy, sx), (sy, sx + 1), (sy + 1, sx), (sy + 1, sx + 1))]
            weights = ((one - fy) * (one - fx), (one - fy) * fx, fy * (one - fx), fy * fx)
            acc = np.float32(0)
            for v, wt in zip(taps, weights):
                acc = np.float32(acc + v * wt)
            out[y, x] = acc
    return out


def test_warp_matches_opencv4_transcription():
    """The warp against a scalar transcription of OpenCV 4's loops, bit for
    bit, on a random image and a depth scene."""
    rng = np.random.default_rng(19)
    img = rng.uniform(0, 2, size=(13, 17)).astype(np.float32)
    for angle in (-150.0, -33.0, 7.0, 90.0, 121.0):
        m = pa2j._rotation_matrix(8.5, 6.5, angle)
        np.testing.assert_array_equal(pa2j.warp_affine_bilinear(img, m, 17, 13),
                                      _warp_opencv4(img, m, 17, 13))


def test_resize_nearest_is_cv2_inter_nearest():
    rng = np.random.default_rng(15)
    for h, w in ((480, 640), (37, 91), (61, 59), (176, 176), (7, 300)):
        img = rng.uniform(size=(h, w)).astype(np.float32)
        for oh, ow in ((176, 176), (48, 48), (37, 91)):
            np.testing.assert_array_equal(
                pa2j.resize_nearest(img, ow, oh),
                cv2.resize(img, (ow, oh), interpolation=cv2.INTER_NEAREST))


def test_rgbd_source_is_refused(trees):
    """``with_color=True`` is no longer refused: the port's tree now has its
    colour JPEGs, and the sample carries the colour crop (BGR, as the JAX
    package reads it, over 255) before the depth in ``rgbd``."""
    root, _ = trees["easy"]["port"]
    ds = pdex.DexYCBDataset("s0", "train", root)
    item = pa2j.A2JDataSource(ds, [0], augment=False, with_color=True)[0]
    assert item["rgbd"].shape[-1] == 4 and item["rgbd"].dtype == np.float32
    np.testing.assert_array_equal(item["rgbd"][..., :3], item["color"].astype(np.float32))
    np.testing.assert_array_equal(item["rgbd"][..., 3:], item["depth"])
    assert 0.0 <= item["color"].min() and item["color"].max() <= 1.0


# ---------------------------------------------------------------------------
# the loader


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray([i]), "x": np.full((2, 3), i, np.float32)}


@pytest.mark.parametrize("n, batch, shuffle, drop_last, shards", [
    (23, 4, True, True, 1), (23, 4, True, False, 1), (23, 5, False, False, 1),
    (23, 4, True, False, 3), (8, 8, True, True, 2),
])
def test_loader_matches_the_jax_loader(n, batch, shuffle, drop_last, shards):
    for shard in range(shards):
        for epoch in (0, 1):
            loaders = [mod.PrefetchLoader(_Indexed(n), batch, shuffle=shuffle, num_workers=1,
                                          drop_last=drop_last, seed=4, shard_id=shard,
                                          num_shards=shards)
                       for mod in (ploader, jloader)]
            for ld in loaders:
                ld.set_epoch(epoch)
            assert len(loaders[0]) == len(loaders[1])
            got, want = list(loaders[0]), list(loaders[1])
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.keys() == b.keys()
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k])


def test_a2j_batches_match_jax_with_one_worker(trees, jax_warp_opencv4):
    """``A2JDataSource`` through ``PrefetchLoader`` with one worker: the
    same order and draws as the JAX package's (the shared Generator), and,
    with OpenCV 4's warp on the JAX side, the same batches."""
    root, _ = trees["easy"]["jax"]
    pds, jds = pdex.DexYCBDataset("s0", "train", root), jdex.DexYCBDataset("s0", "train", root)
    idx = jdex.refine_indices(jds)
    runs = []
    for src_mod, ds, ld_mod in ((pa2j, pds, ploader), (ja2j, jds, jloader)):
        ld = ld_mod.PrefetchLoader(src_mod.A2JDataSource(ds, idx, True, SAMPLE, seed=6), 2,
                                   shuffle=True, num_workers=1, drop_last=False)
        ld.set_epoch(1)
        runs.append(list(ld))
    assert len(runs[0]) == len(runs[1]) == 3
    for a, b in zip(*runs):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# geometry, the evaluator, meters and monitoring


def test_geometry_matches_jax():
    rng = np.random.default_rng(16)
    pts = np.concatenate([rng.normal(0, 0.1, (4, 21, 2)), rng.uniform(0.4, 1.0, (4, 21, 1))],
                         axis=-1).astype(np.float32)
    paras = np.tile(np.array([600.0, 610.0, 320.0, 240.0], np.float32), (4, 1))
    got = pgeo.xyz2uvd(torch.from_numpy(pts), torch.from_numpy(paras)).numpy()
    want = np.asarray(jgeo.xyz2uvd(pts, paras))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)   # float32, one rounding
    a, b = rng.normal(size=(21, 3)), rng.normal(size=(21, 3))
    np.testing.assert_array_equal(pgeo.align_w_scale_np(a, b), jgeo.align_w_scale_np(a, b))
    for x, y in zip(pgeo.align_w_scale_np(a, b, True), jgeo.align_w_scale_np(a, b, True)):
        np.testing.assert_array_equal(x, y)


def test_hpe_evaluator_matches_jax(tmp_path):
    rng = np.random.default_rng(17)
    gt = {i: rng.normal(0, 80, (21, 3)) + [0, 0, 600] for i in range(12)}
    preds = {i: gt[i] + rng.normal(0, 8 + i, (21, 3)) for i in range(12) if i != 5}
    lines = [phpe.format_result_line(i, p) for i, p in preds.items()]
    assert lines == [jhpe.format_result_line(i, p) for i, p in preds.items()]
    res_file = tmp_path / "res.txt"
    res_file.write_text("\n".join(lines) + "\n")
    assert phpe.parse_result_file(str(res_file)).keys() == jhpe.parse_result_file(
        str(res_file)).keys()
    out = {}
    for name, mod in (("port", phpe), ("jax", jhpe)):
        ev = mod.HPEEvaluator(gt)
        results = ev.evaluate(3, str(res_file))
        d = tmp_path / name
        ev.save_epoch_metrics(str(d))
        assert ev.save_pck_curves(str(d), 4) is None
        ev.save_pck_curves(str(d), 3)
        out[name] = (results, ev.report(results), (d / "hpe_curve_3.html").read_text(),
                     pickle.loads((d / "hpe_epoch_metrics.pkl").read_bytes()))
    (pres, prep, phtml, pkl), (jres, jrep, jhtml, jkl) = out["port"], out["jax"]
    assert pres == jres and prep == jrep and phtml == jhtml
    for align in ("ab", "rr", "pa"):
        for field in range(4):
            np.testing.assert_array_equal(pkl[align]["3"][field], jkl[align]["3"][field])
    bad = tmp_path / "bad.txt"
    bad.write_text("1,2,3\n")
    with pytest.raises(ValueError, match="64 comma-separated"):
        phpe.parse_result_file(str(bad))


def test_meters_and_monitoring_match_jax(tmp_path):
    rng = np.random.default_rng(18)
    values = rng.uniform(0, 5, size=(7, 3))
    files = {}
    for name, meters, mon in (("port", pmeters, pmon), ("jax", jmeters, jmon)):
        d = tmp_path / name
        monitor = mon.Monitor(str(d))
        am, logger = meters.AverageMeters(), meters.MetricLogger(window_size=4)
        for epoch, row in enumerate(values):
            am.update({"a": row[0], "b": row[1]}, n=epoch + 1)
            logger.update(loss=row[2])
            monitor.log_train(epoch, am.averages())
            monitor.log_val(epoch, {"mpjpe": row[2]})
        printed = []
        list(logger.log_every(range(3), 2, "h", printer=printed.append))
        monitor.metrics.save_metrics()
        monitor.metrics.plot_metrics()
        mon.save_args({"lr": 0.1, "name": "x"}, str(d))
        files[name] = {p.name: p.read_text() for p in sorted(d.iterdir())}
        files[name]["logs"] = repr(mon.get_logs(str(d / "train.txt")))
        files[name]["meters"] = (str(logger), am.averages(), len(printed))
    assert files["port"] == files["jax"]
