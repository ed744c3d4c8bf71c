"""The port's drawing and serialization utilities against ``cv2`` and the
JAX package: ``utils/draw.py`` (OpenCV's ``drawing.cpp`` transcribed),
``utils/vistool.py`` and ``a2j_infer --vis``, ``utils/meshvis.py``, the
colour PNG of ``data/image_io.py``, ``utils/statepack.py`` with
``utils/msgpack_lite.py``, and ``convert/mano_assets.py``.

Drawing is held pixel for pixel against the installed ``cv2`` (and
through it against the JAX package's ``VisualUtil``, which draws with
``cv2``); written JPEGs byte for byte; the matplotlib figures pixel for
pixel against JAX's on the Agg canvas. The state files are held against
the JAX package's ``statepack`` (which serializes with flax) both ways, and
the MANO converter against the JAX converter's arrays.
"""

import itertools
import os
import pickle
import sys
import types
from types import SimpleNamespace

import cv2
import flax.serialization
import msgpack
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from handnet_tpu import config as jconfig
from handnet_tpu.convert import mano_assets as jmano_assets
from handnet_tpu.utils import meshvis as jmeshvis
from handnet_tpu.utils import statepack as jstatepack
from handnet_tpu.utils import vistool as jvistool
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.apps import a2j_infer
from handnet_tpu_torch.convert import mano_assets
from handnet_tpu_torch.convert.from_flax import (a2j_state_dict_from_flax,
                                                 a2j_variables_from_state_dict,
                                                 fcos_variables_from_state_dict)
from handnet_tpu_torch.data import image_io
from handnet_tpu_torch.models.a2j import A2JSystem
from handnet_tpu_torch.models.fcos import FCOSSystem
from handnet_tpu_torch.utils import draw, meshvis, msgpack_lite, statepack, vistool
from torch_port_fixtures import leaves_equal

H, W = 23, 31
COLOR = (10, 200, 30)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _canvas(channels=3):
    return np.random.default_rng(0).integers(0, 256, (H, W, channels)).astype(np.uint8)


# ---------------------------------------------------------------------------
# utils/draw.py

def _line_cases():
    """Every octant from inside points (steep, shallow, diagonal, axis
    aligned, a single point), segments crossing each edge, and ones wholly
    outside."""
    c = (15, 11)
    inside = [(c[0] + dx, c[1] + dy) for dx, dy in itertools.product((-9, -4, 0, 4, 9),
                                                                      (-7, -3, 0, 3, 7))]
    crossing = [((15, 11), p) for p in ((-20, 5), (50, 8), (12, -30), (9, 60), (-8, -9),
                                        (45, 40), (-100, 200), (300, -7))]
    outside = [((-5, -5), (-1, 30)), ((35, -2), (60, 40)), ((-10, 30), (40, 29)),
               ((-30, 20), (20, -40))]
    return [(c, p) for p in inside] + crossing + outside + [(b, a) for a, b in crossing]


@pytest.mark.parametrize("channels", [1, 3])
def test_line_matches_cv2(channels):
    for p1, p2 in _line_cases():
        want = _canvas(channels)
        cv2.line(want, p1, p2, COLOR[:channels], 1)
        got = draw.line(_canvas(channels), p1, p2, COLOR[:channels])
        assert np.array_equal(got, want), (p1, p2)


def test_circle_and_polylines_match_cv2():
    """Filled circles of radius 0-5 inside, on and past each border and
    corner; closed polylines of random triangles partly off the image."""
    centers = [(15, 11), (0, 0), (1, 1), (W - 1, H - 1), (W - 2, 5), (5, H - 2), (-2, 11),
               (W + 1, 11), (15, -3), (15, H + 2), (-6, -6)]
    for center, radius in itertools.product(centers, range(6)):
        want = _canvas()
        cv2.circle(want, center, radius, COLOR, -1)
        assert np.array_equal(draw.circle(_canvas(), center, radius, COLOR, -1), want), (
            center, radius)
    rng = np.random.default_rng(1)
    for _ in range(100):
        pts = rng.integers(-15, 45, (int(rng.integers(1, 5)), 2)).astype(np.int32)
        want = _canvas()
        cv2.polylines(want, [pts.reshape(-1, 1, 2)], True, COLOR, 1)
        assert np.array_equal(draw.polylines(_canvas(), pts, True, COLOR), want), pts.tolist()


# ---------------------------------------------------------------------------
# utils/vistool.py and a2j_infer --vis

def _joints(rng, n=21, size=48):
    """UVD joints mostly in the crop, a few outside it."""
    uvd = rng.uniform(-4, size + 4, (n, 3)).astype(np.float32)
    uvd[:, 2] = rng.uniform(0.3, 1.0, n)
    return uvd


@pytest.mark.parametrize("dataset", ["dexycb", "nyu", "icvl", "hands2017", "msra"])
def test_visualutil_and_minibatch_match_jax(dataset, tmp_path):
    """``VisualUtil.plot`` (prediction, ground truth, both) and
    ``vis_minibatch`` equal the JAX package's, which draws with ``cv2``; a
    ``.jpg`` is byte-equal to ``cv2.imwrite``'s, a ``.png`` pixel-equal."""
    rng = np.random.default_rng(2)
    n = {"nyu": 14, "icvl": 16}.get(dataset, 21)
    got_vt, want_vt = vistool.VisualUtil(dataset), jvistool.VisualUtil(dataset)
    img = rng.integers(0, 256, (48, 48, 3)).astype(np.uint8)
    gt, pred = _joints(rng, n), _joints(rng, n)
    for g, p in ((None, pred), (gt, None), (gt, pred)):
        got = got_vt.plot(img, None, g, p)
        assert np.array_equal(got, want_vt.plot(img, None, g, p))
        assert not np.array_equal(got, img)
    assert got_vt.plot(img, str(tmp_path / "a.jpg"), gt, pred) is True
    want_vt.plot(img, str(tmp_path / "b.jpg"), gt, pred)
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    got_vt.plot(img, str(tmp_path / "a.png"), gt, pred)
    want_vt.plot(img, str(tmp_path / "b.png"), gt, pred)
    assert np.array_equal(cv2.imread(str(tmp_path / "a.png")),
                          cv2.imread(str(tmp_path / "b.png")))
    depth = rng.uniform(0.2, 1.5, (5, 40, 40, 1)).astype(np.float32)
    gts = np.stack([_joints(rng, n, 40) for _ in range(5)])
    preds = np.stack([_joints(rng, n, 40) for _ in range(5)])
    got = vistool.vis_minibatch(None, depth, gts, got_vt, path=str(tmp_path / "g.jpg"),
                                jt_pred=preds)
    want = jvistool.vis_minibatch(None, depth, gts, want_vt, path=str(tmp_path / "w.jpg"),
                                  jt_pred=preds)
    assert got.shape == (80, 160, 3) and np.array_equal(got, want)
    assert (tmp_path / "g.jpg").read_bytes() == (tmp_path / "w.jpg").read_bytes()


def test_a2j_infer_vis_matches_jax(tmp_path):
    """``a2j_infer --vis`` writes one ``<name>_vis.jpg`` per frame, byte-equal
    to what the JAX app's ``--vis`` lines (``a2j_infer.py:102-114``: frames
    read and resized with ``cv2``, ``VisualUtil.plot``) write for the same
    UVD."""
    rng = np.random.default_rng(3)
    pngs = tmp_path / "pngs"
    pngs.mkdir()
    for i in range(3):
        image_io.write_png(pngs / f"d{i}.png", rng.integers(300, 1200, (30, 40)).astype(
            np.uint16))
    res = a2j_infer.main(["--input", str(pngs), "--output", str(tmp_path / "port"), "--crop",
                          "48", "--batch", "2", "--vis", "--device", "cpu"])
    files = sorted(str(p) for p in pngs.glob("*.png"))
    assert [os.path.basename(p) for p in res["vis"]] == ["d0_vis.jpg", "d1_vis.jpg",
                                                         "d2_vis.jpg"]
    vt = jvistool.VisualUtil("dexycb")
    (tmp_path / "jax").mkdir()
    for f, uvd, got in zip(files, res["uvd"], res["vis"]):
        crop = cv2.resize(cv2.imread(f, cv2.IMREAD_ANYDEPTH).astype(np.float32) / 1000.0,
                          (48, 48), interpolation=cv2.INTER_NEAREST)[..., None]
        vis = np.clip(crop[..., 0] * 255 / max(crop.max(), 1e-6), 0, 255).astype(np.uint8)
        want = str(tmp_path / "jax" / os.path.basename(got))
        vt.plot(np.repeat(vis[:, :, None], 3, axis=-1), want, None, uvd)
        with open(got, "rb") as g, open(want, "rb") as w:
            assert g.read() == w.read()


# ---------------------------------------------------------------------------
# utils/meshvis.py and the colour PNG

def test_meshvis_matches_jax():
    """``depth_colormap`` equals ``cv2.applyColorMap(COLORMAP_JET)`` for all
    256 values (and JAX's on metres); ``project_mesh`` and
    ``draw_mesh_wireframe`` equal JAX's, which draws with ``cv2``."""
    values = np.arange(256, dtype=np.uint8)[None]
    assert np.array_equal(meshvis.JET_LUT[values], cv2.applyColorMap(values, cv2.COLORMAP_JET))
    rng = np.random.default_rng(4)
    depth = rng.uniform(-0.5, 2.5, (30, 40))
    assert np.array_equal(meshvis.depth_colormap(depth), jmeshvis.depth_colormap(depth))
    verts = np.concatenate([rng.uniform(-60, 60, (40, 2)), rng.uniform(300, 500, (40, 1))], 1)
    faces = rng.integers(0, 40, (700, 3))
    paras = np.array([300.0, 300.0, 32.0, 24.0])
    assert np.array_equal(meshvis.project_mesh(verts, paras), jmeshvis.project_mesh(verts, paras))
    img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    got = meshvis.draw_mesh_wireframe(img, verts, faces, paras)
    assert np.array_equal(got, jmeshvis.draw_mesh_wireframe(img, verts, faces, paras))
    assert not np.array_equal(got, img)



def test_visualize_hand_batch_matches_jax(tmp_path):
    """The matplotlib figure helpers (``visualize_hand_batch`` over
    ``add_joints_3d``, ``equal_aspect_3d`` and ``add_mesh_3d``) on
    ``tests/test_e2e_data.py``'s inputs: the same axes as JAX's figure and
    the same pixels on the Agg canvas, a PNG written, and ``ValueError``
    with nothing to draw."""
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(6)
    b, j, v = 2, 21, 40
    kw = dict(images=rng.uniform(size=(b, 48, 64, 3)).astype(np.float32),
              joints2d_gt=rng.uniform(0, 48, size=(b, j, 2)).astype(np.float32),
              joints3d_gt=rng.normal(size=(b, j, 3)).astype(np.float32) * 30,
              verts3d=rng.normal(size=(b, v, 3)).astype(np.float32) * 30,
              faces=rng.integers(0, v, size=(60, 3)))
    kw.update(joints2d_pred=kw["joints2d_gt"] + 1, joints3d_pred=kw["joints3d_gt"] + 1)

    def pixels(fig):
        fig.canvas.draw()
        return np.asarray(fig.canvas.buffer_rgba()).copy()

    path = tmp_path / "grid.png"
    for args, save, n_axes in ((kw, str(path), 6), ({"joints3d_gt": kw["joints3d_gt"]}, None, 2)):
        got = meshvis.visualize_hand_batch(save, **args)
        want = jmeshvis.visualize_hand_batch(None, **args)
        assert len(got.axes) == len(want.axes) == n_axes
        assert np.array_equal(pixels(got), pixels(want))
        plt.close(got)
        plt.close(want)
    assert path.stat().st_size > 1000
    with pytest.raises(ValueError):
        meshvis.visualize_hand_batch(None)

def test_colour_png_against_cv2(tmp_path):
    """8-bit RGB PNG: the port's file (every filter type) reads back in
    ``cv2.imread`` as the BGR array written, and ``cv2``'s file (every
    compression level) decodes to the same pixels; 16-bit RGB is still
    refused, and greyscale is unchanged."""
    rng = np.random.default_rng(5)
    for shape in ((1, 1, 3), (17, 33, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        for kind in range(5):
            image_io.write_png(tmp_path / "p.png", img, kind)
            assert np.array_equal(cv2.imread(str(tmp_path / "p.png")), img)
        for level in (0, 1, 9):
            cv2.imwrite(str(tmp_path / "c.png"), img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            assert np.array_equal(image_io.read_png(tmp_path / "c.png"), img)
        image_io.imwrite(tmp_path / "q.png", img)
        assert np.array_equal(image_io.read_png(tmp_path / "q.png"), img)
    cv2.imwrite(str(tmp_path / "w.png"), rng.integers(0, 65535, (5, 6, 3)).astype(np.uint16))
    with pytest.raises(ValueError, match="bit depth 16 of colour type 2"):
        image_io.read_png(tmp_path / "w.png")
    with pytest.raises(ValueError, match=".tif"):
        image_io.imwrite(tmp_path / "x.tif", img)


# ---------------------------------------------------------------------------
# utils/msgpack_lite.py and utils/statepack.py

def test_msgpack_codec_matches_msgpack():
    """Every length class of every type the codec writes, byte for byte
    against ``msgpack.packb``, and read back as ``msgpack.unpackb`` reads
    it."""
    values = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
              -2 ** 63, 0.5, -1e300, "", "a" * 31, "a" * 32, "é" * 200, "b" * 70000, b"",
              b"x" * 255, b"y" * 256, b"z" * 70000, [], [1] * 15, [1] * 16, [2] * 70000,
              (1, "a"), {}, {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)}]
    for v in values:
        raw = msgpack.packb(v, use_bin_type=True)
        assert msgpack_lite.packb(v) == raw, repr(v)[:40]
        assert msgpack_lite.unpackb(raw) == msgpack.unpackb(raw, strict_map_key=False)
    for n in (1, 2, 4, 8, 16, 3, 300, 70000):
        assert (msgpack_lite.packb(msgpack_lite.Ext(5, b"q" * n))
                == msgpack.packb(msgpack.ExtType(5, b"q" * n)))
    with pytest.raises(ValueError, match="bytes after"):
        msgpack_lite.unpackb(b"\x01\x02")


def test_msgpack_serialize_matches_flax():
    """A tree of the statepack's kinds (arrays of several dtypes, numpy
    scalars, python scalars, None, lists, nested dicts in unsorted order):
    the same bytes as ``flax.serialization.msgpack_serialize``, and each
    side restores the other's bytes to equal leaves; a tuple is refused as
    flax refuses it."""
    rng = np.random.default_rng(6)
    tree = {"z": {"kernel": rng.normal(size=(3, 2, 4)).astype(np.float32),
                  "idx": np.arange(5, dtype=np.int64), "flag": np.bool_(True),
                  "s": np.float32(2.5), "d": np.float64(1.5)},
            "a": {"cfg": {"strides": [8, 16, 32], "name": "resnet34", "q": None, "f": 0.7,
                          "b": False, "n": 3}, "empty": {}},
            "m": [1, 2.5, "x"]}
    raw = flax.serialization.msgpack_serialize(tree)
    assert msgpack_lite.msgpack_serialize(tree) == raw
    got = msgpack_lite.msgpack_restore(raw)
    want = flax.serialization.msgpack_restore(raw)
    assert leaves_equal(got["z"], want["z"]) and got["a"] == want["a"] and got["m"] == want["m"]
    assert type(got["z"]["s"]) is type(want["z"]["s"]) is np.float32
    with pytest.raises(TypeError):
        msgpack_lite.msgpack_serialize({"t": (1, 2)})


@pytest.fixture(scope="module")
def port_states():
    """A small FCOS (2 classes, no extension heads, a 32-wide FPN) and a
    batch-norm A2J (crop 32) from the port's seeded init, with their
    configs."""
    fcfg = pconfig.FCOSConfig(num_classes=2, ext=False, image_h=64, image_w=96,
                              max_detections=8, fpn_channels=32, num_convs=2)
    acfg = pconfig.A2JConfig(crop_h=32, crop_w=32, head_features=32)
    fcos = FCOSSystem(fcfg)
    fcos.init_weights_(torch.Generator().manual_seed(0))
    a2j = A2JSystem(acfg, norm="batch")
    a2j.init_weights_(torch.Generator().manual_seed(1))
    with torch.no_grad():   # trained-looking statistics
        for name, buf in a2j.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(2))
    return SimpleNamespace(model=fcos), fcfg, SimpleNamespace(model=a2j), acfg


SYNTH = {"sequences": 3, "frames": 2, "crop": 32}


@pytest.fixture(scope="module")
def state_files(port_states, tmp_path_factory):
    """The port's file of ``port_states``, and the JAX package's file of the
    same trees and configs (its ``save_trained_states`` reads ``params``
    and ``batch_stats`` off each state)."""
    import dataclasses

    fstate, fcfg, astate, acfg = port_states
    d = tmp_path_factory.mktemp("statepack")
    port = str(d / "port.msgpack")
    statepack.save_trained_states(port, fstate, fcfg, astate, acfg, synth=SYNTH)
    trees = (fcos_variables_from_state_dict(fstate.model.state_dict()),
             a2j_variables_from_state_dict(astate.model.state_dict()))
    jax_cfgs = (jconfig.FCOSConfig(**dataclasses.asdict(fcfg)),
                jconfig.A2JConfig(**dataclasses.asdict(acfg)))
    jax = str(d / "jax.msgpack")
    jstatepack.save_trained_states(jax, SimpleNamespace(**trees[0]), jax_cfgs[0],
                                   SimpleNamespace(**trees[1]), jax_cfgs[1], synth=SYNTH)
    return port, jax, trees, jax_cfgs


def test_statepack_port_file_read_by_jax(state_files):
    """The port's file is flax's ``msgpack_serialize`` of the JAX package's
    payload, byte for byte, and JAX's ``load_trained_states`` gives back
    the models' flax trees, the configs and ``synth``."""
    port, jax, (f_want, a_want), (jf, ja) = state_files
    with open(port, "rb") as a, open(jax, "rb") as b:
        assert a.read() == b.read()
    f_vars, fcfg2, a_vars, acfg2, synth2 = jstatepack.load_trained_states(port)
    assert (fcfg2, acfg2, synth2) == (jf, ja, SYNTH)
    assert leaves_equal(f_vars, f_want) and leaves_equal(a_vars, a_want)


def test_statepack_jax_file_read_by_port(port_states, state_files):
    """A file JAX's ``save_trained_states`` writes loads here into the same
    trees and configs, and the A2J rebuilt from it holds the saved state
    dict bit for bit."""
    _, fcfg, astate, acfg = port_states
    _, jax, (f_vars, a_vars), _ = state_files
    got_f, got_fcfg, got_a, got_acfg, synth = statepack.load_trained_states(jax)
    assert (got_fcfg, got_acfg, synth) == (fcfg, acfg, SYNTH)
    assert leaves_equal(got_f, f_vars) and leaves_equal(got_a, a_vars)
    rebuilt = A2JSystem(got_acfg, norm="batch")
    rebuilt.load_state_dict(a2j_state_dict_from_flax(got_a))
    want = astate.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in rebuilt.state_dict().items()
               if not k.endswith("num_batches_tracked"))


def test_statepack_rejects_unknown_fields():
    with pytest.raises(KeyError, match="not_a_field"):
        statepack._cfg_from(pconfig.A2JConfig, {"not_a_field": 1})
    assert statepack._cfg_from(pconfig.A2JConfig, {"anchor_offsets": [1, 2]}).anchor_offsets == (
        1, 2)


# ---------------------------------------------------------------------------
# convert/mano_assets.py

def test_mano_converter_matches_jax_and_cleans_up(tmp_path, monkeypatch):
    """A chumpy-like pkl (``tests/test_mano.py:112-141``'s contents, pickled
    from a stand-in chumpy module that is gone before the read) converts to
    the JAX converter's arrays, and the port leaves no chumpy module in
    ``sys.modules``. The JAX converter's stubs are removed after it. Stubs
    that an earlier test of the process left behind (the JAX converter's
    own test installs them for good) are taken out for the test and put
    back after it."""
    for name in [k for k in sys.modules if k.startswith("chumpy")]:
        monkeypatch.delitem(sys.modules, name)
    rng = np.random.default_rng(7)
    ch_mod = types.ModuleType("chumpy.ch")

    class Ch:
        pass

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    ch_mod.Ch = Ch

    def chify(arr):
        obj = Ch()
        obj.x = np.asarray(arr)
        return obj

    dd = {"v_template": chify(rng.normal(size=(778, 3))),
          "shapedirs": chify(rng.normal(size=(778, 3, 10))),
          "posedirs": chify(rng.normal(size=(778, 3, 135))),
          "J_regressor": sp.csc_matrix(np.abs(rng.normal(size=(16, 778)))),
          "weights": chify(np.abs(rng.normal(size=(778, 16)))),
          "hands_components": rng.normal(size=(45, 45)), "hands_mean": rng.normal(size=45),
          "f": rng.integers(0, 778, size=(1538, 3)),
          "kintree_table": np.stack([np.arange(16), np.arange(16)]), "bs_type": "lrotmin"}
    pkl = tmp_path / "MANO_TEST.pkl"
    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "chumpy", types.ModuleType("chumpy"))
        m.setitem(sys.modules, "chumpy.ch", ch_mod)
        with open(pkl, "wb") as f:
            pickle.dump(dd, f)
    assert not [k for k in sys.modules if k.startswith("chumpy")]
    got = mano_assets.convert(str(pkl), str(tmp_path / "port.npz"))
    assert not [k for k in sys.modules if k.startswith("chumpy")]
    try:
        want = jmano_assets.convert(str(pkl), str(tmp_path / "jax.npz"))
    finally:
        for name in [k for k in sys.modules if k.startswith("chumpy")]:
            del sys.modules[name]
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    saved = np.load(tmp_path / "port.npz")
    assert all(np.array_equal(saved[k], want[k]) for k in want)
