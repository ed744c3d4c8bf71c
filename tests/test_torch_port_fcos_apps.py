"""The port's FCOS apps and their data (``data/synthetic.py``'s colour
frames, ``data/detect_data.py``, ``data/voc100doh.py``, ``eval/voc.py``,
``apps/train_fcos.py``, ``apps/eval_fcos.py``, the GroupNorm backbone and
``train_a2j --rgbd``) against the JAX package's, on the CPU.

On the CPU the GroupNorms take K2s/K2a's plain versions and the A2J decode
K1's (the kernels run on a card, where chip_smoke.py's ``[fcos_apps]``
phase drives these apps). The JAX CLIs are run only as far as their first
``train_step``, whose input is captured, so no JAX model is initialised
or compiled for them.

Tolerances, each with what was measured:
* the synthetic trees, the detection and VOC items, the roidb, the AP
  sweep and the detection files: equal (JPEG bytes included);
* the preprocessed frames of the first ``train_fcos`` batch: ``PREP_TOL``
  absolute (the two bilinear resizes round apart; measured 6.0e-7), the
  targets equal;
* the GroupNorm-backbone steps: the rules of tests/test_torch_port_train.py
  (``GN_PARAM_TOL`` of each parameter's own change, ``GN_TREE_TOL`` of the
  tree's, ``GN_LOSS_TOL`` relative on the losses);
* ``eval_fcos`` against JAX's, both with bf16 convolutions: ``AP_TOL`` on
  each AP, and ``ROW_SHARE`` of the written rows matched within
  ``BOX_TOL`` px.
"""

import os
import xml.etree.ElementTree as ET

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch._dynamo  # noqa: F401  (see tests/test_torch_port_a2j_apps.py)

from handnet_tpu import config as jconfig
from handnet_tpu.apps import eval_fcos as jeval_fcos
from handnet_tpu.apps import train_a2j as jtrain_a2j
from handnet_tpu.apps import train_fcos as jtrain_fcos
from handnet_tpu.convert.torch_weights import convert_fcos
from handnet_tpu.data import a2j_data as ja2j_data
from handnet_tpu.data import detect_data as jdetect
from handnet_tpu.data import dexycb as jdex
from handnet_tpu.data import voc100doh as jvoc
from handnet_tpu.data.synthetic import make_synthetic_dexycb as jax_synthetic
from handnet_tpu.eval import voc as jeval
from handnet_tpu.train import trainer as jtrainer
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.apps import eval_fcos, train_a2j, train_fcos
from handnet_tpu_torch.convert.from_flax import (fcos_state_dict_from_flax,
                                                 fcos_variables_from_state_dict)
from handnet_tpu_torch.data import a2j_data as pa2j_data
from handnet_tpu_torch.data import detect_data as pdetect
from handnet_tpu_torch.data import dexycb as pdex
from handnet_tpu_torch.data import image_io
from handnet_tpu_torch.data import voc100doh as pvoc
from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb as port_synthetic
from handnet_tpu_torch.eval import voc as peval
from handnet_tpu_torch.models.fcos import FCOSSystem
from handnet_tpu_torch.nn.resnet import GroupNorm
from handnet_tpu_torch.train.trainer import A2JTrainer, FCOSTrainer
from torch_port_fixtures import leaves_equal

PREP_TOL = 1e-5
GN_PARAM_TOL, GN_TREE_TOL, GN_LOSS_TOL = 0.15, 0.02, 1e-4
AP_TOL, BOX_TOL, ROW_SHARE = 1e-6, 0.5, 0.9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Captured(Exception):
    """Raised by a stubbed ``train_step`` to stop a CLI at its first step."""


def _capture_first_step(monkeypatch, trainer_cls, store):
    def step(self, state, batch):
        store.append(jax.tree_util.tree_map(np.asarray, batch))
        raise _Captured
    monkeypatch.setattr(trainer_cls, "init_state", lambda self, *a, **k: None)
    monkeypatch.setattr(trainer_cls, "train_step", step)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """JAX's and the port's synthetic trees at one seed (4 sequences x 4
    frames, 480x640: train_fcos's 16 s0-train samples)."""
    jroot = str(tmp_path_factory.mktemp("jax_tree"))
    proot = str(tmp_path_factory.mktemp("port_tree"))
    jinfo = jax_synthetic(jroot, n_sequences=4, n_frames=4, seed=0)
    pinfo = port_synthetic(proot, n_sequences=4, n_frames=4, seed=0)
    return jroot, proot, jinfo, pinfo


def test_synthetic_tree_equals_jax_tree(trees, tmp_path):
    """Every file of the port's tree equals the JAX tree's: the colour JPEGs
    byte for byte (so cv2 decodes them alike), depth, labels and YAML; the
    hard tree's clutter too."""
    jroot, proot, jinfo, pinfo = trees
    jfiles = sorted(os.path.relpath(os.path.join(d, f), jroot)
                    for d, _, fs in os.walk(jroot) for f in fs)
    pfiles = sorted(os.path.relpath(os.path.join(d, f), proot)
                    for d, _, fs in os.walk(proot) for f in fs)
    assert jfiles == pfiles and sum(f.endswith(".jpg") for f in jfiles) == 16
    for rel in jfiles:
        a, b = os.path.join(jroot, rel), os.path.join(proot, rel)
        if rel.endswith(".jpg"):
            assert open(a, "rb").read() == open(b, "rb").read(), rel
            np.testing.assert_array_equal(cv2.imread(a), cv2.imread(b))
        elif rel.endswith(".npz"):
            ja, pa = np.load(a), np.load(b)
            assert sorted(ja) == sorted(pa) and all(np.array_equal(ja[k], pa[k]) for k in ja)
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(a, cv2.IMREAD_ANYDEPTH),
                                          image_io.read_png(b))
        else:
            import yaml
            assert yaml.safe_load(open(a)) == yaml.safe_load(open(b)), rel
    assert jinfo.keys() == pinfo.keys()
    hj, hp = tmp_path / "hj", tmp_path / "hp"
    jax_synthetic(str(hj), n_sequences=1, n_frames=2, seed=4, difficulty="hard")
    port_synthetic(str(hp), n_sequences=1, n_frames=2, seed=4, difficulty="hard")
    for f in sorted(hj.rglob("color_*.jpg")):
        assert f.read_bytes() == (hp / f.relative_to(hj)).read_bytes()


def test_detect_source_items_equal_jax(trees):
    jroot, proot, _, _ = trees
    jds = jdex.DexYCBDataset("s0", "train", data_dir=proot)
    pds = pdex.DexYCBDataset("s0", "train", data_dir=proot)
    for uint8, e2e in ((True, True), (False, False)):
        jsrc = jdetect.DetectDataSource(jds, range(len(jds)), e2e=e2e, uint8_images=uint8)
        psrc = pdetect.DetectDataSource(pds, range(len(pds)), e2e=e2e, uint8_images=uint8)
        assert len(psrc) == len(jsrc) == 16
        for i in (0, 7, 15):
            want, got = jsrc[i], psrc[i]
            assert want.keys() == got.keys()
            for k in want:
                assert want[k].dtype == got[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the VOC tree (the writer of tests/test_voc100doh.py:15-61)


def _write_xml(path, objects):
    root = ET.Element("annotation")
    for o in objects:
        obj = ET.SubElement(root, "object")
        ET.SubElement(obj, "name").text = o["name"]
        bb = ET.SubElement(obj, "bndbox")
        for k, v in zip(("xmin", "ymin", "xmax", "ymax"), o["bbox"]):
            ET.SubElement(bb, k).text = str(v)
        for k in ("difficult", "contactstate", "handside", "magnitude",
                  "unitdx", "unitdy", "objxmin", "objymin", "objxmax",
                  "objymax"):
            ET.SubElement(obj, k).text = str(o.get(k, "None"))
    ET.ElementTree(root).write(path)


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    devkit = os.path.join(root, "VOC2007")
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        os.makedirs(os.path.join(devkit, sub), exist_ok=True)
    images = ["img000", "img001"]
    with open(os.path.join(devkit, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(images) + "\n")
    _write_xml(os.path.join(devkit, "Annotations", "img000.xml"), [
        {"name": "hand", "bbox": (11, 11, 51, 51), "difficult": 0,
         "contactstate": 3, "handside": 1, "magnitude": 100, "unitdx": 0.6,
         "unitdy": 0.8, "objxmin": 60, "objymin": 10, "objxmax": 100,
         "objymax": 50},
        {"name": "targetobject", "bbox": (61, 11, 101, 51), "difficult": 0},
    ])
    _write_xml(os.path.join(devkit, "Annotations", "img001.xml"), [
        {"name": "hand", "bbox": (21, 21, 81, 81), "difficult": 0,
         "contactstate": 0, "handside": 0},
    ])
    rng = np.random.default_rng(0)
    for im in images:
        image_io.imwrite_jpeg(os.path.join(devkit, "JPEGImages", f"{im}.jpg"),
                              rng.integers(0, 255, size=(120, 160, 3)).astype(np.uint8))
    return root


def test_voc_source_and_roidb_equal_jax(voc_tree):
    jds, pds = jvoc.VOC100DOH(voc_tree), pvoc.VOC100DOH(voc_tree)
    for jrec, prec in zip(jds.roidb(max_boxes=4), pds.roidb(max_boxes=4)):
        assert jrec.keys() == prec.keys()
        for k in jrec:
            np.testing.assert_array_equal(prec[k], jrec[k], err_msg=k)
    assert jds.annotations().keys() == pds.annotations().keys()
    for target in (None, (64, 96), (200, 240), (60, 80)):
        jsrc = jvoc.VOCDetectSource(jds, target_size=target)
        psrc = pvoc.VOCDetectSource(pds, target_size=target)
        for i in range(len(jsrc)):
            want, got = jsrc[i], psrc[i]
            assert want.keys() == got.keys()
            for k in want:
                assert want[k].dtype == got[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{target} {k}")


def _detections(mod, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        box = np.sort(rng.uniform(0, 120, size=4)).astype(np.float64)[[0, 1, 2, 3]]
        out.append(mod.Detection(
            image_id=f"img00{i % 2}", score=float(rng.uniform(0.05, 1.0)),
            bbox=np.array([box[0], box[1], box[0] + 40, box[1] + 40]),
            handstate=int(rng.integers(0, 5)),
            vector=np.array([rng.uniform(0, 0.2), 0.6, 0.8]),
            handside=int(rng.integers(0, 2))))
    return out


def test_voc_eval_and_detection_files_equal_jax(voc_tree, tmp_path):
    annos_j = jvoc.VOC100DOH(voc_tree).annotations()
    annos_p = pvoc.VOC100DOH(voc_tree).annotations()
    hands_j, objs_j = _detections(jeval, 1), _detections(jeval, 2)
    hands_p, objs_p = _detections(peval, 1), _detections(peval, 2)
    want = jeval.evaluate_detections_100doh(hands_j, objs_j, annos_j)
    got = peval.evaluate_detections_100doh(hands_p, objs_p, annos_p)
    assert got == want
    jvoc.write_detection_file(str(tmp_path / "j.txt"), hands_j)
    pvoc.write_detection_file(str(tmp_path / "p.txt"), hands_p)
    assert (tmp_path / "j.txt").read_text() == (tmp_path / "p.txt").read_text()
    back_j = jvoc.read_detection_file(str(tmp_path / "j.txt"))
    back_p = pvoc.read_detection_file(str(tmp_path / "p.txt"))
    assert [(d.image_id, d.score, d.handstate, d.handside) for d in back_j] == \
        [(d.image_id, d.score, d.handstate, d.handside) for d in back_p]
    for a, b in zip(back_j, back_p):
        np.testing.assert_array_equal(a.bbox, b.bbox)
        np.testing.assert_array_equal(a.vector, b.vector)
    rng = np.random.default_rng(3)
    det = {"boxes": rng.uniform(0, 100, (2, 5, 4)).astype(np.float32),
           "scores": rng.uniform(0, 1, (2, 5)).astype(np.float32),
           "labels": rng.integers(1, 3, (2, 5)).astype(np.int32),
           "valid": rng.uniform(size=(2, 5)) > 0.3,
           "sides": rng.integers(0, 2, (2, 5)), "contacts": rng.integers(0, 5, (2, 5)),
           "dxdymags": rng.uniform(0, 1, (2, 5, 3)).astype(np.float32)}
    for a, b in zip(jvoc.decoded_to_detections(det, ["a", "b"]),
                    pvoc.decoded_to_detections(det, ["a", "b"])):
        assert [(d.image_id, d.score, d.handstate, d.handside) for d in a] == \
            [(d.image_id, d.score, d.handstate, d.handside) for d in b]


# ---------------------------------------------------------------------------
# the GroupNorm backbone


SMALL = dict(image_h=64, image_w=96, fpn_channels=64, num_convs=2, ext=True)
TRAIN = dict(lr=0.01, weight_decay=1e-4, optimizer="sgd", warmup_epochs=1)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float64)


def _gn_batch(seed):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    boxes = np.zeros((2, 8, 4), np.float32)
    boxes[:, 0] = rng.uniform(4, 20, 2)[:, None] + np.array([0, 0, 30, 24])
    boxes[:, 1] = [50, 20, 90, 60]
    labels = np.tile(np.array([2, 1, 0, 0, 0, 0, 0, 0], np.int32), (2, 1))
    valid = np.tile(np.array([1, 1, 0, 0, 0, 0, 0, 0], bool), (2, 1))
    info = np.tile(np.array([[3, 1, 0.1, 0.6, 0.8]] + [[-1] * 5] * 7, np.float32), (2, 1, 1))
    return image, {"boxes": boxes, "labels": labels, "valid": valid, "box_info": info}


def test_group_norm_backbone_steps_match_jax():
    """Two float32 steps of ``FCOSTrainer(backbone_norm="group")`` against
    JAX's from the port's init (converted by ``convert_fcos``): the 36
    backbone GroupNorms (flax's fast variance against K2s's exact one,
    equal up to rounding), their scale and bias through the converter.
    Each loss term of each step to ``GN_LOSS_TOL`` relative (measured
    4.9e-7), each parameter to ``GN_PARAM_TOL`` of its own change over the two
    steps and the whole tree to ``GN_TREE_TOL`` of the whole change (the
    rules of tests/test_torch_port_train.py's batch-norm steps; measured
    worst 2.1%, tree 0.19%)."""
    trainer = FCOSTrainer(pconfig.FCOSConfig(**SMALL), pconfig.TrainConfig(**TRAIN, bf16=False),
                          steps_per_epoch=2, backbone_norm="group", device="cpu")
    state = trainer.init_state(3)
    gns = [m for m in state.model.backbone["body"].modules() if isinstance(m, GroupNorm)]
    assert len(gns) == 36 and all(m.eps == 1e-6 and m.num_groups == 32 for m in gns)
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    init = convert_fcos({k: v.numpy() for k, v in sd.items()})
    assert not init.get("batch_stats", {}).get("backbone")
    # the port's converters carry the GroupNorms' scale and bias both ways,
    # as save_params_npz writes them
    variables = fcos_variables_from_state_dict(sd)
    assert leaves_equal(variables["params"], init["params"])
    back = fcos_state_dict_from_flax(variables)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    jt = jtrainer.FCOSTrainer(jconfig.FCOSConfig(**SMALL), jconfig.TrainConfig(**TRAIN, bf16=False),
                              steps_per_epoch=2, backbone_norm="group")
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=init["params"],
                                 batch_stats=init.get("batch_stats", {}),
                                 opt_state=jt.tx.init(init["params"]), tx=jt.tx)
    for seed in (10, 11):
        image, targets = _gn_batch(seed)
        jstate, want = jt.train_step(jstate, {"image": jnp.asarray(image),
                                              "targets": {k: jnp.asarray(v)
                                                          for k, v in targets.items()}})
        state, got = trainer.train_step(state, {"image": torch.from_numpy(image),
                                                "targets": {k: torch.from_numpy(v)
                                                            for k, v in targets.items()}})
        for k in want:
            assert abs(got[k].item() - float(want[k])) <= \
                GN_LOSS_TOL * max(abs(float(want[k])), 1e-6), k
    after = convert_fcos({k: v.detach().numpy() for k, v in state.model.state_dict().items()})
    init_p, want_p = dict(_flat(init["params"])), dict(_flat(jax.device_get(jstate.params)))
    err_sq = change_sq = 0.0
    for key, value in _flat(after["params"]):
        change = want_p[key] - init_p[key]
        assert np.abs(value - want_p[key]).max() <= GN_PARAM_TOL * np.abs(change).max(), key
        err_sq += float(np.sum((value - want_p[key]) ** 2))
        change_sq += float(np.sum(change ** 2))
    assert err_sq ** 0.5 <= GN_TREE_TOL * change_sq ** 0.5


# ---------------------------------------------------------------------------
# the CLIs


def test_train_fcos_first_batch_files_and_refusals(trees, monkeypatch, tmp_path):
    """The port's CLI on the port's tree at 64x96: its first batch equals
    the one JAX's CLI hands its trainer (batch 8, the test mesh's 8 CPU
    devices), it writes the files JAX's CLI writes, and without
    ``--device`` it raises where there is no card. (``--net rcnn`` runs:
    tests/test_torch_port_rcnn_apps.py.)"""
    _, proot, _, _ = trees
    common = ["--data-dir", proot, "--synthetic", "4", "--image-h", "64", "--image-w", "96",
              "--batch", "8", "--epochs", "1", "--workers", "1", "--no-bf16"]
    jax_batches = []
    with monkeypatch.context() as m:
        _capture_first_step(m, jtrainer.FCOSTrainer, jax_batches)
        with pytest.raises(_Captured):
            jtrain_fcos.main(common + ["--output", str(tmp_path / "jax")])
    port_batches = []
    real_step = FCOSTrainer.train_step

    def capture(self, state, batch):
        if not port_batches:
            port_batches.append(batch)
        return real_step(self, state, batch)

    out = tmp_path / "port"
    with monkeypatch.context() as m:
        m.setattr(FCOSTrainer, "train_step", capture)
        res = train_fcos.main(common + ["--device", "cpu", "--output", str(out)])
    want, got = jax_batches[0], port_batches[0]
    assert got["image"].shape == want["image"].shape == (8, 64, 96, 3)
    assert np.abs(got["image"].numpy() - want["image"]).max() <= PREP_TOL
    for k, v in want["targets"].items():
        np.testing.assert_array_equal(got["targets"][k].numpy(), v, err_msg=k)
    assert res["samples"] == 16 and res["epochs"][0]["steps"] == 2
    assert np.isfinite(res["epochs"][0]["losses"]["total_loss"])
    written = {os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out) for f in fs}
    assert {"train.txt", "metrics.json", "metrics.html", "checkpoints/0.pt",
            "cache/refined_train_idx.pkl"} <= written
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_fcos.main(common + ["--output", str(tmp_path / "nocard")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_fcos.main(["--voc-root", proot, "--output", str(tmp_path / "nocard")])


def test_eval_fcos_matches_jax_eval_fcos(voc_tree, tmp_path):
    """Both CLIs on the VOC tree at 64x96 with one reference-keyed
    checkpoint (the port's seed-5 init, the hand and object classes' prior
    raised so that both classes have detections above 0.1): the AP table to
    ``AP_TOL`` (measured equal), the same number of 11-field rows in both
    detection files, and
    ``ROW_SHARE`` of the port's rows matched one to one by a JAX row with
    the image, state and side fields equal, the score to 1e-2, the offsets
    to 2e-3 and the box to ``BOX_TOL`` px. Both sides run bf16 convolutions
    on random weights, whose near-ties flip between the two forwards
    (measured: 118 of 127 object rows and the one hand row matched)."""
    model = FCOSSystem(pconfig.FCOSConfig(num_classes=3, image_h=64, image_w=96))
    model.init_weights_(torch.Generator().manual_seed(5))
    with torch.no_grad():
        model.head.classification_head["cls_logits"].bias.copy_(torch.tensor([-4.0, 1.0, 1.0]))
    ckpt = tmp_path / "fcos.pth"
    torch.save({"model": model.state_dict()}, ckpt)
    args = ["--voc-root", voc_tree, "--image-set", "trainval", "--torch-checkpoint", str(ckpt),
            "--image-h", "64", "--image-w", "96", "--batch", "4"]
    want = jeval_fcos.main(args + ["--output", str(tmp_path / "jax")])
    got = eval_fcos.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= AP_TOL, (k, got[k], want[k])
    for name in ("comp4_det_test_hand.txt", "comp4_det_test_targetobject.txt"):
        rows_j = [r.split() for r in (tmp_path / "jax" / name).read_text().splitlines()]
        rows_p = [r.split() for r in (tmp_path / "port" / name).read_text().splitlines()]
        assert len(rows_p) == len(rows_j) > 0 and all(len(r) == 11 for r in rows_p)
        # one to one; near-equal scores swap order and near-tied classes and
        # contact states flip between two bf16 forwards, so a share of rows
        # is held, not every one
        left, matched = list(rows_j), 0
        for b in rows_p:
            match = [i for i, a in enumerate(left)
                     if (a[0], a[6], a[9], a[10]) == (b[0], b[6], b[9], b[10])
                     and abs(float(a[1]) - float(b[1])) <= 1e-2
                     and np.abs(np.array(a[7:9], float) - np.array(b[7:9], float)).max()
                     <= 2e-3
                     and np.abs(np.array(a[2:6], float) - np.array(b[2:6], float)).max()
                     <= BOX_TOL]
            if match:
                left.pop(match[0])
                matched += 1
        assert matched >= ROW_SHARE * len(rows_p), (name, matched, len(rows_p))


def test_train_a2j_rgbd_batch_equals_jax(trees, monkeypatch, tmp_path):
    """``train_a2j --rgbd`` for one CPU epoch (crop 48, batch 8, one worker)
    on the port's tree: the first batch it hands its trainer equals the one
    JAX's CLI hands its own (the 4-channel crop in BGR + depth order, the
    labels; JAX given OpenCV 4's warp, as the port has it), and the epoch's
    losses are finite."""
    _, proot, _, _ = trees
    common = ["--data-dir", proot, "--synthetic", "4", "--rgbd", "--crop", "48", "--batch", "8",
              "--epochs", "1", "--workers", "1", "--no-bf16", "--eval-every", "1"]
    jax_batches = []
    with monkeypatch.context() as m:
        # the JAX package's warp is cv2's (OpenCV 5.0 here, samples in float);
        # the port's is OpenCV 4's (a 1/32-pixel grid, tests/
        # test_torch_port_a2j_data.py holds the two apart): give JAX the
        # port's so the rotated crops can be held equal
        m.setattr(ja2j_data, "_warp_affine_nearest", pa2j_data.warp_affine_bilinear)
        _capture_first_step(m, jtrainer.A2JTrainer, jax_batches)
        with pytest.raises(_Captured):
            jtrain_a2j.main(common + ["--output", str(tmp_path / "jax")])
    port_batches = []
    real = A2JTrainer.train_step

    def capture(self, state, batch):
        if not port_batches:
            port_batches.append(batch)
        return real(self, state, batch)

    with monkeypatch.context() as m:
        m.setattr(A2JTrainer, "train_step", capture)
        res = train_a2j.main(common + ["--device", "cpu", "--output", str(tmp_path / "port")])
    want, got = jax_batches[0], port_batches[0]
    assert got["image"].shape == want["image"].shape == (8, 48, 48, 4)
    np.testing.assert_array_equal(got["image"].numpy(), want["image"])
    np.testing.assert_array_equal(got["jt_uvd"].numpy(), want["jt_uvd"])
    assert res["state"].model.cfg.in_channels == 4
    assert np.isfinite(res["epochs"][0]["losses"]["total_loss"])
    assert res["evals"] and res["evals"][0]["samples"] > 0
