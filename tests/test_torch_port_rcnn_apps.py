"""``train_fcos --net rcnn`` and ``eval_fcos --net rcnn`` (the port's
``handnet_tpu_torch/apps``) against the JAX package, on the CPU at 64x96
with 16 proposals.

* ``train_fcos --net rcnn --synthetic`` for one epoch (batch-norm
  backbone): finite losses, its checkpoint, and the trained parameters and
  batch statistics written by ``save_params_npz``, which JAX's
  ``FasterRCNNFPN`` applies: its eval forward against the port's within
  the forward tolerances of tests/test_torch_port_rcnn.py;
* ``eval_fcos --net rcnn`` against JAX's ``eval_fcos --net rcnn`` on a VOC
  tree of four JPEGs, with one reference-keyed checkpoint, both in float32:
  the detections (boxes within ``ROW_PX`` px), the rows and the AP table;
  and the port's CLI in bf16, as it ships.
"""

import functools
import os
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch._dynamo  # noqa: F401  (see tests/test_torch_port_a2j_apps.py)

from handnet_tpu.apps import eval_fcos as jeval_fcos
from handnet_tpu.models import faster_rcnn as J
from handnet_tpu.train import checkpoints as jckpt
from handnet_tpu_torch.apps import eval_fcos, train_fcos
from handnet_tpu_torch.data import image_io
from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb
from handnet_tpu_torch.models.faster_rcnn import FasterRCNNFPN
from handnet_tpu_torch.train.checkpoints import save_params_npz

H, W, K = 64, 96, 16
FWD_TOL, TRAIN_PROP_PX = 1e-4, 1e-2
AP_TOL, ROW_PX, SCORE_TOL = 1e-6, 2e-3, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_train_fcos_rcnn_checkpoint_is_applied_by_jax(tmp_path):
    root, out = str(tmp_path / "tree"), tmp_path / "rcnn"
    make_synthetic_dexycb(root, n_sequences=4, n_frames=4, seed=0)
    res = train_fcos.main(["--net", "rcnn", "--data-dir", root, "--synthetic", "4",
                           "--image-h", str(H), "--image-w", str(W), "--num-proposals", str(K),
                           "--batch", "8", "--epochs", "1", "--workers", "1", "--no-bf16",
                           "--device", "cpu", "--output", str(out)])
    epoch = res["epochs"][0]
    assert res["samples"] == 16 and epoch["steps"] == 2
    assert set(epoch["losses"]) == {"loss_classifier", "loss_box_reg", "loss_hand_side",
                                    "loss_dxdymag", "loss_contact", "loss_objectness",
                                    "loss_rpn_box_reg", "total_loss"}
    assert all(np.isfinite(v) for v in epoch["losses"].values())
    model = res["state"].model
    assert isinstance(model, FasterRCNNFPN) and model.num_classes == 23
    saved = torch.load(out / "checkpoints" / "0.pt", weights_only=True)
    assert saved["step"] == 2
    assert all(torch.equal(saved["model"][k], v) for k, v in model.state_dict().items())

    save_params_npz(str(tmp_path / "params.npz"), model)
    save_params_npz(str(tmp_path / "batch_stats.npz"), model, "batch_stats")
    variables = {"params": jckpt.load_params_npz(str(tmp_path / "params.npz")),
                 "batch_stats": jckpt.load_params_npz(str(tmp_path / "batch_stats.npz"))}
    jm = J.FasterRCNNFPN(num_classes=23, image_h=H, image_w=W, num_proposals=K,
                         backbone_norm="batch")
    x = np.random.default_rng(0).normal(size=(2, H, W, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_array_equal(got["proposal_valid"].numpy(),
                                  np.asarray(want["proposal_valid"]))
    assert np.abs(got["proposals"].numpy() - np.asarray(want["proposals"])).max() <= TRAIN_PROP_PX
    for k in ("rpn_objectness", "rpn_deltas", "scores", "deltas", "contact", "dxdy", "side"):
        assert _rel(got[k], want[k]) <= FWD_TOL, k


def _write_xml(path, objects):
    root = ET.Element("annotation")
    for o in objects:
        obj = ET.SubElement(root, "object")
        ET.SubElement(obj, "name").text = o["name"]
        bb = ET.SubElement(obj, "bndbox")
        for k, v in zip(("xmin", "ymin", "xmax", "ymax"), o["bbox"]):
            ET.SubElement(bb, k).text = str(v)
        for k in ("difficult", "contactstate", "handside", "magnitude", "unitdx", "unitdy",
                  "objxmin", "objymin", "objxmax", "objymax"):
            ET.SubElement(obj, k).text = str(o.get(k, "None"))
    ET.ElementTree(root).write(path)


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    """Four 128x192 JPEGs (both CLIs stack a batch's frames, so one size;
    half of it is the network input, no padding), each with a hand and an
    object annotated."""
    root = str(tmp_path_factory.mktemp("voc"))
    devkit = os.path.join(root, "VOC2007")
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        os.makedirs(os.path.join(devkit, sub))
    names = [f"img{i:03d}" for i in range(4)]
    with open(os.path.join(devkit, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    rng = np.random.default_rng(0)
    for i, name in enumerate(names):
        _write_xml(os.path.join(devkit, "Annotations", f"{name}.xml"), [
            {"name": "hand", "bbox": (11 + 5 * i, 11, 61 + 5 * i, 71), "difficult": 0,
             "contactstate": 3, "handside": i % 2, "magnitude": 100, "unitdx": 0.6,
             "unitdy": 0.8},
            {"name": "targetobject", "bbox": (70, 20 + 3 * i, 140, 90), "difficult": 0},
        ])
        image_io.imwrite_jpeg(os.path.join(devkit, "JPEGImages", f"{name}.jpg"),
                              rng.integers(0, 255, size=(128, 192, 3)).astype(np.uint8))
    return root


def _recording(store):
    """A ``decoded_to_detections`` that keeps the batch it is given."""
    def wrap(real):
        def record(det, ids, **kw):
            store.append((list(ids), {k: np.array(v) for k, v in det.items()}))
            return real(det, ids, **kw)
        return record
    return wrap


def test_eval_fcos_rcnn_matches_jax_eval_fcos(voc_tree, tmp_path, monkeypatch):
    """Both CLIs with ``--net rcnn`` on the VOC tree at 64x96 (the frames
    resized, then padded), batch 4, 16 proposals, with one reference-keyed
    checkpoint (the port's seed-5 init), both computing in float32 (the
    test builds JAX's module and the port's at float32): the
    detections each CLI hands ``decoded_to_detections`` (valid, labels,
    sides and contacts equal, boxes within ``ROW_PX`` frame px, which is
    1e-3 px of the network input at half the frame's size (measured 1.02e-3
    frame px), scores and offsets within ``SCORE_TOL`` (measured 4.3e-6)),
    the same rows in both detection files and the AP table
    to ``AP_TOL``. Then the port's CLI as it ships (bf16 convolutions and
    products): 11-field rows and a finite AP table. Two bf16 forwards, XLA's
    and torch's, round apart layer by layer at random weights (XLA keeps
    float32 within its fusions): class scores 2.5% apart, another row
    count (measured 21 and 22 rows)."""
    model = FasterRCNNFPN(3, H, W, K)
    model.init_weights_(torch.Generator().manual_seed(5))
    ckpt = tmp_path / "rcnn.pth"
    torch.save({"model": model.state_dict()}, ckpt)
    args = ["--voc-root", voc_tree, "--image-set", "trainval", "--net", "rcnn",
            "--torch-checkpoint", str(ckpt), "--num-proposals", str(K),
            "--image-h", str(H), "--image-w", str(W), "--batch", "4"]
    jax_dets, port_dets = [], []
    with monkeypatch.context() as m:
        real_module = J.FasterRCNNFPN
        m.setattr(J, "FasterRCNNFPN", lambda **kw: real_module(**{**kw, "dtype": jnp.float32}))
        m.setattr(jeval_fcos, "decoded_to_detections",
                  _recording(jax_dets)(jeval_fcos.decoded_to_detections))
        want = jeval_fcos.main(args + ["--output", str(tmp_path / "jax")])
    with monkeypatch.context() as m:
        m.setattr(eval_fcos, "build_rcnn",
                  functools.partial(eval_fcos.build_rcnn, dtype=torch.float32))
        m.setattr(eval_fcos, "decoded_to_detections",
                  _recording(port_dets)(eval_fcos.decoded_to_detections))
        got = eval_fcos.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    assert len(jax_dets) == len(port_dets) == 1
    (ids_j, det_j), (ids_p, det_p) = jax_dets[0], port_dets[0]
    assert ids_j == ids_p and det_j.keys() == det_p.keys()
    ok = det_j["valid"]
    np.testing.assert_array_equal(det_p["valid"], ok)
    assert ok.sum() >= 8
    for k in ("labels", "sides", "contacts"):
        np.testing.assert_array_equal(det_p[k][ok], det_j[k][ok], err_msg=k)
    assert np.abs(det_p["boxes"][ok] - det_j["boxes"][ok]).max() <= ROW_PX
    assert np.abs(det_p["scores"] - det_j["scores"]).max() <= SCORE_TOL
    assert np.abs(det_p["dxdymags"][ok] - det_j["dxdymags"][ok]).max() <= SCORE_TOL
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= AP_TOL, (k, got[k], want[k])
    for name in ("comp4_det_test_hand.txt", "comp4_det_test_targetobject.txt"):
        rows_j = [r.split() for r in (tmp_path / "jax" / name).read_text().splitlines()]
        rows_p = [r.split() for r in (tmp_path / "port" / name).read_text().splitlines()]
        assert len(rows_p) == len(rows_j) > 0
        for a, b in zip(rows_j, rows_p):
            assert (a[0], a[6], a[9], a[10]) == (b[0], b[6], b[9], b[10]), (a, b)

    shipped = eval_fcos.main(args + ["--output", str(tmp_path / "bf16"), "--device", "cpu"])
    assert shipped.keys() == want.keys() and all(np.isfinite(v) for v in shipped.values())
    rows = [r.split() for name in ("comp4_det_test_hand.txt", "comp4_det_test_targetobject.txt")
            for r in (tmp_path / "bf16" / name).read_text().splitlines()]
    assert rows and all(len(r) == 11 for r in rows)
