"""The whole slice: ``handnet_tpu_torch`` ``HandNetPipeline`` against
``handnet_tpu`` ``HandNetPipeline.__call__`` on the same frames and weights.

The weights start from the port's seeded init, get random norm statistics,
and reach the JAX side through the JAX package's own converters
(``convert_fcos``/``convert_a2j``), so every output is held against the
reference with one set of weights. Frames are exactly ``image_h x image_w``,
so ``preprocess`` takes its native branch on both sides.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handnet_tpu import config as jconfig
from handnet_tpu.convert.torch_weights import convert_a2j, convert_fcos
from handnet_tpu.models.pipeline import HandNetPipeline as JaxPipeline
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.convert.from_flax import pipeline_state_dict_from_flax
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from torch_port_fixtures import assert_close, randomize_norms

REPO = Path(__file__).resolve().parent.parent
H, W, CROP = 64, 96, 48


def _cfg(module, score_thresh):
    return module.HandNetConfig(
        a2j=module.A2JConfig(crop_h=CROP, crop_w=CROP),
        fcos=module.FCOSConfig(image_h=H, image_w=W, max_detections=8, num_classes=3,
                               ext=False, score_thresh=score_thresh),
        pipeline=module.PipelineConfig(crop_size=CROP))


@pytest.fixture(scope="module")
def weights():
    """Port state dict with random norms, and the same weights as JAX variables."""
    sd = {k: v.numpy() for k, v in HandNetPipeline(_cfg(pconfig, 0.0), seed=3, device="cpu")
          .state_dict().items()}
    flax_vars = {
        "detector": randomize_norms(convert_fcos(
            {k[len("detector."):]: v for k, v in sd.items() if k.startswith("detector.")}),
            seed=4),
        "a2j": randomize_norms(convert_a2j(
            {k[len("a2j."):]: v for k, v in sd.items() if k.startswith("a2j.")}), seed=5),
    }
    return pipeline_state_dict_from_flax(flax_vars), flax_vars


def _frames(seed, batch=2):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(batch, H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 1.0, size=(batch, H, W)).astype(np.float32)
    paras = np.tile([600.0, 600.0, W / 2, H / 2], (batch, 1)).astype(np.float32)
    return images, depth, paras


def _run_both(weights, score_thresh, frames):
    state_dict, flax_vars = weights
    port = HandNetPipeline(_cfg(pconfig, score_thresh), device="cpu")
    port.load_state_dict(state_dict, strict=True)
    got = port(*(torch.from_numpy(a) for a in frames))
    jax_pipe = JaxPipeline(_cfg(jconfig, score_thresh))
    want = jax.jit(lambda v, im, d, p: jax_pipe(v, im, d, p))(
        jax.tree_util.tree_map(jnp.asarray, flax_vars), *(jnp.asarray(a) for a in frames))
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def test_slice_matches_jax_found_path(weights):
    """score_thresh 0 makes random weights take the found path; every output
    key is compared. Exact: found, sides, boxes (integer crop boxes) and
    crops (a gather). Scores to 1e-5 (sigmoid/sqrt of float32 head outputs
    that differ at ~1e-6). Joints to 1e-3 px / 1e-2 mm: the A2J heads differ
    at ~1e-6 relative and the decode averages over 144 anchors."""
    got, want = _run_both(weights, 0.0, _frames(0))
    assert sorted(got) == sorted(want) == sorted([
        "joints_uvd", "joints_uvd_full", "joints_xyz", "boxes", "crops", "found",
        "scores", "sides"])
    assert want["found"].all()
    for key in ("found", "sides", "boxes", "crops"):
        assert got[key].shape == want[key].shape, key
        assert np.array_equal(got[key], want[key]), key
    assert_close(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
    for key in ("joints_uvd", "joints_uvd_full"):
        assert_close(got[key], want[key], rtol=1e-4, atol=1e-3, err_msg=key)
    assert_close(got["joints_xyz"], want["joints_xyz"], rtol=1e-4, atol=1e-2)


def test_slice_no_hand_path_zeros(weights):
    """At the default 0.7 threshold random weights find no hand: both sides
    return found False, zero scores and joints, and the degenerate
    [0, 0, 175, 175] crop box. (sides is left out: for a not-found frame it
    is whichever candidate sorts first, an arbitrary choice.)"""
    got, want = _run_both(weights, 0.7, _frames(1))
    assert not want["found"].any() and not got["found"].any()
    for key in ("boxes", "crops", "scores", "joints_uvd", "joints_uvd_full",
                "joints_xyz"):
        assert np.array_equal(got[key], want[key]), key
    assert (got["boxes"] == np.array([0, 0, 175, 175], np.float32)).all()
    assert not got["joints_uvd"].any() and not got["joints_xyz"].any()


def test_rgbd_slice_matches_jax():
    """RGBD mode (``A2JConfig(in_channels=4)``, ``PipelineConfig(rgbd=True)``):
    BGR+D frames, reordered to RGB+D after the crop, feed a 4-channel A2J
    stem. Against JAX at score threshold 0: found, sides, boxes and crops
    exact, scores to 1e-5, joints to 1e-4 px (a probe saw 1.7e-5)."""
    def cfg(module):
        return module.HandNetConfig(
            a2j=module.A2JConfig(crop_h=CROP, crop_w=CROP, in_channels=4),
            fcos=module.FCOSConfig(image_h=H, image_w=W, max_detections=8, num_classes=3,
                                   ext=False, score_thresh=0.0),
            pipeline=module.PipelineConfig(crop_size=CROP, rgbd=True))

    port = HandNetPipeline(cfg(pconfig), seed=3, device="cpu")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert sd["a2j.Backbone.model.conv1.weight"].shape[1] == 4
    flax_vars = {
        "detector": randomize_norms(convert_fcos(
            {k[len("detector."):]: v for k, v in sd.items() if k.startswith("detector.")}), 4),
        "a2j": randomize_norms(convert_a2j(
            {k[len("a2j."):]: v for k, v in sd.items() if k.startswith("a2j.")}), 5)}
    port.load_state_dict(pipeline_state_dict_from_flax(flax_vars), strict=True)
    rng = np.random.default_rng(8)
    images = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    rgbd = np.concatenate([rng.uniform(size=(2, H, W, 3)),
                           rng.uniform(0.3, 1.0, size=(2, H, W, 1))], -1).astype(np.float32)
    got = {k: v.numpy() for k, v in port(torch.from_numpy(images), torch.from_numpy(rgbd)).items()}
    jax_pipe = JaxPipeline(cfg(jconfig))
    want = jax.jit(lambda v, im, d: jax_pipe(v, im, d))(
        jax.tree_util.tree_map(jnp.asarray, flax_vars), jnp.asarray(images), jnp.asarray(rgbd))
    want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want) and want["found"].all()
    assert got["crops"].shape == (2, CROP, CROP, 4)
    for key in ("found", "sides", "boxes", "crops"):
        assert np.array_equal(got[key], want[key]), key
    assert_close(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
    for key in ("joints_uvd", "joints_uvd_full"):
        assert_close(got[key], want[key], rtol=0, atol=1e-4, err_msg=key)


def test_fast_profile_without_yaml():
    """The port's config tree is the JAX package's, field for field, and the
    FAST dict builds the same config as configs/fast.yaml."""
    assert dataclasses.asdict(pconfig.HandNetConfig()) == dataclasses.asdict(
        jconfig.HandNetConfig())
    fast = pconfig.load_config(overrides=pconfig.FAST)
    assert dataclasses.asdict(fast) == dataclasses.asdict(
        jconfig.load_config(yaml_path=str(REPO / "configs" / "fast.yaml")))
    assert (fast.fcos.image_h, fast.fcos.image_w, fast.pipeline.crop_size) == (480, 640, 176)


_NO_JAX_SCRIPT = """
import sys
import numpy as np
import torch
from handnet_tpu_torch import config as C
from handnet_tpu_torch.models.pipeline import HandNetPipeline

cfg = C.HandNetConfig(
    a2j=C.A2JConfig(crop_h=48, crop_w=48),
    fcos=C.FCOSConfig(image_h=64, image_w=96, max_detections=8, num_classes=3,
                      ext=False, score_thresh=0.0),
    pipeline=C.PipelineConfig(crop_size=48))
rng = np.random.default_rng(0)
out = HandNetPipeline(cfg, device="cpu")(
    torch.from_numpy(rng.uniform(size=(2, 64, 96, 3)).astype(np.float32)),
    torch.from_numpy(rng.uniform(0.3, 1.0, size=(2, 64, 96)).astype(np.float32)))
assert tuple(out["joints_uvd"].shape) == (2, 21, 3)
assert bool(torch.isfinite(out["joints_uvd"]).all())
small = torch.from_numpy(rng.uniform(size=(2, 48, 64, 3)).astype(np.float32))  # resampled
assert bool(torch.isfinite(HandNetPipeline(cfg, device="cpu").detect(small)["boxes"]).all())
static = C.HandNetConfig(
    a2j=C.A2JConfig(crop_h=48, crop_w=48, quant="static"),
    fcos=C.FCOSConfig(image_h=64, image_w=96, max_detections=8, num_classes=3,
                      ext=False, score_thresh=0.0, quant="static"),
    pipeline=C.PipelineConfig(crop_size=48))
frames = (torch.from_numpy(rng.uniform(size=(2, 64, 96, 3)).astype(np.float32)),
          torch.from_numpy(rng.uniform(0.3, 1.0, size=(2, 64, 96)).astype(np.float32)))
pipe = HandNetPipeline(static, device="cpu")
pipe.calibrate(*frames)
assert bool(torch.isfinite(pipe(*frames)["joints_uvd"]).all())
HandNetPipeline(C.load_config(overrides=C.QUANT_STATIC), device="cpu")
import dataclasses
mesh = dataclasses.replace(cfg, pipeline=C.PipelineConfig(crop_size=48, with_mesh=True),
                           pose2mesh=C.Pose2MeshConfig(posenet_hid=64))
out = HandNetPipeline(mesh, device="cpu")(*frames)
assert tuple(out["verts"].shape) == (2, 778, 3) and bool(torch.isfinite(out["verts"]).all())
from handnet_tpu_torch.models.mano import ManoAssets, ManoLayer
verts, _ = ManoLayer(ManoAssets.synthetic(rng), device="cpu")(torch.zeros(1, 48))
assert tuple(verts.shape) == (1, 778, 3)
import handnet_tpu_torch.apps.export_pipeline, handnet_tpu_torch.apps.serve, handnet_tpu_torch.export
import handnet_tpu_torch.ops.rotation
import handnet_tpu_torch.train
from handnet_tpu_torch.train.checkpoints import CheckpointManager, save_params_npz
from handnet_tpu_torch.train.trainer import FCOSTrainer
trainer = FCOSTrainer(C.FCOSConfig(image_h=64, image_w=96, fpn_channels=64, num_convs=2),
                      C.TrainConfig(optimizer="sgd", lr=1e-3, warmup_epochs=1),
                      steps_per_epoch=4, backbone_norm="batch", device="cpu")
state = trainer.init_state(0)
boxes = torch.tensor([[[8.0, 8.0, 40.0, 48.0]] + [[0.0] * 4] * 7] * 2)
valid = torch.zeros(2, 8, dtype=torch.bool)
valid[:, 0] = True
info = torch.full((2, 8, 5), -1.0)
info[:, 0] = torch.tensor([1.0, 0.0, 0.5, 0.1, -0.2])
targets = {"boxes": boxes, "labels": valid.int() * 2, "valid": valid, "box_info": info}
image = torch.from_numpy(rng.normal(size=(2, 64, 96, 3)).astype(np.float32))
state, metrics = trainer.train_step(state, {"image": image, "targets": targets})
assert state.step == 1 and bool(torch.isfinite(metrics["total_loss"]))
from handnet_tpu_torch.train.trainer import A2JTrainer
a2j = A2JTrainer(C.A2JConfig(crop_h=32, crop_w=32, num_joints=3, head_features=32),
                 C.TrainConfig(bf16=False), device="cpu")
a2j_state = a2j.init_state(0)
a2j_batch = {"image": torch.from_numpy(rng.uniform(0.3, 1.2, size=(2, 32, 32, 1)).astype(np.float32)),
             "jt_uvd": torch.from_numpy(rng.uniform(0.3, 30, size=(2, 3, 3)).astype(np.float32))}
a2j_state, metrics = a2j.train_step(a2j_state, a2j_batch)
pred, rmse = a2j.eval_step(a2j_state, a2j_batch)
assert a2j_state.step == 1 and tuple(pred.shape) == (2, 3, 3) and bool(torch.isfinite(rmse))
from handnet_tpu_torch.apps import train_pose2mesh as p2m
from handnet_tpu_torch.config import Pose2MeshConfig
mano = ManoLayer(ManoAssets.synthetic(rng), flat_hand_mean=True, device="cpu")
faces = p2m.training_faces(ManoAssets.synthetic(rng))
pyramid = p2m.build_pyramid(faces)
p2m_state = p2m.init_state(pyramid, 1e-4, torch.device("cpu"), Pose2MeshConfig(posenet_hid=64))
losses = p2m.train_step(p2m_state, torch.from_numpy(pyramid.perm_reverse[:778]),
                        torch.from_numpy(faces), *p2m.make_batch(rng, mano, 2))
assert p2m_state.step == 1 and bool(torch.isfinite(losses["total_loss"]))
import tempfile
from handnet_tpu_torch.data import a2j_data, dexycb, loader, synthetic
from handnet_tpu_torch.eval.hpe import HPEEvaluator
import handnet_tpu_torch.apps.a2j_infer, handnet_tpu_torch.apps.eval_hpe
import handnet_tpu_torch.apps.train_a2j
with tempfile.TemporaryDirectory() as root:
    synthetic.make_synthetic_dexycb(root, n_sequences=1, n_frames=2)
    ds = dexycb.DexYCBDataset("s0", "train", data_dir=root)
    source = a2j_data.A2JDataSource(ds, dexycb.refine_indices(ds), augment=True,
                                    cfg=a2j_data.A2JSampleConfig(crop_w=32, crop_h=32))
    batch = next(iter(loader.PrefetchLoader(source, 2, num_workers=1)))
    assert batch["depth"].shape == (2, 32, 32, 1)
    gt = dexycb.hpe_ground_truth(ds)
    res = HPEEvaluator(gt).evaluate_dict(0, {k: v + 1.0 for k, v in gt.items()})
    assert np.isfinite(res["absolute"]["mpjpe"])
    # the colour frames: the JPEG codec, a detection item and a VOC item
    import glob, os
    from handnet_tpu_torch.data import detect_data, image_io, voc100doh
    import handnet_tpu_torch.apps.train_fcos, handnet_tpu_torch.apps.eval_fcos
    color = image_io.imread_color(sorted(glob.glob(root + "/**/color_*.jpg", recursive=True))[0])
    assert color.shape == (480, 640, 3)
    item = detect_data.DetectDataSource(ds, [0], uint8_images=True)[0]
    assert item["image"].shape == (480, 640, 3) and item["target_valid"].any()
    devkit = os.path.join(root, "voc", "VOC2007")
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        os.makedirs(os.path.join(devkit, sub))
    open(os.path.join(devkit, "ImageSets", "Main", "trainval.txt"), "w").write("a\\n")
    open(os.path.join(devkit, "Annotations", "a.xml"), "w").write(
        "<annotation><object><name>hand</name><bndbox><xmin>3</xmin><ymin>4</ymin>"
        "<xmax>30</xmax><ymax>40</ymax></bndbox></object></annotation>")
    image_io.imwrite_jpeg(os.path.join(devkit, "JPEGImages", "a.jpg"), color[:60, :80])
    voc = voc100doh.VOCDetectSource(voc100doh.VOC100DOH(os.path.join(root, "voc")),
                                    target_size=(64, 96))[0]
    assert voc["image"].shape == (64, 96, 3) and voc["target_valid"][0]
    # the last slice's modules: an E2E item, a deprojection, a COCO evaluation
    from handnet_tpu_torch.data import e2e_data, imgtrans, sequence
    from handnet_tpu_torch.eval import bop_pose, coco_det, grasp
    from handnet_tpu_torch.eval.voc import Detection, GTObject
    import handnet_tpu_torch.ops.offset_field
    e2e = e2e_data.E2EDataSource(ds, dexycb.refine_indices(ds))[0]
    assert e2e["image"].shape == (480, 640, 3) and e2e["target_valid"].any()
    pts, mask = sequence.deproject_depth(torch.from_numpy(e2e["depth"][None]),
                                         torch.eye(3)[None], torch.eye(4)[None])
    assert tuple(pts.shape) == (1, 480 * 640, 3) and bool(mask.any())
    coco = coco_det.CocoDetEvaluator({"0": [GTObject("hand", e2e["hand_box"])]}).evaluate(
        [Detection("0", 0.9, e2e["hand_box"])])
    assert coco["AP"] == 1.0
from handnet_tpu_torch.models.faster_rcnn import decode_rcnn_detections
from handnet_tpu_torch.train.trainer import RCNNTrainer
rcnn = RCNNTrainer(C.FCOSConfig(num_classes=3, image_h=64, image_w=96),
                   C.TrainConfig(optimizer="sgd", lr=1e-3, warmup_epochs=1), steps_per_epoch=4,
                   backbone_norm="group", num_proposals=8, device="cpu")
rcnn_state = rcnn.init_state(0)
rcnn_targets = dict(targets, labels=valid.int() * 2)
rcnn_state, metrics = rcnn.train_step(rcnn_state, {"image": image, "targets": rcnn_targets})
assert rcnn_state.step == 1 and bool(torch.isfinite(metrics["total_loss"]))
with torch.no_grad():
    det = decode_rcnn_detections(rcnn_state.model.eval()(image), 3, max_dets=8,
                                 image_hw=(64, 96))
assert tuple(det["boxes"].shape) == (2, 8, 4)
from handnet_tpu_torch.config import load_config
assert load_config(yaml_path="configs/fast.yaml").fcos.image_h > 0
# the demo apps and their utilities: one demo frame, a drawn line, a state file
import handnet_tpu_torch.apps.a2j_mesh, handnet_tpu_torch.apps.ros_node
import handnet_tpu_torch.convert.mano_assets, handnet_tpu_torch.utils.meshvis
from handnet_tpu_torch.apps import demo
from handnet_tpu_torch.utils import draw, statepack
res = demo.main(["--frames", "1", "--size", "48", "64", "--net-size", "48", "64", "--crop",
                 "32", "--score-thresh", "0", "--device", "cpu"])
assert len(res["results"]) == 1 and np.isfinite(res["results"][0]["joints_xyz"]).all()
assert draw.line(np.zeros((8, 8, 3), np.uint8), (0, 0), (7, 3), (1, 2, 3))[3, 7].tolist() == [
    1, 2, 3]
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "states.msgpack")
    fcfg = C.FCOSConfig(image_h=64, image_w=96, fpn_channels=64, num_convs=2)
    acfg = C.A2JConfig(crop_h=32, crop_w=32, num_joints=3, head_features=32)
    statepack.save_trained_states(path, state, fcfg, a2j_state, acfg, synth={"crop": 32})
    f_vars, fcfg2, a_vars, acfg2, synth = statepack.load_trained_states(path)
    assert (fcfg2, acfg2, synth) == (fcfg, acfg, {"crop": 32}) and a_vars["params"]
from handnet_tpu_torch import parallel
(block,) = parallel.shard_batch(parallel.DataMesh((torch.device("cpu"),), 1, 2), image)
assert torch.equal(block, image[1:])
with tempfile.TemporaryDirectory() as d:
    mesh = parallel.init_data_parallel(rank=0, world_size=1, init_method=f"file://{d}/init",
                                       device="cpu")
    ddp = FCOSTrainer(C.FCOSConfig(image_h=64, image_w=96, fpn_channels=64, num_convs=2),
                      C.TrainConfig(optimizer="sgd", lr=1e-3), mesh=mesh, device="cpu")
    ddp_state, metrics = ddp.train_step(ddp.init_state(0), {"image": image, "targets": targets})
    assert ddp_state.wrapped is not None and bool(torch.isfinite(metrics["total_loss"]))
    torch.distributed.destroy_process_group()
from handnet_tpu_torch.tools import gates, rcnn_convergence, synthetic_e2e_validation
from handnet_tpu_torch.tools import int8_saturation_study, resolution_study
from handnet_tpu_torch.tools import bake_bench_calibration
assert callable(synthetic_e2e_validation.main) and callable(rcnn_convergence.main)
assert bake_bench_calibration.bench_frames(1, 2, 2, 3)[1].shape == (1, 2, 3)
assert resolution_study.parse_spec("480x640@nc2@qs") == (480, 640, 2, "static")
assert callable(int8_saturation_study.main)
assert gates.split_indices(10) == ([0, 1, 2, 3, 5, 6, 7, 8], [4, 9])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "handnet_tpu",
                                       "cv2", "yaml", "PIL", "msgpack", "matplotlib", "rclpy"))
print("LOADED", loaded)
"""


def test_port_imports_no_jax():
    """A fresh interpreter runs the slice through the port, float and
    calibrated static int8, detects on frames that it resamples, builds the
    full-width QUANT_STATIC pipeline, runs the mesh head (``with_mesh``) and
    the MANO layer, imports the server, the artifact module, the export CLI
    and the rotations, imports the training package and takes one CPU train
    step of ``FCOSTrainer``, one train and one eval step of ``A2JTrainer``,
    one step of the Pose2Mesh app's ``train_step`` and one of
    ``RCNNTrainer`` (GroupNorm backbone) with a decode of its forward, builds a small
    synthetic DexYCB tree, draws a batch through ``A2JDataSource`` and
    ``PrefetchLoader``, runs ``HPEEvaluator``, imports the A2J and FCOS
    apps, decodes a colour JPEG, builds a ``DetectDataSource`` item and a
    ``VOCDetectSource`` item (a JPEG it writes, resized), builds an
    ``E2EDataSource`` item, deprojects its depth, runs ``CocoDetEvaluator``
    on its hand box, imports the offset field, colour jitter and the BOP
    and grasp evaluators, reads a config
    through ``load_config(yaml_path=...)``, imports the demo apps and their
    utilities, runs one frame of ``demo.main``, draws a line and writes and
    reads back a ``statepack`` file, shards a batch with
    ``handnet_tpu_torch.parallel`` and takes one data-parallel
    ``FCOSTrainer`` step in a one-rank gloo world, imports both learning
    gates (``tools/synthetic_e2e_validation`` and ``tools/rcnn_convergence``)
    with their ``gates``, both studies (``tools/resolution_study``,
    ``tools/int8_saturation_study``) and the calibration baker
    (``tools/bake_bench_calibration``), and has loaded neither jax, optax,
    orbax, the JAX package, ``cv2``, ``yaml``, PIL, ``msgpack``,
    matplotlib nor ``rclpy`` (a subprocess: tests/conftest.py imports jax
    into this one). One intra-op thread, as the other port tests: alone it
    takes as long, and beside the other test workers it does not crowd
    them."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "LOADED []", proc.stdout


def test_pipeline_defaults_to_the_card(monkeypatch):
    """Without a device the pipeline serves on the card: where there is no
    CUDA device it raises instead of carrying on on the CPU, and where there
    is one it asks for "cuda"; ``device="cpu"`` builds on the CPU."""
    cfg = _cfg(pconfig, 0.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HandNetPipeline(cfg)
    pipe = HandNetPipeline(cfg, device="cpu")
    assert {p.device.type for p in pipe.parameters()} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    moved = []
    monkeypatch.setattr(HandNetPipeline, "to", lambda self, device: moved.append(device) or self)
    HandNetPipeline(cfg)
    assert moved == ["cuda"]


def test_load_config_yaml_equals_pyyaml():
    """``load_config(yaml_path=p)`` reads every file under ``configs/``
    through the port's ``yaml_lite`` as pyyaml's ``safe_load`` reads it:
    the same config as the overrides pyyaml gives."""
    import yaml

    files = sorted((REPO / "configs").glob("*.yaml"))
    assert files
    for path in files:
        with open(path) as f:
            want = pconfig.load_config(overrides=yaml.safe_load(f) or {})
        assert pconfig.load_config(yaml_path=str(path)) == want, path.name
