"""The port's learning gates (``handnet_tpu_torch/tools/``) on the CPU.

``gates.py``'s pieces against the JAX package: the split and the
generation keys against JAX's ``DexYCBDataset`` and
``synthetic_sequence_number`` on a JAX tree beside the port's (5 sequences
x 2 frames at 480x640), the padded box and both PASS rules against the
JAX tools' lines (transcribed here: those tools call ``runtime.setup()``
when imported, so no test imports or runs one), the IoU and COCO numbers
against ``handnet_tpu.ops.boxes.box_iou`` and ``CocoDetEvaluator`` on the
same seeded detections (1e-6). The assembled pipeline against the
trainers' own eval forwards (64x96 detector, 32^2 crop, float32, 1e-4).
One ``main`` of each tool at the smoke sizes on ``--device cpu``; its
``--save-state`` pack read by the JAX package's ``load_trained_states``;
without ``--device`` both tools raise where there is no card. The tools'
flags and defaults against the JAX tools' parsers, read from their source.

One torch thread (module fixture); no subprocess, no JAX train step.
"""

import dataclasses

import numpy as np
import pytest
import torch
# torch imports its compiler stack at the first optimizer it builds, and
# that import walks sys.modules through inspect; tests/test_mano.py leaves
# chumpy stub modules there that break the walk, so import it at collection
import torch._dynamo  # noqa: F401

from handnet_tpu import config as jconfig
from handnet_tpu.data.dexycb import DexYCBDataset as JaxDexYCB
from handnet_tpu.data.synthetic import make_synthetic_dexycb as jax_make_tree
from handnet_tpu.data.synthetic import synthetic_sequence_number as jax_sequence_number
from handnet_tpu.eval.coco_det import CocoDetEvaluator as JaxCoco
from handnet_tpu.eval.voc import Detection as JaxDetection
from handnet_tpu.eval.voc import GTObject as JaxGTObject
from handnet_tpu.ops.boxes import box_iou as jax_box_iou
from handnet_tpu.utils import statepack as jax_statepack
from handnet_tpu_torch.config import A2JConfig, FCOSConfig, TrainConfig
from handnet_tpu_torch.data.dexycb import DexYCBDataset
from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb
from handnet_tpu_torch.nn.resnet import BatchNorm2d, FrozenBatchNorm2d
from handnet_tpu_torch.tools import gates, rcnn_convergence, synthetic_e2e_validation
from handnet_tpu_torch.train.trainer import A2JTrainer, FCOSTrainer
from handnet_tpu_torch.utils import statepack
from torch_port_fixtures import jax_tool_defaults, leaves_equal

METRIC_TOL = 1e-6     # IoU and COCO numbers, port against JAX
HANDOFF_TOL = 1e-4    # pipeline against the trainers' eval forwards, float32
# the smoke sizes: 4 sequences x 2 frames, 2 steps each, batch 2, 128x160, 32^2
E2E_SMOKE = ["--sequences", "4", "--frames", "2", "--fcos-steps", "2", "--a2j-steps", "2",
             "--batch", "2", "--image-h", "128", "--image-w", "160", "--crop", "32",
             "--quant-eval", "static"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The port's and JAX's synthetic trees at one seed, with their info
    dicts and their s0 train datasets."""
    out = {}
    for name, make, dataset in (("port", make_synthetic_dexycb, DexYCBDataset),
                                ("jax", jax_make_tree, JaxDexYCB)):
        root = str(tmp_path_factory.mktemp(name))
        info = make(root, n_sequences=5, n_frames=2)
        out[name] = (info, dataset("s0", "train", data_dir=root))
    return out


def test_split_and_generation_keys_match_jax(trees):
    """The split of the port's tree is JAX's (every fifth frame held out),
    every frame's generation key is the one JAX's dataset and
    ``synthetic_sequence_number`` give, and the planted ground truth under
    each key is the JAX tree's."""
    info, ds = trees["port"]
    jinfo, jds = trees["jax"]
    n = len(jds)
    assert len(ds) == n == 8   # sequence 4 is out of the s0 train split
    train, held_out = gates.split_indices(len(ds))
    assert train == [i for i in range(n) if i % 5 != 4]
    assert held_out == [i for i in range(n) if i % 5 == 4] == [4]
    for i in range(n):
        s, _, f = jds._mapping[i]
        key = (jax_sequence_number(jds._sequences[int(s)]), int(f))
        assert gates.generation_key(ds, i) == key
        for field in ("hand_box", "joints_3d", "paras"):
            np.testing.assert_array_equal(info[key][field], jinfo[key][field])


def test_frame_readers(trees):
    """The held-out frames as the tools read them: RGB uint8 and depth in
    metres, the pixels of the tree's files."""
    info, ds = trees["port"]
    _, held_out = gates.split_indices(len(ds))
    sample = ds[held_out[0]]
    rgb, depth = gates.read_rgb(sample), gates.read_depth(sample)
    assert rgb.shape == (480, 640, 3) and rgb.dtype == np.uint8 and rgb.flags.c_contiguous
    assert depth.shape == (480, 640) and depth.dtype == np.float32
    x1, y1, x2, y2 = info[gates.generation_key(ds, held_out[0])]["hand_box"].astype(int)
    # the planted hand, painted (200, 170, 150) in the file's BGR order: its
    # colour in RGB and its depth inside the box, off the joints' stamps
    assert np.abs(rgb[y1:y2, x1:x2].astype(int) - (150, 170, 200)).max(-1).min() <= 8
    assert 0.4 <= float(np.median(depth[y1:y2, x1:x2])) <= 0.8
    frames = gates.frames_01(rgb, "cpu")
    assert frames.shape == (1, 480, 640, 3) and float(frames.max()) <= 1.0


@pytest.mark.parametrize("box", [(300, 200, 360, 260), (2, 3, 80, 90), (560, 400, 639, 479),
                                 (120.5, 100.25, 209.75, 189.5)])
def test_padded_box_matches_jax_lines(box):
    """The planted box padded by 40% and clipped to 640x480, as
    ``synthetic_e2e_validation.py:305-309`` pads it, and its IoU against a
    crop box through JAX's ``box_iou``."""
    gx1, gy1, gx2, gy2 = np.asarray(box, np.float32)
    gw, gh = gx2 - gx1, gy2 - gy1
    want = np.array([max(0, gx1 - 0.4 * gw), max(0, gy1 - 0.4 * gh),
                     min(640, gx2 + 0.4 * gw), min(480, gy2 + 0.4 * gh)])
    got = gates.padded_box(np.asarray(box, np.float32))
    np.testing.assert_array_equal(got, want)
    crop = got + np.array([3.0, -2.0, 5.5, 1.0])
    want_iou = float(np.asarray(jax_box_iou(crop[None], want[None]))[0, 0])
    assert abs(gates.iou(crop, got) - want_iou) <= METRIC_TOL


def _jax_e2e_ok(n, found, ious, mpjpes, found_q, mpjpes_q, quant):
    """``synthetic_e2e_validation.py:340-348``."""
    ok = (found >= 0.8 * n and ious and np.mean(ious) > 0.5
          and mpjpes and np.mean(mpjpes) < 60.0)
    if quant:
        ok = (ok and found_q >= 0.8 * n and mpjpes_q and np.mean(mpjpes_q) < 60.0)
    return bool(ok)


E2E_CASES = [
    # (held out, found, ious, mpjpes, found int8, mpjpes int8, int8 on)
    (24, 24, [0.81] * 24, [27.5] * 24, 24, [29.0] * 24, True),
    (10, 8, [0.6] * 8, [40.0] * 8, 8, [50.0] * 8, True),      # 80% exactly
    (10, 7, [0.9] * 7, [20.0] * 7, 10, [20.0] * 10, True),     # found below 80%
    (10, 10, [0.5] * 10, [20.0] * 10, 10, [20.0] * 10, True),  # IoU not above 0.5
    (10, 10, [0.7] * 10, [60.0] * 10, 10, [20.0] * 10, True),  # MPJPE not under 60
    (10, 10, [0.7] * 10, [30.0] * 10, 7, [20.0] * 7, True),    # int8 found below 80%
    (10, 10, [0.7] * 10, [30.0] * 10, 10, [61.0] * 10, True),  # int8 MPJPE over 60
    (10, 10, [0.7] * 10, [30.0] * 10, 0, [], True),            # int8 found none
    (10, 10, [0.7] * 10, [30.0] * 10, 0, [], False),           # float only
    (10, 0, [], [], 0, [], False),                             # nothing found
]


@pytest.mark.parametrize("case", E2E_CASES)
def test_e2e_pass_rule_matches_jax(case):
    n, found, ious, mpjpes, found_q, mpjpes_q, quant = case
    got = gates.e2e_passes(n, found, ious, mpjpes, found_q if quant else None, mpjpes_q)
    assert got == _jax_e2e_ok(n, found, ious, mpjpes, found_q, mpjpes_q, quant)


@pytest.mark.parametrize("found_rate, ap50, smoke", [
    (0.8, 0.5, False), (0.79, 0.9, False), (1.0, 0.49, False), (0.0, 0.0, True),
    (0.9583, 0.7201, False)])
def test_rcnn_pass_rule_matches_jax(found_rate, ap50, smoke):
    """``rcnn_convergence.py:206``."""
    want = (found_rate >= 0.8 and ap50 >= 0.5) or smoke
    assert gates.rcnn_passes(found_rate, ap50, smoke) == want


def test_detection_tally_matches_jax():
    """Found rate, best-box IoU and COCO AP/AP50/AP75 of seeded detections
    (frames without a valid one, ties of score, boxes near and far from the
    planted one) against ``rcnn_convergence.py:132-161`` on JAX's
    ``box_iou`` and ``CocoDetEvaluator``."""
    rng = np.random.default_rng(19)
    tally = gates.DetectionTally()
    annos, dets, ious, found = {}, [], [], 0
    n_frames, k = 12, 8
    for i in range(n_frames):
        x1, y1 = rng.uniform(100, 400), rng.uniform(80, 280)
        side = rng.uniform(50, 90)
        gt = np.array([x1, y1, x1 + side, y1 + side], np.float32)
        boxes = (gt[None] + rng.normal(0, rng.choice([2.0, 15.0, 60.0]), (k, 4))).astype(
            np.float32)
        scores = rng.uniform(0.3, 1.0, k).astype(np.float32)
        scores[1] = scores[0]
        valid = rng.uniform(size=k) < (0.0 if i % 5 == 3 else 0.5)
        tally.add(str(i), gt, valid, boxes, scores)
        # the JAX tool's loop
        annos[str(i)] = [JaxGTObject("hand", np.asarray(gt, float))]
        if valid.any():
            found += 1
            best = int(np.argmax(np.where(valid, scores, -1)))
            ious.append(float(np.asarray(jax_box_iou(
                boxes[best][None], np.asarray(gt, float)[None]))[0, 0]))
            for j in np.nonzero(valid)[0]:
                dets.append(JaxDetection(str(i), float(scores[j]), boxes[j]))
    coco = JaxCoco(annos).evaluate(dets, ["hand"] * len(dets))
    got = tally.summary("rcnn")
    assert tally.found == found and 0 < found < n_frames
    np.testing.assert_allclose(tally.ious, ious, rtol=0, atol=METRIC_TOL)
    want = {"found_rate": found / n_frames, "mean_iou": float(np.mean(ious)),
            "AP": coco["AP"], "AP50": coco["AP50"], "AP75": coco["AP75"]}
    assert got["net"] == "rcnn"
    for key, value in want.items():
        assert abs(got[key] - round(value, 4)) <= METRIC_TOL, key
    assert 0.0 < coco["AP50"] < 1.0


def _randomize_batch_norms(model, seed: int) -> None:
    """Each trainable BatchNorm's affine and running statistics drawn at
    random, as a trained model holds them."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                c = m.weight.shape[0]
                m.weight.copy_(0.8 + 0.4 * torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.2 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))


def test_assembled_pipeline_against_the_trainers_eval_forwards():
    """The float32 pipeline assembled from a batch-norm FCOS and A2J (their
    norms and running statistics drawn at random) detects as
    ``FCOSSystem.detect`` of the trained detector and poses its own crops as
    ``A2JTrainer.eval_step`` does, within 1e-4; every running variance
    of the pipeline scaled by 1.01 shows in both (the check can fail)."""
    fcfg = FCOSConfig(num_classes=2, ext=False, image_h=64, image_w=96, max_detections=8)
    acfg = A2JConfig(crop_h=32, crop_w=32)
    plain = TrainConfig(bf16=False)
    ftrainer = FCOSTrainer(fcfg, plain, backbone_norm="batch", device="cpu")
    atrainer = A2JTrainer(acfg, plain, device="cpu")
    fstate, astate = ftrainer.init_state(0), atrainer.init_state(1)
    _randomize_batch_norms(fstate.model, 5)
    _randomize_batch_norms(astate.model, 6)
    cfg = gates.pipeline_config(fcfg, acfg, 32)
    # every detection kept, and random heads rank class 0 first: take it as
    # the hand, so both frames go on to the crop and the pose
    cfg = dataclasses.replace(cfg, fcos=dataclasses.replace(cfg.fcos, score_thresh=0.0),
                              pipeline=dataclasses.replace(cfg.pipeline, hand_label=0))
    pipe = gates.assemble_pipeline(cfg, fstate.model, astate.model, dtype=torch.float32,
                                   device="cpu")
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.uniform(size=(2, 120, 160, 3)).astype(np.float32))
    depth = torch.from_numpy(rng.uniform(0.3, 1.0, size=(2, 120, 160)).astype(np.float32))
    err = gates.handoff_errors(pipe, fstate.model, atrainer, astate, images, depth)
    assert err["detections"] > 0 and err["found"] == 2, err
    assert max(err["box"], err["score"], err["joints"]) <= HANDOFF_TOL, err

    with torch.no_grad():
        for m in pipe.modules():
            if isinstance(m, FrozenBatchNorm2d):
                m.running_var.mul_(1.01)
    shifted = gates.handoff_errors(pipe, fstate.model, atrainer, astate, images, depth)
    assert min(shifted["box"], shifted["joints"]) > 10 * HANDOFF_TOL, shifted


def test_assemble_pipeline_refuses_a_foreign_state():
    """A state dict of another architecture does not load quietly."""
    fcfg = FCOSConfig(num_classes=2, ext=False, image_h=64, image_w=96, max_detections=8)
    acfg = A2JConfig(crop_h=32, crop_w=32)
    ftrainer = FCOSTrainer(fcfg, TrainConfig(bf16=False), backbone_norm="group", device="cpu")
    atrainer = A2JTrainer(acfg, TrainConfig(bf16=False), device="cpu")
    with pytest.raises(KeyError, match="detector"):
        gates.assemble_pipeline(gates.pipeline_config(fcfg, acfg, 32),
                                ftrainer.init_state(0).model, atrainer.init_state(1).model,
                                dtype=torch.float32, device="cpu")


def test_e2e_main_smoke_and_its_pack_read_by_jax(tmp_path, capsys, monkeypatch):
    """``main`` at the smoke sizes on the CPU (static int8: calibrated,
    then the int8 pipeline) prints its result lines and exits 0 or 1; its
    ``--save-state`` pack, read by the JAX package's
    ``load_trained_states``, holds every array of the trained models and
    their configs."""
    saved = {}
    save = statepack.save_trained_states

    def capture(path, fstate, fcfg, astate, acfg, synth=None):
        saved.update(f=statepack._variables(fstate), a=statepack._variables(astate),
                     fcfg=fcfg, acfg=acfg)
        save(path, fstate, fcfg, astate, acfg, synth)

    monkeypatch.setattr(statepack, "save_trained_states", capture)
    pack = str(tmp_path / "states.msgpack")
    report = {}
    code = synthetic_e2e_validation.main(E2E_SMOKE + ["--save-state", pack, "--device", "cpu"],
                                         report)
    out = capsys.readouterr().out
    assert code in (0, 1) and (code == 0) == report["ok"]
    for line in ("8 synthetic frames (7 train, 1 held out", "[fcos] loss", "[a2j] loss",
                 "a2j-only MPJPE on held-out seg crops", "held-out frames: 1", "hand found: ",
                 "int8[static] pipeline: found ", f"trained states -> {pack}",
                 "VALIDATION: " + ("PASS" if code == 0 else "FAIL")):
        assert line in out, line
    assert [s["steps"] for s in report["stats"].values()] == [2, 2]
    assert np.isfinite(report["a2j_only"]["mpjpe_mm"])
    assert report["pipeline_int8"].needs_calibration()

    f_vars, fcfg, a_vars, acfg, synth = jax_statepack.load_trained_states(pack)
    assert leaves_equal(f_vars, saved["f"]) and leaves_equal(a_vars, saved["a"])
    assert f_vars["params"] and f_vars["batch_stats"] and a_vars["batch_stats"]
    assert dataclasses.asdict(fcfg) == dataclasses.asdict(saved["fcfg"])
    assert dataclasses.asdict(acfg) == dataclasses.asdict(saved["acfg"])
    assert (fcfg.num_classes, fcfg.image_h, fcfg.image_w, acfg.crop_h) == (2, 128, 160, 32)
    assert isinstance(fcfg, jconfig.FCOSConfig)
    assert synth == {"sequences": 4, "frames": 2, "crop": 32}


def test_rcnn_main_smoke(capsys, monkeypatch):
    """``RCNN_SMOKE`` shrinks the run and keeps the device asked for: both
    nets train 2 steps of batch 2 at 128x160 on the CPU, one JSON line
    each, and the smoke run passes."""
    monkeypatch.setenv("RCNN_SMOKE", "1")
    report = {}
    code = rcnn_convergence.main(["--with-fcos", "--device", "cpu"], report)
    out = capsys.readouterr().out
    assert code == 0 and report["ok"]
    assert "8 synthetic frames (7 train, 1 held out)" in out
    assert "RCNN CONVERGENCE: PASS" in out
    records = [ln for ln in out.splitlines() if ln.startswith('{"net"')]
    assert [r.split('"')[3] for r in records] == ["rcnn", "fcos"]
    for net in ("rcnn", "fcos"):
        entry = report["nets"][net]
        assert entry["stats"]["steps"] == 2
        assert {p.device.type for p in entry["state"].model.parameters()} == {"cpu"}
        assert set(entry["record"]) == {"net", "found_rate", "mean_iou", "AP", "AP50",
                                        "AP75", "final_loss"}


@pytest.mark.parametrize("tool", [synthetic_e2e_validation, rcnn_convergence])
def test_tools_default_to_the_card(tool, monkeypatch):
    """Without ``--device`` a tool trains on the card, and raises where
    there is none, before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    monkeypatch.setattr(tool, "make_synthetic_dexycb", lambda *a, **k: made.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
    assert not made


@pytest.mark.parametrize("tool", [synthetic_e2e_validation, rcnn_convergence])
def test_tool_flags_match_jax(tool):
    """Every flag of the JAX tool, with its default; the port adds
    ``--device`` (None: the card)."""
    name = tool.__name__.rsplit(".", 1)[1]
    got = vars(tool.parse_args([]))
    want = jax_tool_defaults(name)
    assert got == {**want, "device": None}
    assert len(want) >= 8
