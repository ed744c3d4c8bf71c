"""The port's two study tools (``handnet_tpu_torch/tools/resolution_study.py``
and ``int8_saturation_study.py``) on the CPU, against the JAX package.

The JAX tools call ``runtime.setup()`` when imported, so no test imports or
runs one: their lines are transcribed here and their parsers read from
their source. Weights are the port's seeded init, their norms drawn at
random, as flax variables (``convert/from_flax.py``); both sides run in
float32 on the frames of one synthetic tree (10 sequences x 2 frames: 13
training frames, 3 held out), the detector at 64x96 with 64-channel FPN and
towers, A2J on 32^2 crops.

Tolerances:
  * the held-out eval against JAX's ``FCOSSystem.detect`` + ``box_iou`` +
    ``CocoDetEvaluator``: the found count exact; IoU, AP, AP50 and AP75
    within ``EVAL_TOL`` = 1e-4;
  * the ``@qs`` detector's calibration amaxes within ``AMAX_RTOL`` = 3e-2
    of JAX's and at least half of them within 1e-5, the rule of
    ``test_torch_port_quant_slice.py`` and for its reason (the float layers
    between the int8 convs round differently in the last bit, and an int8
    layer turns that into a whole step at a rounding tie);
  * the saturation pipeline's amaxes (detector and A2J, 3 frames) within
    ``PIPELINE_AMAX_RTOL`` = 5e-2, at least half within 1e-5: the same
    mechanism, measured here at up to 4.19e-2 (the detector's cls tower's
    last conv; 67 of 113 within 1e-5);
  * the overflow factor within ``OVERFLOW_RTOL`` = 1e-5: its worst layer is
    the first int8 conv (``layer1_0/conv1``), fed by float layers alone,
    and matches JAX's to 2e-7;
  * the amaxes at margin m are the raw snapshot x (1 + m) in float32 and
    JAX's ``apply_margin`` of that snapshot, exactly, and a raw calibration
    does not depend on the ones before it;
  * the frames bit for bit; the paired margin analysis within 1e-12.

One torch thread (module fixture); no subprocess.
"""

import dataclasses
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# see test_torch_port_learning_gates.py: tests/test_mano.py's chumpy stubs
# break torch's first optimizer import unless it happens at collection
import torch._dynamo  # noqa: F401

from handnet_tpu import config as jconfig
from handnet_tpu.eval.coco_det import CocoDetEvaluator as JaxCoco
from handnet_tpu.eval.voc import Detection as JaxDetection
from handnet_tpu.eval.voc import GTObject as JaxGTObject
from handnet_tpu.models.fcos import FCOSSystem as JaxFCOSSystem
from handnet_tpu.models.fcos import preprocess as jax_preprocess
from handnet_tpu.models.pipeline import HandNetPipeline as JaxPipeline
from handnet_tpu.nn import quant as jquant
from handnet_tpu.ops.boxes import box_iou as jax_box_iou
from handnet_tpu_torch import config as pconfig
from handnet_tpu_torch.convert.from_flax import (a2j_state_dict_from_flax,
                                                 a2j_variables_from_state_dict,
                                                 fcos_state_dict_from_flax,
                                                 fcos_variables_from_state_dict,
                                                 flax_calibration_key)
from handnet_tpu_torch.data.dexycb import DexYCBDataset
from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb
from handnet_tpu_torch.models.a2j import A2JSystem
from handnet_tpu_torch.models.fcos import FCOSSystem
from handnet_tpu_torch.tools import gates, int8_saturation_study, resolution_study
from handnet_tpu_torch.tools import synthetic_e2e_validation
from torch_port_fixtures import assert_close, fast_compile, jax_tool_defaults, randomize_norms

H, W, CROP, WIDTH = 64, 96, 32, 64
EVAL_TOL = 1e-4
AMAX_RTOL = 3e-2
PIPELINE_AMAX_RTOL = 5e-2
AMAX_EXACT_SHARE = 0.5
OVERFLOW_RTOL = 1e-5
PAIRED_TOL = 1e-12
MARGINS = (0.0, 0.1, 0.25)
HOT_GAIN = 2.0
# the pack: 4 sequences x 2 frames, 1 step of each stage at 64x96, 32^2 crops
E2E_PACK = ["--sequences", "4", "--frames", "2", "--fcos-steps", "1", "--a2j-steps", "1",
            "--batch", "2", "--image-h", "64", "--image-w", "96", "--crop", "32",
            "--quant-eval", "none", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``(info, dataset, train indices, held-out indices)`` of one tree."""
    root = str(tmp_path_factory.mktemp("tree"))
    info = make_synthetic_dexycb(root, n_sequences=10, n_frames=2)
    ds = DexYCBDataset("s0", "train", data_dir=root)
    train, held_out = gates.split_indices(len(ds))
    assert (len(train), len(held_out)) == (13, 3)
    return info, ds, train, held_out


def _fcfg(module, **kw):
    return module.FCOSConfig(num_classes=2, ext=False, image_h=H, image_w=W, max_detections=8,
                             fpn_channels=WIDTH, **kw)


def _acfg(module, **kw):
    return module.A2JConfig(crop_h=CROP, crop_w=CROP, head_features=WIDTH, **kw)


@pytest.fixture(scope="module")
def detector_vars():
    """The port's seeded detector as flax variables, its norms drawn at
    random and its box regression's bias raised to 4 anchor sizes each way,
    so that the best-scoring box of each held-out frame overlaps the
    planted hand (IoU 0.005-0.02; at 0.8 they miss it and every IoU is 0)."""
    model = FCOSSystem(_fcfg(pconfig))
    model.init_weights_(torch.Generator().manual_seed(0))
    variables = randomize_norms(fcos_variables_from_state_dict(model.state_dict()), seed=3)
    variables["params"]["head"]["bbox_reg"]["bias"] = np.full(4, 4.0, np.float32)
    return variables


@pytest.fixture(scope="module")
def a2j_vars():
    model = A2JSystem(_acfg(pconfig))
    model.init_weights_(torch.Generator().manual_seed(1))
    return randomize_norms(a2j_variables_from_state_dict(model.state_dict()), seed=4)


def _jax_rgb(sample) -> np.ndarray:
    """The JAX tools' colour read: ``cv2.imread(...)[:, :, ::-1]``."""
    return cv2.imread(sample["color_file"])[:, :, ::-1]


# --- the flags and the resolution study's specs and records ---


@pytest.mark.parametrize("tool", [resolution_study, int8_saturation_study])
def test_tool_flags_match_jax(tool):
    """Every flag of the JAX tool with its default; the port adds
    ``--device`` (None: the card)."""
    name = tool.__name__.rsplit(".", 1)[1]
    want = jax_tool_defaults(name)
    assert vars(tool.parse_args([])) == {**want, "device": None}
    assert len(want) >= 5


def _jax_spec(res: str):
    """``resolution_study.py:184-196`` and the record's name (``:136-138``)."""
    parts = res.split("@")
    nc, quant = 4, False
    for tok in parts[1:]:
        if tok.startswith("nc"):
            nc = int(tok[2:])
        elif tok == "q":
            quant = True
        elif tok == "qs":
            quant = "static"
        else:
            raise ValueError(f"unknown spec suffix @{tok} in {res!r}")
    h, w = (int(x) for x in parts[0].split("x"))
    name = f"{h}x{w}@nc{nc}" + ("@qs" if quant == "static" else "@q" if quant else "")
    return h, w, nc, quant, name


@pytest.mark.parametrize("spec", ["512x640", "800x1088", "480x640@nc2", "480x640@q",
                                  "480x640@qs", "480x640@nc2@qs", "64x96@qs@nc3",
                                  "480x640@fp16", "480x640@nc2@int4"])
def test_spec_parser_matches_jax(spec):
    try:
        want = _jax_spec(spec)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err).split(" in ")[0]):
            resolution_study.parse_spec(spec)
        return
    h, w, nc, quant = resolution_study.parse_spec(spec)
    assert (h, w, nc, quant, resolution_study.spec_name(h, w, nc, quant)) == want
    assert resolution_study.detector_config(h, w, nc) == dataclasses.replace(
        pconfig.FCOSConfig(num_classes=2, ext=False, image_h=h, image_w=w, max_detections=8),
        num_convs=nc)


def test_unknown_spec_refused_before_training(monkeypatch):
    """A bad spec anywhere in ``--resolutions`` stops the run before the
    tree is made."""
    made = []
    monkeypatch.setattr(resolution_study, "make_synthetic_dexycb",
                        lambda *a, **k: made.append(a))
    with pytest.raises(ValueError, match="unknown spec suffix @fp16"):
        resolution_study.main(["--resolutions", "64x96", "64x96@fp16", "--device", "cpu"])
    assert not made


# --- the held-out eval and the @qs calibration against JAX ---


def _jax_held_out(detect, variables, ds, test_idx, info):
    """``resolution_study.py:109-146``: one detect per held-out frame."""
    annos, dets, ious, found = {}, [], [], 0
    for i in test_idx:
        gt = info[gates.generation_key(ds, i)]
        color = _jax_rgb(ds[i])
        out = detect(variables, jnp.asarray(color[None].astype(np.float32) / 255.0))
        annos[str(i)] = [JaxGTObject("hand", np.asarray(gt["hand_box"], float))]
        valid = np.asarray(out["valid"])[0]
        boxes = np.asarray(out["boxes"])[0]
        scores = np.asarray(out["scores"])[0]
        if valid.any():
            found += 1
            best = int(np.argmax(np.where(valid, scores, -1)))
            ious.append(float(np.asarray(jax_box_iou(
                jnp.asarray(boxes[best][None]),
                jnp.asarray(np.asarray(gt["hand_box"], float)[None])))[0, 0]))
            for k in np.nonzero(valid)[0]:
                dets.append(JaxDetection(str(i), float(scores[k]), boxes[k]))
    coco = JaxCoco(annos).evaluate(dets, ["hand"] * len(dets))
    return found, ious, {
        "found_rate": round(found / len(test_idx), 4),
        "mean_iou": round(float(np.mean(ious)) if ious else 0.0, 4),
        "AP": round(coco["AP"], 4), "AP50": round(coco["AP50"], 4),
        "AP75": round(coco["AP75"], 4)}


def test_held_out_eval_matches_jax(tree, detector_vars):
    """``eval_system`` at score threshold 0 (random weights clear no other)
    and ``held_out_eval`` against JAX's detect, ``box_iou`` and COCO
    evaluator on the same held-out frames; the record's keys, order and
    rounding are the JAX tool's."""
    info, ds, _, test_idx = tree
    system = resolution_study.eval_system(_fcfg(pconfig), fcos_state_dict_from_flax(
        detector_vars), False, 0.0, "cpu")
    tally = resolution_study.held_out_eval(system, ds, test_idx, info, "cpu")
    got = resolution_study.record(tally, "64x96@nc4", {"seconds": 12.3456, "last_loss": 0.123456})

    jsys = JaxFCOSSystem(_fcfg(jconfig, score_thresh=0.0))
    frame = jnp.zeros((1, 480, 640, 3), jnp.float32)
    detect = fast_compile(jsys.detect, detector_vars, frame)
    found, ious, want = _jax_held_out(detect, detector_vars, ds, test_idx, info)

    assert tally.found == found == len(test_idx)
    np.testing.assert_allclose(tally.ious, ious, rtol=0, atol=EVAL_TOL)
    # every best box overlaps its hand; no box of random heads fits one, so
    # AP is 0 on both sides (test_torch_port_learning_gates.py holds the
    # tally's AP against JAX's on seeded detections with 0 < AP50 < 1)
    assert min(ious) > 0.0, ious
    assert list(got) == ["resolution", "train_seconds", "final_loss", "found_rate",
                         "mean_iou", "AP", "AP50", "AP75"]
    assert (got["resolution"], got["train_seconds"], got["final_loss"]) == (
        "64x96@nc4", 12.3, 0.1235)
    for key, value in want.items():
        assert abs(got[key] - value) <= EVAL_TOL, (key, got[key], value)


def _assert_amaxes_match(got: dict, want: dict, rtol: float = AMAX_RTOL) -> None:
    """By JAX path: all within ``rtol``, at least ``AMAX_EXACT_SHARE``
    within 1e-5."""
    assert sorted(got) == sorted(want) and all(v > 0 for v in want.values())
    names = sorted(got)
    g, w = np.array([got[n] for n in names]), np.array([want[n] for n in names])
    assert_close(g, w, rtol=rtol, atol=0)
    assert (np.abs(g - w) <= 1e-5 * np.abs(w)).mean() >= AMAX_EXACT_SHARE


def test_static_detector_calibration_matches_jax(tree, detector_vars):
    """``@qs``: the detector alone calibrated on the first 16 training
    frames (13 here), with no margin, against ``resolution_study.py:95-106``
    (``module.apply(..., mutable=["quant_stats"])``)."""
    _, ds, train_idx, _ = tree
    system = resolution_study.eval_system(_fcfg(pconfig), fcos_state_dict_from_flax(
        detector_vars), "static", gates.SCORE_THRESH, "cpu")
    frames = np.stack([gates.read_rgb(ds[i]) for i in train_idx[:16]])
    resolution_study.calibrate_detector(system, gates.frames_01(frames, "cpu"))
    got = {flax_calibration_key(f"detector.{name}"): float(buf)
           for name, buf in system.named_buffers() if name.endswith("act_amax")}

    fcfg = _fcfg(jconfig)
    jsys = JaxFCOSSystem(dataclasses.replace(fcfg, score_thresh=0.5, quant="static"))
    cal = np.stack([_jax_rgb(ds[i]).astype(np.float32) / 255.0 for i in train_idx[:16]])
    net_in, _ = jax_preprocess(jnp.asarray(cal), fcfg)
    _, upd = jax.jit(lambda v, x: jsys.module.apply(v, x, train=False, mutable=[
        "quant_stats"]))(detector_vars, net_in)
    want = {f"detector/{path}": float(np.asarray(leaf))
            for path, leaf in jquant._walk_quant_stats(dict(upd))}
    assert len(want) == 49
    _assert_amaxes_match(got, want)


# --- the saturation study against JAX ---


def _jax_load_frames(ds, idx, info):
    """``int8_saturation_study.py:55-74``."""
    colors, depths, paras, joints = [], [], [], []
    for i in idx:
        gt = info[gates.generation_key(ds, i)]
        sample = ds[i]
        colors.append(cv2.imread(sample["color_file"])[:, :, ::-1].astype(np.float32) / 255.0)
        depths.append(cv2.imread(sample["depth_file"], cv2.IMREAD_ANYDEPTH)
                      .astype(np.float32) / 1000.0)
        paras.append(gt["paras"])
        joints.append(gt["joints_3d"] * 1000.0)
    return np.stack(colors), np.stack(depths), np.stack(paras), np.stack(joints)


def test_load_frames_match_jax(tree):
    info, ds, train_idx, test_idx = tree
    idx = train_idx[:2] + test_idx
    got = int8_saturation_study.load_frames(ds, idx, info)
    want = _jax_load_frames(ds, idx, info)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
    assert got[0].shape == (5, 480, 640, 3) and got[3].shape == (5, 21, 3)


@pytest.fixture(scope="module")
def saturation(tree, detector_vars, a2j_vars):
    """The port's static-int8 float32 pipeline on the converted weights,
    its raw calibration on 3 training frames and the held-out frames."""
    info, ds, train_idx, test_idx = tree
    _, pipe_q = int8_saturation_study.pipelines(
        _fcfg(pconfig), _acfg(pconfig), CROP, fcos_state_dict_from_flax(detector_vars),
        a2j_state_dict_from_flax(a2j_vars), "cpu", dtype=torch.float32)
    cal = int8_saturation_study.load_frames(ds, train_idx[:3], info)
    held = int8_saturation_study.load_frames(ds, test_idx, info)
    raw = int8_saturation_study.calibrate_raw(pipe_q, cal[0], cal[1])
    return pipe_q, raw, cal, held


def _named(snapshot: dict) -> dict:
    return {flax_calibration_key(f"{name}.act_amax"): float(v) for name, v in snapshot.items()}


def test_saturation_calibration_and_overflow_match_jax(saturation, detector_vars, a2j_vars):
    """The raw calibration, every margin's amaxes and the overflow factor on
    frames twice as bright against JAX's functional ``calibrate`` and
    ``apply_margin`` (``int8_saturation_study.py:93-106, 181-203``). At
    score threshold 0.5 the random detector finds no hand, so A2J
    calibrates on the fallback crops on both sides."""
    pipe_q, raw, cal, held = saturation
    cfg = jconfig.HandNetConfig(
        fcos=_fcfg(jconfig, score_thresh=0.5, quant="static"),
        a2j=_acfg(jconfig, quant="static"),
        pipeline=jconfig.PipelineConfig(crop_size=CROP, pad_percent=0.4))
    jpipe = JaxPipeline(cfg, dtype=jnp.float32)
    variables = {"detector": detector_vars, "a2j": a2j_vars}
    raw_cal = jpipe.calibrate(variables, jnp.asarray(cal[0]), jnp.asarray(cal[1]), margin=0.0)
    want_raw = {p: float(np.asarray(v)) for p, v in jquant._walk_quant_stats(raw_cal)}
    assert len(want_raw) == 113
    _assert_amaxes_match(_named(raw), want_raw, PIPELINE_AMAX_RTOL)

    # JAX's apply_margin of the port's raw amaxes, as JAX's tree
    port_raw = {}
    for path, value in _named(raw).items():
        node = port_raw
        for part in path.split("/")[:-1]:
            node = node.setdefault(part, {})
        node["act_amax"] = jnp.float32(value)
    for m in MARGINS:
        int8_saturation_study.set_margin(pipe_q, raw, m)
        snap = int8_saturation_study.amax_snapshot(pipe_q)
        for name, value in snap.items():
            assert torch.equal(value, raw[name] * torch.tensor(1.0 + m, dtype=torch.float32))
        widened = {p: float(np.asarray(v))
                   for p, v in jquant._walk_quant_stats(jquant.apply_margin(port_raw, m))}
        assert _named(snap) == widened
        want = {p: float(np.asarray(v))
                for p, v in jquant._walk_quant_stats(jquant.apply_margin(raw_cal, m))}
        _assert_amaxes_match(_named(snap), want, PIPELINE_AMAX_RTOL)

    hot = held[0] * HOT_GAIN
    before = int8_saturation_study.amax_snapshot(pipe_q)
    got, layer = int8_saturation_study.overflow_factor(pipe_q, raw, hot, held[1])
    after = int8_saturation_study.amax_snapshot(pipe_q)
    assert all(torch.equal(before[k], after[k]) for k in before)
    # _overflow_factor's lines on the trained (uncalibrated) variables
    shifted = jpipe.calibrate(variables, jnp.asarray(hot), jnp.asarray(held[1]), margin=0.0)
    worst = 0.0
    for path, leaf in jquant._walk_quant_stats(shifted):
        denom = want_raw[path]
        if denom > 0:
            worst = max(worst, float(np.asarray(leaf)) / denom)
    ratios = {p: float(np.asarray(v)) / want_raw[p] for p, v in jquant._walk_quant_stats(shifted)}
    assert flax_calibration_key(f"{layer}.act_amax") == max(ratios, key=ratios.get)
    assert worst > 1.2 and got > 1.2
    assert abs(got - worst) <= OVERFLOW_RTOL * worst, (got, worst)


def test_repeated_calibrations_do_not_compound(saturation):
    """In place, a second ``calibrate`` folds into the first (the trap the
    study avoids); ``calibrate_raw`` after other calibrations gives the raw
    amaxes of one, bit for bit; margins set one after another never
    compound; the overflow factor of the calibration frames themselves is 1."""
    pipe_q, raw, cal, held = saturation
    hot = held[0] * HOT_GAIN
    int8_saturation_study.restore_amaxes(pipe_q, raw)
    pipe_q.calibrate(torch.from_numpy(hot), torch.from_numpy(held[1]), margin=0.0)
    folded = int8_saturation_study.amax_snapshot(pipe_q)
    assert all(bool((folded[k] >= raw[k]).all()) for k in raw)
    assert any(not torch.equal(folded[k], raw[k]) for k in raw)

    again = int8_saturation_study.calibrate_raw(pipe_q, cal[0], cal[1])
    assert all(torch.equal(again[k], raw[k]) for k in raw)
    for m in (0.25, 0.1, 0.1, 0.0):
        int8_saturation_study.set_margin(pipe_q, raw, m)
    assert all(torch.equal(v, raw[k]) for k, v in
               int8_saturation_study.amax_snapshot(pipe_q).items())
    assert int8_saturation_study.overflow_factor(pipe_q, raw, cal[0], cal[1])[0] == 1.0


def _jax_paired(per_frame, gains, margins):
    """``int8_saturation_study.py:216-233``."""
    out = []
    for g in gains:
        for i_m, m_a in enumerate(margins):
            for m_b in margins[i_m + 1:]:
                a, b = per_frame[(g, m_a)], per_frame[(g, m_b)]
                both = ~np.isnan(a) & ~np.isnan(b)
                d = (b - a)[both]
                out.append({"paired": f"margin {m_b} vs {m_a}", "gain": g,
                            "n_frames": int(both.sum()),
                            "delta_mpjpe_mean_mm": round(float(d.mean()), 4)
                            if d.size else None,
                            "delta_mpjpe_sem_mm": round(
                                float(d.std(ddof=1) / np.sqrt(d.size)), 4)
                            if d.size > 1 else None})
    return out


def test_paired_analysis_matches_jax():
    """Seeded per-frame MPJPEs with NaNs (frames not found), including a
    pair with one frame in common and one with none."""
    rng = np.random.default_rng(20)
    gains, margins = [1.0, 1.3, 2.0], [0.0, 0.1, 0.25]
    per_frame = {}
    for g in gains:
        for m in margins:
            v = rng.normal(30.0, 5.0, 24)
            v[rng.uniform(size=24) < 0.2 * g] = np.nan
            per_frame[(g, m)] = v
    per_frame[(2.0, 0.1)][:] = np.nan
    per_frame[(2.0, 0.1)][3] = 31.0
    per_frame[(2.0, 0.0)][3] = 29.5
    per_frame[(2.0, 0.25)][:] = np.nan
    got = int8_saturation_study.paired_rows(per_frame, gains, margins)
    want = _jax_paired(per_frame, gains, margins)
    assert [{k: r[k] for k in ("paired", "gain", "n_frames")} for r in got] == \
        [{k: r[k] for k in ("paired", "gain", "n_frames")} for r in want]
    assert any(r["delta_mpjpe_sem_mm"] is None and r["n_frames"] == 1 for r in got)
    assert any(r["delta_mpjpe_mean_mm"] is None for r in got)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in ("delta_mpjpe_mean_mm", "delta_mpjpe_sem_mm"):
            assert (g[key] is None) == (w[key] is None)
            if w[key] is not None:
                assert abs(g[key] - w[key]) <= PAIRED_TOL


def test_table_matches_jax():
    """The summary table, ``int8_saturation_study.py:235-244``."""
    gains, margins = [1.0, 2.0], [0.0, 0.25]
    rows = [{"gain": g, "margin": m, "overflow_factor": round(0.9 + g * (1 + m), 3),
             "int8_found": round(1.0 - g * m / 4, 3), "delta_mpjpe_mm": round(g - 3 * m, 2)}
            for g in gains for m in margins]
    want = ["\ngain  overflow | " + " | ".join(f"m={m:<4}: dMPJPE found" for m in margins)]
    for g in gains:
        cells = []
        for m in margins:
            r = next(r for r in rows if r["gain"] == g and r["margin"] == m)
            cells.append(f"m={m:<4}: {r['delta_mpjpe_mm']:+6.2f} "
                         f"{r['int8_found']:.2f}")
        o = next(r for r in rows if r["gain"] == g)["overflow_factor"]
        want.append(f"{g:4}  {o:8.2f} | " + " | ".join(cells))
    assert int8_saturation_study.table(rows, gains, margins) == want


# --- both tools end to end on the CPU ---


def _json_lines(out: str, first_key: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith('{"' + first_key)]


def test_resolution_main_smoke(capsys):
    """One ``@nc2@qs`` spec at 64x96 (2 steps of batch 2): trained,
    calibrated, evaluated; its JSON line and the closing study line."""
    report = {}
    code = resolution_study.main(["--sequences", "4", "--frames", "2", "--steps", "2",
                                  "--batch", "2", "--resolutions", "64x96@nc2@qs",
                                  "--difficulty", "hard", "--device", "cpu"], report)
    out = capsys.readouterr().out
    assert code == 0 and "8 frames (7 train / 1 held out)" in out
    (rec,) = _json_lines(out, "resolution")
    assert rec["resolution"] == "64x96@nc2@qs" and rec["difficulty"] == "hard"
    assert list(rec) == ["resolution", "train_seconds", "final_loss", "found_rate",
                         "mean_iou", "AP", "AP50", "AP75", "difficulty"]
    assert _json_lines(out, "study") == [{"study": [rec]}]
    entry = report["64x96@nc2@qs"]
    assert entry["stats"]["steps"] == 2 and np.isfinite(rec["final_loss"])
    assert entry["system"].cfg.num_convs == 2 and entry["system"].cfg.score_thresh == 0.5
    assert all(float(b) > 0 for n, b in entry["system"].named_buffers()
               if n.endswith("act_amax"))


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """A pack from the port's ``synthetic_e2e_validation`` smoke run."""
    path = str(tmp_path_factory.mktemp("pack") / "states.msgpack")
    synthetic_e2e_validation.main(E2E_PACK + ["--save-state", path])
    return path


def test_saturation_main_smoke(pack, capsys):
    """On the pack (its ``synth`` sets the crop to 32), an eval tree of 10
    sequences (3 held-out frames), 2 gains x 2 margins: the rows, the
    paired lines and the table; the int8 pipeline left at the last margin
    of the raw calibration."""
    report = {}
    code = int8_saturation_study.main(["--state", pack, "--gains", "1.0,2.0",
                                       "--margins", "0,0.25", "--eval-sequences", "10",
                                       "--device", "cpu"], report)
    out = capsys.readouterr().out
    assert code == 0
    assert "3 held-out frames; calibrated on 13 train frames" in out
    rows = _json_lines(out, "gain")
    assert [(r["gain"], r["margin"]) for r in rows] == [(1.0, 0.0), (1.0, 0.25), (2.0, 0.0),
                                                        (2.0, 0.25)]
    assert list(rows[0]) == ["gain", "margin", "overflow_factor", "fp_found", "int8_found",
                             "fp_mpjpe_mm", "int8_mpjpe_mm", "delta_mpjpe_mm"]
    assert rows[2]["overflow_factor"] > rows[0]["overflow_factor"]
    assert len(_json_lines(out, "paired")) == 2
    assert "gain  overflow | m=0.0 : dMPJPE found | m=0.25: dMPJPE found" in out
    pipe_q = report["pipeline_int8"]
    assert pipe_q.cfg.pipeline.crop_size == 32 and pipe_q.cfg.fcos.quant == "static"
    for name, value in int8_saturation_study.amax_snapshot(pipe_q).items():
        assert torch.equal(value, report["raw"][name] * torch.tensor(1.25))
    assert report["frames"][0].shape == (3, 480, 640, 3)
    assert set(report["overflow_layer"]) == {1.0, 2.0}


@pytest.mark.parametrize("tool", [resolution_study, int8_saturation_study])
def test_tools_default_to_the_card(tool, monkeypatch):
    """Without ``--device`` a tool runs on the card, and raises where there
    is none before it makes a tree or trains."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    monkeypatch.setattr(tool, "make_synthetic_dexycb", lambda *a, **k: made.append(a))
    monkeypatch.setattr(synthetic_e2e_validation, "make_synthetic_dexycb",
                        lambda *a, **k: made.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
    assert not made
