"""Detector accuracy against input resolution, on the card.

The port's ``tools/resolution_study.py``. The ``fast`` operating point runs
the detector at 512x640 for 480x640 frames; the reference's transform
upsamples the short side to 800 (``parity``, 800x1088), which adds FLOPs
but no sensor information. The study prices it: the same detector
(``FCOSTrainer``, 2 classes, batch-norm backbone, AdamW 5e-4, bf16) is
trained per spec on the same synthetic detection task and compared on the
held-out frames through ``FCOSSystem.detect`` at a 0.5 score threshold:
found rate, the best box's IoU against the planted box, COCO AP, AP50 and
AP75.

A spec is ``HxW`` with optional suffixes: ``@ncN`` (towers of N convs,
default 4; ``480x640@nc2`` is ``turbo``), ``@q`` (the held-out eval
through the dynamic-int8 serving path: ``quant``) and ``@qs`` (static int8,
its activation scales calibrated on 16 training frames, with no margin:
``quant_static``). Training is always in float. The GroupNorm towers run
K2s/K2a forward and K2r/K2d backward; the int8 evals run K3q/K3g too.

Prints one JSON line per spec and ``{"study": [...]}`` at the end. The
card by default (``RuntimeError`` where there is none); ``--device cpu``
runs on the CPU:

    python -m handnet_tpu_torch.tools.resolution_study [--steps 500] \\
        [--resolutions 512x640 800x1088 480x640@qs] [--difficulty hard] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import tempfile
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from handnet_tpu_torch.config import FCOSConfig, TrainConfig
from handnet_tpu_torch.data.detect_data import DetectDataSource
from handnet_tpu_torch.data.dexycb import DexYCBDataset
from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb
from handnet_tpu_torch.models.fcos import FCOSSystem
from handnet_tpu_torch.nn.quant import assert_calibrated, set_calibrating
from handnet_tpu_torch.tools import gates
from handnet_tpu_torch.train.trainer import FCOSTrainer, resolve_device

CALIBRATION_FRAMES = 16   # the first training frames, one calibration batch


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--sequences", type=int, default=24)
    parser.add_argument("--frames", type=int, default=6)
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--difficulty", default="easy", choices=["easy", "hard"],
                        help="'hard' plants 28-48px hands and hand-coloured clutter "
                             "(data/synthetic.py), so the found rate is not saturated at 1.0")
    parser.add_argument("--resolutions", nargs="+", default=["512x640", "800x1088"],
                        help="HxW with optional @-suffixes: @ncN (tower num_convs, default 4), "
                             "@q (eval through the dynamic-int8 serving path) and @qs "
                             "(calibrated static int8), e.g. 480x640@nc2 (turbo), 480x640@q "
                             "(quant), 480x640@qs (quant_static)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs on the CPU)")
    return parser.parse_args(argv)


def parse_spec(spec: str) -> Tuple[int, int, int, Union[bool, str]]:
    """``HxW[@ncN][@q|@qs]`` -> ``(h, w, num_convs, quant)``, quant False,
    True (dynamic int8) or "static". An unknown suffix raises
    ``ValueError``."""
    parts = spec.split("@")
    nc, quant = 4, False
    for tok in parts[1:]:
        if tok.startswith("nc"):
            nc = int(tok[2:])
        elif tok == "q":
            quant = True
        elif tok == "qs":
            quant = "static"
        else:
            raise ValueError(f"unknown spec suffix @{tok} in {spec!r}")
    h, w = (int(x) for x in parts[0].split("x"))
    return h, w, nc, quant


def spec_name(h: int, w: int, num_convs: int, quant: Union[bool, str]) -> str:
    """The record's ``resolution``: ``{h}x{w}@nc{n}`` with ``@qs`` or ``@q``."""
    return (f"{h}x{w}@nc{num_convs}"
            + ("@qs" if quant == "static" else "@q" if quant else ""))


def detector_config(h: int, w: int, num_convs: int) -> FCOSConfig:
    return FCOSConfig(num_classes=2, ext=False, image_h=h, image_w=w, max_detections=8,
                      num_convs=num_convs)


def eval_system(fcfg: FCOSConfig, state_dict: Dict[str, torch.Tensor],
                quant: Union[bool, str], score_thresh: float, device) -> FCOSSystem:
    """The serving detector at ``score_thresh`` and ``quant`` holding a
    trained state: the trained batch norms' weights and running statistics
    load into its frozen norms by name. Any key that does not match raises
    ``KeyError`` (a static layer's ``act_amax`` stays to be calibrated)."""
    system = FCOSSystem(dataclasses.replace(fcfg, score_thresh=score_thresh, quant=quant))
    missing, unexpected = system.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith("act_amax")]
    if missing or unexpected:
        raise KeyError(f"eval_system: missing {missing[:3]}, unexpected {unexpected[:3]}")
    return system.to(device, memory_format=torch.channels_last).eval()


@torch.no_grad()
def calibrate_detector(system: FCOSSystem, frames: torch.Tensor) -> None:
    """Static int8: the detector alone folds the amax of each static
    layer's input on one batch of 0-1 ``frames`` into its ``act_amax``,
    with no margin, then ``assert_calibrated``."""
    try:
        set_calibrating(system, True)
        system(system.preprocess(frames)[0])
    finally:
        set_calibrating(system, False)
    assert_calibrated(system)


@torch.inference_mode()
def held_out_eval(system: FCOSSystem, ds, test_idx, info, device) -> gates.DetectionTally:
    """One ``detect`` per held-out frame at B=1: found when any detection
    is valid, the IoU of the best-scoring valid box, every valid detection
    into the COCO evaluator."""
    tally = gates.DetectionTally()
    for i in test_idx:
        gt = info[gates.generation_key(ds, i)]
        out = system.detect(gates.frames_01(gates.read_rgb(ds[i]), device))
        tally.add(str(i), gt["hand_box"], out["valid"][0].cpu().numpy(),
                  out["boxes"][0].cpu().numpy(), out["scores"][0].cpu().numpy())
    return tally


def record(tally: gates.DetectionTally, resolution: str, stats: dict) -> dict:
    """The JSON record of one spec (``resolution_study.py:135-146``)."""
    summary = tally.summary("")
    return {"resolution": resolution,
            "train_seconds": round(stats["seconds"], 1),
            "final_loss": round(stats["last_loss"], 4),
            **{k: summary[k] for k in ("found_rate", "mean_iou", "AP", "AP50", "AP75")}}


def train_and_eval(ds, train_idx, test_idx, info, spec: str, steps: int, batch: int,
                   device, report: Optional[dict] = None) -> dict:
    """Train the detector of ``spec`` from scratch, then evaluate it on the
    held-out frames (through the int8 path for ``@q``/``@qs``). ``report``,
    if given, receives the trained state and the serving detector."""
    h, w, nc, quant = parse_spec(spec)
    fcfg = detector_config(h, w, nc)
    trainer = FCOSTrainer(fcfg, TrainConfig(bf16=True, lr=5e-4, optimizer="adamw"),
                          steps_per_epoch=100, milestones_epochs=(100,),
                          backbone_norm="batch", device=device)
    state = trainer.init_state(0)
    source = DetectDataSource(ds, train_idx, e2e=False, uint8_images=True)
    state, stats = gates.train_detector(trainer, state, source, steps, batch, f"{h}x{w}")

    system = eval_system(fcfg, state.model.state_dict(), quant, gates.SCORE_THRESH, device)
    if quant == "static":
        # the held-out frames are never seen by calibration
        frames = np.stack([gates.read_rgb(ds[i]) for i in train_idx[:CALIBRATION_FRAMES]])
        calibrate_detector(system, gates.frames_01(frames, device))
    tally = held_out_eval(system, ds, test_idx, info, device)
    if report is not None:
        report[spec] = {"state": state, "stats": stats, "system": system}
    return record(tally, spec_name(h, w, nc, quant), stats)


def main(argv=None, report: Optional[dict] = None) -> int:
    """One record per spec. ``report``, if given, receives the records
    (``study``), the number of held-out frames (``held_out``) and, by spec,
    each trained state, its training stats and its serving detector."""
    args = parse_args(argv)
    device = resolve_device("resolution_study", args.device)
    specs = [(spec, parse_spec(spec)) for spec in args.resolutions]   # refuses early
    report = {} if report is None else report
    root = tempfile.mkdtemp(prefix="res_study_")
    try:
        info = make_synthetic_dexycb(root, n_sequences=args.sequences, n_frames=args.frames,
                                     difficulty=args.difficulty)
        ds = DexYCBDataset("s0", "train", data_dir=root)
        train_idx, test_idx = gates.split_indices(len(ds))
        print(f"{len(ds)} frames ({len(train_idx)} train / {len(test_idx)} held out)",
              flush=True)
        report["held_out"] = len(test_idx)
        results = []
        for spec, _ in specs:
            results.append(train_and_eval(ds, train_idx, test_idx, info, spec, args.steps,
                                          args.batch, device, report))
            results[-1]["difficulty"] = args.difficulty
            print(json.dumps(results[-1]), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"study": results}), flush=True)
    report["study"] = results
    return 0


if __name__ == "__main__":
    sys.exit(main())
