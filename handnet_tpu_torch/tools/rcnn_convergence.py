"""Faster R-CNN training-path convergence on the synthetic detect task, on
the card.

The port's ``tools/rcnn_convergence.py``: trains the RPN and RoI heads from
scratch (``RCNNTrainer``, 64 proposals per image, batch-norm backbone,
AdamW, bf16) on the planted-hand task that ``synthetic_e2e_validation``'s
detector learns, and reports the held-out found rate, the best box's IoU
against the planted box and COCO AP, AP50 and AP75
(``eval/coco_det.CocoDetEvaluator``). ``--with-fcos`` also trains an FCOS
control at the same geometry and step budget, so the two detector families
compare on the same data. The R-CNN with a batch-norm backbone launches
none of the port's kernels (cuDNN, cuBLAS and the port's plain RoIAlign
and NMS); the FCOS control runs K2s/K2a forward and K2r/K2d backward.

Prints each net's training clock (seconds, steps/s, loader-wait share), one
JSON line per net and ``RCNN CONVERGENCE: PASS|FAIL`` (found rate >= 0.8 and
AP50 >= 0.5 for the R-CNN); exits 0 on PASS, 1 on FAIL. ``RCNN_SMOKE=1``
shrinks the run to a mechanics check (4 sequences x 2 frames, 2 steps of
batch 2 at 128x160), which passes on finishing, on the device asked for.
The card by default (``RuntimeError`` where there is none); ``--device
cpu`` runs on the CPU:

    python -m handnet_tpu_torch.tools.rcnn_convergence [--steps 600] [--with-fcos] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
from typing import Optional

import torch

from handnet_tpu_torch.config import FCOSConfig, TrainConfig
from handnet_tpu_torch.data.detect_data import DetectDataSource
from handnet_tpu_torch.data.dexycb import DexYCBDataset
from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb
from handnet_tpu_torch.models.faster_rcnn import decode_rcnn_detections
from handnet_tpu_torch.models.fcos import FCOSSystem
from handnet_tpu_torch.tools import gates
from handnet_tpu_torch.train.trainer import FCOSTrainer, RCNNTrainer, resolve_device

NUM_PROPOSALS = 64
SMOKE = {"sequences": 4, "frames": 2, "steps": 2, "batch": 2, "image_h": 128, "image_w": 160}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequences", type=int, default=24)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image-h", type=int, default=256)
    ap.add_argument("--image-w", type=int, default=352)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--with-fcos", action="store_true",
                    help="also train the FCOS control at the same geometry and step budget")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def train(net: str, ds, train_idx, cfg: FCOSConfig, steps: int, batch: int, lr: float,
          device):
    """Train either detector on the synthetic task; both take the same
    targets and the same preprocess. Returns ``(trainer, state, stats)``."""
    tcfg = TrainConfig(bf16=True, lr=lr, optimizer="adamw")
    if net == "rcnn":
        trainer = RCNNTrainer(cfg, tcfg, steps_per_epoch=100, milestones_epochs=(100,),
                              backbone_norm="batch", num_proposals=NUM_PROPOSALS,
                              device=device)
    else:
        trainer = FCOSTrainer(cfg, tcfg, steps_per_epoch=100, milestones_epochs=(100,),
                              backbone_norm="batch", device=device)
    state = trainer.init_state(0)
    src = DetectDataSource(ds, train_idx, e2e=False, uint8_images=True)
    state, stats = gates.train_detector(trainer, state, src, steps, batch, net)
    return trainer, state, stats


def detector(net: str, cfg: FCOSConfig, trainer, state):
    """0-1 RGB frames -> padded detections in frame pixels at the 0.5 score
    threshold. The R-CNN: its trained module in eval mode (running
    statistics, its convolutions under the trainer's bf16 autocast),
    ``decode_rcnn_detections`` clipped to the network input, boxes divided
    by the resize scale. FCOS: a float32 ``FCOSSystem`` holding the trained
    state."""
    if net == "rcnn":
        model = state.model.eval()
        scale = min(cfg.image_h / gates.FRAME_H, cfg.image_w / gates.FRAME_W)

        @torch.no_grad()
        def detect(images):
            net_in, _ = model.preprocess(images)
            with torch.autocast(trainer.device.type, dtype=torch.bfloat16,
                                enabled=trainer.train_cfg.bf16):
                out = model(net_in)
            det = decode_rcnn_detections(out, cfg.num_classes, score_thresh=gates.SCORE_THRESH,
                                         image_hw=(cfg.image_h, cfg.image_w))
            return {**det, "boxes": det["boxes"] / scale}
        return detect
    system = FCOSSystem(dataclasses.replace(cfg, score_thresh=gates.SCORE_THRESH))
    system.load_state_dict(state.model.state_dict())
    system.to(trainer.device, memory_format=torch.channels_last).eval()
    return torch.no_grad()(system.detect)


def evaluate(net: str, ds, test_idx, info, cfg: FCOSConfig, trainer, state) -> dict:
    """Held-out found rate, best-box IoU against the planted box and COCO
    AP (``gates.DetectionTally``)."""
    detect = detector(net, cfg, trainer, state)
    tally = gates.DetectionTally()
    for i in test_idx:
        gt = info[gates.generation_key(ds, i)]
        out = detect(gates.frames_01(gates.read_rgb(ds[i]), trainer.device))
        tally.add(str(i), gt["hand_box"], out["valid"][0].cpu().numpy(),
                  out["boxes"][0].float().cpu().numpy(), out["scores"][0].float().cpu().numpy())
    return tally.summary(net)


def main(argv=None, report: Optional[dict] = None) -> int:
    """Train and evaluate each net; 0 on PASS, 1 on FAIL. ``report``, if
    given, receives per net its JSON record, its training ``stats`` and its
    trainer and state (``nets``), and ``ok``."""
    args = parse_args(argv)
    device = resolve_device("rcnn_convergence", args.device)
    smoke = bool(os.environ.get("RCNN_SMOKE"))
    if smoke:
        for key, value in SMOKE.items():
            setattr(args, key, value)
    report = {} if report is None else report
    report["nets"] = {}
    root = tempfile.mkdtemp(prefix="rcnn_conv_")
    try:
        info = make_synthetic_dexycb(root, n_sequences=args.sequences, n_frames=args.frames)
        ds = DexYCBDataset("s0", "train", data_dir=root)
        train_idx, test_idx = gates.split_indices(len(ds))
        print(f"{len(ds)} synthetic frames ({len(train_idx)} train, {len(test_idx)} held out)",
              flush=True)
        cfg = FCOSConfig(num_classes=2, ext=False, image_h=args.image_h,
                         image_w=args.image_w, max_detections=8)
        results = []
        for net in (["rcnn", "fcos"] if args.with_fcos else ["rcnn"]):
            trainer, state, stats = train(net, ds, train_idx, cfg, args.steps, args.batch,
                                          args.lr, device)
            rec = evaluate(net, ds, test_idx, info, cfg, trainer, state)
            rec["final_loss"] = round(stats["last_loss"], 4)
            results.append(rec)
            report["nets"][net] = {"record": rec, "stats": stats, "trainer": trainer,
                                   "state": state}
            print(json.dumps(rec), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    rcnn = results[0]
    # the detector learned: it finds the planted hand in most held-out
    # frames, with localized boxes (a nontrivial AP50)
    ok = gates.rcnn_passes(rcnn["found_rate"], rcnn["AP50"], smoke)
    print("RCNN CONVERGENCE:", "PASS" if ok else "FAIL", flush=True)
    report["ok"] = ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
