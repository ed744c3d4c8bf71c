"""End-to-end learning validation on synthetic data, on the card.

The port's ``tools/synthetic_e2e_validation.py``: trains both stages from
scratch on the synthetic DexYCB tree, assembles the serving pipeline from
the trained models and checks on the held-out frames that

  1. the detector finds the planted hand (IoU against the planted box,
     padded as the pipeline pads its crop box),
  2. the A2J stage regresses the planted joints (MPJPE in mm, on its own
     crops of the held-out frames),
  3. the pipeline's detect -> crop -> pose handoff keeps that accuracy, in
     float and through the int8 serving path (``--quant-eval``, static by
     default and then part of the PASS rule).

Stage 1 is ``FCOSTrainer`` (2 classes, batch-norm backbone, AdamW 5e-4,
bf16), fed by ``DetectDataSource`` through ``PrefetchLoader``'s 4 threads;
its GroupNorms run kernels K2s/K2a forward and K2r/K2d backward. Stage 2 is
``A2JTrainer`` (AdamW 3.5e-4, bf16) on shift- and scale-augmented crops; its
eval step decodes through K1. The pipeline (bf16) runs K2s/K2a and K1, and
its int8 copy K3q/K3g too; the static copy is calibrated on the first 16
training frames and checked by ``assert_calibrated`` before it serves.

Prints each stage's loss, seconds, steps/s and loader-wait share, the
A2J-only MPJPE, the held-out found count, IoU and MPJPE (float and int8) and
``VALIDATION: PASS|FAIL``; exits 0 on PASS, 1 on FAIL. The card by default
(``RuntimeError`` where there is none); ``--device cpu`` runs on the CPU:

    python -m handnet_tpu_torch.tools.synthetic_e2e_validation \\
        [--fcos-steps 900 --a2j-steps 3000] [--quant-eval static|dynamic|none] \\
        [--save-state PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from handnet_tpu_torch.apps import train_a2j
from handnet_tpu_torch.config import A2JConfig, FCOSConfig, TrainConfig
from handnet_tpu_torch.data.a2j_data import A2JDataSource, A2JSampleConfig
from handnet_tpu_torch.data.detect_data import DetectDataSource
from handnet_tpu_torch.data.dexycb import DexYCBDataset
from handnet_tpu_torch.data.loader import PrefetchLoader
from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb
from handnet_tpu_torch.nn.quant import assert_calibrated
from handnet_tpu_torch.ops.geometry import convert_joints
from handnet_tpu_torch.tools import gates
from handnet_tpu_torch.train.trainer import A2JTrainer, FCOSTrainer, resolve_device
from handnet_tpu_torch.utils import statepack

CALIBRATION_FRAMES = 16   # the first training frames, one calibration batch
SHOWN_FRAMES = 8          # held-out frames whose crop box is printed


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--sequences", type=int, default=24)
    parser.add_argument("--frames", type=int, default=6)
    parser.add_argument("--fcos-steps", type=int, default=900)
    parser.add_argument("--a2j-steps", type=int, default=3000)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--image-h", type=int, default=256)
    parser.add_argument("--image-w", type=int, default=352)
    parser.add_argument("--crop", type=int, default=96)
    parser.add_argument("--quant-eval", nargs="?", const="dynamic", default="static",
                        choices=["dynamic", "static", "none"],
                        help="evaluate the trained stages through the int8 serving path too "
                             "(nn/quant.py): 'static' (the default, part of the PASS rule) = "
                             "per-layer scales calibrated on training frames; 'dynamic' = "
                             "per-sample scales; 'none' = float only")
    parser.add_argument("--save-state", default=None, metavar="PATH",
                        help="write the trained fcos/a2j states and their configs "
                             "(utils/statepack.py, flax msgpack)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs on the CPU)")
    return parser.parse_args(argv)


def train_stages(args, ds, train_idx, device):
    """Stage 1 (FCOS) then stage 2 (A2J) from scratch. Returns
    ``(fcfg, ftrainer, fstate, fstats, acfg, atrainer, astate, astats)``."""
    fcfg = FCOSConfig(num_classes=2, ext=False, image_h=args.image_h, image_w=args.image_w,
                      max_detections=8)
    ftrainer = FCOSTrainer(fcfg, TrainConfig(bf16=True, lr=5e-4, optimizer="adamw"),
                           steps_per_epoch=100, milestones_epochs=(100,),
                           backbone_norm="batch", device=device)
    fstate = ftrainer.init_state(0)
    # the hand alone, label 1
    det_src = DetectDataSource(ds, train_idx, e2e=False, uint8_images=True)
    fstate, fstats = gates.train_detector(ftrainer, fstate, det_src, args.fcos_steps,
                                          args.batch, "fcos")

    acfg = A2JConfig(crop_h=args.crop, crop_w=args.crop)
    atrainer = A2JTrainer(acfg, TrainConfig(bf16=True, lr=3.5e-4), steps_per_epoch=100,
                          device=device)
    astate = atrainer.init_state(1)
    # shift and scale jitter stand in for detector-box noise (the pipeline
    # crops from detected boxes); no rotation, which would need far more
    # steps; the crop padding is the pipeline's
    a_src = A2JDataSource(ds, train_idx, augment=True, cfg=A2JSampleConfig(
        crop_w=args.crop, crop_h=args.crop, bbox_pad=gates.PAD, rand_rotate=0,
        rand_scale_frac=0.3))
    aloader = PrefetchLoader(a_src, args.batch, shuffle=True, num_workers=gates.WORKERS,
                             device_put=train_a2j.pinned(device))
    astate, astats = gates.train_steps(atrainer, astate, aloader, args.a2j_steps,
                                       lambda b: train_a2j.to_device(b, device), "a2j")
    return fcfg, ftrainer, fstate, fstats, acfg, atrainer, astate, astats


@torch.no_grad()
def a2j_only(args, ds, test_idx, atrainer, astate, pipe_dynamic) -> dict:
    """MPJPE of the trained A2J on its own (segmentation-box) crops of the
    held-out frames, through ``A2JTrainer.eval_step`` (K1) and, with a
    dynamic-int8 pipeline, through its pose stage; and the depth error.
    The static int8 path is calibrated on the pipeline's crops, so it is
    priced at the pipeline level only."""
    device = atrainer.device
    src = A2JDataSource(ds, test_idx, augment=False, cfg=A2JSampleConfig(
        crop_w=args.crop, crop_h=args.crop, bbox_pad=gates.PAD, rand_rotate=0))
    mpjpe, mpjpe_q, depth_err = [], [], []
    for i in range(len(src)):
        sample = src[i]
        s = {k: torch.from_numpy(sample[k][None]).to(device)
             for k in ("depth", "jt_uvd", "box", "paras")}
        pred, _ = atrainer.eval_step(astate, {"image": s["depth"], "jt_uvd": s["jt_uvd"]})
        gt_xyz = convert_joints(s["jt_uvd"], s["box"], s["paras"], args.crop, args.crop)[0]

        def error_mm(p):
            xyz = convert_joints(p, s["box"], s["paras"], args.crop, args.crop)[0]
            return float(torch.linalg.norm(xyz - gt_xyz, dim=1).mean())

        mpjpe.append(error_mm(pred))
        if pipe_dynamic is not None:
            mpjpe_q.append(error_mm(pipe_dynamic.pose(s["depth"])))
        depth_err.append(float((pred[0, :, 2] - s["jt_uvd"][0, :, 2]).abs().mean()) * 1000)
    print(f"a2j-only MPJPE on held-out seg crops: {np.mean(mpjpe):.1f} mm "
          f"(depth |err| {np.mean(depth_err):.1f} mm)", flush=True)
    if mpjpe_q:
        print(f"a2j-only MPJPE through the int8 path: {np.mean(mpjpe_q):.1f} mm "
              f"(delta {np.mean(mpjpe_q) - np.mean(mpjpe):+.2f} mm)", flush=True)
    return {"mpjpe_mm": float(np.mean(mpjpe)), "depth_err_mm": float(np.mean(depth_err)),
            "mpjpe_int8_mm": float(np.mean(mpjpe_q)) if mpjpe_q else None}


def calibrate(pipe_q, ds, train_idx, device) -> None:
    """Static int8: one calibration pass over the first 16 training frames
    (the held-out frames are never seen by it), then ``assert_calibrated``."""
    samples = [ds[i] for i in train_idx[:CALIBRATION_FRAMES]]
    images = gates.frames_01(np.stack([gates.read_rgb(s) for s in samples]), device)
    depth = torch.from_numpy(np.stack([gates.read_depth(s) for s in samples])).to(device)
    pipe_q.calibrate(images, depth)
    assert_calibrated(pipe_q)


def held_out_sweep(ds, test_idx, info, pipe, pipe_q, device) -> dict:
    """Each held-out frame through the float pipeline and, if given, the
    int8 one: found counts, the crop box's IoU against the padded planted
    box, and the MPJPE against the planted joints. Also returns the frames
    read (``frames``: RGB uint8, depth in metres)."""
    found, ious, mpjpes, found_q, mpjpes_q, frames = 0, [], [], 0, [], []
    for i in test_idx:
        gt = info[gates.generation_key(ds, i)]
        sample = ds[i]
        rgb, depth = gates.read_rgb(sample), gates.read_depth(sample)
        frames.append((rgb, depth))
        inputs = (gates.frames_01(rgb, device), torch.from_numpy(depth[None]).to(device),
                  torch.from_numpy(gt["paras"][None]).to(device))
        out = pipe(*inputs)
        if bool(out["found"][0]):
            found += 1
            box = out["boxes"][0].cpu().numpy()
            if found <= SHOWN_FRAMES:
                print(f"  frame {i}: crop_box {np.round(box, 1)} planted "
                      f"{np.round(gt['hand_box'], 1)} score {float(out['scores'][0]):.2f}",
                      flush=True)
            ious.append(gates.iou(box, gates.padded_box(gt["hand_box"])))
            xyz = out["joints_xyz"][0].float().cpu().numpy()
            mpjpes.append(float(np.linalg.norm(xyz - gt["joints_3d"] * 1000.0, axis=1).mean()))
        if pipe_q is not None:
            out_q = pipe_q(*inputs)
            if bool(out_q["found"][0]):
                found_q += 1
                xyz = out_q["joints_xyz"][0].float().cpu().numpy()
                mpjpes_q.append(float(np.linalg.norm(xyz - gt["joints_3d"] * 1000.0,
                                                     axis=1).mean()))
    return {"found": found, "ious": ious, "mpjpes": mpjpes, "found_q": found_q,
            "mpjpes_q": mpjpes_q, "frames": frames}


def main(argv=None, report: Optional[dict] = None) -> int:
    """Train, assemble, evaluate; 0 on PASS, 1 on FAIL. ``report``, if
    given, receives the numbers printed (each stage's ``stats``, ``a2j_only``,
    ``held_out``, ``found``, ``iou``, ``mpjpe_mm``, ``found_int8``,
    ``mpjpe_int8_mm``, ``ok``) and the trained trainers, states, configs
    and pipelines, and the held-out frames read."""
    args = parse_args(argv)
    device = resolve_device("synthetic_e2e_validation", args.device)
    quant = {"static": "static", "dynamic": True, "none": None}[args.quant_eval]
    report = {} if report is None else report
    root = tempfile.mkdtemp(prefix="synth_val_")
    try:
        started = time.perf_counter()
        info = make_synthetic_dexycb(root, n_sequences=args.sequences, n_frames=args.frames)
        ds = DexYCBDataset("s0", "train", data_dir=root)
        train_idx, test_idx = gates.split_indices(len(ds))
        print(f"{len(ds)} synthetic frames ({len(train_idx)} train, {len(test_idx)} held out; "
              f"tree {time.perf_counter() - started:.1f}s)", flush=True)

        fcfg, ftrainer, fstate, fstats, acfg, atrainer, astate, astats = train_stages(
            args, ds, train_idx, device)
        if args.save_state:
            statepack.save_trained_states(args.save_state, fstate, fcfg, astate, acfg, synth={
                "sequences": args.sequences, "frames": args.frames, "crop": args.crop})
            print(f"trained states -> {args.save_state}")

        pipe = gates.assemble_pipeline(gates.pipeline_config(fcfg, acfg, args.crop),
                                       fstate.model, astate.model, device=device)
        pipe_q = None
        if quant:
            pipe_q = gates.assemble_pipeline(gates.pipeline_config(fcfg, acfg, args.crop, quant),
                                             fstate.model, astate.model, device=device)
        only = a2j_only(args, ds, test_idx, atrainer, astate,
                        pipe_q if quant is True else None)
        if pipe_q is not None and pipe_q.needs_calibration():
            calibrate(pipe_q, ds, train_idx, device)
        sweep = held_out_sweep(ds, test_idx, info, pipe, pipe_q, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    n = len(test_idx)
    found, ious, mpjpes = sweep["found"], sweep["ious"], sweep["mpjpes"]
    mean = lambda v: float(np.mean(v)) if v else float("nan")   # noqa: E731
    print(f"\nheld-out frames: {n}")
    print(f"hand found: {found}/{n}")
    if ious:
        print(f"crop-box IoU vs planted (padded) box: mean {mean(ious):.3f}")
        print(f"pipeline MPJPE vs planted joints: mean {mean(mpjpes):.1f} mm")
    if pipe_q is not None:
        print(f"int8[{args.quant_eval}] pipeline: found {sweep['found_q']}/{n}, MPJPE "
              f"{mean(sweep['mpjpes_q']):.1f} mm (fp {mean(mpjpes):.1f})")
    ok = gates.e2e_passes(n, found, ious, mpjpes,
                          sweep["found_q"] if pipe_q is not None else None, sweep["mpjpes_q"])
    print("VALIDATION:", "PASS" if ok else "FAIL", flush=True)
    report.update({
        "stats": {"fcos": fstats, "a2j": astats}, "a2j_only": only, "held_out": n,
        "found": found, "iou": mean(ious), "mpjpe_mm": mean(mpjpes),
        "found_int8": sweep["found_q"] if pipe_q is not None else None,
        "mpjpe_int8_mm": mean(sweep["mpjpes_q"]) if pipe_q is not None else None, "ok": ok,
        "fcos": (fcfg, ftrainer, fstate), "a2j": (acfg, atrainer, astate),
        "pipeline": pipe, "pipeline_int8": pipe_q, "frames": sweep["frames"]})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
