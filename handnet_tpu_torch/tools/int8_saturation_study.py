"""Static-int8 saturation against calibration margin, on the card.

The port's ``tools/int8_saturation_study.py``. The static-int8 serving path
(``nn/quant.py``) clips every activation outside its calibrated range at
+-127; calibration sees a finite sample, so frames hotter than any it saw
(brighter scenes, higher contrast, closer hands) saturate silently. For
each calibration margin m and brightness gain g (g > 1: frames hotter than
calibration) the float and the static-int8 (margin m) pipelines run on the
held-out synthetic frames times g; each row gives their found rates and
MPJPEs, the MPJPE delta (int8 - float, so the float path's own sensitivity
to the shift is factored out), and the worst per-layer overflow factor
(the amax a fresh calibration on the shifted frames finds over the
calibrated one). Then, per gain, each pair of margins on the same frames:
the mean and standard error of the per-frame MPJPE delta. Then a table.

The gain multiplies the 0-1 frames WITHOUT clipping them back to [0, 1]:
overexposure pushes activations beyond the calibrated range, which a
clipped contrast shift cannot do once it reaches the normalize bound.

The port's calibration acts in place: ``HandNetPipeline.calibrate`` folds
each batch's amax into ``act_amax`` with ``max`` and ``apply_margin``
multiplies it. The study therefore snapshots every ``act_amax`` after one
margin-0 calibration, restores that snapshot before each margin (margins
never compound), and zeroes every ``act_amax`` before the overflow
factor's fresh calibration (restoring after it).

Trained weights come from ``synthetic_e2e_validation --save-state``
(``--state``); without it this tool first trains the two stages itself
through that tool (700/1,500 steps). The card by default (``RuntimeError``
where there is none); ``--device cpu`` runs on the CPU:

    python -m handnet_tpu_torch.tools.int8_saturation_study [--state PACK] \\
        [--margins 0,0.1,0.25] [--gains 1.0,1.3,1.6,2.0] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from handnet_tpu_torch.convert.from_flax import (a2j_state_dict_from_flax,
                                                 fcos_state_dict_from_flax)
from handnet_tpu_torch.data.dexycb import DexYCBDataset
from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb
from handnet_tpu_torch.models.pipeline import HandNetPipeline
from handnet_tpu_torch.nn.quant import _static_layers, apply_margin, assert_calibrated
from handnet_tpu_torch.tools import gates, synthetic_e2e_validation
from handnet_tpu_torch.train.trainer import resolve_device
from handnet_tpu_torch.utils.statepack import load_trained_states


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--state", default=None,
                        help="trained-state pack from synthetic_e2e_validation --save-state; "
                             "omit to train here (slow)")
    parser.add_argument("--sequences", type=int, default=24)
    parser.add_argument("--frames", type=int, default=6)
    parser.add_argument("--fcos-steps", type=int, default=700)
    parser.add_argument("--a2j-steps", type=int, default=1500)
    parser.add_argument("--crop", type=int, default=96)
    parser.add_argument("--margins", default="0,0.1,0.25")
    parser.add_argument("--gains", default="1.0,1.3,1.6,2.0")
    parser.add_argument("--calib-frames", type=int, default=16)
    parser.add_argument("--eval-sequences", type=int, default=None,
                        help="regenerate the eval tree with more sequences than the training "
                             "tree for statistical power (the same planted distribution; the "
                             "weights and calibration protocol are unchanged)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs on the CPU)")
    return parser.parse_args(argv)


def load_frames(ds, idx: Sequence[int], info) -> tuple:
    """Frames ``idx`` and their ground truth, stacked: RGB 0-1 float32
    ``[N, H, W, 3]``, depth in metres ``[N, H, W]``, intrinsics ``[N, 4]``
    and the planted joints in mm ``[N, 21, 3]``."""
    colors, depths, paras, joints = [], [], [], []
    for i in idx:
        gt = info[gates.generation_key(ds, i)]
        sample = ds[i]
        colors.append(gates.read_rgb(sample).astype(np.float32) / 255.0)
        depths.append(gates.read_depth(sample))
        paras.append(gt["paras"])
        joints.append(gt["joints_3d"] * 1000.0)
    return np.stack(colors), np.stack(depths), np.stack(paras), np.stack(joints)


def eval_pipeline(pipe: HandNetPipeline, colors, depths, paras, joints_mm) -> tuple:
    """``(found rate, mean MPJPE, per-frame MPJPE)`` of one pipeline call
    on all the frames; the per-frame MPJPE is NaN where the hand was not
    found, so margins compare frame by frame."""
    device = next(pipe.parameters()).device
    out = pipe(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (colors, depths, paras)))
    found = out["found"].cpu().numpy().astype(bool)
    xyz = out["joints_xyz"].float().cpu().numpy()
    per_frame = np.array([
        float(np.linalg.norm(xyz[i] - joints_mm[i], axis=1).mean()) if found[i] else np.nan
        for i in range(len(found))])
    mpjpes = per_frame[~np.isnan(per_frame)]
    return (float(found.mean()), float(np.mean(mpjpes)) if mpjpes.size else float("nan"),
            per_frame)


def amax_snapshot(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of every static layer's ``act_amax``, by layer name."""
    return {name: m.act_amax.detach().clone() for name, m in _static_layers(module)}


@torch.no_grad()
def restore_amaxes(module: torch.nn.Module, snapshot: Dict[str, torch.Tensor]) -> None:
    """Every static layer's ``act_amax`` set from ``snapshot``, in place."""
    layers = dict(_static_layers(module))
    if layers.keys() != snapshot.keys():
        raise KeyError("restore_amaxes: the snapshot is of other layers")
    for name, m in layers.items():
        m.act_amax.copy_(snapshot[name])


@torch.no_grad()
def calibrate_raw(pipe: HandNetPipeline, colors, depths) -> Dict[str, torch.Tensor]:
    """A fresh calibration at margin 0 on one batch (every ``act_amax``
    zeroed first, so nothing earlier folds in); returns its snapshot."""
    for _, m in _static_layers(pipe):
        m.act_amax.zero_()
    device = next(pipe.parameters()).device
    pipe.calibrate(torch.from_numpy(np.ascontiguousarray(colors)).to(device),
                   torch.from_numpy(np.ascontiguousarray(depths)).to(device), margin=0.0)
    assert_calibrated(pipe)
    return amax_snapshot(pipe)


def set_margin(pipe: HandNetPipeline, raw: Dict[str, torch.Tensor], margin: float) -> None:
    """The raw calibration widened by ``1 + margin``, never compounded."""
    restore_amaxes(pipe, raw)
    apply_margin(pipe, margin)


def overflow_factor(pipe: HandNetPipeline, raw: Dict[str, torch.Tensor], colors,
                    depths) -> Tuple[float, Optional[str]]:
    """The worst per-layer (shifted amax / calibrated amax) and its layer:
    above 1, that layer's activations on these frames exceed the calibrated
    range. The shifted amaxes come from a fresh margin-0 calibration on the
    frames; the pipeline's own ``act_amax`` are put back after it."""
    saved = amax_snapshot(pipe)
    try:
        shifted = calibrate_raw(pipe, colors, depths)
    finally:
        restore_amaxes(pipe, saved)
    worst, layer = 0.0, None
    for name, amax in shifted.items():
        denom = float(raw[name])
        if denom > 0 and float(amax) / denom > worst:
            worst, layer = float(amax) / denom, name
    return worst, layer


def paired_rows(per_frame: dict, gains: Sequence[float], margins: Sequence[float]) -> List[dict]:
    """Per gain, every pair of margins on the frames both found: the mean
    and standard error of the per-frame MPJPE delta (the wider margin's
    minus the narrower's)."""
    rows = []
    for g in gains:
        for i_m, m_a in enumerate(margins):
            for m_b in margins[i_m + 1:]:
                a, b = per_frame[(g, m_a)], per_frame[(g, m_b)]
                both = ~np.isnan(a) & ~np.isnan(b)
                d = (b - a)[both]
                rows.append({"paired": f"margin {m_b} vs {m_a}", "gain": g,
                             "n_frames": int(both.sum()),
                             "delta_mpjpe_mean_mm": round(float(d.mean()), 4)
                             if d.size else None,
                             "delta_mpjpe_sem_mm": round(
                                 float(d.std(ddof=1) / np.sqrt(d.size)), 4)
                             if d.size > 1 else None})
    return rows


def table(rows: List[dict], gains: Sequence[float], margins: Sequence[float]) -> List[str]:
    """The summary table's lines: per gain, the overflow factor and each
    margin's MPJPE delta and int8 found rate."""
    lines = ["\ngain  overflow | " + " | ".join(f"m={m:<4}: dMPJPE found" for m in margins)]
    for g in gains:
        cells = []
        for m in margins:
            r = next(r for r in rows if r["gain"] == g and r["margin"] == m)
            cells.append(f"m={m:<4}: {r['delta_mpjpe_mm']:+6.2f} {r['int8_found']:.2f}")
        o = next(r for r in rows if r["gain"] == g)["overflow_factor"]
        lines.append(f"{g:4}  {o:8.2f} | " + " | ".join(cells))
    return lines


def pipelines(fcfg, acfg, crop: int, detector, a2j, device,
              dtype: torch.dtype = torch.bfloat16) -> tuple:
    """The float and the static-int8 pipelines of the trained stages (state
    dicts or models) at a 0.5 score threshold and 40% padded crops."""
    return tuple(gates.assemble_pipeline(gates.pipeline_config(fcfg, acfg, crop, quant),
                                         detector, a2j, dtype=dtype, device=device)
                 for quant in (False, "static"))


def train_pack(args, device_arg) -> str:
    """Both stages trained by ``synthetic_e2e_validation`` (float only);
    returns the path of their pack."""
    path = os.path.join(tempfile.mkdtemp(prefix="sat_study_"), "states.msgpack")
    argv = ["--sequences", str(args.sequences), "--frames", str(args.frames),
            "--fcos-steps", str(args.fcos_steps), "--a2j-steps", str(args.a2j_steps),
            "--crop", str(args.crop), "--quant-eval", "none", "--save-state", path]
    if device_arg is not None:
        argv += ["--device", device_arg]
    synthetic_e2e_validation.main(argv)
    return path


def main(argv=None, report: Optional[dict] = None) -> int:
    """The margin x gain grid, the paired margins and the table. ``report``,
    if given, receives the rows (``rows``, ``paired``), the per-frame MPJPEs
    by ``(gain, margin or "fp")``, the layer of each gain's overflow factor
    (``overflow_layer``), both pipelines (``pipeline``,
    ``pipeline_int8``, the latter at the last margin), the raw calibration
    (``raw``) and the held-out frames (``frames``: colours, depths, intrinsics,
    joints in mm)."""
    args = parse_args(argv)
    device = resolve_device("int8_saturation_study", args.device)
    report = {} if report is None else report
    if args.state is None:
        args.state = train_pack(args, args.device)
    f_vars, fcfg, a_vars, acfg, synth = load_trained_states(args.state)
    if synth:
        args.sequences = synth.get("sequences", args.sequences)
        args.frames = synth.get("frames", args.frames)
        args.crop = synth.get("crop", args.crop)
    pipe_fp, pipe_q = pipelines(fcfg, acfg, args.crop, fcos_state_dict_from_flax(f_vars),
                                a2j_state_dict_from_flax(a_vars), device)

    root = tempfile.mkdtemp(prefix="sat_data_")
    try:
        info = make_synthetic_dexycb(root, n_sequences=args.eval_sequences or args.sequences,
                                     n_frames=args.frames)
        ds = DexYCBDataset("s0", "train", data_dir=root)
        train_idx, test_idx = gates.split_indices(len(ds))
        cal_colors, cal_depths, _, _ = load_frames(ds, train_idx[:args.calib_frames], info)
        colors, depths, paras, joints_mm = load_frames(ds, test_idx, info)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the raw calibration: each margin below widens it afresh
    raw = calibrate_raw(pipe_q, cal_colors, cal_depths)
    print(f"{len(test_idx)} held-out frames; calibrated on {len(cal_colors)} train frames",
          flush=True)

    margins = [float(m) for m in args.margins.split(",")]
    gains = [float(g) for g in args.gains.split(",")]
    rows, per_frame, worst_layers = [], {}, {}
    for g in gains:
        hot = colors * g   # overexposure: not clipped to [0, 1]
        fp_found, fp_mpjpe, per_frame[(g, "fp")] = eval_pipeline(pipe_fp, hot, depths, paras,
                                                                 joints_mm)
        overflow, worst_layers[g] = overflow_factor(pipe_q, raw, hot, depths)
        for m in margins:
            set_margin(pipe_q, raw, m)
            q_found, q_mpjpe, per_frame[(g, m)] = eval_pipeline(pipe_q, hot, depths, paras,
                                                                joints_mm)
            rec = {"gain": g, "margin": m, "overflow_factor": round(overflow, 3),
                   "fp_found": round(fp_found, 3), "int8_found": round(q_found, 3),
                   "fp_mpjpe_mm": round(fp_mpjpe, 2), "int8_mpjpe_mm": round(q_mpjpe, 2),
                   "delta_mpjpe_mm": round(q_mpjpe - fp_mpjpe, 2)}
            rows.append(rec)
            print(json.dumps(rec), flush=True)
    paired = paired_rows(per_frame, gains, margins)
    for rec in paired:
        print(json.dumps(rec), flush=True)
    print("\n".join(table(rows, gains, margins)), flush=True)
    report.update({"rows": rows, "paired": paired, "per_frame": per_frame,
                   "overflow_layer": worst_layers,
                   "pipeline": pipe_fp, "pipeline_int8": pipe_q, "raw": raw,
                   "frames": (colors, depths, paras, joints_mm)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
