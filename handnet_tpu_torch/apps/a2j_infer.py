"""Folder inference: depth PNGs -> 21-joint UVD, batched on the card.

The port's ``handnet_tpu/apps/a2j_infer.py`` (reference a2j_infer.py:16-72:
depth pngs, mm/1000 scaling, 176^2 nearest resize, all_joints_uvd.npy).
The PNGs are read with ``data/image_io.py`` and resized with
``a2j_data.resize_nearest`` (``cv2.INTER_NEAREST``). Frames go through
``A2JSystem.predict`` in batches of ``--batch`` in float32, one launch of
kernel K1 per batch, the last batch padded with zero frames as the JAX app
pads it. Weights come from a training run's ``params.npz`` and
``batch_stats.npz`` (``--checkpoint DIR``) or a reference torch checkpoint
(``--torch-checkpoint``, whose anchors are transposed); with neither, the
weights are random. ``--device``: the card by default, which raises where
there is none. ``--vis`` writes ``<name>_vis.jpg`` per frame, the crop with
the predicted skeleton drawn by ``utils/vistool.py`` (the JAX app's
``VisualUtil.plot``, without ``cv2``: the same pixels and the same JPEG
bytes).

Usage:
  python -m handnet_tpu_torch.apps.a2j_infer --input DIR [--output DIR]
      [--checkpoint DIR | --torch-checkpoint a2j.pth] [--batch 8] [--vis] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import List

import numpy as np
import torch

from handnet_tpu_torch.config import A2JConfig
from handnet_tpu_torch.convert.from_flax import a2j_state_dict_from_flax, load_params_npz
from handnet_tpu_torch.convert.torch_weights import a2j_state_dict, load_torch_checkpoint
from handnet_tpu_torch.data.a2j_data import resize_nearest
from handnet_tpu_torch.data.image_io import read_png
from handnet_tpu_torch.models.a2j import A2JSystem
from handnet_tpu_torch.train.trainer import resolve_device


def build_system(args, device: torch.device) -> A2JSystem:
    """The A2J of ``args`` (its crop, and its weights) on ``device``, in
    eval mode."""
    cfg = A2JConfig(crop_h=args.crop, crop_w=args.crop,
                    transposed_anchors=bool(args.torch_checkpoint))
    system = A2JSystem(cfg)
    if args.torch_checkpoint:
        system.load_state_dict(a2j_state_dict(load_torch_checkpoint(args.torch_checkpoint)))
    elif args.checkpoint:
        base = args.checkpoint.rstrip("/")
        system.load_state_dict(a2j_state_dict_from_flax({
            "params": load_params_npz(os.path.join(base, "params.npz")),
            "batch_stats": load_params_npz(os.path.join(base, "batch_stats.npz"))}))
    else:
        print("WARNING: no checkpoint given — random weights")
        system.init_weights_(torch.Generator().manual_seed(0))
    return system.to(device, memory_format=torch.channels_last).eval()


def read_frames(files: List[str], crop: int) -> np.ndarray:
    """``[N, crop, crop, 1]`` float32 depth in metres."""
    crops = []
    for f in files:
        depth = read_png(f).astype(np.float32) / 1000.0  # mm -> m (a2j_infer.py:33)
        crops.append(resize_nearest(depth, crop, crop)[..., None])
    return np.stack(crops)


@torch.no_grad()
def predict_frames(system: A2JSystem, frames: np.ndarray, batch: int) -> np.ndarray:
    """UVD ``[N, J, 3]`` of ``frames`` in batches of ``batch``, the last
    one padded with zero frames."""
    device = system.anchors.device
    pad = (-len(frames)) % batch
    padded = np.concatenate([frames, np.zeros((pad,) + frames.shape[1:], frames.dtype)])
    out = [system.predict(torch.from_numpy(padded[i:i + batch]).to(device))
           for i in range(0, len(padded), batch)]
    return torch.cat(out).cpu().numpy()[:len(frames)]


def write_vis(files: List[str], frames: np.ndarray, all_uvd: np.ndarray,
              out_dir: str) -> List[str]:
    """``<name>_vis.jpg`` per frame: the crop scaled to 0-255 as grey BGR
    with the predicted skeleton (``handnet_tpu/apps/a2j_infer.py:102-114``).
    Returns the paths."""
    from handnet_tpu_torch.utils.vistool import VisualUtil

    vt = VisualUtil("dexycb")
    paths = []
    for f, crop, uvd in zip(files, frames, all_uvd):
        vis = np.clip(crop[..., 0] * 255 / max(crop.max(), 1e-6),
                      0, 255).astype(np.uint8)
        vis = np.repeat(vis[:, :, None], 3, axis=-1)
        paths.append(os.path.join(out_dir, os.path.basename(f).replace(".png", "_vis.jpg")))
        vt.plot(vis, paths[-1], None, uvd)
    return paths


def main(argv=None) -> dict:
    """Write ``all_joints_uvd.npy`` (and with ``--vis`` the images).
    Returns its path, the UVD, the batch count, the seconds spent reading
    the PNGs (``read_s``) and in the batches (``predict_s``, until the UVD
    is on the host), and the images' paths (``vis``, empty without
    ``--vis``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="dir of depth pngs (mm)")
    parser.add_argument("--output", default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--torch-checkpoint", default=None)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--crop", type=int, default=176)
    parser.add_argument("--vis", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device("a2j_infer", args.device)

    out_dir = args.output or args.input
    os.makedirs(out_dir, exist_ok=True)
    system = build_system(args, device)

    files = sorted(glob.glob(os.path.join(args.input, "*.png")))
    if not files:
        raise SystemExit(f"no .png files in {args.input}")
    t0 = time.perf_counter()
    frames = read_frames(files, args.crop)
    t1 = time.perf_counter()
    all_uvd = predict_frames(system, frames, args.batch)
    t2 = time.perf_counter()

    path = os.path.join(out_dir, "all_joints_uvd.npy")
    np.save(path, all_uvd)
    print(f"wrote {path} ({all_uvd.shape})")
    vis = []
    if args.vis:
        vis = write_vis(files, frames, all_uvd, out_dir)
        print(f"wrote {len(vis)} visualizations")
    return {"path": path, "uvd": all_uvd, "batches": -(-len(frames) // args.batch),
            "read_s": t1 - t0, "predict_s": t2 - t1, "vis": vis}


if __name__ == "__main__":
    main()
