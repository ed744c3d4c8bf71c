"""Detector evaluation CLI: VOC AP + hand-constrained AP + FPS, on one card.

The port's ``handnet_tpu/apps/eval_fcos.py`` (reference
trainval_net_fcos.py --test-only path, :107-173, and the
pascal_voc.evaluate_detections sweep, :418-429), with its flags plus
``--device``: the card by default, which raises where there is none;
``--device cpu`` runs on the CPU.

Frames are read with ``data/image_io.py``'s ``imread_color`` (the port's
JPEG decoder) and flipped to RGB, batched by ``--batch`` as the JAX CLI
batches them (the last batch short), and detected by ``FCOSSystem.detect``
with bf16 convolutions (the JAX CLI's ``dtype=bfloat16``): its head's 24
GroupNorms run kernels K2s and K2a on the card. Each ``detect`` call is
timed between CUDA events on the card (on the host's clock on the CPU),
and FPS is the frames over the summed calls. Weights come from a
reference torch checkpoint (``--torch-checkpoint``, through
``load_torch_checkpoint``: the port's detector carries the reference's
names and a frozen-BN backbone); without one they are random, with the
JAX CLI's warning. It writes ``comp4_det_test_hand.txt`` and
``comp4_det_test_targetobject.txt`` (11-field rows), prints the AP table
and FPS, and returns the results.

``--net rcnn`` evaluates the Faster R-CNN alternative instead
(``FasterRCNNFPN`` with its frozen-BN backbone, ``--num-proposals`` per
image, a reference checkpoint through ``faster_rcnn_state_dict``), its
convolutions and dense layers in bf16 (the JAX CLI's ``dtype=bfloat16``),
decoded by ``decode_rcnn_detections`` at ``--score-thresh``; it launches no
kernel of the port.

Usage:
  python -m handnet_tpu_torch.apps.eval_fcos --voc-root DIR [--image-set test]
      [--net fcos|rcnn] [--torch-checkpoint fcos.pth] [--batch 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn as nn

from handnet_tpu_torch.config import FCOSConfig
from handnet_tpu_torch.convert.torch_weights import (faster_rcnn_state_dict, fcos_state_dict,
                                                     load_torch_checkpoint)
from handnet_tpu_torch.data.image_io import imread_color
from handnet_tpu_torch.data.voc100doh import (VOC100DOH, decoded_to_detections,
                                              write_detection_file)
from handnet_tpu_torch.eval.voc import evaluate_detections_100doh
from handnet_tpu_torch.models.faster_rcnn import FasterRCNNFPN, decode_rcnn_detections
from handnet_tpu_torch.models.fcos import FCOSSystem
from handnet_tpu_torch.train.trainer import resolve_device


def build_system(args, cfg: FCOSConfig, device: torch.device) -> FCOSSystem:
    """The detector of ``args`` on ``device``, in eval mode, its
    convolutions in bf16 channels_last (norms and the decode stay
    float32)."""
    system = FCOSSystem(cfg)
    if args.torch_checkpoint:
        system.load_state_dict(fcos_state_dict(load_torch_checkpoint(args.torch_checkpoint)))
    else:
        print("WARNING: random detector weights")
        system.init_weights_(torch.Generator().manual_seed(0))
    system.to(device).eval()
    for m in system.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    return system


def build_rcnn(args, device: torch.device, dtype=torch.bfloat16) -> FasterRCNNFPN:
    """The Faster R-CNN of ``args`` on ``device``, in eval mode, its
    convolutions and dense layers in ``dtype`` (channels_last): the CLI's
    bf16, as the JAX CLI builds it at ``dtype=bfloat16``; a test substitutes
    float32 through ``dtype`` to hold the rows against JAX's."""
    system = FasterRCNNFPN(3, args.image_h, args.image_w, args.num_proposals)
    if args.torch_checkpoint:
        system.load_state_dict(faster_rcnn_state_dict(load_torch_checkpoint(args.torch_checkpoint)))
    else:
        print("WARNING: random detector weights")
        system.init_weights_(torch.Generator().manual_seed(0))
    system.to(device).eval()
    for m in system.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype=dtype, memory_format=torch.channels_last)
    return system


def rcnn_detect(system: FasterRCNNFPN, images_01: torch.Tensor,
                score_thresh: float) -> dict:
    """0-1 RGB frames -> ``decode_rcnn_detections`` of the R-CNN's forward,
    boxes clipped to the network input and scaled back to frame pixels
    (``handnet_tpu/apps/eval_fcos.py:77-86``)."""
    net_in, (sy, sx) = system.preprocess(images_01)
    det = decode_rcnn_detections(system(net_in), system.num_classes, score_thresh=score_thresh,
                                 image_hw=(system.image_h, system.image_w))
    # times [1/sx, 1/sy, 1/sx, 1/sy] in float32, one scalar per column
    det["boxes"] = torch.stack([c * (1 / s) for c, s in
                                zip(det["boxes"].unbind(-1), (sx, sy, sx, sy))], dim=-1)
    return det


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--voc-root", required=True)
    parser.add_argument("--image-set", default="test")
    parser.add_argument("--net", default="fcos", choices=["fcos", "rcnn"],
                        help="detector family (the reference's --net flag)")
    parser.add_argument("--num-proposals", type=int, default=128)
    parser.add_argument("--torch-checkpoint", default=None)
    parser.add_argument("--output", default="models/fcos_eval")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--score-thresh", type=float, default=0.1)
    parser.add_argument("--image-h", type=int, default=800)
    parser.add_argument("--image-w", type=int, default=1088)
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device("eval_fcos", args.device)

    os.makedirs(args.output, exist_ok=True)
    ds = VOC100DOH(args.voc_root, args.image_set)
    indices = ds.image_index[:args.limit or None]

    cfg = FCOSConfig(num_classes=3, image_h=args.image_h,
                     image_w=args.image_w, score_thresh=args.score_thresh)
    if args.net == "rcnn":
        system = build_rcnn(args, device)
        detect = lambda images: rcnn_detect(system, images, args.score_thresh)  # noqa: E731
    else:
        detect = build_system(args, cfg, device).detect
    on_card = device.type == "cuda"

    hands, objects = [], []
    model_ms = 0.0
    n_images = 0
    batch_imgs, batch_ids = [], []

    @torch.no_grad()
    def flush():
        nonlocal model_ms, n_images, batch_imgs, batch_ids
        if not batch_imgs:
            return
        imgs = torch.from_numpy(np.stack(batch_imgs)).to(device)
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            det = detect(imgs)
            end.record()
            end.synchronize()
            model_ms += start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            det = detect(imgs)
            model_ms += (time.perf_counter() - t0) * 1e3
        n_images += len(batch_ids)
        det_np = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
                  for k, v in det.items()}
        h, o = decoded_to_detections(det_np, batch_ids, hand_label=2,
                                     object_label=1,
                                     score_thresh=args.score_thresh)
        hands.extend(h)
        objects.extend(o)
        batch_imgs, batch_ids = [], []

    for index in indices:
        img = imread_color(ds.image_path(index))[:, :, ::-1]
        batch_imgs.append(img.astype(np.float32) / 255.0)
        batch_ids.append(index)
        if len(batch_imgs) == args.batch:
            flush()
    flush()

    write_detection_file(
        os.path.join(args.output, "comp4_det_test_hand.txt"), hands)
    write_detection_file(
        os.path.join(args.output, "comp4_det_test_targetobject.txt"), objects)

    annos = ds.annotations()
    results = evaluate_detections_100doh(hands, objects, annos)
    for k, v in results.items():
        print(f"{k}: {v:.4f}")
    fps = n_images / (model_ms / 1e3) if model_ms > 0 else 0.0
    print(f"FPS: {fps:.2f}")
    return results


if __name__ == "__main__":
    main()
