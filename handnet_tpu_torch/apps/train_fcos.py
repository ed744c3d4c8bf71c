"""FCOS detector training CLI on the cards.

The port's ``handnet_tpu/apps/train_fcos.py`` (reference
trainval_net_fcos.py:26-265: warmup + MultiStepLR, the NaN guard,
per-epoch checkpoints), with its flags and its files (``train.txt``,
``metrics.json``/``.html``, per-epoch checkpoints under ``checkpoints/``,
``cache/refined_train_idx.pkl``), plus ``--device``: the card by default,
which raises where there is none; ``--device cpu`` trains on the CPU.

Data: DexYCB detection targets (hand + objects, ``--data-dir`` or a
``--synthetic N`` tree) through ``DetectDataSource(e2e=True,
uint8_images=True)``, or 100DOH in VOC layout (``--voc-root``, 3 classes)
through ``VOCDetectSource``, whose frames are resized and padded to the
network input on the host. The loader's threads decode each batch (the
port's JPEG decoder, which releases the GIL) and pin it; the loop copies it
to the card without blocking and preprocesses it there
(``FCOSSystem.preprocess``: normalize, resize to fit, pad). The targets are
scaled by ``min(image_h / h, image_w / w)`` of the frames' size, as the JAX
CLI scales them.

Training is ``train/trainer.py``'s ``FCOSTrainer`` with SGD, a one-epoch
warmup and ``--backbone-norm`` (``batch``, ``frozen`` or ``group``): the
head's 24 GroupNorms, and a ``group`` backbone's 36, run kernels K2s and
K2a on the card. ``--net rcnn`` trains the Faster R-CNN alternative
instead (``RCNNTrainer``, ``--num-proposals`` per image; only a ``group``
backbone launches kernels, 36 of each per step). One card takes the whole
batch (``--batch``); launched by ``torchrun`` the ranks train data
parallel as ``train_a2j`` does (``parallel/mesh.py``: the global
``--batch`` rounded to a multiple of the world size, each rank's share
from its loader shard, rank 0 writing the logs and checkpoints). A non-finite loss stops the run with exit code 1, as
the JAX CLI does; the check reads each step's loss after the next step is
launched, so the host does not wait for the card at every step.

Usage:
  python -m handnet_tpu_torch.apps.train_fcos --data-dir $DEX_YCB_DIR
      [--synthetic N] [--voc-root DIR] [--epochs 45] [--batch 8]
      [--image-h 800 --image-w 1088] [--backbone-norm batch|frozen|group]
      [--net fcos|rcnn] [--num-proposals 128] [--device cpu]
  torchrun --nproc-per-node N -m handnet_tpu_torch.apps.train_fcos ...
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from handnet_tpu_torch.config import FCOSConfig, TrainConfig
from handnet_tpu_torch.data.detect_data import DetectDataSource
from handnet_tpu_torch.data.dexycb import DexYCBDataset, refine_indices
from handnet_tpu_torch.data.loader import PrefetchLoader
from handnet_tpu_torch.parallel.mesh import rank_zero_first, torchrun_mesh
from handnet_tpu_torch.train.checkpoints import CheckpointManager
from handnet_tpu_torch.train.trainer import FCOSTrainer, RCNNTrainer, resolve_device
from handnet_tpu_torch.utils.meters import AverageMeters
from handnet_tpu_torch.utils.monitoring import Monitor

# the batch entries the card needs: the frames and the padded targets
DEVICE_KEYS = ("image", "target_boxes", "target_labels", "target_valid", "target_box_info")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-dir", default=os.environ.get("DEX_YCB_DIR"))
    parser.add_argument("--output", default="models/fcos_torch")
    parser.add_argument("--epochs", type=int, default=45)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1.25e-3)
    parser.add_argument("--image-h", type=int, default=800)
    parser.add_argument("--image-w", type=int, default=1088)
    parser.add_argument("--num-classes", type=int, default=23,
                        help="22 ycb+hand categories + background-ish slot")
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--voc-root", default=None,
                        help="train on 100DOH VOC (sets num_classes=3)")
    parser.add_argument("--voc-image-set", default="trainval")
    parser.add_argument("--net", default="fcos", choices=["fcos", "rcnn"],
                        help="detector family, like the reference's --net flag "
                             "(trainval_net_fcos.py:184-187): 'rcnn' trains the Faster R-CNN "
                             "alternative")
    parser.add_argument("--num-proposals", type=int, default=128,
                        help="rcnn only: fixed per-image proposal budget")
    parser.add_argument("--backbone-norm", default="batch",
                        choices=["batch", "frozen", "group"],
                        help="'frozen' only when starting from converted "
                             "pretrained weights (the reference recipe); "
                             "from-scratch training needs 'batch' or 'group'")
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--no-bf16", dest="bf16", action="store_false")
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: the card)")
    return parser.parse_args(argv)


def build_source(args):
    """The training source of ``args`` (sets ``args.num_classes`` to 3 for
    VOC, as the JAX CLI does)."""
    if args.voc_root:
        from handnet_tpu_torch.data.voc100doh import VOC100DOH, VOCDetectSource

        args.num_classes = 3  # background / targetobject / hand
        return VOCDetectSource(VOC100DOH(args.voc_root, args.voc_image_set),
                               target_size=(args.image_h, args.image_w))
    if args.synthetic:
        import tempfile

        from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb

        root = args.data_dir or tempfile.mkdtemp(prefix="synth_dexycb_")
        if not os.path.exists(os.path.join(root, "calibration")):
            make_synthetic_dexycb(root, n_sequences=args.synthetic, n_frames=4)
        ds = DexYCBDataset("s0", "train", data_dir=root)
    else:
        ds = DexYCBDataset("s0", "train", data_dir=args.data_dir)
    idx = refine_indices(ds, cache_path=os.path.join(
        args.output, "cache", "refined_train_idx.pkl"))
    return DetectDataSource(ds, idx, e2e=True, uint8_images=True)


def pinned(device: torch.device):
    """The loader's ``device_put``: the device entries as torch tensors, in
    pinned memory when ``device`` is a card."""
    def put(batch: Dict[str, np.ndarray]) -> Dict:
        out = dict(batch)
        for key in DEVICE_KEYS:
            t = torch.from_numpy(np.ascontiguousarray(batch[key]))
            out[key] = t.pin_memory() if device.type == "cuda" else t
        return out
    return put


def device_batch(batch: Dict, model, cfg: FCOSConfig, device: torch.device) -> Dict:
    """The trainer's batch: frames preprocessed on the device, targets scaled
    into network pixels (``handnet_tpu/apps/train_fcos.py:137-150``)."""
    h, w = batch["image"].shape[1:3]
    scale = min(cfg.image_h / h, cfg.image_w / w)
    images = batch["image"].to(device, non_blocking=True)
    with torch.no_grad():
        net_images = model.preprocess(images)[0]
    return {
        "image": net_images,
        "targets": {
            "boxes": batch["target_boxes"].to(device, non_blocking=True) * scale,
            "labels": batch["target_labels"].to(device, non_blocking=True),
            "valid": batch["target_valid"].to(device, non_blocking=True),
            "box_info": batch["target_box_info"].to(device, non_blocking=True),
        },
    }


def _finite_or_exit(metrics) -> float:
    total = float(metrics["total_loss"])
    if not math.isfinite(total):
        # NaN guard (trainval_net_fcos.py:61-64)
        print("FATAL: non-finite loss, aborting", file=sys.stderr)
        sys.exit(1)
    return total


def main(argv=None) -> dict:
    """Train. Returns per epoch the mean losses and the loop's clock
    (``epochs``: seconds, steps, ms per step, images/s and the share of the
    epoch spent waiting on the loader), the sample count and the trained
    ``state`` (on every rank under ``torchrun``, whose process group it
    leaves at the end)."""
    args = parse_args(argv)
    mesh = torchrun_mesh(args.device)
    device = resolve_device("train_fcos", args.device, mesh)
    log = print if mesh is None or mesh.is_main else (lambda *a, **k: None)

    with rank_zero_first(mesh):
        os.makedirs(args.output, exist_ok=True)
        src = build_source(args)
    log(f"train samples: {len(src)}")

    world, rank = (1, 0) if mesh is None else (mesh.world_size, mesh.rank)
    batch = max(args.batch // world * world, world)
    loader = PrefetchLoader(src, batch // world, shuffle=True, num_workers=args.workers,
                            shard_id=rank, num_shards=world, device_put=pinned(device))
    steps_per_epoch = max(len(loader), 1)

    model_cfg = FCOSConfig(num_classes=args.num_classes,
                           image_h=args.image_h, image_w=args.image_w)
    train_cfg = TrainConfig(batch_size=batch, lr=args.lr, bf16=args.bf16,
                            optimizer="sgd", warmup_epochs=1)
    if args.net == "rcnn":
        trainer = RCNNTrainer(model_cfg, train_cfg, mesh=mesh, steps_per_epoch=steps_per_epoch,
                              backbone_norm=args.backbone_norm,
                              num_proposals=args.num_proposals, device=device)
    else:
        trainer = FCOSTrainer(model_cfg, train_cfg, mesh=mesh, steps_per_epoch=steps_per_epoch,
                              backbone_norm=args.backbone_norm, device=device)
    state = trainer.init_state(train_cfg.seed)

    ckpt = CheckpointManager(os.path.join(args.output, "checkpoints"), mesh=mesh)
    monitor = Monitor(args.output, write=mesh is None or mesh.is_main)
    start_epoch = 0
    if args.resume and ckpt.latest_epoch() is not None:
        state = ckpt.restore(state)
        start_epoch = ckpt.latest_epoch() + 1
        log(f"resumed from epoch {ckpt.latest_epoch()}")

    epochs = []
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        meters = AverageMeters()
        waited = 0.0
        steps = 0
        pending = None
        t0 = time.perf_counter()
        batches = iter(loader)
        while True:
            w0 = time.perf_counter()
            batch_np = next(batches, None)
            waited += time.perf_counter() - w0
            if batch_np is None:
                break
            state, metrics = trainer.train_step(
                state, device_batch(batch_np, state.model, trainer.model_cfg, device))
            steps += 1
            if pending is not None:   # the step before, done or nearly by now
                _finite_or_exit(pending)
                meters.update({k: float(v) for k, v in pending.items()})
            pending = metrics
        if pending is not None:
            _finite_or_exit(pending)
            meters.update({k: float(v) for k, v in pending.items()})
        meters.reduce(mesh)
        dt = time.perf_counter() - t0
        avg = meters.averages()
        epochs.append({"epoch": epoch, "losses": avg, "seconds": dt, "steps": steps,
                       "ms_per_step": dt / max(steps, 1) * 1e3,
                       "images_per_s": steps * batch / max(dt, 1e-9),
                       "loader_wait_share": waited / max(dt, 1e-9)})
        log(f"epoch {epoch}: loss={avg.get('total_loss', 0):.4f} "
              f"({dt:.1f}s, {epochs[-1]['images_per_s']:.1f} images/s, "
              f"{epochs[-1]['ms_per_step']:.1f} ms/step, "
              f"{100 * epochs[-1]['loader_wait_share']:.1f}% waiting on the loader)")
        monitor.log_train(epoch, avg)
        ckpt.save(epoch, state)

    monitor.metrics.save_metrics()
    monitor.metrics.plot_metrics()
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return {"epochs": epochs, "samples": len(src), "state": state}


if __name__ == "__main__":
    main()
