"""A2J training CLI: DexYCB -> train loop on the cards -> checkpoints -> HPE eval.

The port's ``handnet_tpu/apps/train_a2j.py``, with its flags and its files
(``train.txt``, ``val.txt``, ``metrics.json``/``.html``, the 64-field
result file per eval epoch under ``a2j_test_metrics/``, the evaluator's
``dexycb_metrics/``, per-epoch checkpoints, and ``params.npz`` plus
``batch_stats.npz`` in the flax keys that the JAX package's
``load_params_npz`` reads), plus ``--device``: the card by default, which
raises where there is none; ``--device cpu`` trains on the CPU.

The recipe is the reference's (AdamW 3.5e-4 / wd 1e-4 / StepLR 0.2 every
10 / bs 64 / 45 epochs) through ``train/trainer.py``'s ``A2JTrainer``. One
card takes the whole batch (``--batch``); launched by ``torchrun`` the
ranks train data parallel (``parallel/mesh.py``, one card each, NCCL; gloo
on the CPU with ``--device cpu``): ``--batch`` is the global batch, rounded
down to a multiple of the world size as the JAX CLI rounds it over its
devices, each rank loads its share of it (``PrefetchLoader(shard_id=rank,
num_shards=world)``), rank 0 alone runs the eval sweep (the table of a
one-process run) and writes the logs, checkpoints and npz files. The loader's threads decode and
augment each batch and pin it (``PrefetchLoader(device_put=...)``); the
loop copies it to the card without blocking and keeps the step's losses on
the card until the epoch ends, so the host runs ahead of the card. The
eval sweep runs ``A2JTrainer.eval_step`` on every test batch (the last one
partial), which decodes through kernel K1 on the card, then
``convert_joints`` on the device, and writes the result file.

``--rgbd`` trains the 4-channel variant (``A2JConfig(in_channels=4)``) on
the colour crop beside the depth crop. As in the JAX package, the colour
channels are the decoder's BGR order, not RGB (``data/a2j_data.py``).

Usage:
  python -m handnet_tpu_torch.apps.train_a2j --data-dir $DEX_YCB_DIR
      [--epochs 45] [--batch 64] [--output models/a2j_torch] [--device cpu]
      [--synthetic N]   # N synthetic sequences instead of real data
  torchrun --nproc-per-node N -m handnet_tpu_torch.apps.train_a2j ...
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np
import torch

from handnet_tpu_torch.config import A2JConfig, TrainConfig
from handnet_tpu_torch.data.a2j_data import A2JDataSource, A2JSampleConfig
from handnet_tpu_torch.data.dexycb import DexYCBDataset, hpe_ground_truth, refine_indices
from handnet_tpu_torch.data.loader import PrefetchLoader
from handnet_tpu_torch.eval.hpe import HPEEvaluator, format_result_line
from handnet_tpu_torch.ops.geometry import convert_joints
from handnet_tpu_torch.parallel.mesh import barrier, rank_zero_first, torchrun_mesh
from handnet_tpu_torch.train.checkpoints import CheckpointManager, save_params_npz
from handnet_tpu_torch.train.trainer import A2JTrainer, resolve_device
from handnet_tpu_torch.utils.meters import AverageMeters
from handnet_tpu_torch.utils.monitoring import Monitor


def device_keys(rgbd: bool) -> Dict[str, str]:
    """The batch entries that go to the device, by the trainer's names: the
    image is the depth crop, or the 4-channel ``rgbd`` one."""
    return {"image": "rgbd" if rgbd else "depth", "jt_uvd": "jt_uvd", "box": "box",
            "paras": "paras"}


def build_sources(args):
    if args.synthetic:
        import tempfile

        from handnet_tpu_torch.data.synthetic import make_synthetic_dexycb

        root = args.data_dir or tempfile.mkdtemp(prefix="synth_dexycb_")
        if not os.path.exists(os.path.join(root, "calibration")):
            make_synthetic_dexycb(root, n_sequences=args.synthetic,
                                  n_frames=4)
        train_ds = DexYCBDataset("s0", "train", data_dir=root)
        test_ds = DexYCBDataset("s0", "train", data_dir=root)
    else:
        train_ds = DexYCBDataset("s0", "train", data_dir=args.data_dir)
        test_ds = DexYCBDataset("s0", "test", data_dir=args.data_dir)
    cache = os.path.join(args.output, "cache")
    train_idx = refine_indices(
        train_ds, cache_path=os.path.join(cache, "refined_train_idx.pkl"))
    test_idx = refine_indices(
        test_ds, cache_path=os.path.join(cache, "refined_test_idx.pkl"))
    cfg = A2JSampleConfig(crop_w=args.crop, crop_h=args.crop)
    return (A2JDataSource(train_ds, train_idx, augment=True, cfg=cfg, with_color=args.rgbd),
            A2JDataSource(test_ds, test_idx, augment=False, cfg=cfg, with_color=args.rgbd),
            test_ds)


def pinned(device: torch.device, rgbd: bool = False):
    """The loader's ``device_put``: the batch's device entries as torch
    tensors, in pinned memory when ``device`` is a card."""
    keys = device_keys(rgbd).values()

    def put(batch: Dict[str, np.ndarray]) -> Dict:
        out = dict(batch)
        for key in keys:
            t = torch.from_numpy(np.ascontiguousarray(batch[key]))
            out[key] = t.pin_memory() if device.type == "cuda" else t
        return out
    return put


def to_device(batch: Dict, device: torch.device, rgbd: bool = False) -> Dict[str, torch.Tensor]:
    """``{"image", "jt_uvd", "box", "paras"}`` on ``device`` (a copy that
    does not block the host from pinned memory)."""
    return {name: batch[key].to(device, non_blocking=True)
            for name, key in device_keys(rgbd).items()}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-dir", default=os.environ.get("DEX_YCB_DIR"))
    parser.add_argument("--output", default="models/a2j_torch")
    parser.add_argument("--epochs", type=int, default=45)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=3.5e-4)
    parser.add_argument("--crop", type=int, default=176)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="use N synthetic sequences (smoke runs)")
    parser.add_argument("--eval-every", type=int, default=5)
    parser.add_argument("--rgbd", action="store_true",
                        help="the 4-channel RGBD variant (a2j/a2j.py:216 is_RGBD)")
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--no-bf16", dest="bf16", action="store_false")
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: the card)")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Train, evaluate and export. Returns per epoch the mean losses and
    the loop's clock (``epochs``: seconds, ms per step, samples/s and the
    share of the epoch spent waiting on the loader), per eval sweep its
    result file, HPE numbers and batch count (``evals``), the params and
    batch-stats npz paths and the trained ``state`` (on every rank under
    ``torchrun``, whose process group it leaves at the end)."""
    args = parse_args(argv)
    mesh = torchrun_mesh(args.device)
    device = resolve_device("train_a2j", args.device, mesh)
    main_rank = mesh is None or mesh.is_main
    log = print if main_rank else (lambda *a, **k: None)

    with rank_zero_first(mesh):
        os.makedirs(args.output, exist_ok=True)
        train_src, test_src, test_ds = build_sources(args)
    log(f"train samples: {len(train_src)}  test samples: {len(test_src)}")

    world, rank = (1, 0) if mesh is None else (mesh.world_size, mesh.rank)
    batch = max(args.batch // world * world, world)
    loader = PrefetchLoader(train_src, batch // world, shuffle=True,
                            num_workers=args.workers, shard_id=rank, num_shards=world,
                            device_put=pinned(device, args.rgbd))
    steps_per_epoch = max(len(loader), 1)

    model_cfg = A2JConfig(crop_h=args.crop, crop_w=args.crop,
                          in_channels=4 if args.rgbd else 1)
    train_cfg = TrainConfig(batch_size=batch, lr=args.lr, bf16=args.bf16,
                            epochs=args.epochs)
    trainer = A2JTrainer(model_cfg, train_cfg, mesh=mesh, steps_per_epoch=steps_per_epoch,
                         device=device)
    state = trainer.init_state(train_cfg.seed)

    ckpt = CheckpointManager(os.path.join(args.output, "checkpoints"), mesh=mesh)
    monitor = Monitor(args.output, write=main_rank)
    start_epoch = 0
    if args.resume and ckpt.latest_epoch() is not None:
        state = ckpt.restore(state)
        start_epoch = ckpt.latest_epoch() + 1
        log(f"resumed from epoch {ckpt.latest_epoch()}")

    epochs, evals = [], []
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        meters = AverageMeters()
        step_metrics = []
        waited = 0.0
        t0 = time.perf_counter()
        batches = iter(loader)
        while True:
            w0 = time.perf_counter()
            batch_np = next(batches, None)
            waited += time.perf_counter() - w0
            if batch_np is None:
                break
            state, metrics = trainer.train_step(state, to_device(batch_np, device, args.rgbd))
            step_metrics.append(metrics)
        for metrics in step_metrics:   # the one wait for the card in the epoch
            meters.update({k: float(v) for k, v in metrics.items()})
        meters.reduce(mesh)
        dt = time.perf_counter() - t0
        avg = meters.averages()
        steps = len(step_metrics)
        epochs.append({"epoch": epoch, "losses": avg, "seconds": dt, "steps": steps,
                       "ms_per_step": dt / max(steps, 1) * 1e3,
                       "samples_per_s": steps * batch / max(dt, 1e-9),
                       "loader_wait_share": waited / max(dt, 1e-9)})
        log(f"epoch {epoch}: loss={avg.get('total_loss', 0):.4f} "
              f"({dt:.1f}s, {steps * batch / max(dt, 1e-9):.0f} samples/s, "
              f"{epochs[-1]['ms_per_step']:.1f} ms/step, "
              f"{100 * epochs[-1]['loader_wait_share']:.1f}% waiting on the loader)")
        monitor.log_train(epoch, avg)
        ckpt.save(epoch, state)

        if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
            if main_rank:
                evals.append(evaluate(trainer, state, test_src, test_ds, args, epoch, monitor))
            barrier(mesh)

    monitor.metrics.save_metrics()
    monitor.metrics.plot_metrics()
    # flat npz export beside the checkpoints: what a2j_infer and the
    # pipelines load
    params = os.path.join(args.output, "params.npz")
    batch_stats = os.path.join(args.output, "batch_stats.npz")
    if main_rank:
        save_params_npz(params, state.model, "params")
        save_params_npz(batch_stats, state.model, "batch_stats")
    barrier(mesh)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    log(f"done; logs + params.npz in {args.output}")
    return {"epochs": epochs, "evals": evals, "params_npz": params,
            "batch_stats_npz": batch_stats, "state": state}


def evaluate(trainer, state, test_src, test_ds, args, epoch, monitor) -> dict:
    """Test sweep -> result txt (a2j/a2j.py:354-362 format) -> HPE metrics."""
    device = trainer.device
    loader = PrefetchLoader(test_src, trainer.train_cfg.batch_size,
                            shuffle=False, num_workers=args.workers,
                            drop_last=False, device_put=pinned(device, args.rgbd))
    res_lines = []
    rmses = []
    n_batches = 0
    for batch_np in loader:
        batch = to_device(batch_np, device, args.rgbd)
        pred, rmse = trainer.eval_step(state, batch)
        rmses.append(rmse)
        xyz = convert_joints(pred, batch["box"], batch["paras"], args.crop, args.crop)
        xyz = xyz.cpu().numpy()
        for i in range(xyz.shape[0]):
            res_lines.append(format_result_line(int(batch_np["dexycb_id"][i, 0]), xyz[i]))
        n_batches += 1

    metrics_dir = os.path.join(args.output, "a2j_test_metrics")
    os.makedirs(metrics_dir, exist_ok=True)
    res_file = os.path.join(metrics_dir, f"s0_test_{epoch}.txt")
    with open(res_file, "w") as f:
        f.write("\n".join(res_lines) + "\n")

    gt = hpe_ground_truth(test_ds)
    evaluator = HPEEvaluator(gt)
    results = evaluator.evaluate(epoch, res_file)
    print(evaluator.report(results))
    evaluator.save_epoch_metrics(os.path.join(args.output, "dexycb_metrics"))
    # per-epoch PCK-curve HTML (reference hpe_eval.py:240-250)
    evaluator.save_pck_curves(
        os.path.join(args.output, "dexycb_metrics"), epoch)
    rmse = float(np.mean([r.item() for r in rmses]))
    monitor.log_val(epoch, {
        "rmse": rmse,
        "mpjpe_ab": results["absolute"]["mpjpe"],
        "mpjpe_pa": results["procrustes"]["mpjpe"],
        "auc_ab": results["absolute"]["auc"],
    })
    return {"epoch": epoch, "res_file": res_file, "results": results, "rmse": rmse,
            "batches": n_batches, "samples": len(res_lines)}


if __name__ == "__main__":
    main()
