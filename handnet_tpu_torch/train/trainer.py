"""FCOS training on the card: the counterpart of ``handnet_tpu/train/trainer.py``
(``TrainState``, ``make_optimizer``, ``FCOSTrainer``).

The JAX package jits one pure step ``state -> state``; here the step runs
eagerly and updates the model and the optimizer in place (the JAX step
donates its state, so no caller keeps the old one either). The forward runs
the head towers' GroupNorms through kernels K2s and K2a (24 launches of
each per step); their gradients are the plain PyTorch formulas that
``ops/cuda_gn.py`` registers with the ops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from handnet_tpu_torch.config import FCOSConfig, TrainConfig
from handnet_tpu_torch.models.fcos import FCOSSystem
from handnet_tpu_torch.nn.resnet import make_norm
from handnet_tpu_torch.train.schedules import Schedule, multistep_with_warmup


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the learning-rate schedule; ``step``
    counts the updates made, as ``TrainState.step`` does in the JAX
    package."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' ``.grad``, at the
        learning rate ``schedule(step)``: optax evaluates the schedule at the
        count of updates before this one, so the first update uses
        ``schedule(0)``."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """The optimizer of ``handnet_tpu/train/trainer.py:51-59`` on
    ``torch.optim``, over one parameter group: optax decays every
    parameter, biases and norm scales included.

    * ``"adamw"``: ``optax.adamw(lr, weight_decay=wd)``: b1 0.9, b2 0.999,
      eps 1e-8, the decay decoupled and scaled by the learning rate;
    * ``"sgd"``: ``add_decayed_weights(wd)`` then ``sgd(lr, momentum=0.9)``:
      the decay added to the gradient before the momentum, no dampening, no
      Nesterov.

    The learning rate is set before each update (:meth:`TrainState.apply_gradients`).
    """
    params = list(params)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=0.9, dampening=0.0,
                               weight_decay=cfg.weight_decay, nesterov=False)
    raise ValueError(cfg.optimizer)


class FCOSTrainer:
    """FCOS training: SGD or AdamW, MultiStepLR with a one-epoch linear
    warmup, the loss dict summed (reference trainval_net_fcos.py:55-77,
    195-204; ``handnet_tpu/train/trainer.py:159-254``).

    ``backbone_norm``: ``"frozen"`` (the reference's fine-tuning recipe from
    pretrained weights: fixed statistics, trainable affine) or ``"batch"``
    (training from scratch, the training CLI's default). Only a ``"batch"``
    backbone runs its forward in training mode. ``"batch_sync"``,
    ``"group"`` and a ``mesh`` (data parallel over several cards) are not
    ported and raise ``NotImplementedError``. int8 (``quant``) and
    ``gn_fast_variance`` are serving-only and forced off, as in the JAX
    package; the fused-tower head is refused (``ValueError``), since the JAX
    package's fused GroupNorm normalizes over other axes.

    ``device``: None (the default) is the card and raises where there is
    none; pass ``"cpu"`` to train there. The batch must be on that device.

    bf16 (``train_cfg.bf16``) has flax's ``dtype=bfloat16,
    param_dtype=float32`` meaning: the parameters and the optimizer state
    stay float32, convolutions compute in bf16, GroupNorm and BatchNorm
    reduce in float32, and the loss reads the head outputs as float32. The
    trainer gets it from ``torch.autocast(dtype=bfloat16)`` around the
    forward, not from per-layer casts: autocast casts each float32 weight
    to bf16 where a convolution uses it (once per forward) and sends the
    gradient back to the float32 master, which is flax's split, and it
    leaves the serving modules unchanged; the serving pipeline's in-place
    bf16 weights would lose the master copy. Autocast also runs a few
    reductions in float32 where flax stays in bf16 (the ``hand_dxdy``
    head's norm). The loss runs inside the same region: it has no op that
    autocast lowers, and it reads the head outputs as float32.
    """

    def __init__(self, model_cfg: Optional[FCOSConfig] = None,
                 train_cfg: Optional[TrainConfig] = None, mesh=None,
                 steps_per_epoch: int = 1000,
                 milestones_epochs: Sequence[int] = (20, 35),
                 backbone_norm: str = "frozen", device=None):
        if mesh is not None:
            raise NotImplementedError("FCOSTrainer: mesh (data parallel over several cards) "
                                      "is not ported; the port trains on one card")
        make_norm(backbone_norm)   # raises for a norm the port has not
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "FCOSTrainer: no CUDA device (torch.cuda.is_available() is False). "
                    "The trainer runs on the card by default; pass device=\"cpu\" to "
                    "train on the CPU.")
            device = "cuda"
        self.device = torch.device(device)
        model_cfg = model_cfg or FCOSConfig()
        # serving-only, as in the JAX package: round() has no useful
        # gradient, and the E[x^2] - E[x]^2 variance NaNs gradients
        self.model_cfg = dataclasses.replace(model_cfg, quant=False, gn_fast_variance=False)
        self.train_cfg = train_cfg or TrainConfig()
        self.backbone_norm = backbone_norm
        self._norm_trains = backbone_norm == "batch"
        self.schedule = multistep_with_warmup(
            self.train_cfg.lr, steps_per_epoch, milestones_epochs,
            warmup_epochs=1.0 if self.train_cfg.warmup_epochs else 0.0)

    def init_state(self, seed: int) -> TrainState:
        """A detector with seeded random weights (``FCOS.init_weights_``) on
        the trainer's device, channels_last, and a fresh optimizer."""
        model = FCOSSystem(self.model_cfg, backbone_norm=self.backbone_norm)
        model.init_weights_(torch.Generator().manual_seed(seed))
        model.to(self.device, memory_format=torch.channels_last)
        return TrainState(0, model, make_optimizer(self.train_cfg, model.parameters()),
                          self.schedule)

    def train_step(self, state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update on ``batch`` = ``{"image": [B, H, W, 3] preprocessed
        frames, "targets": {"boxes", "labels", "valid"[, "box_info"]}}``.
        Returns ``state`` (updated in place) and the loss dict plus
        ``"total_loss"``, detached."""
        model = state.model
        if model.head.fused_towers:
            raise ValueError("FCOSTrainer: the fused-tower head is not trained (the JAX "
                             "package's fused GroupNorm normalizes over other axes)")
        model.train(self._norm_trains)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.train_cfg.bf16):
            losses = model.loss(batch["image"], batch["targets"])
        total = sum(losses.values())
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        for p in model.parameters():
            # optax moves every parameter (the decay at least); torch's
            # optimizers skip one whose grad is None
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.apply_gradients()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return state, metrics
