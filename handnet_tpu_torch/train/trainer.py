"""Training on the card: the counterpart of ``handnet_tpu/train/trainer.py``
(``TrainState``, ``make_optimizer``, ``A2JTrainer``, ``FCOSTrainer``,
``RCNNTrainer``).

The JAX package jits one pure step ``state -> state``; here the step runs
eagerly and updates the model and the optimizer in place (the JAX step
donates its state, so no caller keeps the old one either).

* ``FCOSTrainer``: the forward runs the head towers' GroupNorms through
  kernels K2s and K2a (24 launches of each per step, 36 more with a
  GroupNorm backbone); their gradients are the plain PyTorch formulas that
  ``ops/cuda_gn.py`` registers with the ops.
* ``A2JTrainer``: the train step launches no kernel of the port (A2J has
  BatchNorm, and its loss is einsums); the eval step decodes through K1,
  one launch per call.
* ``RCNNTrainer``: only a GroupNorm backbone launches kernels of the port
  (K2s and K2a, 36 of each per step); RoIAlign, the RPN's ranking and NMS
  and the heads' products are PyTorch.

Data parallel (``mesh=``, a rank's ``parallel.DataMesh`` from
``init_data_parallel``; the JAX trainers' ``mesh`` with the batch sharded on
``data``): each rank steps on its shard of the global batch through
``DistributedDataParallel``, which averages the gradients. The step is the
whole-batch step, as under JAX's sharded ``jit``: the BatchNorms take the
global batch's statistics (``nn/resnet.py``), the R-CNN's dropout keeps the
rank's rows of the global draw, and the losses count their normalizers over
the world and scale their sums for DDP's average (``fcos_loss``,
``rcnn_loss``, ``rpn_loss``; ``a2j_loss``'s means need neither). The returned
metrics are the global losses, the same on every rank; the eval steps run
on the inner module. DDP gets ``broadcast_buffers=False``: the running
statistics move alike on every rank already.

bf16 (``train_cfg.bf16``) has flax's ``dtype=bfloat16, param_dtype=float32``
meaning: the parameters and the optimizer state stay float32, convolutions
compute in bf16, GroupNorm and BatchNorm reduce in float32, and the losses
read the head outputs as float32. The trainers get it from
``torch.autocast(dtype=bfloat16)`` around the forward, not from per-layer
casts: autocast casts each float32 weight to bf16 where a convolution uses
it (once per forward) and sends the gradient back to the float32 master,
which is flax's split, and it leaves the serving modules unchanged; the
serving pipeline's in-place bf16 weights would lose the master copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from handnet_tpu_torch.config import A2JConfig, FCOSConfig, TrainConfig
from handnet_tpu_torch.models.a2j import A2JSystem, a2j_postprocess
from handnet_tpu_torch.models.faster_rcnn import Dropout, FasterRCNNFPN, rcnn_loss, rpn_loss
from handnet_tpu_torch.models.fcos import FCOSSystem, fcos_loss
from handnet_tpu_torch.nn.resnet import BatchNorm2d, make_norm
from handnet_tpu_torch.parallel.mesh import DataMesh, reduce_mean, replicate
from handnet_tpu_torch.train.schedules import Schedule, multistep_with_warmup, step_decay


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the learning-rate schedule; ``step``
    counts the updates made, as ``TrainState.step`` does in the JAX
    package."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    # the model's DistributedDataParallel wrapper under a mesh
    wrapped: Optional[nn.Module] = None

    @property
    def forward_module(self) -> nn.Module:
        """What a train step calls: the DDP wrapper, else the model."""
        return self.model if self.wrapped is None else self.wrapped

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

    def update(self, total: torch.Tensor) -> None:
        """Back-propagate ``total`` into fresh gradients and apply them.
        optax moves every parameter (the decay at least), and torch's
        optimizers skip one whose grad is None, so such a parameter gets a
        zero gradient (under DDP too, which leaves the grad of a parameter
        that no rank used None)."""
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.apply_gradients()


def data_parallel(model: nn.Module, mesh: Optional[DataMesh]) -> Optional[nn.Module]:
    """Under a mesh: hand the mesh to the model's BatchNorms and dropouts,
    broadcast rank 0's parameters and buffers (``replicate``; DDP's own
    broadcast at construction would skip the buffers), and wrap the model
    in ``DistributedDataParallel``; None without a mesh."""
    if mesh is None:
        return None
    for m in model.modules():
        if isinstance(m, (BatchNorm2d, Dropout)):
            m.mesh = mesh
    replicate(mesh, model)
    device = mesh.device
    return nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=mesh.group, broadcast_buffers=False, init_sync=False)


def touch_outputs(total: torch.Tensor, outputs: Dict[str, torch.Tensor],
                  mesh: Optional[DataMesh]) -> torch.Tensor:
    """Under a mesh, ``total`` plus zero times every output that carries a
    gradient, so that every parameter gets one: DDP's reducer waits for all
    of them at each step. A detector's loss leaves its extension heads out
    where the targets have no ``box_info`` (FCOS's ``hand_lr_layer``,
    ``hand_contact_state_layer`` and ``hand_dydx_layer``; the R-CNN
    predictor's ``hand_lr_layer``, ``hand_contact_state_layer`` and
    ``hand_dydx_layer``); their zero gradients are what
    :meth:`TrainState.update` gives them without a mesh.
    ``find_unused_parameters`` cannot see them (their outputs are among the
    forward's) and a static graph does not keep them apart. A2J's loss uses
    every output. Without a mesh, ``total``."""
    if mesh is None:
        return total
    return total + sum(v.float().sum() * 0.0 for v in outputs.values() if v.requires_grad)


def global_metrics(losses: Dict[str, torch.Tensor], mesh: Optional[DataMesh]
                   ) -> Dict[str, torch.Tensor]:
    """The losses detached; under a mesh the ranks' mean of each, which is
    the whole-batch loss."""
    return dict(zip(losses, reduce_mean(list(losses.values()), mesh)))


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


def resolve_device(name: str, device, mesh: Optional[DataMesh] = None) -> torch.device:
    """The training entry points' device: None means the card, and raises
    where there is none instead of training on the CPU. Under a ``mesh`` it
    is the mesh's device; the mesh must be a rank of a process group
    (``init_data_parallel``), and ``device``, if given, of its type."""
    if mesh is not None:
        if not isinstance(mesh, DataMesh):
            raise TypeError(f"{name}: mesh is a parallel.DataMesh, not {type(mesh).__name__}")
        if mesh.group is None or len(mesh.devices) != 1:
            raise ValueError(f"{name}: a training mesh is one rank of a process group driving "
                             "one device (init_data_parallel, under torchrun); create_mesh's "
                             "one-process meshes serve")
        if device is not None and torch.device(device).type != mesh.device.type:
            raise ValueError(f"{name}: device {device!r} is not the mesh's {mesh.device}")
        return mesh.device
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{name}: no CUDA device (torch.cuda.is_available() is False). "
                "It trains on the card by default; pass device=\"cpu\" to train on "
                "the CPU.")
        device = "cuda"
    return torch.device(device)


def _check_norm(name: str, norm: str, mesh: Optional[DataMesh]) -> None:
    make_norm(norm)   # raises for a norm the port has not
    if norm == "batch_sync" and mesh is None:
        raise ValueError(f"{name}: backbone_norm 'batch_sync' takes its statistics over a "
                         "data mesh: pass mesh=, or use 'batch' (the JAX package's batch_sync "
                         "fails under its trainers' jit: unbound axis name 'data')")


class A2JTrainer:
    """A2J training: AdamW lr 3.5e-4, wd 1e-4, StepLR 0.2 every 10 epochs,
    batch 64 (config/a2j.yaml:8-30); loss = cls + 3 * reg
    (a2j/a2j.py:224-238; ``handnet_tpu/train/trainer.py:68-156``).

    The model is ``A2JSystem(norm="batch")``: the backbone's and the three
    towers' BatchNorms take the batch's statistics in the train step and
    the running ones in the eval step (over the global batch under a
    ``mesh``, see the module's docstring). ``quant`` is serving-only and
    forced off, as in the JAX package. The 2D A2J (``is_3d=False``) trains without the
    depth term, as JAX's does; its eval step is JAX's, see :meth:`eval_step`.

    ``device``: None (the default) is the card and raises where there is
    none; pass ``"cpu"`` to train there. The batch must be on that device:
    ``{"image": [B, H, W, C] depth crops (metres), "jt_uvd": [B, P, 3]}``
    float32.

    Under bf16 the forward runs in the autocast region and the loss outside
    it (:func:`a2j_loss` also turns autocast off itself): its einsums are
    matrix products, which autocast would lower to bf16.
    """

    def __init__(self, model_cfg: Optional[A2JConfig] = None,
                 train_cfg: Optional[TrainConfig] = None, mesh=None,
                 steps_per_epoch: int = 1000, device=None):
        self.device = resolve_device("A2JTrainer", device, mesh)
        self.mesh = mesh
        # int8 is a serving-only path: round() has no useful gradient
        self.model_cfg = dataclasses.replace(model_cfg or A2JConfig(), quant=False)
        self.train_cfg = train_cfg or TrainConfig()
        self.schedule = step_decay(self.train_cfg.lr, steps_per_epoch, self.train_cfg.lr_step,
                                   self.train_cfg.lr_gamma)

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.train_cfg.bf16)

    def init_state(self, seed: int) -> TrainState:
        """An A2J with seeded random weights (``A2J.init_weights_``) and
        batch-norm layers on the trainer's device, channels_last, and a
        fresh optimizer."""
        model = A2JSystem(self.model_cfg, norm="batch")
        model.init_weights_(torch.Generator().manual_seed(seed))
        model.to(self.device, memory_format=torch.channels_last)
        return TrainState(0, model, make_optimizer(self.train_cfg, model.parameters()),
                          self.schedule, data_parallel(model, self.mesh))

    def train_step(self, state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update on ``batch``. Returns ``state`` (updated in place) and
        the ``classification``, ``regression`` (times ``reg_loss_factor``)
        and ``total_loss`` entries, detached."""
        model = state.model.train()
        with self._autocast():
            heads = state.forward_module(batch["image"])
        losses = model.losses(heads, batch["jt_uvd"], self.model_cfg.reg_loss_factor)
        state.update(losses["total_loss"])
        return state, global_metrics(losses, self.mesh)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval-mode forward (running statistics), the decode through K1
        (K1xy for the 2D A2J; the plain versions where
        ``state.model.use_kernels`` is False, or on the CPU), and ``rmse =
        sqrt(mean((jt_uvd - pred)^2))`` over u, v and d together, as the JAX
        package mixes them. Returns ``(pred [B, P, 3] float32, rmse)``, or
        ``pred [B, P, 2]`` for the 2D A2J; the decode runs outside the
        autocast region.

        The 2D A2J's ``[B, P, 2]`` prediction against the ``[B, P, 3]``
        targets of the A2J data path raises ``ValueError``: JAX's eval step
        (``handnet_tpu/train/trainer.py:147``) subtracts the two and fails
        to broadcast them. ``[B, P, 2]`` targets give the RMSE over u and v,
        as JAX's does."""
        model = state.model.eval()
        with self._autocast():
            heads = model(batch["image"])
        pred = a2j_postprocess(heads, model.anchors, use_kernel=model.use_kernels)
        target = batch["jt_uvd"]
        if target.shape != pred.shape:
            raise ValueError(
                f"A2JTrainer.eval_step: jt_uvd {tuple(target.shape)} against the decoded "
                f"{tuple(pred.shape)} (is_3d={self.model_cfg.is_3d}); the JAX package's eval "
                "step fails the same way: its 2D A2J decodes (u, v) only, which does not "
                "broadcast against (u, v, d) targets")
        return pred, torch.sqrt(torch.mean((target - pred) ** 2))


class FCOSTrainer:
    """FCOS training: SGD or AdamW, MultiStepLR with a one-epoch linear
    warmup, the loss dict summed (reference trainval_net_fcos.py:55-77,
    195-204; ``handnet_tpu/train/trainer.py:159-254``).

    ``backbone_norm``: ``"frozen"`` (the reference's fine-tuning recipe from
    pretrained weights: fixed statistics, trainable affine), ``"batch"``
    (training from scratch, the training CLI's default) or ``"group"``
    (flax's GroupNorm(32), eps 1e-6: its 36 layers run K2s and K2a in the
    forward, as the head's 24 do, and their registered plain gradients in
    the backward). Only a ``"batch"`` backbone runs its forward in training
    mode; a GroupNorm normalizes alike in either. ``"batch_sync"`` is
    ``"batch"`` under a ``mesh`` (global statistics either way, see the
    module's docstring) and raises ``ValueError`` without one. int8
    (``quant``) and
    ``gn_fast_variance`` are serving-only and forced off, as in the JAX
    package; the fused-tower head is refused (``ValueError``), since the JAX
    package's fused GroupNorm normalizes over other axes.

    ``device``: None (the default) is the card and raises where there is
    none; pass ``"cpu"`` to train there. The batch must be on that device.

    Under bf16 autocast also runs a few reductions in float32 where flax
    stays in bf16 (the ``hand_dxdy`` head's norm). The loss runs inside the
    autocast region: it has no op that autocast lowers, and it reads the
    head outputs as float32.
    """

    def __init__(self, model_cfg: Optional[FCOSConfig] = None,
                 train_cfg: Optional[TrainConfig] = None, mesh=None,
                 steps_per_epoch: int = 1000,
                 milestones_epochs: Sequence[int] = (20, 35),
                 backbone_norm: str = "frozen", device=None):
        self.device = resolve_device("FCOSTrainer", device, mesh)
        _check_norm("FCOSTrainer", backbone_norm, mesh)
        self.mesh = mesh
        model_cfg = model_cfg or FCOSConfig()
        # serving-only, as in the JAX package: round() has no useful
        # gradient, and the E[x^2] - E[x]^2 variance NaNs gradients
        self.model_cfg = dataclasses.replace(model_cfg, quant=False, gn_fast_variance=False)
        self.train_cfg = train_cfg or TrainConfig()
        self.backbone_norm = backbone_norm
        self._norm_trains = backbone_norm in ("batch", "batch_sync")
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
                          self.schedule, data_parallel(model, self.mesh))

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
            head = state.forward_module(batch["image"])
            losses = fcos_loss(head, batch["targets"], model.anchors, model.anchor_sizes,
                               model.level_slices, model.cfg, self.mesh)
        total = sum(losses.values())
        state.update(touch_outputs(total, head, self.mesh))
        return state, global_metrics({**losses, "total_loss": total}, self.mesh)


class RCNNTrainer:
    """Faster R-CNN training (the reference's ``--net resXX`` alternative,
    trainval_net_fcos.py:184-187; ``handnet_tpu/train/trainer.py:257-353``):
    the RoI heads' and the RPN's losses summed in the JAX package's order,
    with :class:`FCOSTrainer`'s optimizer, schedule and refusals.

    The model is ``FasterRCNNFPN(backbone_norm=...)`` at ``model_cfg``'s
    classes and input size, always in training mode, as the JAX step
    applies it with ``train=True``: a ``"batch"`` backbone takes the batch's
    statistics, and the contact head's dropout draws from a
    ``torch.Generator`` seeded from ``(train_cfg.seed + 1, step)`` on the
    trainer's device (the JAX step folds the step into its PRNG key; the
    two draws cannot be equal).

    ``device``: None (the default) is the card and raises where there is
    none; pass ``"cpu"`` to train there. The batch is :class:`FCOSTrainer`'s.
    Under bf16 the forward runs in the autocast region and the losses
    outside it, as ``a2j_loss`` does: RoIAlign's taps are float32 there
    too, and the losses read the heads' outputs as float32.
    """

    def __init__(self, model_cfg: Optional[FCOSConfig] = None,
                 train_cfg: Optional[TrainConfig] = None, mesh=None,
                 steps_per_epoch: int = 1000,
                 milestones_epochs: Sequence[int] = (20, 35),
                 backbone_norm: str = "frozen", num_proposals: int = 128, device=None):
        self.device = resolve_device("RCNNTrainer", device, mesh)
        _check_norm("RCNNTrainer", backbone_norm, mesh)
        self.mesh = mesh
        self.model_cfg = model_cfg or FCOSConfig()
        self.train_cfg = train_cfg or TrainConfig()
        self.backbone_norm = backbone_norm
        self.num_proposals = num_proposals
        self.schedule = multistep_with_warmup(
            self.train_cfg.lr, steps_per_epoch, milestones_epochs,
            warmup_epochs=1.0 if self.train_cfg.warmup_epochs else 0.0)

    def init_state(self, seed: int) -> TrainState:
        """A detector with seeded random weights
        (``FasterRCNNFPN.init_weights_``) on the trainer's device,
        channels_last, and a fresh optimizer."""
        cfg = self.model_cfg
        model = FasterRCNNFPN(cfg.num_classes, cfg.image_h, cfg.image_w, self.num_proposals,
                              backbone_norm=self.backbone_norm)
        model.init_weights_(torch.Generator().manual_seed(seed))
        model.to(self.device, memory_format=torch.channels_last)
        return TrainState(0, model, make_optimizer(self.train_cfg, model.parameters()),
                          self.schedule, data_parallel(model, self.mesh))

    def dropout_generator(self, step: int) -> torch.Generator:
        """The contact head's dropout draws at ``step``."""
        return torch.Generator(self.device).manual_seed(
            ((self.train_cfg.seed + 1) << 32) + step)

    def train_step(self, state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update on ``batch`` = ``{"image": [B, H, W, 3] preprocessed
        frames, "targets": {"boxes", "labels", "valid"[, "box_info"]}}``.
        Returns ``state`` (updated in place) and the loss dict plus
        ``"total_loss"``, detached."""
        model = state.model.train()
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.train_cfg.bf16):
            out = state.forward_module(batch["image"], self.dropout_generator(state.step))
        losses = rcnn_loss(out, batch["targets"], self.model_cfg.num_classes, self.mesh)
        losses.update(rpn_loss(out, model.anchors, batch["targets"], self.mesh))
        total = sum(losses.values())
        state.update(touch_outputs(total, out, self.mesh))
        return state, global_metrics({**losses, "total_loss": total}, self.mesh)
