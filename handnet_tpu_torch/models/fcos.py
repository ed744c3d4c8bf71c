"""FCOS hand detector: the serving forward and the training loss.

Counterpart of ``handnet_tpu/models/fcos.py`` (``ConvTower``, ``FCOSHead``,
``FCOS``, ``preprocess``, ``decode_detections``, ``match_anchors``,
``fcos_loss``, ``FCOSSystem.detect`` and ``.loss``).
Parameter names follow the reference's torch state dict
(``backbone.body.*``, ``backbone.fpn.*``,
``head.{classification,regression}_head.*``), so the JAX package's
``convert_fcos`` reads them.

``cfg.quant`` makes the backbone's residual blocks, the FPN and the tower
convs int8 (``nn/quant.py``); the stem and the prediction convs stay float,
as in the JAX package. ``cfg.ext`` adds the 100DOH extension heads (contact
state, offset vector), ``cfg.s2d_stem`` the space-to-depth stem
(``nn/resnet.py`` ``StemConv``), and ``FCOSHead.fused_towers`` runs the two
towers as one grouped-conv tower. ``preprocess`` resizes frames of another
size than the network input (``ops/resize.py``). ``backbone_norm`` is the
backbone's norm (``nn/resnet.py`` ``make_norm``): ``"frozen"`` serves and
fine-tunes, ``"batch"`` trains from scratch, its statistics taken from
the batch in ``module.train()`` mode, and ``"group"`` (GroupNorm(32),
the same in train and eval) runs through K2s and K2a as the head's
GroupNorms do, ``use_kernels`` switching both.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from handnet_tpu_torch.config import FCOSConfig
from handnet_tpu_torch.nn.fpn import FPN
from handnet_tpu_torch.nn.quant import conv_layer
from handnet_tpu_torch.nn.resnet import GroupNorm, group_norm_nchw, init_conv_weights_, resnet34
from handnet_tpu_torch.ops.anchors import fcos_anchor_pyramid
from handnet_tpu_torch.ops.boxes import giou_loss, linear_decode, linear_encode
from handnet_tpu_torch.ops.focal import bce_with_logits, sigmoid_focal_loss
from handnet_tpu_torch.ops.nms import batched_nms_fixed
from handnet_tpu_torch.ops.resize import resize_bilinear_matmul
from handnet_tpu_torch.parallel.mesh import DataMesh, all_reduce_sum, dp_scale


class ConvTower(nn.Sequential):
    """num_convs x (conv3x3 + GroupNorm(32) + ReLU), shared across FPN levels
    (reference fcos.py:235-240,355-360). The GroupNorm applies its ReLU
    itself; children keep the numbers of the reference's [Conv, GN, ReLU]
    triplets (``0, 1, 3, 4, ...``), so the state dict's keys are the
    reference's."""

    def __init__(self, channels: int, num_convs: int = 4, use_kernel: bool = True,
                 quant: Any = False):
        super().__init__()
        for i in range(num_convs):
            self.add_module(str(3 * i), conv_layer(quant, channels, channels, 3, padding=1))
            self.add_module(str(3 * i + 1),
                            GroupNorm(32, channels, relu=True, use_kernel=use_kernel))


def _flat(t: torch.Tensor, k: int) -> torch.Tensor:
    """NCHW head output -> ``[B, H*W, k]`` in the JAX (h, w) anchor order."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, k)


class FCOSHead(nn.Module):
    """Both towers and the output convs, shared across levels; returns flat
    ``[B, N, .]`` outputs concatenated over levels, with
    ``hand_contact_state`` and ``hand_dxdy`` when ``cfg.ext``.

    ``fused_towers`` (False by default, read at forward time, the
    counterpart of the JAX class attribute) runs the cls and reg towers as
    one tower of twice the width: layer 1 is one conv with the two kernels'
    output channels concatenated, the later layers are 2-group convs, and
    each GroupNorm(32) pair is one GroupNorm of 64 groups. The concatenated
    parameters are built from the two towers' at every forward, so the
    parameters and state-dict keys are the same either way. Float towers
    only: with ``cfg.quant`` it raises, where the JAX package's fused head
    would serve its towers' float kernels.
    """

    def __init__(self, cfg: FCOSConfig, use_kernels: bool = True):
        super().__init__()
        c = cfg.fpn_channels
        self.num_classes = cfg.num_classes
        self.ext = cfg.ext
        self.quant = cfg.quant
        self.fused_towers = False
        cls_layers = {
            "conv": ConvTower(c, cfg.num_convs, use_kernels, cfg.quant),
            "cls_logits": nn.Conv2d(c, cfg.num_classes, 3, padding=1),
            "hand_lr_layer": nn.Conv2d(c, 2, 3, padding=1),
        }
        if cfg.ext:
            cls_layers["hand_contact_state_layer"] = nn.Conv2d(c, 5, 3, padding=1)
            cls_layers["hand_dydx_layer"] = nn.Conv2d(c, 3, 3, padding=1)
        self.classification_head = nn.ModuleDict(cls_layers)
        self.regression_head = nn.ModuleDict({
            "conv": ConvTower(c, cfg.num_convs, use_kernels, cfg.quant),
            "bbox_reg": nn.Conv2d(c, 4, 3, padding=1),
            "bbox_ctrness": nn.Conv2d(c, 1, 3, padding=1),
        })
        self.prior_bias = -math.log((1.0 - cfg.prior_prob) / cfg.prior_prob)

    def _fused_layers(self) -> List[Tuple[torch.Tensor, ...]]:
        """Per tower layer: the concatenated conv weight and bias, GroupNorm
        scale and bias, and the GroupNorm module of the cls tower (for its
        eps and kernel switch)."""
        if self.quant:
            raise ValueError("FCOSHead: fused_towers runs float convs only; the towers "
                             f"are int8 (quant={self.quant!r})")
        cls_t, reg_t = self.classification_head["conv"], self.regression_head["conv"]
        layers = []
        for i in range(len(cls_t) // 2):   # children named by the triplets: 0, 1, 3, 4, ...
            conv_c, conv_r = getattr(cls_t, str(3 * i)), getattr(reg_t, str(3 * i))
            gn_c, gn_r = getattr(cls_t, str(3 * i + 1)), getattr(reg_t, str(3 * i + 1))
            layers.append((torch.cat([conv_c.weight, conv_r.weight]),
                           torch.cat([conv_c.bias, conv_r.bias]),
                           torch.cat([gn_c.weight, gn_r.weight]),
                           torch.cat([gn_c.bias, gn_r.bias]), gn_c))
        return layers

    @staticmethod
    def _fused_tower(f: torch.Tensor, layers) -> Tuple[torch.Tensor, torch.Tensor]:
        x = f
        for i, (weight, bias, scale, gbias, gn) in enumerate(layers):
            x = F.conv2d(x, weight, bias, padding=1, groups=1 if i == 0 else 2)
            # 2 x 32 groups of C/32 channels: the two towers' GroupNorms
            x = group_norm_nchw(x, scale, gbias, 2 * gn.num_groups, gn.eps, True,
                                gn.use_kernel)
        c = x.shape[1] // 2
        return x[:, :c], x[:, c:]

    def forward(self, features: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        cls_h, reg_h = self.classification_head, self.regression_head
        keys = ["cls_logits", "hand_lr", "bbox_regression", "bbox_ctrness"]
        if self.ext:
            keys[2:2] = ["hand_contact_state", "hand_dxdy"]
        outs: Dict[str, list] = {k: [] for k in keys}
        fused = self._fused_layers() if self.fused_towers else None
        for f in features:
            if fused is None:
                cls_t, reg_t = cls_h["conv"](f), reg_h["conv"](f)
            else:
                cls_t, reg_t = self._fused_tower(f, fused)
            outs["cls_logits"].append(_flat(cls_h["cls_logits"](cls_t), self.num_classes))
            outs["hand_lr"].append(_flat(cls_h["hand_lr_layer"](cls_t), 2))
            if self.ext:
                outs["hand_contact_state"].append(
                    _flat(cls_h["hand_contact_state_layer"](cls_t), 5))
                # relu, then the (dx, dy) pair L2-normalized and scaled by 0.1
                # with the magnitude channel kept raw (reference fcos.py:301-303)
                dxdy = F.relu(cls_h["hand_dydx_layer"](cls_t))
                mag, vec = dxdy[:, :1], dxdy[:, 1:]
                norm = torch.sqrt(vec.square().sum(dim=1, keepdim=True) + 1e-12)
                outs["hand_dxdy"].append(_flat(torch.cat([mag, 0.1 * vec / norm], dim=1), 3))
            # relu on box regression (reference fcos.py:379)
            outs["bbox_regression"].append(_flat(F.relu(reg_h["bbox_reg"](reg_t)), 4))
            outs["bbox_ctrness"].append(_flat(reg_h["bbox_ctrness"](reg_t), 1))
        return {k: torch.cat(v, dim=1) for k, v in outs.items()}


class FCOS(nn.Module):
    """ResNet-34 + FPN + head. ``forward`` takes preprocessed NHWC frames
    and returns the raw flat head outputs."""

    def __init__(self, cfg: Optional[FCOSConfig] = None, use_kernels: bool = True,
                 backbone_norm: str = "frozen"):
        super().__init__()
        cfg = cfg or FCOSConfig()
        if cfg.backbone != "resnet34":
            raise NotImplementedError(f"FCOS: backbone {cfg.backbone!r}")
        self.cfg = cfg
        self.backbone = nn.ModuleDict({
            "body": resnet34(quant=cfg.quant, s2d_stem=cfg.s2d_stem, norm=backbone_norm,
                             use_kernels=use_kernels),
            "fpn": FPN((128, 256, 512), cfg.fpn_channels, quant=cfg.quant),
        })
        self.head = FCOSHead(cfg, use_kernels)

    def init_weights_(self, generator: torch.Generator) -> None:
        """Seeded random init (conv kernels LeCun-normal, cls prior bias)."""
        init_conv_weights_(self, generator)
        with torch.no_grad():
            self.head.classification_head["cls_logits"].bias.fill_(self.head.prior_bias)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: ``[B, H, W, 3]`` already normalized (see :func:`preprocess`)."""
        body = self.backbone["body"]
        x = images.permute(0, 3, 1, 2).to(body.conv1.weight.dtype)
        feats = body(x.contiguous(memory_format=torch.channels_last))
        pyramid = self.backbone["fpn"]([feats["c3"], feats["c4"], feats["c5"]])
        return self.head(pyramid)


def preprocess(images: torch.Tensor, cfg: FCOSConfig, mean: Optional[torch.Tensor] = None,
               std: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Tuple[float, float]]:
    """Normalize RGB ``[B, H, W, 3]`` frames (0-1 float, or uint8) for the
    detector, resize them aspect-preserving to fit ``image_h x image_w``
    and pad them bottom/right to that size.

    ``mean`` and ``std`` are ``cfg.image_mean``/``image_std`` as float32
    tensors on the frames' device (``FCOSSystem``'s buffers); None builds
    them from ``cfg``, a host-to-device copy at every call, which a CUDA
    graph cannot capture.

    Frames that need no resample are only normalized and padded. Others are
    normalized, then resized with the pad fused in (``ops/resize.py``): the
    weight rows sum to 1 inside the resized region, so normalizing first
    commutes with the resize there, and to 0 in the pad, which stays exactly
    zero. Returns the network input (float32) and the (scale_y, scale_x)
    from frame to network pixels.
    """
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    _, h, w, _ = images.shape
    scale = min(cfg.image_h / h, cfg.image_w / w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    if mean is None or std is None:
        mean, std = (torch.tensor(v, dtype=torch.float32, device=images.device)
                     for v in (cfg.image_mean, cfg.image_std))
    normalized = (images - mean.to(images.dtype)) / std.to(images.dtype)
    if (new_h, new_w) != (h, w):
        normalized = resize_bilinear_matmul(normalized, new_h, new_w,
                                            padded_hw=(cfg.image_h, cfg.image_w))
    elif (h, w) != (cfg.image_h, cfg.image_w):
        normalized = F.pad(normalized, (0, 0, 0, cfg.image_w - w, 0, cfg.image_h - h))
    return normalized, (new_h / h, new_w / w)


def anchors_for(cfg: FCOSConfig):
    """``(anchors [N, 4], anchor_sizes [N], level_slices)`` as numpy."""
    return fcos_anchor_pyramid(cfg.image_h, cfg.image_w, cfg.strides)


def decode_detections(head: Dict[str, torch.Tensor], anchors: torch.Tensor,
                      cfg: FCOSConfig, scale_to_original=None
                      ) -> Dict[str, torch.Tensor]:
    """Fixed-shape detection decode (reference fcos.py:572-659).

    Returns ``[B, K]`` tensors (K = cfg.max_detections): boxes ``[B, K, 4]``,
    scores, labels, sides, valid, and with the extension heads contacts and
    dxdymags ``[B, K, 3]``. Invalid slots have score 0 and valid False.
    Candidates are ranked by a stable descending sort, so equal scores keep
    index order as ``jax.lax.top_k`` does.
    """
    k = cfg.max_detections
    cls_logits = head["cls_logits"].float()
    ctrness = head["bbox_ctrness"].float()
    reg = head["bbox_regression"].float()

    # score = sqrt(sigmoid(cls) * sigmoid(ctr)) (fcos.py:598)
    scores = torch.sqrt(torch.sigmoid(cls_logits) * torch.sigmoid(ctrness))
    scores_max = scores.amax(dim=-1)                       # [B, N]
    labels_max = scores.argmax(dim=-1)                     # [B, N]
    mask = scores_max > cfg.score_thresh                   # hard 0.7 (fcos.py:600)

    boxes = linear_decode(reg, anchors[None])              # [B, N, 4]

    masked = torch.where(mask, scores_max, torch.zeros_like(scores_max))
    ranked = torch.sort(masked, dim=1, descending=True, stable=True)
    top_scores = ranked.values[:, :k]                      # [B, K]
    top_idx = ranked.indices[:, :k]
    top_boxes = boxes.gather(1, top_idx[..., None].expand(-1, -1, 4))
    top_labels = labels_max.gather(1, top_idx)
    valid = top_scores > cfg.score_thresh

    keep = batched_nms_fixed(top_boxes, top_scores, top_labels, valid,
                             cfg.post_nms_thresh)
    sides = torch.sigmoid(head["hand_lr"].float()).argmax(dim=-1)
    out = {
        "boxes": top_boxes,
        "scores": torch.where(keep, top_scores, torch.zeros_like(top_scores)),
        "labels": top_labels,
        "sides": sides.gather(1, top_idx),
        "valid": keep,
    }
    if "hand_contact_state" in head:
        contacts = torch.sigmoid(head["hand_contact_state"].float()).argmax(dim=-1)
        out["contacts"] = contacts.gather(1, top_idx)
        out["dxdymags"] = head["hand_dxdy"].float().gather(
            1, top_idx[..., None].expand(-1, -1, 3))
    if scale_to_original is not None:
        # times [1/sx, 1/sy, 1/sx, 1/sy] in float32, one scalar per column:
        # the same bits as a product with that vector, with no vector to
        # copy to the device
        sy, sx = scale_to_original
        out["boxes"] = torch.stack([c * (1 / s) for c, s in
                                    zip(out["boxes"].unbind(-1), (sx, sy, sx, sy))], dim=-1)
    return out


def _one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot with ``jax.nn.one_hot``'s meaning: a label outside
    ``[0, n)`` (the padding's -1) gives a row of zeros."""
    return (labels[..., None] == torch.arange(n, device=labels.device)).float()


def _take_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values [B, M, ...]`` at ``idx [B, N]`` -> ``[B, N, ...]``."""
    return values[torch.arange(idx.shape[0], device=idx.device)[:, None], idx]


def match_anchors(anchors: torch.Tensor, anchor_sizes: torch.Tensor, level_slices,
                  gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                  center_sampling_radius: float = 1.5) -> torch.Tensor:
    """Center-sampling matcher (reference fcos.py:530-568;
    ``handnet_tpu/models/fcos.py:314``), batched: ``anchors [N, 4]`` and
    ``anchor_sizes [N]``, padded ``gt_boxes [B, M, 4]`` and ``gt_valid
    [B, M]`` -> the matched GT index per anchor ``[B, N]``, -1 for
    background.

    An anchor takes the GTs whose centre lies within ``radius * size`` of
    it, that contain its centre, and whose largest (l, t, r, b) distance
    falls in its level's range ``(4 size, 8 size)`` (open at the pyramid's
    ends); of those, the smallest area wins. The quality ``1e8 - area`` is
    float32, as in the JAX package: its ulp there is 8, so GTs whose areas
    differ by a few pixels tie, and the first of them wins (``argmax``'s
    first maximal index). Computing it in float64 would pick others.
    """
    n = anchors.shape[0]
    gt_centers = (gt_boxes[..., :2] + gt_boxes[..., 2:]) / 2                 # [B, M, 2]
    anchor_centers = (anchors[:, :2] + anchors[:, 2:]) / 2                   # [N, 2]
    dist = (anchor_centers[None, :, None, :] - gt_centers[:, None]).abs().amax(dim=-1)
    pairwise = dist < center_sampling_radius * anchor_sizes[:, None]         # [B, N, M]

    x = anchor_centers[None, :, 0:1]
    y = anchor_centers[None, :, 1:2]
    ltrb = torch.stack([x - gt_boxes[:, None, :, 0], y - gt_boxes[:, None, :, 1],
                        gt_boxes[:, None, :, 2] - x, gt_boxes[:, None, :, 3] - y],
                       dim=-1)                                               # [B, N, M, 4]
    pairwise &= ltrb.amin(dim=-1) > 0

    idx = torch.arange(n, device=anchors.device)
    lower = torch.where(idx < level_slices[0][1], 0.0, anchor_sizes * 4)
    upper = torch.where(idx >= level_slices[-1][0], math.inf, anchor_sizes * 8)
    max_dist = ltrb.amax(dim=-1)
    pairwise &= (max_dist > lower[:, None]) & (max_dist < upper[:, None])
    pairwise &= gt_valid[:, None, :]

    gt_areas = ((gt_boxes[..., 2] - gt_boxes[..., 0])
                * (gt_boxes[..., 3] - gt_boxes[..., 1])).float()
    quality = pairwise.float() * (1e8 - gt_areas[:, None, :])
    best, matched = quality.max(dim=-1)
    return torch.where(best < 1e-5, -1, matched)


def fcos_loss(head: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
              anchors: torch.Tensor, anchor_sizes: torch.Tensor, level_slices,
              cfg: FCOSConfig, mesh: Optional[DataMesh] = None) -> Dict[str, torch.Tensor]:
    """All FCOS losses (reference ``FCOSHead.compute_loss``, fcos.py:44-178;
    ``handnet_tpu/models/fcos.py:362``), in float32 whatever the head's dtype.

    ``targets`` are fixed-shape and padded: boxes ``[B, M, 4]``, labels
    ``[B, M]``, valid ``[B, M]`` bool and, for the extension heads, box_info
    ``[B, M, 5]`` = (contact state, hand side, magnitude, dx, dy). Every term
    is divided by the number of foreground anchors over the whole batch;
    ``hand_dxdy`` is a mean over all anchors before that division, as in the
    reference. Keys in the JAX package's order.

    Under a data ``mesh`` (a rank of ``DistributedDataParallel``, its shard
    of the batch) the number of foreground anchors is summed over the world
    before its clamp at 1, as it is a sum over the global batch under JAX's
    sharded ``jit``, and each term is this rank's share of the whole-batch
    loss in the form DDP's gradient average expects: the sums times the
    world size (:func:`~handnet_tpu_torch.parallel.mesh.dp_scale`),
    ``hand_dxdy``'s mean over equal shards as it is. The ranks' mean of each
    term is the whole-batch term.
    """
    cls_logits = head["cls_logits"].float()
    reg = head["bbox_regression"].float()
    ctrness = head["bbox_ctrness"].float()[..., 0]
    hand_lr = head["hand_lr"].float()

    matched = match_anchors(anchors, anchor_sizes, level_slices, targets["boxes"],
                            targets["valid"], cfg.center_sampling_radius)    # [B, N]
    fg = matched >= 0
    num_fg = all_reduce_sum(fg.sum(), mesh).clamp(min=1).float()
    scale = dp_scale(mesh)
    midx = matched.clamp(min=0)
    gt_boxes_at = _take_rows(targets["boxes"], midx)                         # [B, N, 4]
    fg_col = fg[..., None]

    cls_targets = _one_hot(_take_rows(targets["labels"], midx), cfg.num_classes) * fg_col
    loss_cls = sigmoid_focal_loss(cls_logits, cls_targets).sum()
    box_info = targets.get("box_info")
    if box_info is not None:
        side = _take_rows(box_info[..., 1], midx).to(torch.int32)
        loss_hand_lr = sigmoid_focal_loss(hand_lr, _one_hot(side, 2) * fg_col).sum() * 2e-2
    else:
        loss_hand_lr = torch.zeros((), device=cls_logits.device)

    giou = giou_loss(linear_decode(reg, anchors[None]), gt_boxes_at)
    loss_reg = torch.where(fg, giou, 0.0).sum()

    ltrb = linear_encode(anchors[None], gt_boxes_at)
    lr_, tb = ltrb[..., 0::2], ltrb[..., 1::2]

    def ratio(pair):
        top = pair.amax(dim=-1)
        return pair.amin(dim=-1) / torch.where(top == 0, 1.0, top)

    ctr_target = torch.sqrt((ratio(lr_) * ratio(tb)).abs())
    loss_ctr = torch.where(fg, bce_with_logits(ctrness, ctr_target), 0.0).sum()

    losses = {"classification": loss_cls * scale / num_fg,
              "bbox_regression": loss_reg * scale / num_fg,
              "bbox_ctrness": loss_ctr * scale / num_fg, "hand_lr": loss_hand_lr * scale / num_fg}
    if cfg.ext and "hand_contact_state" in head and box_info is not None:
        contact = _take_rows(box_info[..., 0], midx).to(torch.int32)
        losses["hand_contact_state"] = sigmoid_focal_loss(
            head["hand_contact_state"].float(), _one_hot(contact, 5) * fg_col
        ).sum() * 1e-2 * scale / num_fg
        gt_dxdy = _take_rows(box_info[..., 2:5], midx)
        losses["hand_dxdy"] = (head["hand_dxdy"].float() - gt_dxdy).square().mean() * 10.0 / num_fg
    return losses


class FCOSSystem(FCOS):
    """The FCOS module plus its anchor table and the ``detect`` and ``loss``
    entries.

    (The JAX package pairs a flax module with its anchors in a plain class;
    here the anchors, their sizes, and the normalization's mean and std are
    non-persistent buffers, so the state dict is FCOS's own.)
    """

    def __init__(self, cfg: Optional[FCOSConfig] = None, use_kernels: bool = True,
                 backbone_norm: str = "frozen"):
        super().__init__(cfg, use_kernels, backbone_norm)
        anchors, anchor_sizes, self.level_slices = anchors_for(self.cfg)
        self.register_buffer("anchors", torch.from_numpy(anchors), persistent=False)
        self.register_buffer("anchor_sizes", torch.from_numpy(anchor_sizes), persistent=False)
        for name, value in (("image_mean", self.cfg.image_mean),
                            ("image_std", self.cfg.image_std)):
            self.register_buffer(name, torch.tensor(value, dtype=torch.float32),
                                 persistent=False)

    def preprocess(self, images: torch.Tensor) -> Tuple[torch.Tensor, Tuple[float, float]]:
        """:func:`preprocess` with this detector's config and buffers."""
        return preprocess(images, self.cfg, self.image_mean, self.image_std)

    def detect(self, images_01: torch.Tensor) -> Dict[str, torch.Tensor]:
        """0-1 RGB frames ``[B, H, W, 3]`` -> padded detections in frame
        pixel coordinates."""
        net_in, scale = self.preprocess(images_01)
        head = self(net_in)
        return decode_detections(head, self.anchors, self.cfg,
                                 scale_to_original=scale)

    def loss(self, net_images: torch.Tensor,
             targets: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """:func:`fcos_loss` of this detector's forward on preprocessed frames,
        in the module's mode: ``train()`` takes a ``"batch"`` backbone's
        statistics from the batch and moves its running statistics."""
        return fcos_loss(self(net_images), targets, self.anchors, self.anchor_sizes,
                         self.level_slices, self.cfg)
