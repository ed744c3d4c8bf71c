"""Faster R-CNN + FPN, the alternative 100DOH detector: the forward, the
decode and the training losses.

Counterpart of ``handnet_tpu/models/faster_rcnn.py`` (``roi_align``,
``multiscale_roi_align``, ``RPNHead``, ``TwoMLPHead``,
``FastRCNNPredictor``, ``rpn_anchor_grid``, ``FasterRCNNFPN``,
``decode_rcnn_detections``, ``rcnn_loss``, ``rpn_loss``; ``propose``'s
ranking and NMS are :func:`select_proposals` here), whose reference
is fpn_utils/faster_rcnn_fpn.py:14-281 with the 100DOH extension heads.
Parameter names are the reference's torch state dict's
(``backbone.body.*``, ``backbone.fpn.{inner,layer}_blocks.{0..3}``,
``rpn.head.{conv,cls_logits,bbox_pred}``, ``roi_heads.box_head.{fc6,fc7}``,
``roi_heads.box_predictor.*``), so ``convert_faster_rcnn`` reads them.

Shapes stay fixed as in the JAX package: the RPN keeps ``2 k`` candidates
per image by objectness, one greedy NMS walks them, and exactly ``k =
num_proposals`` boxes come out with a validity mask. Rankings use a stable
descending sort, so equal scores keep index order as ``jax.lax.top_k``
does.

RoIAlign copies the JAX package's arithmetic, not torchvision's
``roi_align(aligned=False)``: every sample is shifted by -0.5, ``floor``
is clipped into the map and the weight into ``[0, 1]``, no roi size is
clamped and no tap outside the map is zeroed. The taps' weights are
float32, so the pooled features are float32 whatever the pyramid's dtype.
:func:`multiscale_roi_align` gathers each roi at its own level only (the
JAX package pools every roi at every level and then selects one): the
same float32 operations in the same order, on a quarter of the gathers.

The GroupNorm backbone (``backbone_norm="group"``) runs kernels K2s and
K2a, 36 launches of each per forward on the card; everything else here is
PyTorch (gathers, sorts, cuBLAS products). Tensors are NCHW in
channels_last memory, as in ``nn/resnet.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from handnet_tpu_torch.config import FCOSConfig
from handnet_tpu_torch.models.fcos import _flat, preprocess
from handnet_tpu_torch.models.fcos import _take_rows as _take
from handnet_tpu_torch.nn.fpn import FPN
from handnet_tpu_torch.nn.resnet import init_conv_weights_, resnet34
from handnet_tpu_torch.ops.boxes import box_iou, clip_boxes, delta_decode, delta_encode
from handnet_tpu_torch.ops.focal import bce_with_logits, smooth_l1
from handnet_tpu_torch.ops.nms import batched_nms_fixed, nms_fixed, topk_candidates
from handnet_tpu_torch.parallel.mesh import DataMesh, all_reduce_sum, dp_scale

ROI_SIZE = 7


# ---------------------------------------------------------------------------
# RoIAlign (gather-based bilinear, 2 x 2 taps per bin).


def _taps(base: torch.Tensor, h: torch.Tensor, w: torch.Tensor, rois: torch.Tensor,
          scale: torch.Tensor, out_size: int, sampling: int):
    """RoIAlign's bilinear taps of ``rois [N, 4]`` (image pixels, ``scale``
    [N] to their map), each roi on its own ``h [N] x w [N]`` map whose rows
    start at ``base [N]`` in a table of NHWC rows: per corner (y0x0, y0x1,
    y1x0, y1x1), the table rows ``[N, S, S, s, s]`` and the float32 weights
    ``[N, S, S, s, s, 1]``."""
    x1, y1 = rois[:, 0] * scale, rois[:, 1] * scale
    x2, y2 = rois[:, 2] * scale, rois[:, 3] * scale
    bin_w = (x2 - x1) / out_size
    bin_h = (y2 - y1) / out_size
    dev = rois.device
    offs = (torch.arange(sampling, dtype=torch.float32, device=dev) + 0.5) / sampling
    grid = torch.arange(out_size, dtype=torch.float32, device=dev)
    steps = grid[None, :, None] + offs[None, None, :]              # [1, S, s]
    xs = x1[:, None, None] + steps * bin_w[:, None, None]          # [N, S, s]
    ys = y1[:, None, None] + steps * bin_h[:, None, None]
    xs = xs - 0.5   # the JAX package's centre convention
    ys = ys - 0.5
    n = rois.shape[0]
    full = (n, out_size, out_size, sampling, sampling)
    yy = ys[:, :, None, :, None].expand(full)
    xx = xs[:, None, :, None, :].expand(full)
    hm = (h - 1).to(torch.float32).view(n, 1, 1, 1, 1)
    wm = (w - 1).to(torch.float32).view(n, 1, 1, 1, 1)
    y0 = torch.minimum(torch.floor(yy).clamp(min=0), hm)
    x0 = torch.minimum(torch.floor(xx).clamp(min=0), wm)
    y1i = torch.minimum((y0 + 1).clamp(min=0), hm).long()
    x1i = torch.minimum((x0 + 1).clamp(min=0), wm).long()
    wy = (yy - y0).clamp(0, 1)[..., None]
    wx = (xx - x0).clamp(0, 1)[..., None]
    y0, x0 = y0.long(), x0.long()
    row = base.view(n, 1, 1, 1, 1)
    wl = w.view(n, 1, 1, 1, 1)
    return ((row + y0 * wl + x0, (1 - wy) * (1 - wx)), (row + y0 * wl + x1i, (1 - wy) * wx),
            (row + y1i * wl + x0, wy * (1 - wx)), (row + y1i * wl + x1i, wy * wx))


def _pool(flat: torch.Tensor, base: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
          rois: torch.Tensor, scale: torch.Tensor, out_size: int,
          sampling: int) -> torch.Tensor:
    """The taps of :func:`_taps` read from ``flat [M, C]`` and averaged per
    bin: ``[N, S, S, C]`` float32, the JAX package's sum in its order."""
    (i00, w00), (i01, w01), (i10, w10), (i11, w11) = _taps(base, h, w, rois, scale,
                                                           out_size, sampling)

    def tap(idx):
        return flat.index_select(0, idx.reshape(-1)).view(*idx.shape, -1)

    vals = w00 * tap(i00) + w01 * tap(i01) + w10 * tap(i10) + w11 * tap(i11)
    return vals.mean(dim=(3, 4))


def _nhwc_rows(feat: torch.Tensor) -> torch.Tensor:
    """NCHW ``[B, C, H, W]`` -> its NHWC rows ``[B*H*W, C]`` (a view of a
    channels_last tensor)."""
    return feat.permute(0, 2, 3, 1).reshape(-1, feat.shape[1])


def roi_align(features: torch.Tensor, rois: torch.Tensor, out_size: int,
              spatial_scale: float, sampling: int = 2) -> torch.Tensor:
    """``features [B, C, H, W]``, ``rois [B, R, 4]`` xyxy in image pixels ->
    ``[B, R, S, S, C]`` float32: ``sampling^2`` bilinear taps averaged per
    output bin, with the JAX package's convention (module docstring)."""
    b, c, h, w = features.shape
    r = rois.shape[1]
    dev = rois.device
    base = (torch.arange(b, device=dev) * (h * w)).repeat_interleave(r)
    n = b * r
    hs = torch.full((n,), h, device=dev)
    ws = torch.full((n,), w, device=dev)
    scale = torch.full((n,), spatial_scale, dtype=torch.float32, device=dev)
    out = _pool(_nhwc_rows(features), base, hs, ws, rois.reshape(n, 4), scale,
                out_size, sampling)
    return out.view(b, r, out_size, out_size, c)


def roi_levels(rois: torch.Tensor, num_levels: int, k_min: int,
               canonical_level: int = 4, canonical_scale: float = 224.0) -> torch.Tensor:
    """FPN level of each roi, 0-based (torchvision LevelMapper: a
    ``canonical_scale``-sized roi maps to level ``canonical_level``,
    ``k = floor(k0 + log2(sqrt(wh) / 224))``, clamped to the levels), with
    the JAX package's ``maximum(w h, 1e-6)`` and ``+1e-6``; ``log2`` is
    ``log(x) / log(2)`` in float32, as ``jnp.log2`` computes it."""
    w = rois[..., 2] - rois[..., 0]
    h = rois[..., 3] - rois[..., 1]
    scale = torch.sqrt((w * h).clamp(min=1e-6))
    log2 = torch.log(scale / canonical_scale + 1e-6) / np.float32(math.log(2.0))
    lvl = torch.floor(canonical_level + log2) - k_min
    return lvl.clamp(0, num_levels - 1).long()


def multiscale_roi_align(pyramid: Sequence[torch.Tensor], rois: torch.Tensor,
                         out_size: int, strides: Sequence[int],
                         canonical_level: int = 4,
                         canonical_scale: float = 224.0) -> torch.Tensor:
    """RoIAlign of ``rois [B, R, 4]`` over the FPN levels ``pyramid``
    (``[B, C, H_l, W_l]`` each, ``strides`` their strides), each roi at the
    level :func:`roi_levels` assigns it -> ``[B, R, S, S, C]`` float32.

    The levels' NHWC rows are concatenated into one table, and each roi's
    taps index its own level's rows: the values and the gradient of the JAX
    package's all-levels pooling and ``take_along_axis``, without its
    other three levels' gathers."""
    b, r = rois.shape[:2]
    c = pyramid[0].shape[1]
    base, hs, ws, scale = level_geometry(pyramid, rois, strides, canonical_level,
                                         canonical_scale)
    flat = torch.cat([_nhwc_rows(p) for p in pyramid])
    out = _pool(flat, base, hs, ws, rois.reshape(-1, 4), scale, out_size, 2)
    return out.view(b, r, out_size, out_size, c)


def level_geometry(pyramid: Sequence[torch.Tensor], rois: torch.Tensor, strides: Sequence[int],
                   canonical_level: int = 4, canonical_scale: float = 224.0):
    """Each roi's map in the table of the levels' concatenated NHWC rows:
    ``(first row, height, width, scale)``, each ``[B*R]``."""
    b, r = rois.shape[:2]
    dev = rois.device
    lvl = roi_levels(rois, len(pyramid), int(np.log2(strides[0])), canonical_level,
                     canonical_scale).reshape(-1)
    sizes = [(p.shape[2], p.shape[3]) for p in pyramid]
    starts = np.cumsum([0] + [b * h * w for h, w in sizes[:-1]])

    def table(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=dev)[lvl]

    hs = table([h for h, _ in sizes], torch.long)
    ws = table([w for _, w in sizes], torch.long)
    image = torch.arange(b, device=dev).repeat_interleave(r)
    base = table(list(starts), torch.long) + image * hs * ws
    return base, hs, ws, table([1.0 / s for s in strides], torch.float32)


# ---------------------------------------------------------------------------
# Modules.


class RPNHead(nn.Module):
    """3x3 conv + ReLU shared over levels, then per-anchor objectness and
    box deltas (torchvision ``RPNHead``). Returns ``[B, N]`` and
    ``[B, N, 4]`` concatenated over the levels."""

    def __init__(self, channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, features: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        obj, reg = [], []
        for f in features:
            t = F.relu(self.conv(f))
            obj.append(_flat(self.cls_logits(t), 1)[..., 0])
            reg.append(_flat(self.bbox_pred(t), 4))
        return torch.cat(obj, 1), torch.cat(reg, 1)


class TwoMLPHead(nn.Module):
    """flatten -> fc6 -> ReLU -> fc7 -> ReLU (fpn_utils/faster_rcnn_fpn.py:
    193-214). Takes pooled rois ``[N, S, S, C]`` and flattens them ``[C, S,
    S]``-major, the reference's order (the JAX package flattens ``[S, S,
    C]``; its converter permutes fc6's rows)."""

    def __init__(self, in_features: int, representation: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(in_features, representation)
        self.fc7 = nn.Linear(representation, representation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # float32 pooled rois in the weights' dtype, as flax's Dense casts
        # them (autocast casts a float32 weight's product itself)
        x = x.permute(0, 3, 1, 2).flatten(1).to(self.fc6.weight.dtype)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in training, ``where(keep, x / keep_prob, 0)``
    with ``keep`` drawn from ``generator`` (the default generator where
    None); the identity in eval mode.

    ``mesh`` (set by a data-parallel trainer): ``x`` is this rank's block of
    the global batch's rows, and ``keep`` is that block of the global draw,
    as JAX draws the mask of the sharded array: every rank draws the whole
    mask from the same generator state and keeps its rows."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.mesh = None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        world, rank = ((1, 0) if self.mesh is None
                       else (self.mesh.world_size, self.mesh.rank))
        n = x.shape[0]
        draw = torch.rand((world * n, *x.shape[1:]), generator=generator, device=x.device)
        keep = draw[rank * n:(rank + 1) * n] < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class FastRCNNPredictor(nn.Module):
    """Class scores, box deltas and the 100DOH extension heads, as the
    reference's ``FastRCNNPredictor.forward`` (faster_rcnn_fpn.py:227-282):

    * ``hand_contact_state_layer``: Linear(->32), ReLU, Dropout(0.5),
      Linear(->5C) (children 0-3, as in the reference's ``Sequential``);
    * ``hand_dydx_layer``: Linear(->3C) whose flat tail ``[:, 1:]`` (every
      class's values together) is L2-normalized in float32 (``+1e-24``
      under the sqrt, ``max(., 1e-12)``) and scaled by 0.1, column 0 raw;
    * ``hand_lr_layer``: Linear(->C), per-class hand-side logits.
    """

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        c = num_classes
        self.cls_score = nn.Linear(in_features, c)
        self.bbox_pred = nn.Linear(in_features, c * 4)
        self.hand_contact_state_layer = nn.Sequential(
            nn.Linear(in_features, 32), nn.ReLU(), Dropout(0.5), nn.Linear(32, c * 5))
        self.hand_dydx_layer = nn.Linear(in_features, c * 3)
        self.hand_lr_layer = nn.Linear(in_features, c)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        fc1, relu, dropout, fc2 = self.hand_contact_state_layer
        contact = fc2(dropout(relu(fc1(x)), generator))
        dxdy_raw = self.hand_dydx_layer(x).float()
        tail = dxdy_raw[:, 1:]
        norm = torch.sqrt((tail * tail).sum(dim=-1, keepdim=True) + 1e-24).clamp(min=1e-12)
        dxdy = torch.cat([dxdy_raw[:, :1], 0.1 * tail / norm], dim=1)
        return {"scores": self.cls_score(x), "deltas": self.bbox_pred(x), "contact": contact,
                "dxdy": dxdy, "side": self.hand_lr_layer(x)}


def rpn_anchor_grid(image_h: int, image_w: int, strides, sizes,
                    aspect_ratios) -> np.ndarray:
    """torchvision's RPN anchor table (the reference's
    fcos_utils/anchor_utils.py:56-114), numpy, a copy of the JAX package's:
    per location the base anchors are ratio-major with half-extents
    ROUNDED, on the stride grid's corners; the pool level's grid is the
    ceil-half of the last conv level's, its stride ``image // grid``.
    Returns the level-concatenated ``[N, 4]`` float32 table."""
    grids = []
    for stride in strides[:-1]:
        grids.append((image_h // stride, image_w // stride, stride, stride))
    gh, gw = (grids[-1][0] + 1) // 2, (grids[-1][1] + 1) // 2
    grids.append((gh, gw, image_h // gh, image_w // gw))

    all_anchors = []
    for (gh, gw, sh, sw), size in zip(grids, sizes):
        hs = np.array([size * np.sqrt(ar) for ar in aspect_ratios])
        ws = np.array([size / np.sqrt(ar) for ar in aspect_ratios])
        base = np.round(np.stack([-ws, -hs, ws, hs], axis=1) / 2.0)
        sx = np.arange(gw, dtype=np.float32) * sw
        sy = np.arange(gh, dtype=np.float32) * sh
        shift_x, shift_y = np.meshgrid(sx, sy)
        shifts = np.stack([shift_x, shift_y, shift_x, shift_y], axis=-1).reshape(-1, 1, 4)
        all_anchors.append((shifts + base[None]).reshape(-1, 4))
    return np.concatenate(all_anchors, 0).astype(np.float32)


def select_proposals(obj: torch.Tensor, reg: torch.Tensor, anchors: torch.Tensor,
                     image_hw: Tuple[int, int], k: int, nms_thresh: float = 0.7):
    """The RPN's proposals from its objectness ``[B, N]`` and deltas ``[B,
    N, 4]`` over ``anchors [N, 4]`` (``handnet_tpu/models/faster_rcnn.py:
    280-293``): the decoded, clipped boxes of the ``2 k`` best anchors, one
    greedy NMS over them, then the ``k`` best kept (an image with fewer
    kept boxes fills its list with -inf entries, lower index first).
    Returns ``(boxes [B, k, 4], scores [B, k], valid [B, k])``."""
    boxes = clip_boxes(delta_decode(reg, anchors[None]), *image_hw)
    top_scores, top_idx = topk_candidates(obj, 2 * k)
    top_boxes = _take(boxes, top_idx)
    keep = nms_fixed(top_boxes, top_scores, torch.ones_like(top_idx, dtype=torch.bool),
                     nms_thresh)
    sel = torch.where(keep, top_scores, torch.full_like(top_scores, -math.inf))
    final_scores, final_idx = topk_candidates(sel, k)
    return _take(top_boxes, final_idx), final_scores, final_scores > -math.inf


class FasterRCNNFPN(nn.Module):
    """Backbone + FPN + RPN + RoI heads at the reference's geometry
    (faster_rcnn_fpn.py:112-190): ResNet-34 with an FPN over c2..c5
    (strides 4-32) plus the parameter-free P6 subsample (torchvision
    ``LastLevelMaxPool``) for the RPN only; anchors of sizes 32..512 x
    ratios (0.5, 1, 2); RoIAlign over P2-P5 with the canonical 224 ->
    level-4 mapping; a 1024-wide TwoMLPHead.

    ``forward`` takes NHWC frames ``[B, H, W, 3]`` preprocessed as FCOS's
    (:meth:`preprocess`, ``FCOSConfig``'s mean and std, as both JAX CLIs
    preprocess them) and returns the proposals and the per-roi head
    outputs; the decode and the losses are the functions below. Train mode takes a ``"batch"`` backbone's
    statistics from the batch and runs the contact head's dropout (drawn
    from ``generator``). ``backbone_norm``: ``"frozen"`` (the default, for
    converted weights), ``"batch"`` or ``"group"`` (K2s/K2a; each GroupNorm's
    ``use_kernel`` switches it to its plain version).
    """

    strides = (4, 8, 16, 32, 64)   # the last: the P6 pool level
    anchor_sizes = (32, 64, 128, 256, 512)
    aspect_ratios = (0.5, 1.0, 2.0)

    def __init__(self, num_classes: int = 3, image_h: int = 800, image_w: int = 1088,
                 num_proposals: int = 128, backbone_norm: str = "frozen"):
        super().__init__()
        self.num_classes = num_classes
        self.image_h, self.image_w = image_h, image_w
        self.num_proposals = num_proposals
        self.backbone = nn.ModuleDict({
            "body": resnet34(norm=backbone_norm),
            "fpn": FPN((64, 128, 256, 512), 256),
        })
        self.rpn = nn.ModuleDict({"head": RPNHead(256, len(self.aspect_ratios))})
        self.roi_heads = nn.ModuleDict({
            "box_head": TwoMLPHead(256 * ROI_SIZE * ROI_SIZE, 1024),
            "box_predictor": FastRCNNPredictor(1024, num_classes),
        })
        anchors = rpn_anchor_grid(image_h, image_w, self.strides, self.anchor_sizes,
                                  self.aspect_ratios)
        self.register_buffer("anchors", torch.from_numpy(anchors), persistent=False)
        self.input_cfg = FCOSConfig(image_h=image_h, image_w=image_w)
        for name in ("image_mean", "image_std"):
            self.register_buffer(name, torch.tensor(getattr(self.input_cfg, name),
                                                    dtype=torch.float32), persistent=False)

    def preprocess(self, images: torch.Tensor) -> Tuple[torch.Tensor, Tuple[float, float]]:
        """``models/fcos.py``'s :func:`preprocess` at this detector's input
        size: normalized, resized to fit and padded frames, and the (scale_y,
        scale_x) from frame to network pixels."""
        return preprocess(images, self.input_cfg, self.image_mean, self.image_std)

    def init_weights_(self, generator: torch.Generator) -> None:
        """Seeded random init in the JAX package's defaults: conv and dense
        kernels LeCun-normal (std 1/sqrt(fan_in)), biases zero."""
        init_conv_weights_(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                                   / math.sqrt(m.in_features))
                    m.bias.zero_()

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """P2..P5 and the P6 subsample (RPN only), NCHW."""
        body = self.backbone["body"]
        x = images.permute(0, 3, 1, 2).to(body.conv1.weight.dtype)
        feats = body(x.contiguous(memory_format=torch.channels_last))
        pyramid = self.backbone["fpn"]([feats[f"c{i}"] for i in range(2, 6)])
        pyramid.append(pyramid[-1][:, :, ::2, ::2])   # LastLevelMaxPool
        return pyramid

    def propose(self, pyramid: List[torch.Tensor], nms_thresh: float = 0.7):
        """RPN forward -> ``num_proposals`` boxes per image
        (:func:`select_proposals`). Returns ``(boxes [B, k, 4], scores [B,
        k], valid [B, k], raw objectness [B, N], raw deltas [B, N, 4])``;
        the proposals are cut from the gradient, as the reference's RPN
        detaches them."""
        raw_obj, raw_reg = self.rpn["head"](pyramid)
        boxes, scores, valid = select_proposals(
            raw_obj.detach(), raw_reg.detach(), self.anchors, (self.image_h, self.image_w),
            self.num_proposals, nms_thresh)
        return boxes, scores, valid, raw_obj, raw_reg

    def roi_forward(self, pyramid: List[torch.Tensor], proposals: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """RoIAlign over P2-P5 and the heads, on the flattened ``[B*R]``
        rois; outputs reshaped to ``[B, R, ...]``."""
        b, r = proposals.shape[:2]
        pooled = multiscale_roi_align(pyramid[:4], proposals, ROI_SIZE, self.strides[:4])
        x = self.roi_heads["box_head"](pooled.reshape(b * r, *pooled.shape[2:]))
        out = self.roi_heads["box_predictor"](x, generator)
        return {k: v.reshape(b, r, *v.shape[1:]) for k, v in out.items()}

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        pyramid = self.features(images)
        proposals, rpn_scores, valid, rpn_obj, rpn_reg = self.propose(pyramid)
        head = self.roi_forward(pyramid, proposals, generator)
        return {"proposals": proposals, "rpn_scores": rpn_scores,
                "proposal_valid": valid, "rpn_objectness": rpn_obj,
                "rpn_deltas": rpn_reg, **head}


# ---------------------------------------------------------------------------
# Decode and losses.


def decode_rcnn_detections(outputs: Dict[str, torch.Tensor], num_classes: int,
                           score_thresh: float = 0.1, nms_thresh: float = 0.5,
                           max_dets: int = 32, image_hw: Optional[Tuple[int, int]] = None
                           ) -> Dict[str, torch.Tensor]:
    """Fixed-shape ``RoIHeads.postprocess_detections`` (reference
    roi_heads.py:243-358): per-roi class softmax, per-class delta decode,
    clip, background dropped, (roi, class) pairs flattened, score threshold,
    tiny boxes (a side under 1e-2) dropped, the best ``max_dets`` pairs,
    class-aware NMS. Per pair: ``sides`` (sigmoid > 0.5), ``contacts`` (the
    5-way argmax) and ``dxdymags``. As in the JAX package, the pairs are cut
    to ``max_dets`` before the NMS, so shapes stay fixed."""
    probs = torch.softmax(outputs["scores"].float(), dim=-1)
    b, r, c = probs.shape
    deltas = outputs["deltas"].float().reshape(b, r, c, 4)
    boxes = delta_decode(deltas, outputs["proposals"][:, :, None, :],
                         weights=(10.0, 10.0, 5.0, 5.0))
    if image_hw is not None:
        boxes = clip_boxes(boxes, image_hw[0], image_hw[1])

    fg_probs = probs[:, :, 1:].reshape(b, -1)
    fg_boxes = boxes[:, :, 1:, :].reshape(b, -1, 4)
    labels = torch.arange(1, c, device=probs.device).expand(b, r, c - 1).reshape(b, -1)
    wh = fg_boxes[..., 2:] - fg_boxes[..., :2]
    not_small = (wh >= 1e-2).all(-1)
    valid = ((fg_probs > score_thresh) & not_small
             & outputs["proposal_valid"][:, :, None].expand(b, r, c - 1).reshape(b, -1))

    masked = torch.where(valid, fg_probs, torch.zeros_like(fg_probs))
    top_scores, top_idx = topk_candidates(masked, max_dets)
    out_boxes = _take(fg_boxes, top_idx)
    out_labels = _take(labels, top_idx)
    keep = batched_nms_fixed(out_boxes, top_scores, out_labels, top_scores > score_thresh,
                             nms_thresh)

    sides_bin = (torch.sigmoid(outputs["side"].float()) > 0.5).float()
    contacts = outputs["contact"].float().reshape(b, r, c, 5).argmax(-1)[:, :, 1:]
    dxdy = outputs["dxdy"].float().reshape(b, r, c, 3)[:, :, 1:]
    return {"boxes": out_boxes,
            "scores": torch.where(keep, top_scores, torch.zeros_like(top_scores)),
            "labels": out_labels, "valid": keep,
            "sides": _take(sides_bin[:, :, 1:].reshape(b, -1), top_idx),
            "contacts": _take(contacts.reshape(b, -1), top_idx),
            "dxdymags": _take(dxdy.reshape(b, -1, 3), top_idx)}


def _sampler_weights(fg: torch.Tensor, bg: torch.Tensor, fg_cap: int, total: int,
                     mesh: Optional[DataMesh] = None):
    """Per-row weights and the normalizer of the expectation of
    torchvision's ``BalancedPositiveNegativeSampler``, per image: fg rows
    ``min(n_fg, fg_cap) / n_fg``, bg rows ``min(n_bg, total - n_fg_s) /
    n_bg``, normalizer ``max(sum(n_fg_s + n_bg_s), 1)``, the sum over the
    global batch under a data ``mesh`` (the caps stay per image)."""
    n_fg_i, n_bg_i = fg.sum(1), bg.sum(1)
    n_fg_s = n_fg_i.clamp(max=fg_cap)
    n_bg_s = torch.minimum(n_bg_i, total - n_fg_s)
    w = (fg * (n_fg_s / n_fg_i.clamp(min=1))[:, None]
         + bg * (n_bg_s / n_bg_i.clamp(min=1))[:, None]).float()
    return w, all_reduce_sum((n_fg_s + n_bg_s).sum(), mesh).clamp(min=1)


def _safe(boxes: torch.Tensor) -> torch.Tensor:
    """Boxes with ``x2, y2`` raised to at least ``x1 + 1, y1 + 1``: the
    delta encoding's log of a degenerate box is NaN, which would reach the
    gradient through the fg mask."""
    return torch.cat([boxes[..., :2], torch.maximum(boxes[..., 2:], boxes[..., :2] + 1.0)], -1)


def _pick(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values [B, R, C, K]`` at class ``idx [B, R]`` -> ``[B, R, K]``."""
    return values.gather(2, idx[:, :, None, None].expand(-1, -1, 1, values.shape[-1]))[:, :, 0]


def rcnn_loss(outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
              num_classes: int, mesh: Optional[DataMesh] = None) -> Dict[str, torch.Tensor]:
    """The RoI heads' losses (``handnet_tpu/models/faster_rcnn.py:387``;
    reference roi_heads.py:16-117), float32: proposals matched to GTs at
    IoU 0.5 (argmax, first index on ties), the classifier's cross entropy
    and the box smooth-L1 (beta 1/9, on (10, 10, 5, 5)-weighted
    encodings) weighted by the expectation of the 512-per-image,
    25%-positive sampler and divided by its sampled count; with
    ``box_info``, the 0.1-weighted side BCE, dxdy MSE and contact cross
    entropy over the positives at their matched class.

    Under a data ``mesh`` (a rank of ``DistributedDataParallel``) the
    sampled count and the positives are counted over the global batch
    before their clamps, as under JAX's sharded ``jit``, and every term,
    a sum over rows, is scaled by the world size for DDP's gradient average
    (``parallel.mesh.dp_scale``): the ranks' mean is the whole-batch loss."""
    props = outputs["proposals"]
    iou = box_iou(props, targets["boxes"])
    iou = torch.where(targets["valid"][:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(-1)
    match = iou.argmax(-1)
    gt_labels = _take(targets["labels"], match)
    gt_boxes = _take(targets["boxes"], match)

    fg = best_iou >= 0.5
    bg = (best_iou < 0.5) & (best_iou >= 0.0)
    cls_target = torch.where(fg, gt_labels, torch.zeros_like(gt_labels)).long()
    w, n_sample = _sampler_weights(fg, bg, 128, 512, mesh)
    scale = dp_scale(mesh)

    logits = outputs["scores"].float()
    ce = -F.log_softmax(logits, dim=-1).gather(-1, cls_target[..., None])[..., 0]
    loss_cls = (w * ce).sum() * scale / n_sample

    b, r = fg.shape
    deltas = outputs["deltas"].float().reshape(b, r, num_classes, 4)
    sel = _pick(deltas, cls_target)
    reg_target = delta_encode(_safe(gt_boxes), _safe(props), weights=(10.0, 10.0, 5.0, 5.0))
    n_fg = all_reduce_sum(fg.sum(), mesh).clamp(min=1)
    loss_reg = torch.where(fg[..., None], w[..., None] * smooth_l1(sel - reg_target, 1.0 / 9.0),
                           0.0).sum() * scale / n_sample

    losses = {"loss_classifier": loss_cls, "loss_box_reg": loss_reg}
    if "box_info" in targets:
        info = _take(targets["box_info"], match)
        side_sel = _pick(outputs["side"].float().reshape(b, r, num_classes, 1), cls_target)[..., 0]
        bce = bce_with_logits(side_sel, info[..., 1])
        losses["loss_hand_side"] = 0.1 * (torch.where(fg, bce, 0.0).sum() * scale / n_fg)
        dxdy_sel = _pick(outputs["dxdy"].float().reshape(b, r, num_classes, 3), cls_target)
        mse = ((dxdy_sel - info[..., 2:]) ** 2).mean(-1)
        losses["loss_dxdymag"] = 0.1 * (torch.where(fg, mse, 0.0).sum() * scale / n_fg)
        contact_sel = _pick(outputs["contact"].float().reshape(b, r, num_classes, 5), cls_target)
        contact_ce = -F.log_softmax(contact_sel, dim=-1).gather(
            -1, info[..., 0].clamp(min=0).long()[..., None])[..., 0]
        losses["loss_contact"] = 0.1 * (torch.where(fg, contact_ce, 0.0).sum() * scale / n_fg)
    return losses


def rpn_assign(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
    """The RPN's anchor assignment (torchvision ``Matcher(0.7, 0.3,
    allow_low_quality_matches=True)``): returns ``(fg, bg, match)``, each
    ``[B, N]``. An anchor tying some GT's best IoU (``==``, ties included)
    is foreground with its own argmax GT."""
    b = gt_boxes.shape[0]
    iou = box_iou(anchors[None].expand(b, -1, -1), gt_boxes)           # [B, N, M]
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best = iou.amax(-1)
    match = iou.argmax(-1)
    gt_best = torch.where(gt_valid, iou.amax(1), torch.full_like(gt_valid, -2.0, dtype=iou.dtype))
    lowq = ((iou == gt_best[:, None, :]) & gt_valid[:, None, :]).any(-1)
    fg = (best >= 0.7) | lowq
    bg = (best < 0.3) & (best >= 0.0) & ~fg
    return fg, bg, match


def rpn_loss(outputs: Dict[str, torch.Tensor], anchors: torch.Tensor,
             targets: Dict[str, torch.Tensor],
             mesh: Optional[DataMesh] = None) -> Dict[str, torch.Tensor]:
    """The RPN's losses (``handnet_tpu/models/faster_rcnn.py:502``;
    torchvision ``RegionProposalNetwork``, fg/bg IoU 0.7/0.3), float32:
    objectness BCE and box smooth-L1 (beta 1/9, on (1, 1, 1, 1)-weighted
    encodings) over every non-ignored anchor, weighted by the expectation
    of the 256-per-image, 50%-positive sampler and divided by its sampled
    count (:func:`rpn_assign` assigns); a data ``mesh`` as in
    :func:`rcnn_loss`."""
    obj = outputs["rpn_objectness"].float()
    deltas = outputs["rpn_deltas"].float()
    fg, bg, match = rpn_assign(anchors, targets["boxes"], targets["valid"])
    w, n_sample = _sampler_weights(fg, bg, 128, 256, mesh)
    scale = dp_scale(mesh)
    obj_loss = (w * bce_with_logits(obj, fg.float())).sum() * scale / n_sample
    reg_target = delta_encode(_safe(_take(targets["boxes"], match)), anchors[None])
    box_loss = torch.where(fg[..., None], w[..., None] * smooth_l1(deltas - reg_target, 1.0 / 9.0),
                           0.0).sum() * scale / n_sample
    return {"loss_objectness": obj_loss, "loss_rpn_box_reg": box_loss}
