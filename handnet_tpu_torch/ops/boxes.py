"""Box coders, IoU and GIoU on ``[..., 4]`` (x1, y1, x2, y2) tensors: the
counterpart of ``handnet_tpu/ops/boxes.py`` (FCOS's linear encode and
decode, Faster R-CNN's delta encode and decode, area, pairwise IoU, the GIoU
loss, clipping and resizing), batched over any leading dims, each with the
JAX function's float32 operations in its order."""

from __future__ import annotations

import math

import torch


def linear_encode(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Encode ``boxes`` as (l, t, r, b) distances from the (square)
    ``anchors``' centres, in units of the anchor size (reference
    det_utils.py:233-264)."""
    ctr_x = 0.5 * (anchors[..., 0] + anchors[..., 2])
    ctr_y = 0.5 * (anchors[..., 1] + anchors[..., 3])
    target = torch.stack([
        ctr_x - boxes[..., 0],
        ctr_y - boxes[..., 1],
        boxes[..., 2] - ctr_x,
        boxes[..., 3] - ctr_y,
    ], dim=-1)
    w = anchors[..., 2] - anchors[..., 0]
    h = anchors[..., 3] - anchors[..., 1]
    return target / torch.stack([w, h, w, h], dim=-1)


def linear_decode(rel_codes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Decode (l, t, r, b) offsets, in units of the anchor size, back to
    boxes (reference det_utils.py:266-294)."""
    ctr_x = 0.5 * (anchors[..., 0] + anchors[..., 2])
    ctr_y = 0.5 * (anchors[..., 1] + anchors[..., 3])
    w = anchors[..., 2] - anchors[..., 0]
    h = anchors[..., 3] - anchors[..., 1]
    rel_codes = rel_codes * torch.stack([w, h, w, h], dim=-1)
    return torch.stack([
        ctr_x - rel_codes[..., 0],
        ctr_y - rel_codes[..., 1],
        ctr_x + rel_codes[..., 2],
        ctr_y + rel_codes[..., 3],
    ], dim=-1)


BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def delta_encode(reference_boxes: torch.Tensor, proposals: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode ``reference_boxes`` (GT) w.r.t. ``proposals`` as (dx, dy, dw,
    dh) (reference det_utils.py:7-58)."""
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0]
    ex_h = proposals[..., 3] - proposals[..., 1]
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h
    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0]
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1]
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h
    return torch.stack([
        wx * (gt_cx - ex_cx) / ex_w,
        wy * (gt_cy - ex_cy) / ex_h,
        ww * torch.log(gt_w / ex_w),
        wh * torch.log(gt_h / ex_h),
    ], dim=-1)


def delta_decode(rel_codes: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 bbox_xform_clip: float = BBOX_XFORM_CLIP) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) back to boxes (reference
    det_utils.py:176-217). The deltas keep their dtype up to the products
    with the boxes' sizes, as in the JAX package (bf16 deltas: ``exp`` in
    bf16)."""
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    dx = rel_codes[..., 0] / wx
    dy = rel_codes[..., 1] / wy
    dw = (rel_codes[..., 2] / ww).clamp(max=bbox_xform_clip)
    dh = (rel_codes[..., 3] / wh).clamp(max=bbox_xform_clip)
    pred_cx = dx * w + cx
    pred_cy = dy * h + cy
    pred_w = torch.exp(dw) * w
    pred_h = torch.exp(dh) * h
    return torch.stack([
        pred_cx - 0.5 * pred_w,
        pred_cy - 0.5 * pred_h,
        pred_cx + 0.5 * pred_w,
        pred_cy + 0.5 * pred_h,
    ], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU ``[..., N, M]`` between ``[..., N, 4]`` and ``[..., M, 4]``."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def giou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise ``1 - GIoU`` of two box sets of one shape (reference
    fcos_utils/utils.py:3-62); callers reduce. The intersection is a
    ``torch.where`` as in the JAX package, so no gradient reaches the
    corners of boxes that do not overlap."""
    x1, y1, x2, y2 = boxes1.unbind(-1)
    x1g, y1g, x2g, y2g = boxes2.unbind(-1)
    xkis1, ykis1 = torch.maximum(x1, x1g), torch.maximum(y1, y1g)
    xkis2, ykis2 = torch.minimum(x2, x2g), torch.minimum(y2, y2g)
    overlap = (ykis2 > ykis1) & (xkis2 > xkis1)
    intsctk = torch.where(overlap, (xkis2 - xkis1) * (ykis2 - ykis1), 0.0)
    unionk = (x2 - x1) * (y2 - y1) + (x2g - x1g) * (y2g - y1g) - intsctk
    iouk = intsctk / (unionk + eps)
    area_c = (torch.maximum(x2, x2g) - torch.minimum(x1, x1g)) * (
        torch.maximum(y2, y2g) - torch.minimum(y1, y1g))
    return 1.0 - (iouk - (area_c - unionk) / (area_c + eps))


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip boxes to ``[0, width] x [0, height]``."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, width), y1.clamp(0, height),
                        x2.clamp(0, width), y2.clamp(0, height)], dim=-1)


def resize_boxes(boxes: torch.Tensor, from_size, to_size) -> torch.Tensor:
    """Rescale boxes between image sizes ``(h, w)`` (reference
    fcos.py:770-783)."""
    ratio_h = to_size[0] / from_size[0]
    ratio_w = to_size[1] / from_size[1]
    scale = torch.tensor([ratio_w, ratio_h, ratio_w, ratio_h], dtype=boxes.dtype,
                         device=boxes.device)
    return boxes * scale
