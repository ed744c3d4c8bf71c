"""Box coders, IoU and GIoU on ``[..., 4]`` (x1, y1, x2, y2) tensors — the
subset of ``handnet_tpu/ops/boxes.py`` that FCOS serves and trains with
(linear encode and decode, area, pairwise IoU, the GIoU loss), batched over
any leading dims."""

from __future__ import annotations

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
