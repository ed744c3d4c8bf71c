"""Box decode and IoU on ``[..., 4]`` (x1, y1, x2, y2) tensors — the serving
subset of ``handnet_tpu/ops/boxes.py`` (FCOS linear decode, area, pairwise
IoU), batched over any leading dims."""

from __future__ import annotations

import torch


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
