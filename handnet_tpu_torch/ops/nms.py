"""Fixed-shape class-aware NMS, batched over images.

Counterpart of ``handnet_tpu/ops/nms.py:54-72`` (``batched_nms_fixed``, vmapped
there): the K x K IoU matrix is built once, then a greedy suppression walks
the K candidates in index order (callers sort by score first). Outputs keep
shape ``[B, K]``; suppressed entries are masked invalid, never removed.
"""

from __future__ import annotations

import torch

from handnet_tpu_torch.ops.boxes import box_iou


def batched_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
                      labels: torch.Tensor, valid: torch.Tensor,
                      iou_thresh: float) -> torch.Tensor:
    """Greedy class-aware NMS over ``[B, K]`` candidates sorted by score.

    Args:
      boxes: ``[B, K, 4]``; scores: ``[B, K]`` (the sort is the caller's);
      labels: ``[B, K]``; valid: ``[B, K]`` bool.
      iou_thresh: suppression threshold (reference fcos.py:635 uses 0.3).

    Returns the keep mask ``[B, K]``. Boxes of different labels never
    suppress each other (torchvision ``batched_nms`` semantics).
    """
    del scores  # suppression is by index order; kept for the JAX signature
    k = boxes.shape[-2]
    idx = torch.arange(k, device=boxes.device)
    later = idx[None, :] > idx[:, None]                       # [K, K]: j > i
    same_class = labels[..., :, None] == labels[..., None, :]
    overlap = (box_iou(boxes, boxes) > iou_thresh) & same_class & later
    keep = valid.clone()
    for i in range(k):
        # a kept box i suppresses every later overlapping box
        keep &= ~(overlap[..., i, :] & keep[..., i:i + 1])
    return keep
