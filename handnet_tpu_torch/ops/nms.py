"""Fixed-shape greedy NMS, batched over images.

Counterpart of ``handnet_tpu/ops/nms.py`` (``topk_candidates``,
``nms_fixed`` and ``batched_nms_fixed``, vmapped there): the K x K IoU
matrix is built once, then a greedy suppression walks the K candidates in
index order (callers sort by score first), one walk over the whole
``[B, K]`` batch. Outputs keep shape ``[B, K]``; suppressed entries are
masked invalid, never removed.
"""

from __future__ import annotations

import torch

from handnet_tpu_torch.ops.boxes import box_iou


def topk_candidates(scores: torch.Tensor, k: int):
    """The ``k`` largest scores along the last axis and their indices,
    descending, equal scores in index order as ``jax.lax.top_k`` gives them
    (a stable sort; ``torch.topk`` orders ties as it likes)."""
    ranked = torch.sort(scores, dim=-1, descending=True, stable=True)
    return ranked.values[..., :k], ranked.indices[..., :k]


def _greedy(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Walk ``[..., K]`` candidates in index order: a kept box ``i``
    suppresses every later box ``j`` with ``overlap[..., i, j]``."""
    k = overlap.shape[-1]
    idx = torch.arange(k, device=overlap.device)
    overlap = overlap & (idx[None, :] > idx[:, None])          # [K, K]: j > i
    keep = valid.clone()
    for i in range(k):
        keep &= ~(overlap[..., i, :] & keep[..., i:i + 1])
    return keep


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              iou_thresh: float) -> torch.Tensor:
    """Greedy single-class NMS over ``[B, K]`` candidates sorted by score:
    ``boxes [B, K, 4]``, ``valid [B, K]`` bool (``scores`` only honour the
    JAX signature: suppression is by index order). Returns the keep mask
    ``[B, K]``."""
    del scores
    return _greedy(box_iou(boxes, boxes) > iou_thresh, valid)


def batched_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
                      labels: torch.Tensor, valid: torch.Tensor,
                      iou_thresh: float) -> torch.Tensor:
    """Greedy class-aware NMS over ``[B, K]`` candidates sorted by score:
    as :func:`nms_fixed`, with ``labels [B, K]``; boxes of different labels
    never suppress each other (torchvision ``batched_nms`` semantics; the
    reference fcos.py:635 uses threshold 0.3)."""
    del scores
    same_class = labels[..., :, None] == labels[..., None, :]
    return _greedy((box_iou(boxes, boxes) > iou_thresh) & same_class, valid)
