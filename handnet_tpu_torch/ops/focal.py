"""Elementwise detection losses: a copy of ``handnet_tpu/ops/focal.py`` in
PyTorch (that package's ``ops/__init__.py`` imports jax). Callers reduce."""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy with logits, in the numerically
    stable form (the centerness loss, reference fcos.py:160)."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise focal loss with torchvision's ``sigmoid_focal_loss``
    meaning: ``BCE(x, t) * (1 - p_t) ** gamma``, alpha-balanced when
    ``alpha >= 0``."""
    p = torch.sigmoid(logits)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = bce_with_logits(logits, targets) * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def smooth_l1(diff: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 of ``|diff|``: ``0.5 d^2 / beta`` up to ``beta``,
    ``d - 0.5 beta`` above (reference a2j/anchor.py:125-129)."""
    ad = diff.abs()
    return torch.where(ad <= beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)
