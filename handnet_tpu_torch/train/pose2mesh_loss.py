"""Pose2Mesh training losses: a copy of ``handnet_tpu/train/pose2mesh_loss.py``
in PyTorch.

Reference: pose2mesh/lib/core/loss.py: CoordLoss (masked L1),
NormalVectorLoss (predicted edges against the GT face normals),
EdgeLengthLoss (edge-length L1), LaplacianLoss (uniform Laplacian
smoothness), over batched ``[B, V, 3]`` coordinates. ``faces`` is an
``[F, 3]`` integer array or tensor of vertex indices.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _faces(faces, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(faces, dtype=torch.long, device=device)


def coord_l1(pred: torch.Tensor, target: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean L1 (CoordLoss with has_valid)."""
    if valid is not None:
        pred = pred * valid
        target = target * valid
    return (pred - target).abs().mean()


def _unit(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.sqrt((v * v).sum(dim=-1, keepdim=True) + eps)


def normal_vector_loss(pred: torch.Tensor, target: torch.Tensor, faces) -> torch.Tensor:
    """Mean ``|cos|`` between the predicted triangles' edges and the GT face
    normals."""
    f = _faces(faces, pred.device)
    p0, p1, p2 = pred[:, f[:, 0]], pred[:, f[:, 1]], pred[:, f[:, 2]]
    g0, g1, g2 = target[:, f[:, 0]], target[:, f[:, 1]], target[:, f[:, 2]]
    n_gt = _unit(torch.linalg.cross(_unit(g1 - g0), _unit(g2 - g0), dim=-1))
    cos = torch.stack([(e * n_gt).sum(dim=-1).abs()
                       for e in (_unit(p1 - p0), _unit(p2 - p0), _unit(p2 - p1))], dim=1)
    return cos.mean()


def edge_length_loss(pred: torch.Tensor, target: torch.Tensor, faces) -> torch.Tensor:
    """Mean L1 between the predicted and the GT triangles' edge lengths."""
    f = _faces(faces, pred.device)

    def lengths(x):
        a, b, c = x[:, f[:, 0]], x[:, f[:, 1]], x[:, f[:, 2]]
        return torch.stack([torch.sqrt(((a - b) ** 2).sum(dim=-1) + 1e-12),
                            torch.sqrt(((a - c) ** 2).sum(dim=-1) + 1e-12),
                            torch.sqrt(((b - c) ** 2).sum(dim=-1) + 1e-12)], dim=1)

    return (lengths(pred) - lengths(target)).abs().mean()


def uniform_laplacian(faces: np.ndarray, n_verts: int) -> np.ndarray:
    """Row-normalized uniform Laplacian matrix (LaplacianLoss's constructor),
    float32 numpy."""
    lap = np.zeros((n_verts, n_verts), np.float32)
    f = np.asarray(faces)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        lap[f[:, a], f[:, b]] = -1
        lap[f[:, b], f[:, a]] = -1
    np.fill_diagonal(lap, -lap.sum(1))
    d = np.maximum(np.diag(lap), 1e-8)
    return lap / d[:, None]


def laplacian_loss(pred: torch.Tensor, lap: torch.Tensor) -> torch.Tensor:
    """Mean squared norm of the Laplacian-smoothed vertices."""
    smoothed = torch.einsum("vu,buc->bvc", lap, pred)
    return (smoothed ** 2).sum(dim=-1).mean()


def pose2mesh_losses(mesh_pred: torch.Tensor, mesh_gt: torch.Tensor,
                     pose3d_pred: torch.Tensor, pose3d_gt: torch.Tensor,
                     joints_from_mesh_pred: Optional[torch.Tensor] = None,
                     joints_from_mesh_gt: Optional[torch.Tensor] = None,
                     faces=None, normal_weight: float = 0.1,
                     edge_weight: float = 20.0) -> Dict[str, torch.Tensor]:
    """The get_loss bundle (loss.py:get_loss): coord L1 on the mesh and the
    lifted 3D pose (and the regressed joints where given); with ``faces``
    the normal (times ``normal_weight``) and edge (times ``edge_weight``)
    terms; ``total_loss`` their sum, in the JAX package's order."""
    losses = {"mesh_coord": coord_l1(mesh_pred, mesh_gt),
              "pose_coord": coord_l1(pose3d_pred, pose3d_gt)}
    if joints_from_mesh_pred is not None:
        losses["joint_coord"] = coord_l1(joints_from_mesh_pred, joints_from_mesh_gt)
    if faces is not None:
        losses["normal"] = normal_vector_loss(mesh_pred, mesh_gt, faces) * normal_weight
        losses["edge"] = edge_length_loss(mesh_pred, mesh_gt, faces) * edge_weight
    losses["total_loss"] = sum(losses.values())
    return losses
