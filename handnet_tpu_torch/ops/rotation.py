"""Batched rotation math (axis-angle -> rotation matrices, 6D rotations).

Counterpart of ``handnet_tpu/ops/rotation.py`` (reference:
manopth/rodrigues_layer.py:44-55, quaternion-based batch Rodrigues, and
manopth/rot6d.py).
"""

from __future__ import annotations

import torch


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) -> [..., 3, 3]."""
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def batch_rodrigues(axisang: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle -> [..., 3, 3] rotations, by the reference's
    quaternion construction, ``+1e-8`` inside the norm included
    (rodrigues_layer.py:44-55)."""
    angle = torch.linalg.vector_norm(axisang + 1e-8, dim=-1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    return quat_to_rotmat(quat)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """[..., 6] continuous 6D rotation -> [..., 3, 3] (Zhou et al.;
    rot6d.py compute_rotation_matrix_from_ortho6d): the two columns
    Gram-Schmidt-orthonormalized, the third their cross product."""
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2).transpose(-1, -2)
