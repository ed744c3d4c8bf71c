"""Dense joint-offset field encode and decode (an auxiliary representation).

Counterpart of ``handnet_tpu/ops/offset_field.py:20-80`` (reference
utils/feature_tool.py:10-65, ``FeatureModule.joint2offset`` and
``offset2joint_softmax``): joints become per-pixel unit offset vectors and
closeness heatmaps over the (normalized) depth crop, and a softmax-weighted
vote decodes them back. Fields are ``[B, J*4, F, F]`` channel groups, as in
the reference. Everything runs on the input's device, batched.

The depth is resized to ``F x F`` by this module's own nearest rule,
``src = i * h // F`` (:func:`_resize_nearest`), which is not the cv2 rule
of ``data/a2j_data.py``.
"""

from __future__ import annotations

import torch


def _mesh_coords(feature_size: int, dtype: torch.dtype, device):
    """Pixel centres in [-1, 1]: ``(mesh_x, mesh_y)``, each ``[F, F]``."""
    r = 2.0 * (torch.arange(feature_size, dtype=dtype, device=device) + 0.5) / feature_size - 1.0
    return (r[None, :].expand(feature_size, feature_size),
            r[:, None].expand(feature_size, feature_size))


def _resize_nearest(img: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest resize of the last two axes to ``size x size``: source index
    ``i * h // size`` (the JAX module's rule)."""
    h, w = img.shape[-2], img.shape[-1]
    ys = torch.arange(size, device=img.device) * h // size
    xs = torch.arange(size, device=img.device) * w // size
    return img[..., ys[:, None], xs[None, :]]


def _coords3(img_r: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[B, 3, F, F]``: the mesh's x and y, then the resized depth."""
    b, f = img_r.shape[0], img_r.shape[-1]
    mesh_x, mesh_y = _mesh_coords(f, dtype, img_r.device)
    coords = torch.stack([mesh_x, mesh_y], 0)[None].expand(b, 2, f, f)
    return torch.cat([coords, img_r], 1)


def joint2offset(jt_uvd: torch.Tensor, img: torch.Tensor, kernel_size: float,
                 feature_size: int) -> torch.Tensor:
    """Joints ``[B, J, 3]`` (normalized coordinates) and depth ``[B, 1, H, W]``
    -> field ``[B, J*4, F, F]``: per joint 3 unit-offset channels, then all
    the joints' heatmaps."""
    b, j, _ = jt_uvd.shape
    img_r = _resize_nearest(img, feature_size)                    # [B, 1, F, F]
    coords3 = _coords3(img_r, jt_uvd.dtype)                       # [B, 3, F, F]
    offset = jt_uvd[:, :, :, None, None] - coords3[:, None]       # [B, J, 3, F, F]
    dis = torch.sqrt(torch.sum(offset ** 2, dim=2) + 1e-8)        # [B, J, F, F]
    offset_norm = offset / dis[:, :, None]
    heatmap = (kernel_size - dis) / kernel_size
    mask = (heatmap >= 0) & (img_r < 0.99)                        # [B, J, F, F]
    offset_masked = (offset_norm * mask[:, :, None]).reshape(b, j * 3, feature_size,
                                                              feature_size)
    return torch.cat([offset_masked, heatmap * mask], dim=1)


def offset2joint_softmax(offset: torch.Tensor, img: torch.Tensor,
                         kernel_size: float) -> torch.Tensor:
    """Inverse decode: field ``[B, J*4, F, F]`` and depth ``[B, 1, H, W]``
    -> joints ``[B, J, 3]``."""
    b, feature_num, f, _ = offset.shape
    j = feature_num // 4
    img_r = _resize_nearest(img, f)
    vec = offset[:, :j * 3].reshape(b, j, 3, -1)
    ht = offset[:, j * 3:].reshape(b, j, -1)
    coords3 = _coords3(img_r, offset.dtype)[:, None].expand(b, j, 3, f, f).reshape(b, j, 3, -1)
    mask = (img_r < 0.99).reshape(b, 1, -1)
    vec = vec * mask[:, :, None]
    ht = ht * mask
    weights = torch.softmax(ht * 30.0, dim=-1)
    dis = kernel_size - ht * kernel_size
    return torch.sum((vec * dis[:, :, None] + coords3) * weights[:, :, None], dim=-1)
