"""Camera geometry and joint-space conversions, batched over leading dims.

Counterparts of ``handnet_tpu/ops/geometry.py:30-66`` (reference
datasets3d/a2jdataset.py:21-38 and a2j/a2j.py:17-43).
"""

from __future__ import annotations

import torch


def uvd2xyz(pts: torch.Tensor, paras: torch.Tensor) -> torch.Tensor:
    """Unproject pixel UVD ``[..., J, 3]`` to camera XYZ with
    ``paras = [fx, fy, cx, cy]`` of shape ``[..., 4]``."""
    f = paras[..., None, 0:2]
    c = paras[..., None, 2:4]
    xy = (pts[..., 0:2] - c) * pts[..., 2:3] / f
    return torch.cat([xy, pts[..., 2:3]], dim=-1)


def crop_uvd_to_image_uvd(jt_uvd: torch.Tensor, box: torch.Tensor,
                          crop_w: int, crop_h: int) -> torch.Tensor:
    """Map crop-frame UVD back to full-image UVD given the crop box
    (a2j/a2j.py:25-30: u' = u * (x2-x1)/crop_w + x1; depth passes through)."""
    x1 = box[..., None, 0]
    y1 = box[..., None, 1]
    x2 = box[..., None, 2]
    y2 = box[..., None, 3]
    u = jt_uvd[..., 0] * (x2 - x1) / crop_w + x1
    v = jt_uvd[..., 1] * (y2 - y1) / crop_h + y1
    return torch.stack([u, v, jt_uvd[..., 2]], dim=-1)


def convert_joints(jt_uvd: torch.Tensor, box: torch.Tensor, paras: torch.Tensor,
                   crop_w: int = 176, crop_h: int = 176) -> torch.Tensor:
    """Crop UVD -> XYZ in millimeters (reference a2j/a2j.py:17-43)."""
    img_uvd = crop_uvd_to_image_uvd(jt_uvd, box, crop_w, crop_h)
    return uvd2xyz(img_uvd, paras) * 1000.0
