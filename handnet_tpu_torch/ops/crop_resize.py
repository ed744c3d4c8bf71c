"""Detect -> pose handoff: box padding and the nearest-neighbour crop.

Counterparts of ``handnet_tpu/ops/crop_resize.py:23-52,96-111``, batched
over images. The crop reproduces the reference's
``F.interpolate(depth[..., y1:y2+1, x1:x2+1], size=(S, S))`` (default nearest,
handnet_pipeline.py:101) as one gather with ``src = start + floor(i*len/S)``.
"""

from __future__ import annotations

import torch


def crop_resize_nearest(images: torch.Tensor, boxes: torch.Tensor,
                        out_h: int, out_w: int) -> torch.Tensor:
    """Crop each image to its integer box (x1, y1, x2, y2, inclusive) and
    resize with nearest sampling.

    Args:
      images: ``[B, H, W, C]``.
      boxes: ``[B, 4]`` integer boxes, inclusive corners.

    Returns ``[B, out_h, out_w, C]``.
    """
    b, h_img, w_img = images.shape[:3]
    x1, y1, x2, y2 = boxes.to(torch.int64).unbind(-1)
    h = (y2 - y1 + 1).clamp(min=1)
    w = (x2 - x1 + 1).clamp(min=1)
    iy = torch.arange(out_h, device=images.device)
    ix = torch.arange(out_w, device=images.device)
    ys = (y1[:, None] + (iy[None, :] * h[:, None]) // out_h).clamp(0, h_img - 1)
    xs = (x1[:, None] + (ix[None, :] * w[:, None]) // out_w).clamp(0, w_img - 1)
    bi = torch.arange(b, device=images.device)[:, None, None]
    return images[bi, ys[:, :, None], xs[:, None, :]]


def pad_box(boxes: torch.Tensor, percent: float, image_h: int,
            image_w: int) -> torch.Tensor:
    """Pad ``[..., 4]`` boxes by ``percent`` of their size, clipped to the image.

    The box is truncated to int32 *before* the pad, as the reference's int64
    box arithmetic does (handnet_pipeline.py:88-97); like the reference, the
    far edge clips to ``image_w``/``image_h`` (not minus one).
    """
    boxes = boxes.to(torch.int32)
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    dx = (percent * w).to(torch.int32)
    dy = (percent * h).to(torch.int32)
    x1 = (boxes[..., 0] - dx).clamp(min=0)
    y1 = (boxes[..., 1] - dy).clamp(min=0)
    x2 = (boxes[..., 2] + dx).clamp(max=image_w)
    y2 = (boxes[..., 3] + dy).clamp(max=image_h)
    return torch.stack([x1, y1, x2, y2], dim=-1).to(torch.int32)
