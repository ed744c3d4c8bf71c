"""Detect -> pose handoff: box padding, the nearest-neighbour crop and its
bilinear variant.

Counterparts of ``handnet_tpu/ops/crop_resize.py:23-111``, batched over
images (the JAX functions take one image and ``vmap`` it). The nearest crop
reproduces the reference's ``F.interpolate(depth[..., y1:y2+1, x1:x2+1],
size=(S, S))`` (default nearest, handnet_pipeline.py:101) as one gather with
``src = start + floor(i*len/S)``; the bilinear one samples at half-pixel
centres (``align_corners=False``), as JAX's does.
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


def crop_resize_bilinear(images: torch.Tensor, boxes: torch.Tensor,
                         out_h: int, out_w: int) -> torch.Tensor:
    """Crop each image to its box (x1, y1, x2, y2, inclusive) and resize
    bilinearly, with half-pixel centres: JAX's clip of the taps to the image,
    ``+0.5``/``-0.5`` centres and weights clipped to [0, 1]
    (``handnet_tpu/ops/crop_resize.py:55-85``).

    Args:
      images: ``[B, H, W, C]`` or ``[B, H, W]``.
      boxes: ``[B, 4]`` boxes, inclusive corners (taken as float32).

    Returns ``[B, out_h, out_w, C]`` (or ``[B, out_h, out_w]``), float32 for
    float32 or integer images.
    """
    h_img, w_img = images.shape[1], images.shape[2]
    x1, y1, x2, y2 = boxes.to(torch.float32).unbind(-1)
    h = (y2 - y1 + 1.0).clamp(min=1.0)
    w = (x2 - x1 + 1.0).clamp(min=1.0)
    iy = torch.arange(out_h, dtype=torch.float32, device=images.device)
    ix = torch.arange(out_w, dtype=torch.float32, device=images.device)
    fy = y1[:, None] + (iy[None, :] + 0.5) * (h / out_h)[:, None] - 0.5     # [B, out_h]
    fx = x1[:, None] + (ix[None, :] + 0.5) * (w / out_w)[:, None] - 0.5     # [B, out_w]
    y0 = torch.floor(fy).clamp(0, h_img - 1)
    x0 = torch.floor(fx).clamp(0, w_img - 1)
    y1i = (y0 + 1).clamp(0, h_img - 1).long()
    x1i = (x0 + 1).clamp(0, w_img - 1).long()
    wy = (fy - y0).clamp(0.0, 1.0)
    wx = (fx - x0).clamp(0.0, 1.0)
    y0, x0 = y0.long(), x0.long()

    squeeze = images.dim() == 3
    img = images[..., None] if squeeze else images
    bi = torch.arange(img.shape[0], device=images.device)[:, None, None]

    def tap(ys, xs):
        return img[bi, ys[:, :, None], xs[:, None, :]]              # [B, out_h, out_w, C]

    wy_ = wy[:, :, None, None]
    wx_ = wx[:, None, :, None]
    out = ((1 - wy_) * (1 - wx_) * tap(y0, x0) + (1 - wy_) * wx_ * tap(y0, x1i)
           + wy_ * (1 - wx_) * tap(y1i, x0) + wy_ * wx_ * tap(y1i, x1i))
    return out[..., 0] if squeeze else out


def batch_crop_resize(images: torch.Tensor, boxes: torch.Tensor, out_h: int, out_w: int,
                      mode: str = "nearest") -> torch.Tensor:
    """``[B, H, W, C] x [B, 4] -> [B, out_h, out_w, C]`` by
    :func:`crop_resize_nearest` (``mode="nearest"``) or
    :func:`crop_resize_bilinear` (any other ``mode``, as JAX's
    ``batch_crop_resize`` takes it)."""
    fn = crop_resize_nearest if mode == "nearest" else crop_resize_bilinear
    return fn(images, boxes, out_h, out_w)


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
