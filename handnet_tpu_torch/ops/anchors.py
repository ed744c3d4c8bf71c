"""Anchor grids for A2J and FCOS — static numpy constants.

A numpy copy of ``handnet_tpu/ops/anchors.py:15-98`` (that package's
``ops/__init__.py`` imports jax, so the port cannot import it). The tables
must stay bit-equal to the JAX package's; tests/test_torch_port_modules.py
asserts it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def a2j_anchor_grid(feat_h: int, feat_w: int, stride: int = 16,
                    offsets: Sequence[int] = (2, 6, 10, 14),
                    transposed: bool = False) -> np.ndarray:
    """Dense (u, v) anchor positions for A2J, shape ``[feat_h*feat_w*A, 2]``.

    A = len(offsets)^2 anchors per cell at sub-stride offsets
    ``offsets x offsets``. Flat order is row-major over (h, w, a) with
    ``a = i*len(offsets)+j``; the A2J head output must be flattened in the
    same (h, w, a) order (models/a2j.py permutes NCHW to NHWC first).

    ``transposed=True`` reproduces the reference's head permutation quirk
    (a2j/a2j.py:86-89) that pairs regression channel 0 with the row grid.
    """
    offs = np.asarray(offsets, dtype=np.float32)
    n = len(offs)
    off_v, off_u = np.meshgrid(offs, offs, indexing="ij")  # [n, n]
    off_u = off_u.reshape(-1)
    off_v = off_v.reshape(-1)

    ys = np.arange(feat_h, dtype=np.float32) * stride
    xs = np.arange(feat_w, dtype=np.float32) * stride
    grid_v, grid_u = np.meshgrid(ys, xs, indexing="ij")  # [H, W]

    u = grid_u[:, :, None] + off_u[None, None, :]  # [H, W, A]
    v = grid_v[:, :, None] + off_v[None, None, :]
    if transposed:
        anchors = np.stack([v, u], axis=-1)
    else:
        anchors = np.stack([u, v], axis=-1)
    return anchors.reshape(-1, 2).astype(np.float32)


def fcos_level_anchors(feat_h: int, feat_w: int, stride: int,
                       size: float) -> np.ndarray:
    """Single-scale stride-centered anchors for one FPN level, ``[H*W, 4]``
    (reference anchor_utils.py:56-112 with aspect ratio 1.0)."""
    half = np.round(size / 2.0)
    ys = np.arange(feat_h, dtype=np.float32) * stride
    xs = np.arange(feat_w, dtype=np.float32) * stride
    grid_y, grid_x = np.meshgrid(ys, xs, indexing="ij")
    cx = grid_x.reshape(-1)
    cy = grid_y.reshape(-1)
    return np.stack([cx - half, cy - half, cx + half, cy + half], axis=-1).astype(np.float32)


def fcos_anchor_pyramid(image_h: int, image_w: int,
                        strides: Sequence[int] = (8, 16, 32),
                        sizes: Sequence[float] | None = None,
                        ) -> Tuple[np.ndarray, np.ndarray, list]:
    """All-level anchors + per-anchor metadata for a static image size.

    Returns ``anchors [N, 4]`` (level-major), ``anchor_size [N]`` and
    ``level_slices``: a list of (start, count, (feat_h, feat_w)) per level.
    """
    if sizes is None:
        sizes = strides  # anchor size == stride (reference fcos.py:489)
    anchors = []
    anchor_size = []
    level_slices = []
    start = 0
    for stride, size in zip(strides, sizes):
        fh = int(np.ceil(image_h / stride))
        fw = int(np.ceil(image_w / stride))
        a = fcos_level_anchors(fh, fw, stride, size)
        anchors.append(a)
        anchor_size.append(np.full((a.shape[0],), float(size), dtype=np.float32))
        level_slices.append((start, a.shape[0], (fh, fw)))
        start += a.shape[0]
    return (np.concatenate(anchors, axis=0),
            np.concatenate(anchor_size, axis=0),
            level_slices)
