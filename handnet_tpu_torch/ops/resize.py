"""Separable bilinear resize as two matrix products.

Counterpart of ``handnet_tpu/ops/resize.py``. A bilinear resize is a banded
weight matrix applied along H and one applied along W; the matrices here are
the JAX package's (:func:`_resize_matrix`, a numpy copy): the half-pixel
triangle kernel of ``jax.image.resize``, renormalized over the in-range taps
at the edges, widened by in/out when downscaling (antialias). Rows past the
resized size are zero, so the detector's bottom/right zero pad comes out of
the same two products.

The JAX package leaves the two products to XLA; here they are two matrix
products in float32 (cuBLAS on the card). The matrices are uploaded once
per (sizes, device) and cached, so that a CUDA graph captured after a first
call copies nothing from the host.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


@lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int,
                   padded_out: Optional[int] = None) -> np.ndarray:
    """``[padded_out or out_size, in_size]`` float32 bilinear weight rows.

    Row o holds the triangle-kernel weights for output center
    ``x = (o + 0.5) * in/out - 0.5``, normalized over the in-range taps;
    downscaling widens the support by in/out; rows ``>= out_size`` are zero.
    """
    rows = padded_out or out_size
    m = np.zeros((rows, in_size), np.float32)
    scale = out_size / in_size
    support = max(1.0, 1.0 / scale)          # antialias widening on downscale
    ks = np.arange(in_size, dtype=np.float64)
    for o in range(out_size):
        x = (o + 0.5) / scale - 0.5
        w = np.clip(1.0 - np.abs(ks - x) / support, 0.0, None)  # triangle
        total = w.sum()
        if total <= 0:
            continue
        m[o] = (w / total).astype(np.float32)
    return m


def _matrix_on(in_size: int, out_size: int, padded_out: int,
               device: torch.device) -> torch.Tensor:
    """The weight rows on ``device``, uploaded once per (sizes, device). Under
    ``torch.export`` they are uploaded afresh and become a constant of the
    graph: the traced tensor must not outlive the trace in the cache."""
    if torch.compiler.is_compiling():
        return _uploaded.__wrapped__(in_size, out_size, padded_out, device)
    return _uploaded(in_size, out_size, padded_out, device)


@lru_cache(maxsize=64)
def _uploaded(in_size: int, out_size: int, padded_out: int,
              device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix(in_size, out_size, padded_out)).to(device)


def resize_bilinear_matmul(images: torch.Tensor, out_h: int, out_w: int,
                           padded_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Bilinear-resize float32 NHWC ``images`` to ``(out_h, out_w)``.

    ``padded_hw``: an optional ``(H, W) >= (out_h, out_w)``; the result is
    that size, with exact zeros past the resized region. Returns
    ``[B, H, W, C]`` float32 (a view whose memory is ``[B, H, C, W]``).

    The W product comes first: with C beside the batch it is one GEMM
    ``[B*h*C, w] x [w, W]``, and the H product then multiplies ``[h, C*W]``
    slabs of each image, so C=3 is never a GEMM side. The W product's
    operand is copied to ``[B, h, C, w]`` first: handed the permuted view,
    ``torch.matmul`` passes it to cuBLAS as a transposed operand, for which
    cuBLAS picks a far slower kernel (``chip_smoke.py`` times both).
    """
    b, h, w, c = images.shape
    ph, pw = padded_hw or (out_h, out_w)
    mh = _matrix_on(h, out_h, ph, images.device)
    mw = _matrix_on(w, out_w, pw, images.device)
    x = images.permute(0, 1, 3, 2).reshape(b * h * c, w) @ mw.t()        # [B*h*C, W]
    x = torch.bmm(mh.expand(b, ph, h), x.view(b, h, c * pw))             # [B, H, C*W]
    return x.view(b, ph, c, pw).permute(0, 1, 3, 2)
