"""Feature Pyramid Network (torchvision topology), serving forward.

Counterpart of ``handnet_tpu/nn/fpn.py:20-55``: lateral 1x1 convs, a
top-down pathway with nearest upsampling to the exact target size, and 3x3
output convs; no extra level. Parameter names follow torchvision
(``inner_blocks.{i}``, ``layer_blocks.{i}``). ``quant`` makes both kinds of
conv int8 (``nn/quant.py``), as in the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch
import torch.nn as nn

from handnet_tpu_torch.nn.quant import conv_layer


def upsample_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest upsample of NCHW ``x`` to ``(out_h, out_w)`` with integer
    ``src = floor(dst * in / out)`` (exact for odd maps too). Gathers on the
    NHWC view, so a channels_last input gives a channels_last output."""
    h, w = x.shape[-2:]
    ys = torch.arange(out_h, device=x.device) * h // out_h
    xs = torch.arange(out_w, device=x.device) * w // out_w
    nhwc = x.permute(0, 2, 3, 1)
    return nhwc[:, ys[:, None], xs[None, :]].permute(0, 3, 1, 2)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (128, 256, 512),
                 out_channels: int = 256, quant: Any = False):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            [conv_layer(quant, c, out_channels, 1) for c in in_channels])
        self.layer_blocks = nn.ModuleList(
            [conv_layer(quant, out_channels, out_channels, 3, padding=1)
             for _ in in_channels])

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """features: bottom-up NCHW maps ordered fine -> coarse (c3, c4, c5)."""
        laterals = [blk(f) for blk, f in zip(self.inner_blocks, features)]
        out = [laterals[-1]]
        for lat in reversed(laterals[:-1]):
            out.insert(0, lat + upsample_nearest(out[0], *lat.shape[-2:]))
        return [blk(o) for blk, o in zip(self.layer_blocks, out)]
