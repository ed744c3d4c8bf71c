"""A2J anchor-to-joint regressor, serving forward.

Counterpart of ``handnet_tpu/models/a2j.py`` (``A2JHead``, ``A2J``,
``anchors_for``, ``a2j_postprocess``, ``A2JSystem.predict``). Parameter names
follow the reference's A2JModel state dict (``Backbone.model.*``,
``classificationModel.*``, ``regressionModel.*``, ``DepthRegressionModel.*``),
so the JAX package's ``convert_a2j`` reads them.

The heads' NCHW outputs go to NHWC *before* the ``[B, N, P]`` reshape: the
anchor table is in (h, w, a) order (``ops/anchors.py``). ``cfg.quant`` makes
the backbone's residual blocks and the heads' ``conv1..4`` int8
(``nn/quant.py``); the stem and each head's ``output`` conv stay float.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from handnet_tpu_torch.config import A2JConfig
from handnet_tpu_torch.nn.quant import conv_layer
from handnet_tpu_torch.nn.resnet import FrozenBatchNorm2d, init_conv_weights_, resnet50_dilated
from handnet_tpu_torch.ops.anchors import a2j_anchor_grid
from handnet_tpu_torch.ops.cuda_a2j import a2j_decode, a2j_decode_reference


class A2JHead(nn.Module):
    """4 x (conv3x3 + BN + ReLU) + output conv3x3 (a2j/a2j.py:44-181); BN in
    eval mode."""

    def __init__(self, in_channels: int, out_channels: int, features: int = 256,
                 quant: Any = False):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"conv{i}", conv_layer(quant, in_channels if i == 1 else features,
                                                 features, 3, padding=1))
            setattr(self, f"bn{i}", FrozenBatchNorm2d(features))
        self.output = nn.Conv2d(features, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return self.output(x)


class A2J(nn.Module):
    """Dilated ResNet-50 + the classification, regression and depth heads.
    ``forward`` returns the raw flat head tensors."""

    def __init__(self, cfg: Optional[A2JConfig] = None):
        super().__init__()
        cfg = cfg or A2JConfig()
        if cfg.backbone != "resnet50" or not cfg.is_3d:
            raise NotImplementedError(
                f"A2J: backbone {cfg.backbone!r}, is_3d={cfg.is_3d} (only the 3D "
                "ResNet-50 model is ported)")
        self.cfg = cfg
        stem_in = 3 if cfg.in_channels == 1 else cfg.in_channels
        body = resnet50_dilated(in_channels=stem_in, quant=cfg.quant)
        self.Backbone = nn.ModuleDict({"model": body})
        a, p, f = cfg.num_anchors, cfg.num_joints, cfg.head_features
        self.classificationModel = A2JHead(1024, a * p, f, cfg.quant)
        self.regressionModel = A2JHead(2048, a * p * 2, f, cfg.quant)
        self.DepthRegressionModel = A2JHead(2048, a * p, f, cfg.quant)

    def init_weights_(self, generator: torch.Generator) -> None:
        """Seeded random init (conv kernels LeCun-normal)."""
        init_conv_weights_(self, generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: ``[B, H, W, C]``, C = 1 (depth) or 4 (RGBD). Returns cls
        ``[B, N, P]``, reg ``[B, N, P, 2]`` and depth ``[B, N, P]`` with
        N = feat_h * feat_w * A in (h, w, a) order."""
        cfg = self.cfg
        if cfg.in_channels == 1 and x.shape[-1] == 1:
            # depth replicated to 3 channels for the RGB stem (a2j/a2j.py:197-199)
            x = x.expand(-1, -1, -1, 3)
        body = self.Backbone["model"]
        x = x.permute(0, 3, 1, 2).to(body.conv1.weight.dtype)
        feats = body(x.contiguous(memory_format=torch.channels_last))
        x3, x4 = feats["c4"], feats["c5"]  # both stride 16 (dilated layer4)
        b, p = x.shape[0], cfg.num_joints

        def flat(t, *trailing):
            return t.permute(0, 2, 3, 1).reshape(b, -1, p, *trailing)

        return {"cls": flat(self.classificationModel(x3)),
                "reg": flat(self.regressionModel(x4), 2),
                "depth": flat(self.DepthRegressionModel(x4))}


def anchors_for(cfg: A2JConfig) -> np.ndarray:
    return a2j_anchor_grid(cfg.feat_h, cfg.feat_w, cfg.stride,
                           cfg.anchor_offsets, transposed=cfg.transposed_anchors)


def a2j_postprocess(heads: Dict[str, torch.Tensor], anchors: torch.Tensor,
                    use_kernel: bool = True) -> torch.Tensor:
    """Anchor aggregation -> UVD keypoints ``[B, P, 3]`` float32: kernel K1
    (``ops/cuda_a2j.py``), or its plain version when ``use_kernel`` is False."""
    decode = a2j_decode if use_kernel else a2j_decode_reference
    return decode(heads["cls"], heads["reg"], heads["depth"], anchors)


class A2JSystem(A2J):
    """The A2J module plus its anchor table (a non-persistent buffer) and the
    ``predict`` entry: depth crops in, UVD out."""

    def __init__(self, cfg: Optional[A2JConfig] = None, use_kernels: bool = True):
        super().__init__(cfg)
        self.use_kernels = use_kernels
        self.register_buffer("anchors", torch.from_numpy(anchors_for(self.cfg)),
                             persistent=False)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return a2j_postprocess(self(x), self.anchors, use_kernel=self.use_kernels)
