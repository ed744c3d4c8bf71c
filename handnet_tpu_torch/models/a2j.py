"""A2J anchor-to-joint regressor: the forward, the decode and the loss.

Counterpart of ``handnet_tpu/models/a2j.py`` (``A2JHead``, ``A2J``,
``anchors_for``, ``a2j_postprocess``, ``a2j_loss``, ``A2JSystem.predict``
and ``loss_and_predict``). Parameter names
follow the reference's A2JModel state dict (``Backbone.model.*``,
``classificationModel.*``, ``regressionModel.*``, ``DepthRegressionModel.*``),
so the JAX package's ``convert_a2j`` reads them. The 2D A2J (``is_3d``
False) has no depth head: its heads are ``cls`` and ``reg``, it decodes to
``[B, P, 2]`` through K1xy and its loss has no depth term.

The heads' NCHW outputs go to NHWC *before* the ``[B, N, P]`` reshape: the
anchor table is in (h, w, a) order (``ops/anchors.py``). ``cfg.quant`` makes
the backbone's residual blocks and the heads' ``conv1..4`` int8
(``nn/quant.py``); the stem and each head's ``output`` conv stay float.

``norm`` names the norm layers of the backbone and the three towers, as
``make_norm`` does (``nn/resnet.py``): ``"frozen"`` (serving: fixed
statistics), ``"batch"`` (training: batch statistics in ``train()`` mode,
the running ones in ``eval()`` mode), both with the same state-dict keys, or
``"group"``: flax's ``GroupNorm(32)`` in all 65 norms (53 in the backbone,
12 in the towers; C/G 2 to 64), each through kernels K2s and K2a with the
ReLU that follows fused into K2a, and ``weight``/``bias`` alone in the state
dict. With grad (a train step of :meth:`A2JSystem.losses`), each norm's
backward is kernels K2r and K2d, 65 launches of each per step; on the CPU
the same calls take the kernels' plain versions. ``A2JTrainer`` builds
``"batch"`` only, as the JAX package's does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from handnet_tpu_torch.config import A2JConfig
from handnet_tpu_torch.nn.quant import conv_layer
from handnet_tpu_torch.nn.resnet import (GroupNorm, init_conv_weights_, make_norm, norm_relu,
                                         resnet50_dilated)
from handnet_tpu_torch.ops.anchors import a2j_anchor_grid
from handnet_tpu_torch.ops.cuda_a2j import (a2j_decode, a2j_decode_reference, a2j_decode_xy,
                                            a2j_decode_xy_reference)
from handnet_tpu_torch.ops.focal import smooth_l1


class A2JHead(nn.Module):
    """4 x (conv3x3 + BN + ReLU) + output conv3x3 (a2j/a2j.py:44-181), the
    norm layers named by ``norm``; a GroupNorm takes its ReLU into K2a."""

    def __init__(self, in_channels: int, out_channels: int, features: int = 256,
                 quant: Any = False, norm: str = "frozen"):
        super().__init__()
        norm_layer = make_norm(norm)
        for i in range(1, 5):
            setattr(self, f"conv{i}", conv_layer(quant, in_channels if i == 1 else features,
                                                 features, 3, padding=1))
            setattr(self, f"bn{i}", norm_layer(features))
        self.output = nn.Conv2d(features, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = norm_relu(getattr(self, f"bn{i}"), getattr(self, f"conv{i}")(x))
        return self.output(x)


class A2J(nn.Module):
    """Dilated ResNet-50 + the classification, regression and (3D only)
    depth heads. ``forward`` returns the raw flat head tensors."""

    def __init__(self, cfg: Optional[A2JConfig] = None, norm: str = "frozen"):
        super().__init__()
        cfg = cfg or A2JConfig()
        if cfg.backbone != "resnet50":
            raise NotImplementedError(f"A2J: backbone {cfg.backbone!r} (only the dilated "
                                      "ResNet-50 is ported)")
        self.cfg = cfg
        stem_in = 3 if cfg.in_channels == 1 else cfg.in_channels
        body = resnet50_dilated(in_channels=stem_in, quant=cfg.quant, norm=norm)
        self.Backbone = nn.ModuleDict({"model": body})
        a, p, f = cfg.num_anchors, cfg.num_joints, cfg.head_features
        self.classificationModel = A2JHead(1024, a * p, f, cfg.quant, norm)
        self.regressionModel = A2JHead(2048, a * p * 2, f, cfg.quant, norm)
        if cfg.is_3d:
            self.DepthRegressionModel = A2JHead(2048, a * p, f, cfg.quant, norm)

    def init_weights_(self, generator: torch.Generator) -> None:
        """Seeded random init (conv kernels LeCun-normal)."""
        init_conv_weights_(self, generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: ``[B, H, W, C]``, C = 1 (depth) or 4 (RGBD). Returns cls
        ``[B, N, P]``, reg ``[B, N, P, 2]`` and, for the 3D A2J, depth
        ``[B, N, P]``, with N = feat_h * feat_w * A in (h, w, a) order."""
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

        out = {"cls": flat(self.classificationModel(x3)),
               "reg": flat(self.regressionModel(x4), 2)}
        if cfg.is_3d:
            out["depth"] = flat(self.DepthRegressionModel(x4))
        return out


def anchors_for(cfg: A2JConfig) -> np.ndarray:
    return a2j_anchor_grid(cfg.feat_h, cfg.feat_w, cfg.stride,
                           cfg.anchor_offsets, transposed=cfg.transposed_anchors)


def a2j_postprocess(heads: Dict[str, torch.Tensor], anchors: torch.Tensor,
                    use_kernel: bool = True) -> torch.Tensor:
    """Anchor aggregation -> UVD keypoints ``[B, P, 3]`` float32 through
    kernel K1 (``ops/cuda_a2j.py``), or, for heads without ``"depth"`` (the
    2D A2J), UV ``[B, P, 2]`` through K1xy; their plain versions when
    ``use_kernel`` is False."""
    if "depth" not in heads:
        decode_xy = a2j_decode_xy if use_kernel else a2j_decode_xy_reference
        return decode_xy(heads["cls"], heads["reg"], anchors)
    decode = a2j_decode if use_kernel else a2j_decode_reference
    return decode(heads["cls"], heads["reg"], heads["depth"], anchors)


def a2j_loss(heads: Dict[str, torch.Tensor], gt_uvd: torch.Tensor, anchors: torch.Tensor,
             spatial_factor: float = 0.5, depth_beta: float = 3.0,
             reference_depth_quirk: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """A2J anchor-surrogate and offset losses (reference a2j/anchor.py:84-153;
    ``handnet_tpu/models/a2j.py:156-199``): ``(cls_loss, reg_loss)``, scalar
    means over the batch; the caller scales ``reg_loss`` by
    ``reg_loss_factor``.

    * classification: smooth-L1 (beta 1) between the GT (u, v) and the
      softmax-weighted anchors;
    * regression: smooth-L1 (beta 1) of the softmax-weighted ``anchor +
      offset``, times ``spatial_factor``, plus, where the heads hold
      ``"depth"`` (the 3D A2J), the depth term: the *raw L1 mean* of the
      weighted depth's error where ``reference_depth_quirk`` (the reference
      computes a smooth-L1 and adds the L1, anchor.py:145-150), else its
      smooth-L1 with ``beta=depth_beta``. ``gt_uvd`` may then be ``[B, P,
      2]``.

    Everything runs in float32 with autocast off, whatever the heads' dtype
    and the caller's region: the three einsums are matrix products, which
    autocast would run in bf16, where the JAX package computes them in
    float32 on float32 inputs.

    Data parallel: both losses are means over the batch, so over equal
    shards the mean of the ranks' losses, which ``DistributedDataParallel``'s
    gradient average differentiates, is the whole-batch loss: unlike
    ``fcos_loss`` and the R-CNN losses it needs no global normalizer and no
    world-size scale.
    """
    with torch.autocast(heads["cls"].device.type, enabled=False):
        w = torch.softmax(heads["cls"].float(), dim=1)                  # [B, N, P]
        anchors = anchors.float()
        gt_xy = gt_uvd[..., :2].float()                                 # [B, P, 2]
        anchor_pos = torch.einsum("bnp,nc->bpc", w, anchors)
        anchor_loss = smooth_l1(gt_xy - anchor_pos, beta=1.0).mean(dim=(1, 2))
        pos = anchors[None, :, None, :] + heads["reg"].float()          # [B, N, P, 2]
        pred_xy = torch.einsum("bnp,bnpc->bpc", w, pos)
        reg_loss = smooth_l1(gt_xy - pred_xy, beta=1.0).mean(dim=(1, 2)) * spatial_factor
        if "depth" in heads:
            pred_d = torch.einsum("bnp,bnp->bp", w, heads["depth"].float())
            diff_d = gt_uvd[..., 2].float() - pred_d
            if reference_depth_quirk:
                depth_term = diff_d.abs().mean(dim=1)                   # anchor.py:150
            else:
                depth_term = smooth_l1(diff_d, beta=depth_beta).mean(dim=1)
            reg_loss = reg_loss + depth_term
        return anchor_loss.mean(), reg_loss.mean()


class A2JSystem(A2J):
    """The A2J module plus its anchor table (a non-persistent buffer) and the
    ``predict``, ``losses`` and ``loss_and_predict`` entries. ``use_kernels``
    decodes through K1, or K1xy for the 2D A2J, and runs a ``"group"``
    model's norms through K2s and K2a (else the plain versions of all
    three); setting it later switches them all. ``norm`` as :class:`A2J`."""

    def __init__(self, cfg: Optional[A2JConfig] = None, use_kernels: bool = True,
                 norm: str = "frozen"):
        super().__init__(cfg, norm)
        self.use_kernels = use_kernels
        self.register_buffer("anchors", torch.from_numpy(anchors_for(self.cfg)),
                             persistent=False)

    @property
    def use_kernels(self) -> bool:
        return self._use_kernels

    @use_kernels.setter
    def use_kernels(self, on: bool) -> None:
        self._use_kernels = on
        for m in self.modules():
            if isinstance(m, GroupNorm):
                m.use_kernel = on

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return a2j_postprocess(self(x), self.anchors, use_kernel=self.use_kernels)

    def losses(self, heads: Dict[str, torch.Tensor], gt_uvd: torch.Tensor,
               reg_loss_factor: float = 3.0) -> Dict[str, torch.Tensor]:
        """:func:`a2j_loss` with ``reg_loss`` times ``reg_loss_factor`` (the
        reference's loss = cls + 3 * reg, a2j/a2j.py:224-238), as the
        ``classification``, ``regression`` and ``total_loss`` entries."""
        cls_loss, reg_loss = a2j_loss(heads, gt_uvd, self.anchors, self.cfg.spatial_factor)
        reg_loss = reg_loss * reg_loss_factor
        return {"classification": cls_loss, "regression": reg_loss,
                "total_loss": cls_loss + reg_loss}

    def loss_and_predict(self, x: torch.Tensor, gt_uvd: torch.Tensor,
                         reg_loss_factor: float = 3.0
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The losses of this module's forward on depth crops ``x`` and its
        decoded UVD ``[B, P, 3]`` (UV ``[B, P, 2]`` for the 2D A2J), in the
        module's mode: ``train()`` takes a
        ``"batch"`` model's statistics from the batch and moves its running
        statistics (the JAX package returns them as ``updates``). The
        prediction carries no gradient."""
        heads = self(x)
        with torch.no_grad():
            pred = a2j_postprocess({k: v.detach() for k, v in heads.items()}, self.anchors,
                                   use_kernel=self.use_kernels)
        return self.losses(heads, gt_uvd, reg_loss_factor), pred
