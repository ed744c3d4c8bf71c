"""ResNet backbones for the port.

Counterpart of ``handnet_tpu/nn/resnet.py``: FCOS's ResNet-34 and A2J's
ResNet-50 whose layer4 has stride 1 and dilation 2. Parameter names follow
torchvision (``conv1``, ``bn1``, ``layer{L}.{B}.conv{N}``,
``...downsample.{0,1}``), the names the JAX package's converters read.

``norm`` picks the norm layers as ``make_norm`` does there: ``"frozen"``
(the default; fixed statistics, trainable affine), ``"batch"`` (flax's
trainable BatchNorm), ``"batch_sync"`` (the same, refusing to train without
a data mesh) or ``"group"`` (flax's ``GroupNorm(32)``, eps 1e-6,
through kernels K2s and K2a on the card, the ReLU fused into K2a where one
follows directly). The two batch norms hold ``weight``, ``bias``,
``running_mean`` and ``running_var``; a GroupNorm holds ``weight`` and
``bias`` alone.

Tensors are NCHW in ``torch.channels_last`` memory: the same bytes as the JAX
package's NHWC, and the layout in which cuDNN runs bf16 convolutions.

``quant`` (False, True/"dynamic" or "static") makes every residual-block
conv, downsample included, an int8 ``QuantConv`` (``nn/quant.py``); the stem
stays float, as in the JAX package (``handnet_tpu/nn/resnet.py:198-201``),
plain or by space-to-depth (:class:`StemConv`).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from handnet_tpu_torch.nn.quant import conv_layer
from handnet_tpu_torch.ops.cuda_gn import group_norm
from handnet_tpu_torch.parallel.mesh import all_reduce_sum


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics: ``x * mul + add`` per channel.

    Serves both the FCOS backbone's frozen BN and A2J's BatchNorm in eval
    mode. ``mul``/``add`` are formed in float32 and cast to the activation
    dtype, as ``handnet_tpu`` does (nn/resnet.py:52-54). eps is 1e-5. The
    statistics are buffers that nothing updates; ``weight`` and ``bias``
    are parameters, which a trainer updates, as optax updates the JAX
    package's (``self.param``, nn/resnet.py:47-48).
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        std = torch.sqrt(self.running_var.float() + self.eps)
        scale = self.weight.float()
        mul = scale / std
        add = self.bias.float() - self.running_mean.float() * scale / std
        return x * mul.to(x.dtype)[:, None, None] + add.to(x.dtype)[:, None, None]


class BatchNorm2d(nn.Module):
    """Trainable BatchNorm with the meaning of flax's ``nn.BatchNorm(momentum
    =0.9, epsilon=1e-5, param_dtype=float32)`` (``make_norm("batch")``).

    In training mode it normalizes by the batch's statistics over (N, H, W),
    taken in float32 as ``E[x]`` and ``max(E[x^2] - E[x]^2, 0)`` (flax's fast
    variance), and moves the running statistics by ``0.9 * running + 0.1 *
    batch`` with the *biased* batch variance: ``torch.nn.BatchNorm2d``
    would store the unbiased one. In eval mode it normalizes by the running
    statistics. Either way ``(x - mean) * (rsqrt(var + eps) * weight) +
    bias`` is computed in float32 and cast to x's dtype.

    ``mesh`` (a ``parallel.DataMesh``, set by a data-parallel trainer): over
    a world of several ranks the training statistics are the global batch's,
    as flax's under a sharded ``jit``: each rank's per-channel sums of x and
    x^2 and its element count are summed over the world (differentiably)
    before the same formulas, so every rank normalizes alike and moves its
    running statistics alike.
    """

    momentum = 0.9   # flax's: the running statistics keep 0.9 of themselves

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.mesh = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _batch_statistics(self, xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.mesh is None or self.mesh.world_size == 1:
            mean = xf.mean(dim=(0, 2, 3))
            return mean, (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp(min=0.0)
        c = xf.shape[1]
        count = xf.new_full((1,), xf.numel() // c)
        sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)),
                                         count]), self.mesh)
        mean = sums[:c] / sums[-1]
        return mean, (sums[c:2 * c] / sums[-1] - mean.square()).clamp(min=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean, var = self._batch_statistics(xf)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class SyncBatchNorm2d(BatchNorm2d):
    """``make_norm("batch_sync")``: flax's ``BatchNorm(axis_name="data")``,
    statistics over the data mesh's ranks. Under a mesh it is
    :class:`BatchNorm2d`, whose statistics are global there too. Training
    without a mesh raises ``ValueError``: there is no axis to reduce over
    (JAX's ``batch_sync`` fails so under its trainers' ``jit``, with "unbound
    axis name: data")."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.mesh is None:
            raise ValueError("SyncBatchNorm2d (norm 'batch_sync'): training needs a data mesh "
                             "(a trainer's mesh=) to take its statistics over; without one "
                             "use norm 'batch'")
        return super().forward(x)


def group_norm_nchw(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float, relu: bool,
                    use_kernel: bool) -> torch.Tensor:
    """``group_norm`` of an NCHW tensor through the NHWC view of its
    channels_last bytes, which is what the kernels read."""
    nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    y = group_norm(nhwc, scale, bias, num_groups, eps, relu=relu, use_kernel=use_kernel)
    return y.permute(0, 3, 1, 2)


class GroupNorm(nn.Module):
    """GroupNorm of an NCHW (channels_last) tensor, with the ReLU that follows
    it when ``relu`` is set (or ``forward``'s ``relu`` says so): kernels K2s
    and K2a (``ops/cuda_gn.py``), two launches; ``use_kernel=False`` takes
    their plain versions instead. Parameters are named like
    ``torch.nn.GroupNorm``'s. There are no running statistics: train and
    eval normalize alike."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 relu: bool = False, use_kernel: bool = True):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.relu = relu
        self.use_kernel = use_kernel
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, relu: Optional[bool] = None) -> torch.Tensor:
        return group_norm_nchw(x, self.weight, self.bias, self.num_groups, self.eps,
                               self.relu if relu is None else relu, self.use_kernel)


NORMS = {"frozen": FrozenBatchNorm2d, "batch": BatchNorm2d, "batch_sync": SyncBatchNorm2d}


def make_norm(norm: str, use_kernel: bool = True):
    """The norm layer class for ``norm`` (``handnet_tpu/nn/resnet.py:57-70``):
    ``"group"`` is flax's ``nn.GroupNorm(num_groups=32)``, eps 1e-6;
    ``"batch_sync"`` takes its statistics over the data mesh's ranks
    (:class:`SyncBatchNorm2d`)."""
    if norm in NORMS:
        return NORMS[norm]
    if norm == "group":
        return functools.partial(GroupNorm, 32, eps=1e-6, use_kernel=use_kernel)
    raise ValueError(f"unknown norm {norm!r}")


def norm_relu(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``relu(norm(x))``, the ReLU fused into the norm's kernel where it is a
    :class:`GroupNorm`."""
    if isinstance(norm, GroupNorm):
        return norm(x, relu=True)
    return F.relu(norm(x))


class StemConv(nn.Conv2d):
    """The 7x7/stride-2 stem conv (no bias), optionally computed by
    space-to-depth (``handnet_tpu/nn/resnet.py:142-185``).

    With ``s2d`` and even H and W, the input's 2x2 pixel blocks become 12
    channels and the kernel, zero-padded to 8x8 at the top and left, is
    re-blocked to ``[O, 4*I, 4, 4]``: a stride-1 4x4 conv over the blocks,
    with 2 blocks of zero padding before and 1 after, gives the plain conv's
    output. Otherwise it is the plain conv. The parameter is the plain
    ``weight [O, I, 7, 7]`` either way, so state dicts do not change.
    """

    def __init__(self, in_channels: int, width: int, s2d: bool = False):
        super().__init__(in_channels, width, 7, stride=2, padding=3, bias=False)
        self.s2d = s2d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        if not self.s2d or h % 2 or w % 2:
            return super().forward(x)
        # out[i] = sum_d k8[d] x[2i + d - 4] with k8 the kernel padded at the
        # front; d = 2t + r is tap t of the block at offset r
        k8 = F.pad(self.weight, (1, 0, 1, 0))                     # [O, I, 8, 8]
        k8 = k8.view(self.out_channels, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
        k8 = k8.reshape(self.out_channels, 4 * c, 4, 4)           # channels (r_h, r_w, i)
        # 4 pixels of zeros before and 2 after = 2 blocks before and 1 after
        xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 4, 2, 4, 2))    # NHWC [B, H+6, W+6, I]
        hb, wb = (h + 6) // 2, (w + 6) // 2
        xs = xp.reshape(b, hb, 2, wb, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hb, wb, 4 * c)
        return F.conv2d(xs.permute(0, 3, 1, 2),
                        k8.contiguous(memory_format=torch.channels_last))


def _downsample(cin: int, cout: int, stride: int, quant: Any, norm) -> nn.Sequential:
    return nn.Sequential(conv_layer(quant, cin, cout, 1, stride=stride, bias=False),
                         norm(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 quant: Any = False, norm=FrozenBatchNorm2d):
        super().__init__()
        self.conv1 = conv_layer(quant, cin, planes, 3, stride=stride, padding=dilation,
                                dilation=dilation, bias=False)
        self.bn1 = norm(planes)
        self.conv2 = conv_layer(quant, planes, planes, 3, padding=dilation,
                                dilation=dilation, bias=False)
        self.bn2 = norm(planes)
        self.downsample = (_downsample(cin, planes, stride, quant, norm)
                           if stride != 1 or cin != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = norm_relu(self.bn1, self.conv1(x))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """Stride on the 3x3 (a2j/resnet.py:40-52, torchvision v1.5)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 quant: Any = False, norm=FrozenBatchNorm2d):
        super().__init__()
        self.conv1 = conv_layer(quant, cin, planes, 1, bias=False)
        self.bn1 = norm(planes)
        self.conv2 = conv_layer(quant, planes, planes, 3, stride=stride, padding=dilation,
                                dilation=dilation, bias=False)
        self.bn2 = norm(planes)
        self.conv3 = conv_layer(quant, planes, planes * 4, 1, bias=False)
        self.bn3 = norm(planes * 4)
        self.downsample = (_downsample(cin, planes * 4, stride, quant, norm)
                           if stride != 1 or cin != planes * 4 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = norm_relu(self.bn1, self.conv1(x))
        y = norm_relu(self.bn2, self.conv2(y))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet trunk returning the pyramid ``{"c1": ..., "c5": ...}`` (NCHW).

    ``stage_strides``/``stage_dilations`` give A2J's layer4 stride 1 and
    dilation 2. The first block of a dilated stage keeps the previous stage's
    dilation (a2j/resnet.py:133-145; ``handnet_tpu/nn/resnet.py:216-221``).
    ``s2d_stem`` computes the stem by space-to-depth (:class:`StemConv`);
    ``norm`` names the norm layers (:func:`make_norm`), and ``use_kernels``
    says whether a GroupNorm runs K2s and K2a or their plain versions.
    """

    def __init__(self, block, stage_sizes: Sequence[int], width: int = 64,
                 stage_strides: Tuple[int, ...] = (1, 2, 2, 2),
                 stage_dilations: Tuple[int, ...] = (1, 1, 1, 1),
                 in_channels: int = 3, quant: Any = False, s2d_stem: bool = False,
                 norm: str = "frozen", use_kernels: bool = True):
        super().__init__()
        norm_layer = make_norm(norm, use_kernels)
        self.conv1 = StemConv(in_channels, width, s2d=s2d_stem)
        self.bn1 = norm_layer(width)
        cin = width
        for i, num_blocks in enumerate(stage_sizes):
            planes = width * 2 ** i
            blocks = []
            for j in range(num_blocks):
                dilation = (stage_dilations[i] if j > 0
                            else stage_dilations[i - 1] if i > 0 else 1)
                stride = stage_strides[i] if j == 0 else 1
                blocks.append(block(cin, planes, stride, dilation, quant, norm_layer))
                cin = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = norm_relu(self.bn1, self.conv1(x))
        feats = {"c1": x}
        # padding of a torch max-pool is -inf, as flax max_pool's is
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            feats[f"c{i + 2}"] = x
        return feats


def resnet34(**kw) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), **kw)


def resnet50_dilated(**kw) -> ResNet:
    """A2J's backbone: layer4 stride 1, dilation 2 (a2j/resnet.py:112)."""
    return ResNet(Bottleneck, (3, 4, 6, 3), stage_strides=(1, 2, 2, 1),
                  stage_dilations=(1, 1, 1, 2), **kw)


def init_conv_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded conv init in the JAX package's defaults: kernels LeCun-normal
    (std 1/sqrt(fan_in)), biases zero. Norm layers are built as the identity
    already."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
