"""Pose2Mesh: 2D joints -> 3D joints (MLP lifter) -> 778-vertex hand mesh
(coarse-to-fine Chebyshev GCN), serving forward.

Counterpart of ``handnet_tpu/models/pose2mesh.py`` (``PoseNet``,
``cheby_conv``, ``ChebyLayer``, ``MeshNet``, ``Pose2Mesh`` and the two joint
normalizations). Parameter names follow the reference's FlatPose2Mesh state
dict (``pose_lifter.{w1, linear_stages.i.{w1, batch_norm1, w2, batch_norm2},
w2}``, ``pose2mesh.{fc, cl.N, bn.N}``), so the JAX package's
``convert_pose2mesh`` reads them. The reference's ``pose_lifter.batch_norm1``
is never used in its forward and is not declared here. Dropout is off at
inference and not modelled.

Inside ``MeshNet`` activations are VERTEX-MAJOR, ``[V, B, F]``: the
Chebyshev products ``L @ X`` are then one ``[V, V] x [V, B*F]`` GEMM on
contiguous memory, and the binary-tree upsample is a ``repeat_interleave``
of whole rows. The Laplacians, the residual resize matrices and the linear
weights are held in the compute dtype; the BatchNorms form their scale and
shift from float32 statistics (``FrozenBatchNorm1d``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from handnet_tpu_torch.config import Pose2MeshConfig
from handnet_tpu_torch.ops.graph import GraphPyramid


class FrozenBatchNorm1d(nn.Module):
    """BatchNorm over the last axis with fixed statistics: ``x * mul + add``,
    ``mul`` and ``add`` formed in float32 from the running statistics and
    cast to the activation dtype. eps is 1e-5 (flax's and torch's default)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        add = self.bias.float() - self.running_mean.float() * mul
        return torch.addcmul(add.to(x.dtype), x, mul.to(x.dtype))


class Dense(nn.Linear):
    """``nn.Linear`` that casts its input to its weight's dtype (flax
    ``Dense(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class LinearStage(nn.Module):
    """BN -> ReLU -> Linear, twice, with the skip (posenet.py:11-38;
    ``handnet_tpu`` ``ResidualLinearBlock``)."""

    def __init__(self, size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w1 = Dense(size, size, dtype=dtype)
        self.batch_norm1 = FrozenBatchNorm1d(size)
        self.w2 = Dense(size, size, dtype=dtype)
        self.batch_norm2 = FrozenBatchNorm1d(size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.w1(torch.relu_(self.batch_norm1(x)))
        y = self.w2(torch.relu_(self.batch_norm2(y)))
        return x + y


class PoseNet(nn.Module):
    """2D -> 3D joint lifter (posenet.py:41-98): 2J -> hid -> (residual
    stage x stages) -> 3J."""

    def __init__(self, num_joints: int = 21, hid: int = 4096, stages: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_joints = num_joints
        self.w1 = Dense(num_joints * 2, hid, dtype=dtype)
        self.linear_stages = nn.ModuleList([LinearStage(hid, dtype) for _ in range(stages)])
        self.w2 = Dense(hid, num_joints * 3, dtype=dtype)

    def forward(self, pose2d: torch.Tensor) -> torch.Tensor:
        b = pose2d.shape[0]
        x = self.w1(pose2d.reshape(b, -1))
        for stage in self.linear_stages:
            x = stage(x)
        return self.w2(x).reshape(b, self.num_joints, 3)


def cheby_conv(x: torch.Tensor, L: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, k: int) -> torch.Tensor:
    """K-order Chebyshev graph convolution, dense (cheby_graph_conv.py:5-42).

    x ``[V, B, Fin]`` (vertex-major), L ``[V, V]`` rescaled Laplacian,
    weight ``[Fout, Fin*K]`` (torch Linear layout; the flax kernel is its
    transpose) whose input axis has the features slowest and k fastest, as
    the reference flattens its stacked terms. Returns ``[V, B, Fout]``.

    The recurrence's ``2 L T_{k-1} - T_{k-2}`` is one ``addmm``. The terms
    are laid side by side k-major, ``[V*B, K, Fin]`` (a copy of whole
    feature rows; stacked k-minor, as the reference does, the copy
    interleaves single elements and took 4.4 of the head's 7.2 ms on an
    H100), and the weight's input axis is put in the same order.
    """
    v, b, fin = x.shape
    flat = x.reshape(v, b * fin)
    terms = [flat]
    if k > 1:
        terms.append(L @ flat)
    for _ in range(2, k):
        terms.append(torch.addmm(terms[-2], L, terms[-1], beta=-1.0, alpha=2.0))
    if k == 1:
        return F.linear(flat.view(v * b, fin), weight, bias).view(v, b, -1)
    stacked = torch.stack([t.view(v * b, fin) for t in terms], dim=1)      # [V*B, K, Fin]
    weight = weight.view(-1, fin, k).transpose(1, 2).reshape(-1, k * fin)  # k-major
    return F.linear(stacked.view(v * b, k * fin), weight, bias).view(v, b, -1)


class ChebyLayer(nn.Linear):
    """One Chebyshev graph convolution (the reference's ``cl.N``, a Linear
    over the stacked terms). ``MeshNet`` applies the BatchNorm ``bn.N``
    after it, as ``handnet_tpu``'s ``ChebyLayer(use_bn=True)`` does."""

    def __init__(self, fin: int, fout: int, k: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__(fin * k, fout, dtype=dtype)
        self.k = k

    def forward(self, x: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
        return cheby_conv(x.to(self.weight.dtype), L, self.weight, self.bias, self.k)


def _feature_resize_matrix(fin: int, fout: int) -> np.ndarray:
    """Linear-interpolation matrix over the FEATURE axis:
    F.interpolate(mode='linear', align_corners=False) as the residual
    connections use it (meshnet.py:109-113)."""
    m = np.zeros((fin, fout), np.float32)
    scale = fin / fout
    for j in range(fout):
        src = (j + 0.5) * scale - 0.5
        lo = int(np.floor(src))
        w = src - lo
        lo_c = min(max(lo, 0), fin - 1)
        hi_c = min(max(lo + 1, 0), fin - 1)
        m[lo_c, j] += 1.0 - w
        m[hi_c, j] += w
    return m


class MeshNet(nn.Module):
    """Coarse-to-fine Chebyshev GCN (meshnet.py:11-117).

    The pyramid's second-coarsest mesh level is dropped (meshnet.py:38,
    ``del graph_L[-2]``); block 0 runs on the joint graph, an fc lifts it to
    the coarsest mesh level kept, and each later block but the last two
    adds its resized input and doubles the nodes (binary-tree upsample).
    """

    def __init__(self, pyramid: GraphPyramid, in_channels: int = 5, out_channels: int = 3,
                 k: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        laps = list(pyramid.laplacians)
        del laps[-2]
        for i, lap in enumerate(laps):
            self.register_buffer(f"lap{i}", torch.from_numpy(lap).to(dtype), persistent=False)
        self.num_laps = len(laps)
        # channel plan (meshnet.py:23-27, mano branch)
        self.block_channels = [
            (in_channels, 32, 64, 64),
            (64, 128, 256), (256, 256, 256), (256, 256, 256),
            (256, 256, 256), (256, 128, 128),
            (128, 64, out_channels),
        ]
        cl = [ChebyLayer(chans[li], chans[li + 1], k, dtype)
              for chans in self.block_channels for li in range(len(chans) - 1)]
        self.cl = nn.ModuleList(cl)
        # every layer but the last has a BatchNorm, bn.N after cl.N
        self.bn = nn.ModuleList([FrozenBatchNorm1d(layer.out_features) for layer in cl[:-1]])
        self.joint_nodes = laps[-1].shape[0]
        self.up_nodes = laps[-2].shape[0]
        self.fc = Dense(self.joint_nodes * self.block_channels[0][-1],
                        self.up_nodes * self.block_channels[1][0], dtype=dtype)
        # residual resizes over the feature axis; an identity (fin == fout)
        # is skipped, which is exact
        for i, chans in enumerate(self.block_channels[1:-1], start=1):
            if chans[0] != chans[-1]:
                self.register_buffer(
                    f"resize{i}", torch.from_numpy(_feature_resize_matrix(chans[0], chans[-1]))
                    .to(dtype), persistent=False)

    def laplacian(self, ldx: int) -> torch.Tensor:
        return getattr(self, f"lap{ldx % self.num_laps}")

    def _residual(self, i: int, input_x: torch.Tensor) -> torch.Tensor:
        rm = getattr(self, f"resize{i}", None)
        if rm is None:
            return input_x
        v, b, f = input_x.shape
        return (input_x.reshape(v * b, f) @ rm).view(v, b, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x ``[B, J, in_channels]`` -> mesh ``[V_padded, B, 3]``, vertex-major
        (``pyramid.perm_reverse[:778]`` recovers the vertex order)."""
        b = x.shape[0]
        x = x.transpose(0, 1).contiguous()                       # [J, B, C]
        n_blocks = len(self.block_channels)
        li = 0
        for i, chans in enumerate(self.block_channels):
            ldx = -(i + 1) if i < n_blocks - 1 else -i
            L = self.laplacian(ldx)
            input_x = x
            for _ in range(len(chans) - 1):
                x = self.cl[li](x, L)
                if li < len(self.bn):       # all but the very last layer
                    x = torch.relu_(self.bn[li](x))
                li += 1
            if i == 0:
                # joint graph -> first mesh level (meshnet.py:104-106): the
                # fc reads [B, J*64] joint-major
                x = self.fc(x.transpose(0, 1).reshape(b, -1))
                x = x.view(b, self.up_nodes, -1).transpose(0, 1).contiguous()
            elif i < n_blocks - 2:
                x = x + self._residual(i, input_x)
                x = x.repeat_interleave(2, dim=0)                 # binary-tree upsample
            elif i == n_blocks - 2:
                x = x + self._residual(i, input_x)
        return x

    def init_weights_(self, generator: torch.Generator) -> None:
        """Seeded random init: the Chebyshev weights uniform in +-sqrt(2 /
        (K*Fin + Fout)) (meshnet.py:50-52), the fc LeCun-normal, biases 0."""
        with torch.no_grad():
            for layer in self.cl:
                scale = math.sqrt(2.0 / (layer.in_features + layer.out_features))
                draw = torch.rand(layer.weight.shape, generator=generator) * (2 * scale) - scale
                layer.weight.copy_(draw)
                layer.bias.zero_()
            _lecun_normal_(self.fc, generator)


def _lecun_normal_(layer: nn.Linear, generator: torch.Generator) -> None:
    with torch.no_grad():
        std = 1.0 / math.sqrt(layer.in_features)
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator) * std)
        layer.bias.zero_()


class Pose2Mesh(nn.Module):
    """FlatPose2Mesh (pose2mesh_net.py:8-28): lifter + GCN; the lifted 3D
    pose is detached and divided by 1000 before the concatenation.

    Args:
      pyramid: the graph pyramid (``ops/graph.py`` ``build_graph_pyramid``).
      cfg: the lifter's widths and the Chebyshev order.
      dtype: compute dtype of the linear layers, the Chebyshev products and
        the residual resizes (the BatchNorms' statistics stay float32).
    """

    def __init__(self, pyramid: GraphPyramid, cfg: Pose2MeshConfig = Pose2MeshConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pose_lifter = PoseNet(cfg.num_joints, cfg.posenet_hid, cfg.posenet_stages, dtype)
        self.pose2mesh = MeshNet(pyramid, in_channels=5, k=cfg.cheby_order, dtype=dtype)

    def init_weights_(self, generator: torch.Generator) -> None:
        """Seeded random init: the lifter's linears LeCun-normal (flax
        ``Dense``'s default), then the GCN (:meth:`MeshNet.init_weights_`);
        norms at identity."""
        for layer in self.pose_lifter.modules():
            if isinstance(layer, nn.Linear):
                _lecun_normal_(layer, generator)
        self.pose2mesh.init_weights_(generator)

    def forward(self, pose2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pose2d ``[B, J, 2]`` (normalized) -> (mesh ``[B, V_padded, 3]`` in
        the compute dtype, a view of the vertex-major result; pose3d
        ``[B, J, 3]``)."""
        pose3d = self.pose_lifter(pose2d)
        combined = torch.cat([pose2d.float(), (pose3d.detach() / 1000.0).float()], dim=2)
        return self.pose2mesh(combined).transpose(0, 1), pose3d


def normalize_joints_for_pose2mesh_batched(joints2d: torch.Tensor,
                                           input_shape=(384, 288)) -> torch.Tensor:
    """``[B, J, 2]`` -> ``[B, J, 2]`` float32, on the device: the bbox,
    aspect, affine and standardization of :func:`normalize_joints_for_pose2mesh`
    with its branches as selects, plus eps guards so that all-zero (masked
    "no hand") rows stay finite. The std is the population std, as
    ``jnp.std``'s."""
    j = joints2d.float()
    x, y = j[..., 0], j[..., 1]
    xmin, ymin = x.amin(dim=-1), y.amin(dim=-1)
    w = x.amax(dim=-1) - xmin
    h = y.amax(dim=-1) - ymin
    w = torch.where(w > 1, w - 1, w)
    h = torch.where(h > 1, h - 1, h)
    cx = xmin + w / 2.0
    cy = ymin + h / 2.0
    aspect = input_shape[1] / input_shape[0]
    # only the width of the aspect-fixed box matters: s is the one isotropic
    # scale, and the final per-axis standardization absorbs offsets
    new_w = torch.where(w < aspect * h, h * aspect, w)
    dst_w, dst_h = float(input_shape[1]), float(input_shape[0])
    s = dst_w / new_w.clamp_min(1e-4)
    u = ((x - cx[..., None]) * s[..., None] + dst_w / 2.0) / dst_w
    v = ((y - cy[..., None]) * s[..., None] + dst_h / 2.0) / dst_h
    out = torch.stack([u, v], dim=-1)
    mean = out.mean(dim=-2, keepdim=True)
    std = out.std(dim=-2, correction=0, keepdim=True)
    return (out - mean) / (std + 1e-8)


def normalize_joints_for_pose2mesh(joints2d: np.ndarray,
                                   input_shape=(384, 288)) -> np.ndarray:
    """The demo-side 2D-joint normalization on the host (ros_demo.py:148-160
    predict_mesh): bbox from joints -> aspect-fixed box -> affine to the
    model input frame -> scale to [0, 1] -> standardize over the joints."""
    j = np.asarray(joints2d, np.float64)
    xmin, ymin = j[:, 0].min(), j[:, 1].min()
    xmax, ymax = j[:, 0].max(), j[:, 1].max()
    # process_bbox aspect fix (coord_utils.py:42-67)
    w = xmax - xmin
    h = ymax - ymin
    x1, y1 = xmin, ymin
    w = w - 1 if w > 1 else w
    h = h - 1 if h > 1 else h
    cx, cy = x1 + w / 2.0, y1 + h / 2.0
    aspect = input_shape[1] / input_shape[0]
    if w > aspect * h:
        h = w / aspect
    elif w < aspect * h:
        w = h * aspect
    # affine: center -> input center, scale w -> input_w (aug_utils.py:140-173,
    # rot=0)
    dst_w, dst_h = input_shape[1], input_shape[0]
    s = dst_w / w
    out = np.empty_like(j)
    out[:, 0] = (j[:, 0] - cx) * s + dst_w / 2.0
    out[:, 1] = (j[:, 1] - cy) * s + dst_h / 2.0
    out /= np.array([[dst_w, dst_h]])
    mean = out.mean(axis=0)
    std = out.std(axis=0)
    return ((out - mean) / std).astype(np.float32)
