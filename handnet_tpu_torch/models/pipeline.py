"""HandNetPipeline — the fused frame -> joints forward.

Counterpart of ``handnet_tpu/models/pipeline.py:32-196,263-271``: normalize ->
ResNet-34+FPN+GN towers (kernel K2) -> fixed-shape decode + NMS -> masked
argmax hand selection -> 40% pad -> nearest crop -> dilated ResNet-50 + A2J
heads -> anchor decode (kernel K1) -> optional XYZ unprojection. Frames of
any size are resized to the detector's input (``models/fcos.py``
``preprocess``); :meth:`HandNetPipeline.detect` and
:meth:`HandNetPipeline.pose` run either half alone. Frames
without a hand flow through as masked zeros instead of control flow
(reference handnet_pipeline.py:81-83,107-108).

With ``quant`` configs the backbones, FPN and towers run int8 convolutions
(kernels K3q and K3g, ``nn/quant.py``); a ``quant="static"`` pipeline is calibrated by
:meth:`HandNetPipeline.calibrate` (or ``nn.quant.load_calibration``) before it
serves.

With ``pipeline.with_mesh`` the forward goes on from the joints to a
778-vertex hand mesh in the same call (``handnet_tpu/models/pipeline.py:49-69,
176-195``): the crop-frame UV joints are normalized on the device and run
through Pose2Mesh (``models/pose2mesh.py``) over the graph pyramid of the
mesh (``ops/graph.py``), built once at construction. Without ``mesh_faces``
the pyramid is that of a same-size strip stand-in for the licensed MANO
triangulation, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from handnet_tpu_torch.config import HandNetConfig
from handnet_tpu_torch.models.a2j import A2JSystem
from handnet_tpu_torch.models.fcos import FCOSSystem
from handnet_tpu_torch.models.pose2mesh import Pose2Mesh, normalize_joints_for_pose2mesh_batched
from handnet_tpu_torch.nn.quant import QuantConv, apply_margin, set_calibrating
from handnet_tpu_torch.ops.crop_resize import crop_resize_nearest, pad_box
from handnet_tpu_torch.ops.geometry import convert_joints, crop_uvd_to_image_uvd
from handnet_tpu_torch.ops.graph import HAND_SKELETON, build_graph_pyramid, strip_faces


class HandNetPipeline(nn.Module):
    """RGB(+D) frames in, UVD (and XYZ) joints out.

    Args:
      cfg: the config tree (``config.load_config(overrides=config.FAST)``
        is the fast operating point).
      dtype: compute dtype of the convolutions (float32 or bfloat16); norm
        parameters, int8 layers' master weights and the decode stay
        float32, as in the JAX package.
      device: where the weights live; inputs must be on the same device.
        None (the default) is the card, ``"cuda"``, and raises where there
        is no CUDA device: the pipeline never moves to the CPU by itself.
        Pass ``"cpu"`` to run there.
      use_kernels: True (the default) runs kernels K1, K2 and (int8
        configs) K3 on CUDA tensors. False runs their plain PyTorch
        versions instead; it is never chosen automatically and exists to
        price the kernels.
      seed: seed of the ``torch.Generator`` for the random init (weights
        usually come from ``load_state_dict`` afterwards, see
        ``convert/from_flax.py``).
      mesh_faces: ``[F, 3]`` triangles of the mesh the ``with_mesh`` head
        predicts (the MANO triangulation); None is the strip stand-in.

    The state dict is ``detector.*`` (FCOS), ``a2j.*`` (A2J) and, with the
    mesh head, ``pose2mesh.*`` (Pose2Mesh), in the reference's torch names.
    """

    def __init__(self, cfg: Optional[HandNetConfig] = None,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device | str] = None,
                 use_kernels: bool = True, seed: int = 0, mesh_faces=None):
        super().__init__()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "HandNetPipeline: no CUDA device (torch.cuda.is_available() is False). "
                    "The pipeline serves on the card by default; pass device=\"cpu\" to "
                    "run on the CPU.")
            device = "cuda"
        self.cfg = cfg or HandNetConfig()
        self.detector = FCOSSystem(self.cfg.fcos, use_kernels)
        self.a2j = A2JSystem(self.cfg.a2j, use_kernels)
        hand_label = self.cfg.pipeline.hand_label
        self.hand_label = (self.cfg.fcos.num_classes - 1
                           if hand_label is None else hand_label)
        # the crop box of frames without a hand: a degenerate box that keeps
        # the crop's gather in bounds
        self.register_buffer("fallback_box", torch.tensor([0, 0, 175, 175], dtype=torch.int32),
                             persistent=False)
        self.pose2mesh = None
        if self.cfg.pipeline.with_mesh:
            faces = strip_faces() if mesh_faces is None else mesh_faces
            self.mesh_faces = np.asarray(faces, np.int64)
            self.pyramid = build_graph_pyramid(self.mesh_faces, self.cfg.pose2mesh.num_joints,
                                               HAND_SKELETON, levels=6)
            self.pose2mesh = Pose2Mesh(self.pyramid, self.cfg.pose2mesh, dtype)
            # padded GCN node -> mesh vertex order
            order = self.pyramid.perm_reverse[:self.cfg.pose2mesh.num_mesh_verts]
            self.register_buffer("mesh_order", torch.from_numpy(order), persistent=False)
        generator = torch.Generator().manual_seed(seed)
        self.detector.init_weights_(generator)
        self.a2j.init_weights_(generator)
        if self.pose2mesh is not None:
            self.pose2mesh.init_weights_(generator)
        self.to(device)
        for m in self.modules():
            if isinstance(m, QuantConv):
                # JAX quantizes the float32 kernel: a bf16 master weight
                # would change the int8 weights and their scales
                m.use_kernel = use_kernels
            elif isinstance(m, nn.Conv2d):
                m.to(dtype=dtype, memory_format=torch.channels_last)

    def needs_calibration(self) -> bool:
        """True when this config serves static int8 (``quant="static"``):
        :meth:`calibrate` or ``nn.quant.load_calibration`` must run first."""
        return "static" in (self.cfg.fcos.quant, self.cfg.a2j.quant)

    def _detect_and_crop(self, images: torch.Tensor,
                         depth_images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Detector -> best hand box -> padded crop (reference
        handnet_pipeline.py:63-102)."""
        cfg = self.cfg
        img_h, img_w = images.shape[1], images.shape[2]
        if depth_images.dim() == 3:
            depth_images = depth_images[..., None]
        if cfg.pipeline.rgbd and depth_images.shape[-1] == 4:
            # reference feeds BGR+D and swaps to RGB+D after the crop (:102)
            depth_images = depth_images[..., [2, 1, 0, 3]]

        det = self.detector.detect(images)

        # best hand box per image: masked argmax (first maximum on ties)
        is_hand = (det["labels"] == self.hand_label) & det["valid"]
        hand_scores = torch.where(is_hand, det["scores"], torch.zeros_like(det["scores"]))
        best = hand_scores.argmax(dim=1, keepdim=True)              # [B, 1]
        found = is_hand.gather(1, best)[:, 0]
        score = hand_scores.gather(1, best)[:, 0]
        box = det["boxes"].gather(1, best[..., None].expand(-1, -1, 4))[:, 0]
        side = det["sides"].gather(1, best)[:, 0]

        # pad by 40% and clip (reference :88-97, int truncation first)
        crop_box = pad_box(box, cfg.pipeline.pad_percent, img_h, img_w)
        crop_box = torch.where(found[:, None], crop_box, self.fallback_box)
        size = cfg.pipeline.crop_size
        crops = crop_resize_nearest(depth_images, crop_box, size, size)
        return {"found": found, "scores": score, "sides": side,
                "crop_box": crop_box, "crops": crops}

    @torch.inference_mode()
    def forward(self, images: torch.Tensor, depth_images: torch.Tensor,
                paras: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Args:
          images: ``[B, H, W, 3]`` RGB in 0-1, or uint8.
          depth_images: ``[B, H, W]`` depth in meters (or ``[B, H, W, C]``).
          paras: optional ``[B, 4]`` intrinsics (fx, fy, cx, cy); when
            given, ``joints_xyz`` in mm is returned too.

        Returns a dict: joints_uvd ``[B, P, 3]`` (crop frame), boxes
        ``[B, 4]`` padded crop boxes, crops ``[B, S, S, C]``, found ``[B]``,
        scores ``[B]``, sides ``[B]``, joints_uvd_full ``[B, P, 3]``
        (frame UV + depth), and joints_xyz ``[B, P, 3]`` when paras is
        given. With ``pipeline.with_mesh`` also verts ``[B, 778, 3]``
        (root-relative metres, float32) and, when paras is given, verts_xyz
        ``[B, 778, 3]`` (camera frame, mm). Frames without a hand have found
        False and zeroed joints and vertices.
        """
        cfg = self.cfg
        stage = self._detect_and_crop(images, depth_images)
        found = stage["found"]
        keep = found[:, None, None]
        boxes = stage["crop_box"].float()
        size = cfg.pipeline.crop_size

        joints_uvd = self.a2j.predict(stage["crops"]) * keep
        out = {
            "joints_uvd": joints_uvd,
            "boxes": boxes,
            "crops": stage["crops"],
            "found": found,
            "scores": stage["scores"],
            "sides": stage["sides"],
            "joints_uvd_full": crop_uvd_to_image_uvd(joints_uvd, boxes, size, size) * keep,
        }
        if paras is not None:
            out["joints_xyz"] = convert_joints(joints_uvd, boxes, paras, size, size) * keep
        if self.pose2mesh is not None:
            # the normalization is similarity-invariant: crop-frame UV feeds
            # the lifter as frame UV would (ros_demo.py:148-160)
            mesh, _ = self.pose2mesh(normalize_joints_for_pose2mesh_batched(joints_uvd[..., :2]))
            verts = mesh[:, self.mesh_order].float()
            out["verts"] = verts * keep
            if paras is not None:
                # camera-frame mm, anchored at the predicted wrist
                # (ros_demo.py:334: mesh * 1000 + joints3d)
                out["verts_xyz"] = (verts * 1000.0 + out["joints_xyz"][:, :1]) * keep
        return out

    @torch.inference_mode()
    def detect(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Detector-only entry (the reference's ``is_detect=True`` branch):
        RGB frames ``[B, H, W, 3]`` (0-1 float, or uint8) -> padded
        detections in frame pixels (``FCOSSystem.detect``)."""
        return self.detector.detect(images)

    @torch.inference_mode()
    def pose(self, depth_crops: torch.Tensor) -> torch.Tensor:
        """Pose-only entry (the ``is_3D=True`` branch): depth crops
        ``[B, S, S, C]`` -> UVD joints ``[B, P, 3]`` in the crop frame."""
        return self.a2j.predict(depth_crops)

    @torch.no_grad()
    def calibrate(self, images: Union[torch.Tensor, Sequence[torch.Tensor]],
                  depth_images: Union[torch.Tensor, Sequence[torch.Tensor]],
                  margin: Optional[float] = None) -> None:
        """One-pass activation-scale calibration of the static int8 layers,
        in place (``handnet_tpu/models/pipeline.py:198-261``).

        Each static layer's ``act_amax`` folds in the global amax of every
        batch it sees, in serving order: the detector over all batches
        first, then A2J over the crops of the now calibrated, static
        detector. ``images``/``depth_images`` are one batch or sequences of
        batches. At the end every amax is widened by ``1 + margin`` (default
        ``cfg.pipeline.quant_margin``): pass all batches in one call, since
        repeated calls compound it. A no-op for float and dynamic configs.
        The mesh head has no int8 layer and does not run here.
        """
        if not self.needs_calibration():
            return
        if isinstance(images, torch.Tensor):
            batches = [(images, depth_images)]
        else:
            batches = list(zip(images, depth_images))
        try:
            set_calibrating(self.detector, True)
            for im, _ in batches:
                self.detector(self.detector.preprocess(im)[0])
            set_calibrating(self.detector, False)
            set_calibrating(self.a2j, True)
            for im, d in batches:
                self.a2j(self._detect_and_crop(im, d)["crops"])
        finally:
            set_calibrating(self, False)
        if margin is None:
            margin = self.cfg.pipeline.quant_margin
        if margin:
            apply_margin(self, margin)
