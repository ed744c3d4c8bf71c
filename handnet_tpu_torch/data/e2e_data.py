"""E2E full-frame dataset source: image, detection target and 3D hand sample.

Counterpart of ``handnet_tpu/data/e2e_data.py`` (reference
datasets3d/e2edataset.py:19-261): full-frame RGB, detection targets (YCB
objects by id and the hand as category 22 with its handedness box_info),
and the sample fields (the TransQueries vocabulary, datasets3d/queries.py)
with the hand box and the camera intrinsics.

The 3D labels come from the label npz (``joint_3d``) or, for the mesh,
from the port's ``ManoLayer`` regenerating it from ``pose_m`` as the
reference's load_3d does (e2edataset.py:94-157), on the layer's device.
Frames are read by ``data/image_io.py`` (the port's JPEG and PNG decoders):
no cv2.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from handnet_tpu_torch.data import image_io
from handnet_tpu_torch.data.a2j_data import hand_bbox_from_seg
from handnet_tpu_torch.data.detect_data import build_detection_target
from handnet_tpu_torch.data.dexycb import paras_from_intrinsics


class E2EDataSource:
    """Indexable DexYCB -> full e2e sample source."""

    def __init__(self, dataset, refined_idx, max_boxes: int = 8,
                 mano_layers: Optional[Dict] = None):
        """mano_layers: optional ``{'left': ManoLayer, 'right': ManoLayer}``
        (``models/mano.py``) to regenerate verts3d from pose_m when the npz
        lacks them."""
        self.dataset = dataset
        self.refined_idx = list(refined_idx)
        self.max_boxes = max_boxes
        self.mano_layers = mano_layers or {}

    def __len__(self):
        return len(self.refined_idx)

    def _mesh_from_pose(self, label, sample) -> Optional[np.ndarray]:
        """The MANO mesh ``[778, 3]`` in metres from the label's ``pose_m``
        (PCA pose 0:48, translation 48:51) and the subject's betas, through
        the side's layer on its device; None without a layer or a pose."""
        side = sample["mano_side"]
        if side not in self.mano_layers or "pose_m" not in label:
            return None
        pose_m = label["pose_m"].reshape(-1)
        if not pose_m.any():
            return None
        layer = self.mano_layers[side]
        device = layer.v_template.device
        pose = torch.from_numpy(np.asarray(pose_m, np.float32)[None]).to(device)
        betas = torch.from_numpy(np.asarray(sample["mano_betas"], np.float32)[None]).to(device)
        with torch.no_grad():
            verts, _ = layer(pose[:, :48], betas, pose[:, 48:51])
        return verts[0].cpu().numpy() / 1000.0  # back to metres

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = self.dataset[self.refined_idx[idx]]
        color = image_io.imread_color(sample["color_file"])[:, :, ::-1]
        depth = image_io.read_png(sample["depth_file"])
        label = np.load(sample["label_file"])

        target = build_detection_target(label["seg"], sample["ycb_ids"],
                                        sample["mano_side"], self.max_boxes, e2e=True)
        hand_box = hand_bbox_from_seg(label["seg"], pad_percent=0.0)
        if hand_box is None:
            hand_box = np.zeros(4, np.float32)

        joints2d = label["joint_2d"].reshape(21, 2).astype(np.float32)
        out = {
            "image": color.astype(np.float32) / 255.0,
            "depth": depth.astype(np.float32) / 1000.0,
            "dexycb_id": np.asarray([self.refined_idx[idx]], np.int64),
            "joints3d": label["joint_3d"].reshape(21, 3).astype(np.float32),
            # joints2d relative to the hand box corner (e2edataset.py:223)
            "joints2d": joints2d - hand_box[None, :2].astype(np.float32),
            "joints2d_abs": joints2d,
            "hand_box": np.asarray(hand_box, np.float32),
            "side": np.asarray([1 if sample["mano_side"] == "right" else 0], np.int32),
            "paras": paras_from_intrinsics(sample["intrinsics"]),
            **{f"target_{k}": v for k, v in target.items()},
        }
        verts = self._mesh_from_pose(label, sample)
        if verts is not None:
            out["verts3d"] = verts.astype(np.float32)
        return out
