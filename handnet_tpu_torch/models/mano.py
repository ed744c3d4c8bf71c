"""MANO hand model (linear blend skinning), batched.

Counterpart of ``handnet_tpu/models/mano.py`` (reference:
manopth/manolayer.py:13-274): PCA pose coefficients -> axis-angle ->
rotation matrices -> shape and pose blendshapes -> 3-level kinematic chain
x 5 fingers -> LBS -> 778 vertices and 21 joints in millimetres.
:class:`ManoLayer` is an ``nn.Module`` whose model tensors are
(non-persistent) buffers on one device: it has no weights to load.

Model assets load from the ``.npz`` the JAX package's converter writes
(``handnet_tpu/convert/mano_assets.py``, from the licensed
MANO_{LEFT,RIGHT}.pkl); :meth:`ManoAssets.synthetic` draws random
plausible assets for tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from handnet_tpu_torch.ops.rotation import batch_rodrigues

# finger-tip vertex ids appended as joints 16..20 (manolayer.py:250-253)
TIPS_RIGHT = (745, 317, 444, 556, 673)
TIPS_LEFT = (745, 317, 445, 556, 673)
# kinematic-chain order -> visualization order (manolayer.py:260)
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18,
                 10, 11, 12, 19, 7, 8, 9, 20)
# transforms concat [root, lev1 x5, lev2 x5, lev3 x5] -> per-finger chains
# (manolayer.py:228)
TRANSFORM_REORDER = (0, 1, 6, 11, 2, 7, 12, 3, 8, 13, 4, 9, 14, 5, 10, 15)
LEV1 = (1, 4, 7, 10, 13)
LEV2 = (2, 5, 8, 11, 14)
LEV3 = (3, 6, 9, 12, 15)


@dataclass(frozen=True)
class ManoAssets:
    """Static MANO model tensors (from MANO_{side}.pkl via the converter)."""

    v_template: np.ndarray      # [778, 3]
    shapedirs: np.ndarray       # [778, 3, 10]
    posedirs: np.ndarray        # [778, 3, 135]
    J_regressor: np.ndarray     # [16, 778]
    weights: np.ndarray         # [778, 16] skinning weights
    hands_components: np.ndarray  # [45, 45] PCA basis
    hands_mean: np.ndarray      # [45]
    faces: np.ndarray           # [1538, 3] int
    side: str = "right"

    @classmethod
    def load(cls, path: str, side: str = "right") -> "ManoAssets":
        data = np.load(path, allow_pickle=False)
        return cls(
            v_template=data["v_template"].astype(np.float32),
            shapedirs=data["shapedirs"].astype(np.float32),
            posedirs=data["posedirs"].astype(np.float32),
            J_regressor=data["J_regressor"].astype(np.float32),
            weights=data["weights"].astype(np.float32),
            hands_components=data["hands_components"].astype(np.float32),
            hands_mean=data["hands_mean"].astype(np.float32),
            faces=data["faces"].astype(np.int32),
            side=side,
        )

    @classmethod
    def synthetic(cls, rng: np.random.Generator, n_verts: int = 778,
                  side: str = "right") -> "ManoAssets":
        """Random plausible assets for tests (no licensed MANO files needed);
        the same draws as the JAX package's for the same ``rng``."""
        v = rng.normal(size=(n_verts, 3)).astype(np.float32) * 0.05
        jr = np.abs(rng.normal(size=(16, n_verts)).astype(np.float32))
        jr = jr / jr.sum(axis=1, keepdims=True)
        w = np.abs(rng.normal(size=(n_verts, 16)).astype(np.float32))
        w = w / w.sum(axis=1, keepdims=True)
        return cls(
            v_template=v,
            shapedirs=rng.normal(size=(n_verts, 3, 10)).astype(np.float32) * 0.01,
            posedirs=rng.normal(size=(n_verts, 3, 135)).astype(np.float32) * 0.001,
            J_regressor=jr,
            weights=w,
            hands_components=np.eye(45, dtype=np.float32),
            hands_mean=np.zeros(45, np.float32),
            faces=np.zeros((4, 3), np.int32),
            side=side,
        )


class ManoLayer(nn.Module):
    """MANO forward (manolayer.py:110-274, PCA pose, axis-angle root).

    ``forward(pose_coeffs [B, 3+ncomps], betas [B, 10], trans [B, 3])`` ->
    ``(verts [B, 778, 3], joints [B, 21, 3])`` in millimetres. With
    ``flat_hand_mean=False`` the PCA pose is offset by ``hands_mean``.

    Args:
      device: where the model tensors live; inputs must be there too. None
        (the default) is the card and raises where there is no CUDA device;
        pass ``"cpu"`` to run on the CPU.
    """

    def __init__(self, assets: ManoAssets, ncomps: int = 45, flat_hand_mean: bool = False,
                 use_pca: bool = True, center_idx: Optional[int] = None,
                 device: Optional[torch.device | str] = None):
        super().__init__()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ManoLayer: no CUDA device (torch.cuda.is_available() is False); "
                    "pass device=\"cpu\" to run on the CPU.")
            device = "cuda"
        self.ncomps = ncomps
        self.use_pca = use_pca
        self.center_idx = center_idx
        self.side = assets.side
        self.faces = assets.faces
        mean = np.zeros_like(assets.hands_mean) if flat_hand_mean else assets.hands_mean
        tips = TIPS_RIGHT if assets.side == "right" else TIPS_LEFT
        tensors = {
            "shapedirs": assets.shapedirs, "posedirs": assets.posedirs,
            "v_template": assets.v_template, "J_regressor": assets.J_regressor,
            "skin_weights": assets.weights, "comps": assets.hands_components[:ncomps],
            "hands_mean": mean, "homogeneous_row": np.array([0.0, 0.0, 0.0, 1.0], np.float32),
            "eye3": np.eye(3, dtype=np.float32),
            # index tables, as buffers: no host list reaches the device per call
            "tips": np.asarray(tips), "lev1": np.asarray(LEV1), "lev2": np.asarray(LEV2),
            "lev3": np.asarray(LEV3), "transform_reorder": np.asarray(TRANSFORM_REORDER),
            "joint_reorder": np.asarray(JOINT_REORDER),
        }
        for name, value in tensors.items():
            self.register_buffer(name, torch.from_numpy(np.array(value)), persistent=False)
        self.to(device)

    def _with_zeros(self, rot_trans: torch.Tensor) -> torch.Tensor:
        """[..., 3, 4] -> [..., 4, 4] homogeneous (tensutils.th_with_zeros)."""
        row = self.homogeneous_row.to(rot_trans.dtype).expand(rot_trans.shape[:-2] + (1, 4))
        return torch.cat([rot_trans, row], dim=-2)

    def forward(self, pose_coeffs: torch.Tensor, betas: Optional[torch.Tensor] = None,
                trans: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        b = pose_coeffs.shape[0]

        # PCA coeffs -> full 45-dim axis-angle hand pose (manolayer.py:129-143)
        hand_coeffs = pose_coeffs[:, 3:3 + self.ncomps]
        full_hand_pose = hand_coeffs @ self.comps if self.use_pca else hand_coeffs
        full_pose = torch.cat([pose_coeffs[:, :3], self.hands_mean + full_hand_pose], dim=1)

        # rotmats of all 16 segments; the pose blendshapes exclude the root
        rot_mats = batch_rodrigues(full_pose.reshape(b, 16, 3))        # [B, 16, 3, 3]
        root_rot = rot_mats[:, 0]
        pose_map = (rot_mats[:, 1:] - self.eye3).reshape(b, 135)

        # shape blendshapes (manolayer.py:171-184)
        if betas is None:
            v_shaped = self.v_template[None].expand(b, -1, -1)
        else:
            v_shaped = torch.einsum("vcs,bs->bvc", self.shapedirs, betas) + self.v_template[None]
        joints_rest = torch.einsum("jv,bvc->bjc", self.J_regressor, v_shaped)

        # pose blendshapes (manolayer.py:187-188)
        v_posed = v_shaped + torch.einsum("vcp,bp->bvc", self.posedirs, pose_map)

        # kinematic chain: root + 3 levels x 5 fingers (manolayer.py:193-230)
        root_j = joints_rest[:, 0:1]                                   # [B, 1, 3]
        root_tf = self._with_zeros(torch.cat([root_rot, root_j.transpose(1, 2)], dim=2))

        def level_tf(parent_tf, rots, j_rel):
            local = self._with_zeros(torch.cat([rots, j_rel[..., None]], dim=-1))
            return parent_tf @ local

        all_rots = rot_mats[:, 1:]                                     # [B, 15, 3, 3]
        lev_rots = [all_rots[:, lev - 1] for lev in (self.lev1, self.lev2, self.lev3)]
        lev1_j, lev2_j, lev3_j = (joints_rest[:, lev] for lev in (self.lev1, self.lev2,
                                                                   self.lev3))
        lev1_tf = level_tf(root_tf[:, None].expand(b, 5, 4, 4), lev_rots[0], lev1_j - root_j)
        lev2_tf = level_tf(lev1_tf, lev_rots[1], lev2_j - lev1_j)
        lev3_tf = level_tf(lev2_tf, lev_rots[2], lev3_j - lev2_j)

        transforms = torch.cat([root_tf[:, None], lev1_tf, lev2_tf, lev3_tf], dim=1)
        transforms = transforms[:, self.transform_reorder]             # [B, 16, 4, 4]

        # inverse bind: subtract the transformed rest-joint translation
        # (manolayer.py:232-234)
        joint_h = torch.cat([joints_rest, joints_rest.new_zeros(b, 16, 1)], dim=2)
        tmp = torch.einsum("bjik,bjk->bji", transforms, joint_h)        # [B, 16, 4]
        rel = transforms - torch.cat([transforms.new_zeros(b, 16, 4, 3), tmp[..., None]], dim=3)

        # LBS (manolayer.py:236-246)
        T = torch.einsum("bjik,vj->bvik", rel, self.skin_weights)       # [B, V, 4, 4]
        v_posed_h = torch.cat([v_posed, v_posed.new_ones(b, v_posed.shape[1], 1)], dim=2)
        verts = torch.einsum("bvik,bvk->bvi", T, v_posed_h)[..., :3]
        joints = transforms[:, :, :3, 3]                               # [B, 16, 3]

        # fingertips + reorder (manolayer.py:250-260)
        joints = torch.cat([joints, verts[:, self.tips]], dim=1)[:, self.joint_reorder]

        if trans is not None:
            joints = joints + trans[:, None]
            verts = verts + trans[:, None]
        elif self.center_idx is not None:
            center = joints[:, self.center_idx:self.center_idx + 1]
            joints = joints - center
            verts = verts - center
        return verts * 1000.0, joints * 1000.0
