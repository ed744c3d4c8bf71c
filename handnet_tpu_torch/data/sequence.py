"""Multi-camera sequence loader with the depth deprojection on the device.

Counterpart of ``handnet_tpu/data/sequence.py`` (reference dex-ycb-toolkit
SequenceLoader, sequence_loader.py:20-559, which deprojects the depth maps
of all 8 cameras into masked world-frame point clouds per frame,
``_deproject_depth_and_filter_points``:304).

The deprojection is one batched product over all cameras at once: ``[C, H,
W]`` depth -> ``[C, H*W, 3]`` world points and ``[C, H*W]`` masks, with the
cameras' inverse intrinsics and extrinsics held on the loader's device. The
host only decodes the PNGs (``data/image_io.py``) and reads the YAML
(``data/yaml_lite.py``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from handnet_tpu_torch.data import image_io, yaml_lite


def deproject_depth(depth_m: torch.Tensor, inv_k: torch.Tensor, cam_to_world: torch.Tensor,
                    filter_z: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[C, H, W]`` metric depth -> (``[C, H*W, 3]`` world points, ``[C, H*W]``
    mask of depths above ``filter_z``), on the inputs' device, float32.

    inv_k: ``[C, 3, 3]`` inverse intrinsics; cam_to_world: ``[C, 4, 4]``.
    """
    c, h, w = depth_m.shape
    dev = depth_m.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([grid_x, grid_y, torch.ones_like(grid_x)], dim=0).reshape(3, -1)  # [3, HW]
    depth = depth_m.to(torch.float32).reshape(c, 1, -1)
    rays = torch.matmul(inv_k.to(torch.float32), pix)                  # [C, 3, HW]
    pts_h = torch.cat([rays * depth, torch.ones_like(depth)], dim=1)   # [C, 4, HW]
    pts_world = torch.matmul(cam_to_world.to(torch.float32)[:, :3], pts_h)  # [C, 3, HW]
    return pts_world.transpose(1, 2), depth_m.reshape(c, -1) > filter_z


def load_extrinsics(dex_ycb_dir: str, extrinsics_name: str,
                    serials: List[str]) -> List[np.ndarray]:
    """Read calibration/extrinsics_<name>/extrinsics.yml into 4x4 cam->world
    transforms per serial (sequence_loader.py:86-99 layout: 12 row-major
    numbers per camera)."""
    path = os.path.join(dex_ycb_dir, "calibration", f"extrinsics_{extrinsics_name}",
                        "extrinsics.yml")
    extr = yaml_lite.load(path)["extrinsics"]
    out = []
    for s in serials:
        t44 = np.eye(4, dtype=np.float32)
        t44[:3] = np.asarray(extr[s], np.float32).reshape(3, 4)
        out.append(t44)
    return out


def sequence_loader_from_meta(dex_ycb_dir: str, sequence: str, serials: List[str],
                              device=None) -> "SequenceLoader":
    """A :class:`SequenceLoader` straight from a sequence's meta.yml and the
    calibration tree (the reference constructor's path,
    sequence_loader.py:40-99)."""
    seq_dir = os.path.join(dex_ycb_dir, sequence)
    meta = yaml_lite.load(os.path.join(seq_dir, "meta.yml"))
    intrinsics = [yaml_lite.load(os.path.join(dex_ycb_dir, "calibration", "intrinsics",
                                              f"{s}_640x480.yml"))["color"]
                  for s in serials]
    extrinsics = load_extrinsics(dex_ycb_dir, meta["extrinsics"], serials)
    return SequenceLoader(seq_dir, serials, intrinsics, extrinsics, device=device)


class SequenceLoader:
    """Frame loader over one DexYCB sequence directory across its cameras.

    ``device``: where ``inv_k`` ``[C, 3, 3]`` and ``cam_to_world`` ``[C, 4,
    4]`` live and :meth:`points` deprojects. None (the default) is the card
    and raises where there is none; pass ``"cpu"`` to run on the CPU.
    """

    def __init__(self, sequence_dir: str, serials: List[str], intrinsics: List[Dict],
                 extrinsics: Optional[List[np.ndarray]] = None, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("SequenceLoader: no CUDA device (torch.cuda.is_available() "
                                   "is False); pass device=\"cpu\" to deproject on the CPU.")
            device = "cuda"
        self.device = torch.device(device)
        self.sequence_dir = sequence_dir
        self.serials = serials
        inv_k = [np.linalg.inv(np.array([[intr["fx"], 0, intr["ppx"]],
                                         [0, intr["fy"], intr["ppy"]],
                                         [0, 0, 1]], np.float32))
                 for intr in intrinsics]
        self.inv_k = torch.from_numpy(np.stack(inv_k).astype(np.float32)).to(self.device)
        if extrinsics is None:
            extrinsics = [np.eye(4, dtype=np.float32) for _ in serials]
        self.cam_to_world = torch.from_numpy(
            np.stack(extrinsics).astype(np.float32)).to(self.device)
        probe = os.path.join(sequence_dir, serials[0])
        self.num_frames = len([f for f in os.listdir(probe) if f.startswith("aligned_depth")])

    def depth_frames(self, frame: int) -> np.ndarray:
        """``[C, H, W]`` float32 depth in metres: each camera's 16-bit PNG in
        millimetres, decoded on the host."""
        return np.stack([
            image_io.read_png(os.path.join(self.sequence_dir, s,
                                           f"aligned_depth_to_color_{frame:06d}.png"))
            .astype(np.float32) / 1000.0
            for s in self.serials])

    def points(self, frame: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """World-frame point clouds ``[C, H*W, 3]`` and masks ``[C, H*W]`` of
        all cameras of one frame, on the loader's device."""
        depth = torch.from_numpy(self.depth_frames(frame)).to(self.device)
        return deproject_depth(depth, self.inv_k, self.cam_to_world)
