"""Synthetic DexYCB-format fixture generator, without ``cv2`` or ``yaml``.

The port's copy of ``handnet_tpu/data/synthetic.py``: a miniature dataset
tree in the real DexYCB layout (dex_ycb.py:94-290: colour jpg / 16-bit
depth png / labels npz / calibration yml / meta.yml) with a procedurally
placed square "hand" whose 3D joints project consistently through the
synthetic intrinsics. Colour frames go through ``data/image_io.py``'s
``resize_linear_u8`` and ``imwrite_jpeg`` (``cv2.resize`` and
``cv2.imwrite`` there), depth PNGs through ``write_png`` and YAML through
``data/yaml_lite.py``.

It makes every random draw the JAX writer makes, in its order, so at one
seed the depth, the labels, the YAML contents, the returned info dict and
the colour frames' pixels equal the JAX tree's (the JPEG files are
byte-equal where the JAX writer's ``cv2`` resizes as OpenCV 5.0 does).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from handnet_tpu_torch.data import image_io, yaml_lite


def _write_yaml(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    yaml_lite.dump(obj, path)


def synthetic_sequence_number(sequence_dir: str) -> int:
    """Generation index of a synthetic sequence from its directory name
    (``2020000{s:02d}_000000``) — needed because DexYCBDataset's split
    tables FILTER sequences, so dataset sequence indices differ from
    generation indices."""
    name = os.path.basename(sequence_dir).split("_")[0]
    return int(name[7:])


def make_synthetic_dexycb(root: str, n_sequences: int = 2,
                          n_frames: int = 3, seed: int = 0,
                          h: int = 480, w: int = 640,
                          difficulty: str = "easy") -> Dict:
    """Create a 1-subject, 1-camera synthetic tree under ``root``.

    Returns dict with ground-truth bookkeeping per (seq, frame):
    hand box, joints_3d (m), paras, depth_z.

    ``difficulty="hard"``: hands of 28-48 px, a hand colour that varies per
    frame, and 3-5 hand-coloured clutter rectangles at other depths.
    """
    if difficulty not in ("easy", "hard"):
        raise ValueError(f"difficulty must be easy|hard, got {difficulty!r}")
    hard = difficulty == "hard"
    rng = np.random.default_rng(seed)
    subject = "20200709-subject-01"
    serial = "836212060125"
    fx, fy, cx, cy = 600.0, 600.0, w / 2.0, h / 2.0
    _write_yaml(os.path.join(root, "calibration", "intrinsics",
                             f"{serial}_{w}x{h}.yml"),
                {"color": {"fx": fx, "fy": fy, "ppx": cx, "ppy": cy}})
    _write_yaml(os.path.join(root, "calibration", "mano_calib0", "mano.yml"),
                {"betas": [0.0] * 10})

    info: Dict[Tuple[int, int], Dict] = {}
    for s in range(n_sequences):
        seq = f"2020000{s:02d}_000000"
        seq_dir = os.path.join(root, subject, seq)
        cam_dir = os.path.join(seq_dir, serial)
        os.makedirs(cam_dir, exist_ok=True)
        _write_yaml(os.path.join(seq_dir, "meta.yml"), {
            "num_frames": n_frames,
            "ycb_ids": [1, 5],
            "ycb_grasp_ind": 0,
            "mano_sides": ["right"],
            "mano_calib": ["calib0"],
        })
        for fidx in range(n_frames):
            # place a square "hand" at depth z
            z = float(rng.uniform(0.4, 0.8))
            hw = int(rng.integers(28, 48) if hard else rng.integers(50, 90))
            u0 = int(rng.integers(120, w - 240))
            v0 = int(rng.integers(100, h - 200))

            seg = np.zeros((h, w), np.uint8)
            seg[v0:v0 + hw, u0:u0 + hw] = 255
            # a YCB object elsewhere
            seg[20:60, 20:80] = 1

            depth_mm = np.full((h, w), 2000, np.uint16)
            depth_mm[seg == 255] = int(z * 1000)
            depth_mm[seg == 1] = 1500

            # low-frequency background (upsampled coarse noise), then
            # per-pixel noise
            coarse = rng.integers(40, 215, size=(h // 40, w // 40, 3))
            color = image_io.resize_linear_u8(coarse.astype(np.uint8), w, h)
            color = np.clip(color.astype(np.int16) + rng.integers(
                -12, 13, size=(h, w, 3)), 0, 255).astype(np.uint8)
            hand_color = (
                tuple(int(c) for c in rng.integers(-25, 26, size=3)
                      + np.array([200, 170, 150])) if hard
                else (200, 170, 150))
            if hard:
                # hand-coloured clutter at non-hand depths
                for _ in range(int(rng.integers(3, 6))):
                    cw = int(rng.integers(20, 60))
                    cu = int(rng.integers(0, w - cw))
                    cv = int(rng.integers(0, h - cw))
                    patch = (seg[cv:cv + cw, cu:cu + cw] == 0)
                    jitter = rng.integers(-20, 21, size=3)
                    color[cv:cv + cw, cu:cu + cw][patch] = np.clip(
                        np.array(hand_color) + jitter, 0, 255)
                    dpatch = depth_mm[cv:cv + cw, cu:cu + cw]
                    dpatch[patch] = int(rng.uniform(1.0, 1.8) * 1000)
            color[seg == 255] = hand_color

            # 21 joints uniformly inside the hand square, consistent 3D;
            # each stamps a shallow joint-specific depth bump so the pose is
            # inferable from the depth image
            ju = rng.uniform(u0 + 5, u0 + hw - 5, size=21)
            jv = rng.uniform(v0 + 5, v0 + hw - 5, size=21)
            for j in range(21):
                uu, vv = int(ju[j]), int(jv[j])
                bump = int(z * 1000) - 5 - j
                depth_mm[max(vv - 2, 0):vv + 3, max(uu - 2, 0):uu + 3] = bump
                color[max(vv - 2, 0):vv + 3, max(uu - 2, 0):uu + 3] = (
                    10 * j + 20, 255 - 10 * j, 128)
            joint_3d = np.stack([(ju - cx) * z / fx, (jv - cy) * z / fy,
                                 np.full(21, z)], axis=1)
            joint_2d = np.stack([ju, jv], axis=1)

            image_io.imwrite_jpeg(os.path.join(cam_dir, f"color_{fidx:06d}.jpg"), color)
            image_io.write_png(os.path.join(
                cam_dir, f"aligned_depth_to_color_{fidx:06d}.png"), depth_mm)
            pose_m = np.zeros((1, 51), np.float32)
            pose_m[0, 0] = 0.1  # non-zero => "has pose"
            np.savez(os.path.join(cam_dir, f"labels_{fidx:06d}.npz"),
                     seg=seg,
                     joint_3d=joint_3d[None].astype(np.float32),
                     joint_2d=joint_2d[None].astype(np.float32),
                     pose_m=pose_m)
            info[(s, fidx)] = {
                "hand_box": np.array([u0, v0, u0 + hw - 1, v0 + hw - 1],
                                     np.float32),
                "joints_3d": joint_3d.astype(np.float32),
                "paras": np.array([fx, fy, cx, cy], np.float32),
                "depth_z": z,
            }
    return info
