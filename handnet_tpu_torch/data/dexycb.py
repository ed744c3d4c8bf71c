"""DexYCB dataset reader — layout-compatible with the published dataset.

A copy of ``handnet_tpu/data/dexycb.py`` that reads the YAML files with
``data/yaml_lite.py`` instead of ``yaml`` (the port imports nothing of the
JAX package); the split tables, the sample dicts, the refined-index pickle
cache and the HPE ground truth are the same.

Reference: dex-ycb-toolkit/dex_ycb_toolkit/dex_ycb.py:94-290 (directory
layout, s0-s3 split definitions, sample dict fields) and factory.py:8-32.
Re-written clean: same split index math, same sample contract
(color_file/depth_file/label_file/intrinsics/ycb_ids/mano_side/mano_betas),
no torch.

Also hosts the refined-index generator (refine_idx_gen.py:8-30 equivalent:
drop samples whose 2D joints fall outside the frame) and the HPE ground-truth
extraction the evaluator consumes (hpe_eval.py:62-96 equivalent).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from handnet_tpu_torch.data import yaml_lite

SUBJECTS = [
    "20200709-subject-01", "20200813-subject-02", "20200820-subject-03",
    "20200903-subject-04", "20200908-subject-05", "20200918-subject-06",
    "20200928-subject-07", "20201002-subject-08", "20201015-subject-09",
    "20201022-subject-10",
]

SERIALS = [
    "836212060125", "839512060362", "840412060917", "841412060263",
    "932122060857", "932122060861", "932122061900", "932122062010",
]

YCB_CLASSES = {
    1: "002_master_chef_can", 2: "003_cracker_box", 3: "004_sugar_box",
    4: "005_tomato_soup_can", 5: "006_mustard_bottle", 6: "007_tuna_fish_can",
    7: "008_pudding_box", 8: "009_gelatin_box", 9: "010_potted_meat_can",
    10: "011_banana", 11: "019_pitcher_base", 12: "021_bleach_cleanser",
    13: "024_bowl", 14: "025_mug", 15: "035_power_drill",
    16: "036_wood_block", 17: "037_scissors", 18: "040_large_marker",
    19: "051_large_clamp", 20: "052_extra_large_clamp", 21: "061_foam_brick",
}

HAND_SEG_LABEL = 255  # hand pixels in the seg map

MANO_JOINT_CONNECT = [
    [0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
    [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15],
    [15, 16], [0, 17], [17, 18], [18, 19], [19, 20],
]

_BOP_SUBSAMPLE = 4


def _split_indices(setup: str, split: str):
    """The s0-s3 split tables (dex_ycb.py:127-186), re-stated."""
    all_subjects = list(range(10))
    all_serials = list(range(8))
    all_seqs = list(range(100))
    if setup == "s0":
        if split == "train":
            return all_subjects, all_serials, [i for i in all_seqs if i % 5 != 4]
        if split == "val":
            return [0, 1], all_serials, [i for i in all_seqs if i % 5 == 4]
        if split == "test":
            return list(range(2, 10)), all_serials, [i for i in all_seqs if i % 5 == 4]
    if setup == "s1":  # unseen subjects
        if split == "train":
            return [0, 1, 2, 3, 4, 5, 9], all_serials, all_seqs
        if split == "val":
            return [6], all_serials, all_seqs
        if split == "test":
            return [7, 8], all_serials, all_seqs
    if setup == "s2":  # unseen cameras
        if split == "train":
            return all_subjects, [0, 1, 2, 3, 4, 5], all_seqs
        if split == "val":
            return all_subjects, [6], all_seqs
        if split == "test":
            return all_subjects, [7], all_seqs
    if setup == "s3":  # unseen objects
        if split == "train":
            return (all_subjects, all_serials,
                    [i for i in all_seqs if i // 5 not in (3, 7, 11, 15, 19)])
        if split == "val":
            return (all_subjects, all_serials,
                    [i for i in all_seqs if i // 5 in (3, 19)])
        if split == "test":
            return (all_subjects, all_serials,
                    [i for i in all_seqs if i // 5 in (7, 11, 15)])
    raise ValueError(f"unknown setup/split {setup}/{split}")


class DexYCBDataset:
    """Indexable dataset over (sequence, camera, frame) triples."""

    ycb_classes = YCB_CLASSES

    def __init__(self, setup: str, split: str,
                 data_dir: Optional[str] = None):
        self.setup = setup
        self.split = split
        self.data_dir = data_dir or os.environ.get("DEX_YCB_DIR")
        if self.data_dir is None:
            raise RuntimeError("DEX_YCB_DIR not set and no data_dir given")
        self.h, self.w = 480, 640

        subject_ind, serial_ind, sequence_ind = _split_indices(setup, split)
        self._subjects = [SUBJECTS[i] for i in subject_ind
                          if os.path.isdir(os.path.join(self.data_dir,
                                                        SUBJECTS[i]))]
        # keep only serials whose calibration exists — lets partial mirrors
        # and synthetic fixtures load (real DexYCB always has all 8)
        self._serials = [
            SERIALS[i] for i in serial_ind
            if os.path.exists(os.path.join(
                self.data_dir, "calibration", "intrinsics",
                f"{SERIALS[i]}_{self.w}x{self.h}.yml"))
        ]

        self._intrinsics = []
        for s in self._serials:
            intr_file = os.path.join(self.data_dir, "calibration",
                                     "intrinsics",
                                     f"{s}_{self.w}x{self.h}.yml")
            self._intrinsics.append(yaml_lite.load(intr_file)["color"])

        self._sequences: List[str] = []
        self._ycb_ids: List[List[int]] = []
        self._mano_side: List[str] = []
        self._mano_betas: List[List[float]] = []
        mapping = []
        offset = 0
        for subj in self._subjects:
            seqs = sorted(os.listdir(os.path.join(self.data_dir, subj)))
            seqs = [os.path.join(subj, s) for s in seqs]
            seqs = [seqs[i] for i in sequence_ind if i < len(seqs)]
            self._sequences += seqs
            for i, q in enumerate(seqs):
                meta = yaml_lite.load(os.path.join(self.data_dir, q, "meta.yml"))
                n_serials = len(self._serials)
                c, f_ = np.meshgrid(np.arange(n_serials),
                                    np.arange(meta["num_frames"]),
                                    indexing="ij")
                s_ = (offset + i) * np.ones_like(c.ravel())
                mapping.append(np.stack([s_, c.ravel(), f_.ravel()], axis=1))
                self._ycb_ids.append(meta["ycb_ids"])
                self._mano_side.append(meta["mano_sides"][0])
                calib = os.path.join(self.data_dir, "calibration",
                                     f"mano_{meta['mano_calib'][0]}",
                                     "mano.yml")
                self._mano_betas.append(yaml_lite.load(calib)["betas"])
            offset += len(seqs)
        self._mapping = (np.vstack(mapping) if mapping
                         else np.zeros((0, 3), np.int64))

    def __len__(self) -> int:
        return len(self._mapping)

    def __getitem__(self, idx: int) -> Dict:
        s, c, f = self._mapping[idx]
        d = os.path.join(self.data_dir, self._sequences[s], self._serials[c])
        return {
            "color_file": os.path.join(d, f"color_{f:06d}.jpg"),
            "depth_file": os.path.join(d, f"aligned_depth_to_color_{f:06d}.png"),
            "label_file": os.path.join(d, f"labels_{f:06d}.npz"),
            "intrinsics": self._intrinsics[c],
            "ycb_ids": self._ycb_ids[s],
            "mano_side": self._mano_side[s],
            "mano_betas": self._mano_betas[s],
        }


_FACTORY_CACHE: Dict[str, DexYCBDataset] = {}


def get_dataset(name: str, data_dir: Optional[str] = None) -> DexYCBDataset:
    """'s0_train'-style factory (factory.py:18-32)."""
    key = f"{name}:{data_dir}"
    if key not in _FACTORY_CACHE:
        setup, split = name.split("_")
        _FACTORY_CACHE[key] = DexYCBDataset(setup, split, data_dir)
    return _FACTORY_CACHE[key]


def paras_from_intrinsics(intr: Dict) -> np.ndarray:
    """[fx, fy, ppx, ppy] — the 'paras' vector used throughout."""
    return np.asarray([intr["fx"], intr["fy"], intr["ppx"], intr["ppy"]],
                      np.float32)


def refine_indices(dataset: DexYCBDataset, max_outside: int = 2,
                   cache_path: Optional[str] = None) -> List[int]:
    """Filter samples whose hand is (mostly) outside the frame.

    refine_idx_gen.py:8-30 semantics: drop a sample when >2 of its 2D joints
    leave the image bounds or the wrist (joint 0) does, or when no MANO pose
    exists (joint_2d all -1).
    """
    if cache_path and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    keep = []
    for i in range(len(dataset)):
        sample = dataset[i]
        label = np.load(sample["label_file"])
        j2d = label["joint_2d"].reshape(21, 2)
        if np.all(j2d == -1):
            continue
        outside = ((j2d[:, 0] < 0) | (j2d[:, 0] >= dataset.w)
                   | (j2d[:, 1] < 0) | (j2d[:, 1] >= dataset.h))
        if outside.sum() > max_outside or outside[0]:
            continue
        keep.append(i)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump(keep, f)
    return keep


def hpe_ground_truth(dataset: DexYCBDataset) -> Dict[int, np.ndarray]:
    """image_id -> [21, 3] mm GT for the HPE evaluator (hpe_eval.py:62-96:
    skip all -1 samples, scale x1000)."""
    out = {}
    for i in range(len(dataset)):
        label = np.load(dataset[i]["label_file"])
        j3d = label["joint_3d"].reshape(21, 3)
        if np.all(j3d == -1):
            continue
        out[i] = j3d * 1000.0
    return out
