"""Detection-target construction from DexYCB frames, fixed-shape.

The port's copy of ``handnet_tpu/data/detect_data.py``: the colour frame is
read with ``data/image_io.py`` (``imread_color``, the port's JPEG decoder)
and the depth with its PNG reader, where the JAX package calls ``cv2``; the
masks' boxes come from the port's ``rle``.

Covers both reference datasets:
* DetectDataset (datasets3d/detectdataset.py:12-107): hand box only,
  category 1.
* E2EDataset targets (datasets3d/e2edataset.py:159-247): YCB object boxes
  (category = ycb id) + hand box (category 22), plus the 5-field ``box_info``
  rows (contact_state, hand_side, magnitude, dx, dy) with handedness filled
  for the hand row and -1/-0 padding exactly like the reference (:214-221).

TPU-first: instead of ragged per-image lists, every target is padded to
``max_boxes`` with a validity mask — the shape the vectorized FCOS matcher
(models/fcos.py) consumes directly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from handnet_tpu_torch.data import image_io
from handnet_tpu_torch.data import rle as rle_mod
from handnet_tpu_torch.data.dexycb import HAND_SEG_LABEL

HAND_CATEGORY_E2E = 22


def seg_to_boxes(seg: np.ndarray, ycb_ids, include_objects: bool = True
                 ) -> Dict[str, np.ndarray]:
    """Extract xyxy boxes per segment label (e2edataset.py:190-211)."""
    boxes = []
    labels = []
    ids = (list(ycb_ids) if include_objects else []) + [HAND_SEG_LABEL]
    for y in ids:
        mask = seg == y
        if not mask.any():
            continue
        r = rle_mod.encode(np.asfortranarray(mask).astype(np.uint8))
        x, yy, w, h = rle_mod.toBbox(r)
        boxes.append([x, yy, x + w, yy + h])
        labels.append(HAND_CATEGORY_E2E if y == HAND_SEG_LABEL else int(y))
    return {
        "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        "labels": np.asarray(labels, np.int32),
    }


def build_detection_target(seg: np.ndarray, ycb_ids, mano_side: str,
                           max_boxes: int = 8, e2e: bool = True,
                           ) -> Dict[str, np.ndarray]:
    """Fixed-shape target dict: boxes [M,4], labels [M], valid [M],
    box_info [M,5].

    e2e=True: objects + hand (labels = ycb id / 22). e2e=False: hand only,
    label 1 (detectdataset.py semantics).
    """
    extracted = seg_to_boxes(seg, ycb_ids, include_objects=e2e)
    boxes = extracted["boxes"]
    labels = extracted["labels"]
    if not e2e:
        labels = np.ones_like(labels)

    n = min(len(boxes), max_boxes)
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_labels = np.zeros((max_boxes,), np.int32)
    out_valid = np.zeros((max_boxes,), bool)
    # box_info padding: -1 everywhere, field 4 zeroed (e2edataset.py:214-215)
    out_info = np.full((max_boxes, 5), -1.0, np.float32)
    out_info[:, 4] = 0.0

    out_boxes[:n] = boxes[:n]
    out_labels[:n] = labels[:n]
    out_valid[:n] = True

    hand_label = HAND_CATEGORY_E2E if e2e else 1
    for i in range(n):
        if out_labels[i] == hand_label:
            out_info[i, 1] = 1.0 if mano_side == "right" else 0.0
    return {"boxes": out_boxes, "labels": out_labels, "valid": out_valid,
            "box_info": out_info}


class DetectDataSource:
    """Indexable DexYCB -> (image, fixed-shape target) source."""

    def __init__(self, dataset, refined_idx, max_boxes: int = 8,
                 e2e: bool = True, uint8_images: bool = False):
        """``uint8_images``: keep frames at sensor width (uint8; depth stays
        float meters) — 4x less host->device traffic per train step; the
        model's preprocess dequantizes on device."""
        self.dataset = dataset
        self.refined_idx = list(refined_idx)
        self.max_boxes = max_boxes
        self.e2e = e2e
        self.uint8_images = uint8_images

    def __len__(self):
        return len(self.refined_idx)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = self.dataset[self.refined_idx[idx]]
        color = image_io.imread_color(sample["color_file"])[:, :, ::-1]  # BGR -> RGB
        label = np.load(sample["label_file"])
        target = build_detection_target(label["seg"], sample["ycb_ids"],
                                        sample["mano_side"], self.max_boxes,
                                        self.e2e)
        depth = image_io.read_png(sample["depth_file"])
        return {
            "image": (np.ascontiguousarray(color) if self.uint8_images
                      else color.astype(np.float32) / 255.0),
            "depth": depth.astype(np.float32) / 1000.0,
            "dexycb_id": np.asarray([self.refined_idx[idx]], np.int64),
            **{f"target_{k}": v for k, v in target.items()},
        }
