"""100DOH dataset in Pascal-VOC format: annotations, roidb, eval adapters.

Reference surfaces rebuilt (lib/datasets/pascal_voc.py:40-444,
lib/roi_data_layer/roidb.py:13-136, roiFPNbatchLoader.py:17-59):
* XML parsing including the hand attributes (contactstate, handside,
  magnitude x0.001, unitdx/unitdy — pascal_voc.py:263-291),
* roidb records with fixed-shape padded targets for the FCOS matcher,
* the detection-file round trip used by the VOC evaluator (11-field rows:
  path score x1 y1 x2 y2 state mag*dx mag*dy side 1 —
  trainval_net_fcos.py:137-158 / _write_voc_results_file pascal_voc.py:326).

Classes: background / targetobject / hand (pascal_voc.py:47).

The port's copy of ``handnet_tpu/data/voc100doh.py``: images are read with
``data/image_io.py``'s ``imread_color`` (the port's JPEG decoder) and
resized with its ``resize_linear_u8`` (``cv2``'s fixed-point INTER_LINEAR)
where the JAX package calls ``cv2``.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from handnet_tpu_torch.data import image_io
from handnet_tpu_torch.eval.voc import Detection, GTObject

CLASSES = ("__background__", "targetobject", "hand")
CLASS_TO_IND = {c: i for i, c in enumerate(CLASSES)}


def _maybe(node, default):
    if node is None or node.text is None or node.text == "None":
        return default
    return node.text


def parse_annotation(xml_path: str) -> List[Dict]:
    """Parse one 100DOH VOC xml into object dicts (pascal_voc.py:226-291
    fields; boxes 0-based)."""
    tree = ET.parse(xml_path)
    objects = []
    for obj in tree.findall("object"):
        bbox = obj.find("bndbox")
        rec = {
            "name": obj.find("name").text.lower().strip(),
            "bbox": np.array([
                max(float(bbox.find("xmin").text) - 1, 0),
                max(float(bbox.find("ymin").text) - 1, 0),
                max(float(bbox.find("xmax").text) - 1, 0),
                max(float(bbox.find("ymax").text) - 1, 0),
            ], np.float32),
            "difficult": int(_maybe(obj.find("difficult"), 0)),
            "contactstate": int(_maybe(obj.find("contactstate"), -1)),
            "handside": int(float(_maybe(obj.find("handside"), -1))),
            # x0.001 scale balance (pascal_voc.py:275-276)
            "magnitude": float(_maybe(obj.find("magnitude"), 0)) * 0.001,
            "unitdx": float(_maybe(obj.find("unitdx"), 0)),
            "unitdy": float(_maybe(obj.find("unitdy"), 0)),
            "objxmin": _maybe(obj.find("objxmin"), None),
            "objymin": _maybe(obj.find("objymin"), None),
            "objxmax": _maybe(obj.find("objxmax"), None),
            "objymax": _maybe(obj.find("objymax"), None),
        }
        if rec["objxmin"] is not None:
            rec["objectbbox"] = np.array(
                [float(rec["objxmin"]), float(rec["objymin"]),
                 float(rec["objxmax"]), float(rec["objymax"])], np.float32)
        else:
            rec["objectbbox"] = None
        objects.append(rec)
    return objects


@dataclass
class VOC100DOH:
    """VOC-layout dataset: {root}/VOC2007/{Annotations,ImageSets/Main,
    JPEGImages} (pascal_voc.py:49-76 path scheme)."""

    root: str
    image_set: str = "trainval"
    year: str = "2007"

    def __post_init__(self):
        self.devkit = os.path.join(self.root, f"VOC{self.year}")
        setfile = os.path.join(self.devkit, "ImageSets", "Main",
                               f"{self.image_set}.txt")
        with open(setfile) as f:
            self.image_index = [x.strip() for x in f if x.strip()]

    def __len__(self):
        return len(self.image_index)

    def image_path(self, index: str) -> str:
        return os.path.join(self.devkit, "JPEGImages", f"{index}.jpg")

    def annotation_path(self, index: str) -> str:
        return os.path.join(self.devkit, "Annotations", f"{index}.xml")

    def annotations(self) -> Dict[str, List[GTObject]]:
        """Whole-set GT for the evaluator (eval/voc.py records)."""
        out = {}
        for index in self.image_index:
            objs = parse_annotation(self.annotation_path(index))
            out[index] = [
                GTObject(name=o["name"], bbox=o["bbox"],
                         difficult=bool(o["difficult"]),
                         handstate=max(o["contactstate"], 0),
                         handside=max(o["handside"], 0),
                         objectbbox=o["objectbbox"])
                for o in objs
            ]
        return out

    def roidb(self, max_boxes: int = 16) -> List[Dict[str, np.ndarray]]:
        """Fixed-shape training records (roidb.py:13-52 equivalent):
        boxes [M,4], labels [M], valid [M], box_info [M,5] =
        (contact_state, hand_side, magnitude, unitdx, unitdy) — the
        roiFPNbatchLoader target layout."""
        records = []
        for index in self.image_index:
            objs = parse_annotation(self.annotation_path(index))
            n = min(len(objs), max_boxes)
            boxes = np.zeros((max_boxes, 4), np.float32)
            labels = np.zeros((max_boxes,), np.int32)
            valid = np.zeros((max_boxes,), bool)
            info = np.full((max_boxes, 5), -1.0, np.float32)
            for i, o in enumerate(objs[:n]):
                boxes[i] = o["bbox"]
                labels[i] = CLASS_TO_IND.get(o["name"], 0)
                valid[i] = not o["difficult"]
                info[i] = [o["contactstate"], o["handside"], o["magnitude"],
                           o["unitdx"], o["unitdy"]]
            records.append({"index": index, "image": self.image_path(index),
                            "boxes": boxes, "labels": labels, "valid": valid,
                            "box_info": info})
        return records


class VOCDetectSource:
    """Indexable image+target source over the roidb for the prefetch loader.

    ``target_size=(h, w)``: aspect-preserving resize + bottom/right pad to a
    static shape (boxes scaled accordingly). VOC images vary in size and the
    TPU path needs fixed shapes — this replaces the reference's aspect-ratio
    grouped batching (fpn_utils/group_by_aspect_ratio.py)."""

    def __init__(self, dataset: VOC100DOH, max_boxes: int = 16,
                 target_size=None):
        self.records = dataset.roidb(max_boxes)
        self.target_size = target_size

    def __len__(self):
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        img = image_io.imread_color(rec["image"])[:, :, ::-1]
        boxes = rec["boxes"]
        if self.target_size is not None:
            th, tw = self.target_size
            h, w = img.shape[:2]
            scale = min(th / h, tw / w)
            nh, nw = int(round(h * scale)), int(round(w * scale))
            resized = image_io.resize_linear_u8(img, nw, nh)
            padded = np.zeros((th, tw, 3), img.dtype)
            padded[:nh, :nw] = resized
            img = padded
            boxes = (boxes * scale).astype(np.float32)
        return {
            "image": img.astype(np.float32) / 255.0,
            "target_boxes": boxes,
            "target_labels": rec["labels"],
            "target_valid": rec["valid"],
            "target_box_info": rec["box_info"],
        }


# ---------------------------------------------------------------------------
# Detection-file round trip (evaluation interchange format).


def write_detection_file(path: str, detections: Sequence[Detection]):
    """11-field rows: path score x1 y1 x2 y2 state dx*mag dy*mag side 1
    (trainval_net_fcos.py:137-158 row layout)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for d in detections:
            mag, dx, dy = (float(d.vector[0]), float(d.vector[1]),
                           float(d.vector[2]))
            f.write(
                f"{d.image_id} {d.score:.6f} "
                f"{d.bbox[0]:.1f} {d.bbox[1]:.1f} {d.bbox[2]:.1f} "
                f"{d.bbox[3]:.1f} {d.handstate} {mag * dx:.6f} "
                f"{mag * dy:.6f} {d.handside} 1\n")


def read_detection_file(path: str) -> List[Detection]:
    out = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) < 10:
                continue
            mag_dx, mag_dy = float(p[7]), float(p[8])
            mag = float(np.hypot(mag_dx, mag_dy))
            vec = (np.array([mag, mag_dx / mag, mag_dy / mag])
                   if mag > 0 else np.zeros(3))
            out.append(Detection(
                image_id=p[0], score=float(p[1]),
                bbox=np.array([float(x) for x in p[2:6]]),
                handstate=int(float(p[6])), vector=vec,
                handside=int(float(p[9]))))
    return out


def decoded_to_detections(det: Dict[str, np.ndarray], image_ids: Sequence[str],
                          hand_label: int = 2, object_label: int = 1,
                          score_thresh: float = 0.1):
    """Split a batch of fixed-shape pipeline detections into hand/object
    Detection lists (the trainval_net_fcos.py:132-158 packing step)."""
    hands, objects = [], []
    boxes = np.asarray(det["boxes"])
    scores = np.asarray(det["scores"])
    labels = np.asarray(det["labels"])
    valid = np.asarray(det["valid"])
    sides = np.asarray(det.get("sides", np.zeros_like(labels)))
    contacts = np.asarray(det.get("contacts", np.zeros_like(labels)))
    dxdy = np.asarray(det.get("dxdymags",
                              np.zeros(labels.shape + (3,), np.float32)))
    for b in range(boxes.shape[0]):
        for k in range(boxes.shape[1]):
            if not valid[b, k] or scores[b, k] <= score_thresh:
                continue
            rec = Detection(
                image_id=image_ids[b], score=float(scores[b, k]),
                bbox=boxes[b, k].astype(float),
                handstate=int(contacts[b, k]),
                vector=dxdy[b, k].astype(float),
                handside=int(sides[b, k]))
            if labels[b, k] == hand_label:
                hands.append(rec)
            elif labels[b, k] == object_label:
                objects.append(rec)
    return hands, objects
