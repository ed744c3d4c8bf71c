"""100DOH / Pascal-VOC detection evaluation: standard AP plus the
hand-constrained AP variants (handstate / handside / objectbbox / all).

The port's copy of ``handnet_tpu/eval/voc.py`` (numpy only, unchanged).

Reference: lib/datasets/voc_eval.py — ``voc_ap`` (:56-89), ``voc_eval``
(:95-238), ``voc_eval_hand`` (:248-380) with hand-object association
(``gen_det_result``, :662-702: in-contact hands link to the object whose
center is nearest along the predicted offset ray).

Redesign: the evaluator consumes in-memory records instead of the reference's
txt-file + pickle-cache plumbing; adapters read/write the reference's file
formats where needed (data/voc.py). Matching math is identical, including the
+1 pixel VOC box-area convention (:203-210) and greedy per-GT claiming.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from a PR curve (all-point interpolation by default, 11-point with
    ``use_07_metric`` — reference voc_eval.py:56-89)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _voc_overlaps(gt: np.ndarray, box: np.ndarray) -> np.ndarray:
    """VOC IoU with the +1 pixel convention (voc_eval.py:198-212)."""
    ixmin = np.maximum(gt[:, 0], box[0])
    iymin = np.maximum(gt[:, 1], box[1])
    ixmax = np.minimum(gt[:, 2], box[2])
    iymax = np.minimum(gt[:, 3], box[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inter = iw * ih
    union = ((box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
             + (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0)
             - inter)
    return inter / union


@dataclass
class GTObject:
    """One annotated object (parse_rec fields, voc_eval.py:19-53)."""

    name: str
    bbox: np.ndarray                       # [4] x1 y1 x2 y2
    difficult: bool = False
    handstate: int = 0
    handside: int = 0
    objectbbox: Optional[np.ndarray] = None  # associated object box or None


@dataclass
class Detection:
    image_id: str
    score: float
    bbox: np.ndarray
    handstate: int = 0
    vector: np.ndarray = field(default_factory=lambda: np.zeros(3))  # mag,dx,dy
    handside: int = 0
    objectbbox: Optional[np.ndarray] = None
    objectbbox_score: Optional[float] = None


def voc_eval(detections: Sequence[Detection],
             annotations: Dict[str, List[GTObject]], classname: str,
             ovthresh: float = 0.5, use_07_metric: bool = False):
    """Standard VOC AP for one class (reference voc_eval.py:95-238)."""
    class_recs = {}
    npos = 0
    for image_id, objs in annotations.items():
        objs_c = [o for o in objs if o.name.lower() == classname]
        bbox = (np.stack([o.bbox for o in objs_c]).astype(float)
                if objs_c else np.zeros((0, 4)))
        difficult = np.array([o.difficult for o in objs_c], bool)
        npos += int((~difficult).sum())
        class_recs[image_id] = {"bbox": bbox, "difficult": difficult,
                                "det": [False] * len(objs_c)}

    dets = sorted(detections, key=lambda d: -d.score)
    nd = len(dets)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d, det in enumerate(dets):
        rec = class_recs.get(det.image_id)
        ovmax, jmax = -np.inf, -1
        if rec is not None and rec["bbox"].size > 0:
            overlaps = _voc_overlaps(rec["bbox"], np.asarray(det.bbox, float))
            ovmax = overlaps.max()
            jmax = int(overlaps.argmax())
        if ovmax > ovthresh:
            if not rec["difficult"][jmax]:
                if not rec["det"][jmax]:
                    tp[d] = 1.0
                    rec["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    recall = tp / max(float(npos), np.finfo(np.float64).eps)
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return recall, precision, voc_ap(recall, precision, use_07_metric)


def _iou_simple(bb1, bb2) -> float:
    """Plain IoU without the +1 convention (voc_eval.py:593-616 get_iou)."""
    x1 = max(bb1[0], bb2[0])
    y1 = max(bb1[1], bb2[1])
    x2 = min(bb1[2], bb2[2])
    y2 = min(bb1[3], bb2[3])
    if x2 < x1 or y2 < y1:
        return 0.0
    inter = (x2 - x1) * (y2 - y1)
    a1 = (bb1[2] - bb1[0]) * (bb1[3] - bb1[1])
    a2 = (bb2[2] - bb2[0]) * (bb2[3] - bb2[1])
    return inter / float(a1 + a2 - inter)


def _val_objectbbox(gt_obj, det_obj, threshold: float = 0.5) -> bool:
    """Object-association check (voc_eval.py:576-589): both-None passes, both
    present require IoU > 0.5, mixed fails."""
    if gt_obj is None and det_obj is None:
        return True
    if gt_obj is not None and det_obj is not None:
        return _iou_simple(gt_obj, det_obj) > threshold
    return False


def associate_hands_to_objects(hand_dets: Sequence[Detection],
                               object_dets: Sequence[Detection]
                               ) -> List[Detection]:
    """Link each in-contact hand to the object detection whose center is
    closest to the point projected along the hand's offset vector
    (gen_det_result, voc_eval.py:662-702: point = hand_center + mag*1e4*(dx,dy),
    with centers computed in (y, x) order as the reference does)."""
    by_image: Dict[str, List[Detection]] = {}
    for od in object_dets:
        by_image.setdefault(od.image_id, []).append(od)

    out = []
    for hd in hand_dets:
        objs = by_image.get(hd.image_id, [])
        if hd.handstate <= 0 or not objs:
            out.append(Detection(hd.image_id, hd.score, hd.bbox, hd.handstate,
                                 hd.vector, hd.handside, None, None))
            continue
        # centers in (y, x) like calculate_center (voc_eval.py:654-655)
        def center_yx(bb):
            return np.array([(bb[0] + bb[2]) / 2, (bb[1] + bb[3]) / 2])

        hand_cc = center_yx(hd.bbox)
        mag, dx, dy = float(hd.vector[0]), float(hd.vector[1]), float(hd.vector[2])
        point = np.array([hand_cc[0] + mag * 10000 * dx,
                          hand_cc[1] + mag * 10000 * dy])
        centers = np.stack([center_yx(o.bbox) for o in objs])
        best = int(np.argmin(((centers - point) ** 2).sum(axis=1)))
        out.append(Detection(hd.image_id, hd.score, hd.bbox, hd.handstate,
                             hd.vector, hd.handside,
                             np.asarray(objs[best].bbox, float),
                             float(objs[best].score)))
    return out


def voc_eval_hand(hand_dets: Sequence[Detection],
                  object_dets: Sequence[Detection],
                  annotations: Dict[str, List[GTObject]],
                  classname: str = "hand", ovthresh: float = 0.5,
                  use_07_metric: bool = False, constraint: str = ""):
    """Hand-constrained AP (reference voc_eval_hand, voc_eval.py:248-380).

    constraint in {'', 'handstate', 'handside', 'objectbbox', 'all'}.
    """
    assert constraint in ("", "handstate", "handside", "objectbbox", "all")

    class_recs = {}
    npos = 0
    for image_id, objs in annotations.items():
        objs_c = [o for o in objs if o.name.lower() == classname]
        bbox = (np.stack([o.bbox for o in objs_c]).astype(float)
                if objs_c else np.zeros((0, 4)))
        difficult = np.array([o.difficult for o in objs_c], bool)
        npos += int((~difficult).sum())
        class_recs[image_id] = {
            "bbox": bbox,
            "difficult": difficult,
            "handstate": np.array([o.handstate for o in objs_c], int),
            "handside": np.array([o.handside for o in objs_c], int),
            "objectbbox": [o.objectbbox for o in objs_c],
            "det": [False] * len(objs_c),
        }

    dets = sorted(associate_hands_to_objects(hand_dets, object_dets),
                  key=lambda d: -d.score)
    nd = len(dets)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d, det in enumerate(dets):
        rec = class_recs.get(det.image_id)
        ovmax, jmax = -np.inf, -1
        if rec is not None and rec["bbox"].size > 0:
            overlaps = _voc_overlaps(rec["bbox"], np.asarray(det.bbox, float))
            ovmax = overlaps.max()
            jmax = int(overlaps.argmax())
        if ovmax <= ovthresh:
            fp[d] = 1.0
            continue
        if rec["difficult"][jmax]:
            continue
        ok = not rec["det"][jmax]
        if constraint in ("handstate", "all"):
            ok = ok and rec["handstate"][jmax] == det.handstate
        if constraint in ("handside", "all"):
            ok = ok and rec["handside"][jmax] == det.handside
        if constraint in ("objectbbox", "all"):
            ok = ok and _val_objectbbox(rec["objectbbox"][jmax], det.objectbbox)
        if ok:
            tp[d] = 1.0
            rec["det"][jmax] = True
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    recall = tp / max(float(npos), np.finfo(np.float64).eps)
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return recall, precision, voc_ap(recall, precision, use_07_metric)


def evaluate_detections_100doh(hand_dets, object_dets, annotations,
                               ovthresh: float = 0.5) -> Dict[str, float]:
    """The full eval sweep of pascal_voc._do_python_eval (pascal_voc.py:345-404):
    per-class AP + the four constrained hand APs."""
    out = {}
    for cls in ("targetobject", "hand"):
        dets = object_dets if cls == "targetobject" else hand_dets
        _, _, ap = voc_eval(dets, annotations, cls, ovthresh)
        out[f"ap_{cls}"] = ap
    for constraint in ("handstate", "handside", "objectbbox", "all"):
        _, _, ap = voc_eval_hand(hand_dets, object_dets, annotations,
                                 "hand", ovthresh, constraint=constraint)
        out[f"ap_hand_{constraint}"] = ap
    return out
