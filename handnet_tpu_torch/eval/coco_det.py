"""COCO-style evaluation: bbox, segm (mask IoU), keypoints (OKS) AP.

The port's copy of ``handnet_tpu/eval/coco_det.py`` (numpy only, unchanged
but for the imports: the port's ``data/rle.py`` and ``eval/voc.py``).

Reference: dex-ycb-toolkit/dex_ycb_toolkit/coco_eval.py:26-262 builds COCO
annotations on the fly and calls pycocotools' COCOeval over the three tasks
('bbox', 'segm', 'keypoints', :215-236, with kpt_oks_sigmas = [0.05]*21,
:23). Here the matcher + PR accumulation are implemented directly (same
published COCO protocol: greedy per-IoU-threshold matching in descending
score order, crowd-free, 101-point interpolated AP), over in-memory records
— no JSON round trip. Segm IoU uses the native RLE kernel (data/rle.py);
OKS follows pycocotools' computeOks.

API: ``CocoDetEvaluator(gt).evaluate(detections, labels, iou_type=...)``
-> metric dict. GT/detections reuse eval.voc record types (GTObject label =
category name or id via ``name``); masks/keypoints ride in parallel dicts
keyed by the record's identity (see evaluate args).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from handnet_tpu_torch.data import rle as rle_codec
from handnet_tpu_torch.eval.voc import Detection, GTObject

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
# reference coco_eval.py:23 — untuned hand-joint sigmas
KPT_OKS_SIGMAS = np.full(21, 0.05)


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _oks_matrix(dt_kpts: Sequence[np.ndarray], gt_kpts: Sequence[np.ndarray],
                gt_areas: Sequence[float],
                gt_boxes: Optional[Sequence[np.ndarray]] = None,
                sigmas: np.ndarray = KPT_OKS_SIGMAS) -> np.ndarray:
    """Object keypoint similarity, pycocotools computeOks semantics.

    dt_kpts: list of ``[J, 2+]`` predicted (x, y, ...) arrays.
    gt_kpts: list of ``[J, 3]`` (x, y, vis) arrays. When a GT has no visible
    joints, pycocotools falls back to distances outside the 2x-expanded GT
    box (cocoeval computeOks k1==0 branch) — used here for matching against
    IGNORED GTs; pass ``gt_boxes`` (xyxy) to enable it.
    gt_areas: GT object areas (the OKS scale term).
    """
    variances = (2.0 * np.asarray(sigmas)) ** 2                   # [J]
    out = np.zeros((len(dt_kpts), len(gt_kpts)))
    for g, (gk, area) in enumerate(zip(gt_kpts, gt_areas)):
        gk = np.asarray(gk, np.float64)
        vis = gk[:, 2] > 0
        for d, dk in enumerate(dt_kpts):
            dk = np.asarray(dk, np.float64)
            if vis.any():
                d2 = ((dk[:, 0] - gk[:, 0]) ** 2
                      + (dk[:, 1] - gk[:, 1]) ** 2)
                e = d2 / variances / (max(area, 1e-9) + np.spacing(1)) / 2.0
                out[d, g] = float(np.mean(np.exp(-e[vis])))
            elif gt_boxes is not None:
                bx = np.asarray(gt_boxes[g], np.float64)
                w, h = bx[2] - bx[0], bx[3] - bx[1]
                x0, x1 = bx[0] - w, bx[0] + 2 * w
                y0, y1 = bx[1] - h, bx[1] + 2 * h
                dx = (np.maximum(0.0, x0 - dk[:, 0])
                      + np.maximum(0.0, dk[:, 0] - x1))
                dy = (np.maximum(0.0, y0 - dk[:, 1])
                      + np.maximum(0.0, dk[:, 1] - y1))
                e = ((dx ** 2 + dy ** 2) / variances
                     / (max(area, 1e-9) + np.spacing(1)) / 2.0)
                out[d, g] = float(np.mean(np.exp(-e)))
    return out


class CocoDetEvaluator:
    def __init__(self, annotations: Dict[str, List[GTObject]],
                 max_dets: int = 100):
        self.annotations = annotations
        self.max_dets = max_dets
        self.categories = sorted({o.name for objs in annotations.values()
                                  for o in objs})

    def evaluate(self, detections: Sequence[Detection],
                 labels: Sequence[str] | None = None,
                 iou_type: str = "bbox",
                 dt_masks: Optional[Dict[int, dict]] = None,
                 gt_masks: Optional[Dict[int, dict]] = None,
                 dt_keypoints: Optional[Dict[int, np.ndarray]] = None,
                 gt_keypoints: Optional[Dict[int, np.ndarray]] = None,
                 ) -> Dict[str, float]:
        """Evaluate one COCO task over the stored annotations.

        Category comes via the parallel ``labels`` list (or all one class).
        For ``iou_type='segm'``: ``dt_masks[id(det)]`` / ``gt_masks[id(gt)]``
        map records to RLE dicts (data/rle.py:encode format).
        For ``iou_type='keypoints'``: ``dt_keypoints[id(det)]`` ``[J, 2+]``
        and ``gt_keypoints[id(gt)]`` ``[J, 3]`` (x, y, vis); GT objects with
        no visible keypoints are ignored (COCO num_keypoints==0 convention).
        """
        if iou_type not in ("bbox", "segm", "keypoints"):
            raise ValueError(iou_type)
        if iou_type == "segm" and (dt_masks is None or gt_masks is None):
            raise ValueError("segm eval needs dt_masks and gt_masks")
        if iou_type == "keypoints" and (dt_keypoints is None
                                        or gt_keypoints is None):
            raise ValueError("keypoints eval needs dt/gt keypoints")
        if labels is None:
            labels = [self.categories[0]] * len(detections)

        # per (category, image) buckets
        det_by = defaultdict(list)
        for d, c in zip(detections, labels):
            det_by[(c, d.image_id)].append(d)

        def _gt_area(o: GTObject) -> float:
            if gt_masks is not None and id(o) in gt_masks:
                return float(rle_codec.area(gt_masks[id(o)]))
            return float((o.bbox[2] - o.bbox[0]) * (o.bbox[3] - o.bbox[1]))

        def _iou_for(dets: List[Detection], gt: List[GTObject]) -> np.ndarray:
            if not gt:
                return np.zeros((len(dets), 0))
            if iou_type == "segm":
                return np.asarray(rle_codec.iou(
                    [dt_masks[id(d)] for d in dets],
                    [gt_masks[id(o)] for o in gt]))
            if iou_type == "keypoints":
                # ignored GTs may lack a keypoints entry entirely (filtered
                # into gt_ignored at :167-171); substitute an all-invisible
                # array so _oks_matrix takes its box-fallback branch
                no_kpts = np.zeros(
                    (np.asarray(dt_keypoints[id(dets[0])]).shape[0], 3))
                return _oks_matrix([dt_keypoints[id(d)] for d in dets],
                                   [gt_keypoints.get(id(o), no_kpts)
                                    for o in gt],
                                   [_gt_area(o) for o in gt],
                                   gt_boxes=[o.bbox for o in gt])
            return _iou_xyxy(np.stack([d.bbox for d in dets]),
                             np.stack([o.bbox for o in gt]))

        # tp flag matrix per category: [T, D] over all images
        ap_per_cat = {}
        ap50_per_cat = {}
        ap75_per_cat = {}
        ar_per_cat = {}
        for cat in self.categories:
            scores_all = []
            matches_all = []  # [T] bools per det
            n_gt = 0
            for image_id, objs in self.annotations.items():
                gt = [o for o in objs if o.name == cat]
                gt_ignored: List[GTObject] = []
                if iou_type == "keypoints":
                    # COCO IGNORES (not drops) GT with num_keypoints == 0:
                    # detections matched to them count as neither TP nor FP
                    # (pycocotools _prepare/evaluateImg semantics)
                    active = [o for o in gt
                              if id(o) in gt_keypoints
                              and np.asarray(gt_keypoints[id(o)])[:, 2].any()]
                    gt_ignored = [o for o in gt
                                  if not any(o is a for a in active)]
                    gt = active
                n_gt += len(gt)
                dets = sorted(det_by.get((cat, image_id), []),
                              key=lambda d: -d.score)[:self.max_dets]
                if not dets:
                    continue
                iou = _iou_for(dets, gt)
                iou_ign = (_iou_for(dets, gt_ignored) if gt_ignored
                           else np.zeros((len(dets), 0)))
                for d_idx, det in enumerate(dets):
                    scores_all.append(det.score)
                    row = []
                    for t in IOU_THRS:
                        row.append(-1)  # placeholder, filled below
                    matches_all.append(row)
                # greedy matching per threshold
                base = len(matches_all) - len(dets)
                for t_idx, t in enumerate(IOU_THRS):
                    taken = np.zeros(len(gt), bool)
                    for d_idx in range(len(dets)):
                        best, best_iou = -1, t
                        for g_idx in range(len(gt)):
                            if taken[g_idx]:
                                continue
                            if iou[d_idx, g_idx] >= best_iou:
                                best, best_iou = g_idx, iou[d_idx, g_idx]
                        if best >= 0:
                            taken[best] = True
                            matches_all[base + d_idx][t_idx] = 1
                        elif (iou_ign.shape[1]
                              and iou_ign[d_idx].max() >= t):
                            # matched only to an ignored GT: excluded from
                            # both TP and FP
                            matches_all[base + d_idx][t_idx] = -1
                        else:
                            matches_all[base + d_idx][t_idx] = 0

            if n_gt == 0:
                continue
            if not scores_all:
                ap_per_cat[cat] = 0.0
                ap50_per_cat[cat] = 0.0
                ap75_per_cat[cat] = 0.0
                ar_per_cat[cat] = 0.0
                continue
            order = np.argsort(-np.asarray(scores_all))
            m = np.asarray(matches_all)[order]          # [D, T]
            aps = []
            recalls = []
            for t_idx in range(len(IOU_THRS)):
                tp = np.cumsum(m[:, t_idx] == 1)
                fp = np.cumsum(m[:, t_idx] == 0)
                rec = tp / n_gt
                prec = tp / np.maximum(tp + fp, 1e-9)
                # 101-point interpolation (COCO protocol)
                prec_envelope = np.maximum.accumulate(prec[::-1])[::-1]
                interp = np.zeros_like(RECALL_THRS)
                idx = np.searchsorted(rec, RECALL_THRS, side="left")
                valid = idx < len(prec_envelope)
                interp[valid] = prec_envelope[idx[valid]]
                aps.append(interp.mean())
                recalls.append(rec[-1] if len(rec) else 0.0)
            ap_per_cat[cat] = float(np.mean(aps))
            ap50_per_cat[cat] = float(aps[0])
            ap75_per_cat[cat] = float(aps[5])
            ar_per_cat[cat] = float(np.mean(recalls))

        def mean(d):
            return float(np.mean(list(d.values()))) if d else 0.0

        return {
            "AP": mean(ap_per_cat),
            "AP50": mean(ap50_per_cat),
            "AP75": mean(ap75_per_cat),
            "AR": mean(ar_per_cat),
            "per_category": ap_per_cat,
        }
